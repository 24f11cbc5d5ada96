// Routed experts of an LFM2-MoE layer (pocket_tts_tpu_torch/models/lfm2.py),
// hand-written for Hopper (sm_90a).
//
// Replaces: no TPU kernel; the JAX package has no mixture of experts.  Added
// because a layer's bank of E experts cannot be read whole for every token,
// and applying per-token chosen weights in PyTorch needs a host-side grouping
// (nonzero, per-expert counts) that would make the frame loop wait for the
// device.  Three kernels, all reading ids that stay on the device:
//   moe_router_kernel  logits = x . router[e] (float32), score = sigmoid,
//                      top k of score + expert_bias (ties to the lower id),
//                      weight = score / (sum of the k scores + 1e-6) * scale,
//                      and each valid token's picks added to slots[e];
//   moe_up_kernel      h[s, f] = silu(gate[e][f] . x[t]) * (up[e][f] . x[t])
//                      for each slot s = t * k + j, e = ids[s];
//   moe_down_kernel    y[t, n] = sum over t's slots, in ascending e, of
//                      w[s] * (down[e][n] . h[s]), rounded once to bf16.
//
// What bounds it on the card: bytes.  At B = 1 (one token a launch) a layer of
// LFM2-8B-A1B reads the gate and up rows of its k = 4 chosen experts, 4 x 2 x
// 1792 x 2048 x 2 B = 58.7 MB (17.5 us at 3.35 TB/s), and their down rows,
// 29.4 MB (8.8 us), at 2 FLOP a weight, far below the bf16 ridge (~295 FLOP a
// byte).  A prefill's tokens touch most of the bank (705 MB a layer) once.
//
// What the design does about it:
//   * One warp per weight row: the up kernel's CTA owns kWarps rows f of the
//     gate and of the up matrix (grid F / kWarps), the down kernel's kWarps
//     output rows n (grid K / kWarps).  A lane reads 16 bytes of the row per
//     step, a warp 512 contiguous bytes, unrolled so that many loads are in
//     flight, through the read-only path (the bank is never written).
//   * At one token (the frame step, the <true> instantiation) a CTA takes the
//     token's k experts straight from the ids; at more tokens (<false>) it
//     first sorts the launch's slots by expert in shared memory (a counting
//     sort by one thread), then walks the experts that were chosen, so each
//     chosen row is read once a CTA for all the tokens routed to it, up to
//     kSlotBatch slots sharing each step's weight loads (the repeats of a row
//     for more slots come from L1), and the unchosen experts are never read.
//   * The SwiGLU is applied where the two dot products end, and h (k rows of
//     F floats a token) stays in float32 scratch, which the down kernel reads.
//     The weighted sum over a token's experts is kept per (token, row) in
//     shared memory by the row's warp: no atomics in any sum.
//
// Lane independence: a token's outputs depend only on its own row of x, its
// ids and weights.  Every dot product sums a lane's 16-byte steps in order and
// then a butterfly of the same pairs; the k experts of a token are summed in
// ascending expert id in both instantiations.  So a token is bit-identical
// alone and inside any batch, run to run.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// The C entries return a cudaError_t (0 = success).

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kChunk = 256;  // elements of a row one warp step covers (32 lanes x 8 bf16)
constexpr int kMaxExperts = 64;
constexpr int kMaxTopk = 8;
constexpr int kMaxSlots = 2048;
constexpr int kMaxTokens = 512;
constexpr float kNormEps = 1e-6f;
constexpr int kSlotBatch = 4;  // slots of one expert a warp takes at once (grouped launches)

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// the two bf16 values of a 32-bit word, lower address first
__device__ __forceinline__ float lo(uint32_t u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float hi(uint32_t u) { return __uint_as_float(u & 0xffff0000u); }

__device__ __forceinline__ float dot8(uint4 w, uint4 x, float acc) {
  acc = fmaf(lo(w.x), lo(x.x), acc);
  acc = fmaf(hi(w.x), hi(x.x), acc);
  acc = fmaf(lo(w.y), lo(x.y), acc);
  acc = fmaf(hi(w.y), hi(x.y), acc);
  acc = fmaf(lo(w.z), lo(x.z), acc);
  acc = fmaf(hi(w.z), hi(x.z), acc);
  acc = fmaf(lo(w.w), lo(x.w), acc);
  return fmaf(hi(w.w), hi(x.w), acc);
}

__device__ __forceinline__ float dot8f(uint4 w, float4 a, float4 b, float acc) {
  acc = fmaf(lo(w.x), a.x, acc);
  acc = fmaf(hi(w.x), a.y, acc);
  acc = fmaf(lo(w.y), a.z, acc);
  acc = fmaf(hi(w.y), a.w, acc);
  acc = fmaf(lo(w.z), b.x, acc);
  acc = fmaf(hi(w.z), b.y, acc);
  acc = fmaf(lo(w.w), b.z, acc);
  return fmaf(hi(w.w), b.w, acc);
}

// float -> bf16 bits, round to nearest even (NaN kept a NaN)
__device__ __forceinline__ uint16_t to_bf16(float v) {
  uint32_t u = __float_as_uint(v);
  if ((u & 0x7fffffffu) > 0x7f800000u) return 0x7fc0u;
  u += 0x7fffu + ((u >> 16) & 1u);
  return static_cast<uint16_t>(u >> 16);
}

struct RouteArgs {
  const void* x;           // [M, K] bf16 or f32, row stride x_stride elements
  long long x_stride;
  int x_bf16;
  const float* w;          // [E, K]
  const float* bias;       // [E] or null
  int* ids;                // [M, topk]
  float* wts;              // [M, topk]
  unsigned long long* slots;  // [E] or null
  const bool* valid;       // [M] or null (every token valid)
  int K, E, topk, norm;
  float scale;
};

__global__ void __launch_bounds__(kThreads) moe_router_kernel(RouteArgs a) {
  __shared__ float score[kMaxExperts];
  __shared__ float sel[kMaxExperts];
  const int t = blockIdx.x, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int e = warp; e < a.E; e += kWarps) {
    const float4* w = reinterpret_cast<const float4*>(a.w + static_cast<long long>(e) * a.K);
    float acc = 0.f;
    if (a.x_bf16) {
      const uint2* x = reinterpret_cast<const uint2*>(static_cast<const uint16_t*>(a.x) +
                                                      t * a.x_stride);
      for (int c = lane; c < a.K / 4; c += 32) {
        const float4 wv = __ldg(w + c);
        const uint2 xv = x[c];
        acc = fmaf(wv.x, lo(xv.x), acc);
        acc = fmaf(wv.y, hi(xv.x), acc);
        acc = fmaf(wv.z, lo(xv.y), acc);
        acc = fmaf(wv.w, hi(xv.y), acc);
      }
    } else {
      const float4* x = reinterpret_cast<const float4*>(static_cast<const float*>(a.x) +
                                                        t * a.x_stride);
      for (int c = lane; c < a.K / 4; c += 32) {
        const float4 wv = __ldg(w + c);
        const float4 xv = x[c];
        acc = fmaf(wv.x, xv.x, acc);
        acc = fmaf(wv.y, xv.y, acc);
        acc = fmaf(wv.z, xv.z, acc);
        acc = fmaf(wv.w, xv.w, acc);
      }
    }
    acc = warp_sum(acc);
    if (lane == 0) {
      const float sc = 1.f / (1.f + expf(-acc));
      const float v = sc + (a.bias != nullptr ? a.bias[e] : 0.f);
      score[e] = sc;
      sel[e] = v == v ? v : -CUDART_INF_F;  // a NaN is never chosen first
    }
  }
  __syncthreads();
  if (warp != 0) return;
  // the top k by rounds of a warp argmax (ties to the lower id): lane l holds
  // experts l and l + 32; every lane ends with the same picks in the same order
  float v0 = lane < a.E ? sel[lane] : -CUDART_INF_F;
  float v1 = lane + 32 < a.E ? sel[lane + 32] : -CUDART_INF_F;
  int chosen[kMaxTopk];
  float sum = 0.f;
  for (int j = 0; j < a.topk; ++j) {
    float bv = v0;
    int bi = lane;
    if (v1 > bv) {
      bv = v1;
      bi = lane + 32;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
      if (ov > bv || (ov == bv && oi < bi)) {
        bv = ov;
        bi = oi;
      }
    }
    bi = min(bi, a.E - 1);
    chosen[j] = bi;
    if (bi == lane) v0 = -CUDART_INF_F;
    if (bi == lane + 32) v1 = -CUDART_INF_F;
    sum += score[bi];
  }
  if (lane != 0) return;
  const float denom = a.norm ? sum + kNormEps : 1.f;
  const bool counted = a.slots != nullptr && (a.valid == nullptr || a.valid[t]);
  for (int j = 0; j < a.topk; ++j) {
    a.ids[t * a.topk + j] = chosen[j];
    a.wts[t * a.topk + j] = score[chosen[j]] / denom * a.scale;
    if (counted) atomicAdd(a.slots + chosen[j], 1ull);
  }
}

struct ExpertArgs {
  const uint16_t* x;       // [M, K] bf16, row stride x_stride elements
  long long x_stride;
  const int* ids;          // [M, topk]
  const float* wts;        // [M, topk]
  const uint16_t* up;      // [E, 2F, K] bf16: gate rows, then up rows
  const uint16_t* down;    // [E, K, F] bf16
  float* h;                // [M * topk, F] scratch
  uint16_t* y;             // [M, K] bf16
  int M, K, F, E, topk;
};

// The launch's slots grouped by expert, experts ascending, slots in order
// within one: group g is expert gexp[g], slots order[gstart[g] .. gstart[g + 1]).
struct Groups {
  int order[kMaxSlots];
  int ids[kMaxSlots];
  int gexp[kMaxExperts];
  int gstart[kMaxExperts + 1];
  int n;
};

template <bool kOne>
__device__ void group_slots(const ExpertArgs& a, Groups& g) {
  const int S = a.M * a.topk;
  for (int s = threadIdx.x; s < S; s += kThreads)
    g.ids[s] = min(max(a.ids[s], 0), a.E - 1);
  __syncthreads();
  if (threadIdx.x == 0) {
    if (kOne) {  // one token: its k distinct experts, sorted
      for (int s = 0; s < S; ++s) g.order[s] = s;
      for (int i = 1; i < S; ++i) {
        const int v = g.order[i];
        int j = i;
        while (j > 0 && g.ids[g.order[j - 1]] > g.ids[v]) {
          g.order[j] = g.order[j - 1];
          --j;
        }
        g.order[j] = v;
      }
      int n = 0;
      for (int i = 0; i < S; ++i) {
        if (i == 0 || g.ids[g.order[i]] != g.ids[g.order[i - 1]]) {
          g.gexp[n] = g.ids[g.order[i]];
          g.gstart[n] = i;
          ++n;
        }
      }
      g.gstart[n] = S;
      g.n = n;
    } else {  // counting sort by expert
      int next[kMaxExperts];
      for (int e = 0; e < a.E; ++e) next[e] = 0;
      for (int s = 0; s < S; ++s) ++next[g.ids[s]];
      int at = 0, n = 0;
      for (int e = 0; e < a.E; ++e) {
        const int c = next[e];
        if (c) {
          g.gexp[n] = e;
          g.gstart[n] = at;
          ++n;
        }
        next[e] = at;
        at += c;
      }
      g.gstart[n] = at;
      g.n = n;
      for (int s = 0; s < S; ++s) g.order[next[g.ids[s]]++] = s;
    }
  }
  __syncthreads();
}

template <bool kOne>
__global__ void __launch_bounds__(kThreads) moe_up_kernel(ExpertArgs a) {
  __shared__ Groups g;
  group_slots<kOne>(a, g);
  constexpr int kB = kOne ? 1 : kSlotBatch;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int f = blockIdx.x * kWarps + warp;
  const int chunks = a.K / kChunk;
  for (int q = 0; q < g.n; ++q) {
    const long long e = g.gexp[q];
    const uint4* wg = reinterpret_cast<const uint4*>(a.up + (e * 2 * a.F + f) * a.K) + lane;
    const uint4* wu = reinterpret_cast<const uint4*>(a.up + (e * 2 * a.F + a.F + f) * a.K) +
                      lane;
    for (int i = g.gstart[q]; i < g.gstart[q + 1]; i += kB) {
      // up to kB slots share each step's weight loads (a shorter last batch
      // repeats its last slot and writes it once)
      const int cnt = min(kB, g.gstart[q + 1] - i);
      int s[kB];
      const uint4* xr[kB];
      float ag[kB], au[kB];
#pragma unroll
      for (int j = 0; j < kB; ++j) {
        s[j] = g.order[i + min(j, cnt - 1)];
        xr[j] = reinterpret_cast<const uint4*>(a.x + (s[j] / a.topk) * a.x_stride) + lane;
        ag[j] = au[j] = 0.f;
      }
#pragma unroll 4
      for (int c = 0; c < chunks; ++c) {
        const uint4 gv = __ldg(wg + 32 * c), uv = __ldg(wu + 32 * c);
#pragma unroll
        for (int j = 0; j < kB; ++j) {
          const uint4 xv = xr[j][32 * c];
          ag[j] = dot8(gv, xv, ag[j]);
          au[j] = dot8(uv, xv, au[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < kB; ++j) {
        const float gs = warp_sum(ag[j]), us = warp_sum(au[j]);
        if (lane == 0 && j < cnt)
          a.h[static_cast<long long>(s[j]) * a.F + f] = gs / (1.f + expf(-gs)) * us;
      }
    }
  }
}

template <bool kOne>
__global__ void __launch_bounds__(kThreads) moe_down_kernel(ExpertArgs a) {
  __shared__ Groups g;
  __shared__ float acc[(kOne ? 1 : kMaxTokens) * kWarps];
  group_slots<kOne>(a, g);
  constexpr int kB = kOne ? 1 : kSlotBatch;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n = blockIdx.x * kWarps + warp;
  const int chunks = a.F / kChunk;
  for (int t = lane; t < a.M; t += 32) acc[t * kWarps + warp] = 0.f;
  __syncwarp();
  for (int q = 0; q < g.n; ++q) {
    const long long e = g.gexp[q];
    const uint4* wr = reinterpret_cast<const uint4*>(a.down + (e * a.K + n) * a.F) + lane;
    for (int i = g.gstart[q]; i < g.gstart[q + 1]; i += kB) {
      const int cnt = min(kB, g.gstart[q + 1] - i);
      int s[kB];
      const float4* hr[kB];
      float d[kB];
#pragma unroll
      for (int j = 0; j < kB; ++j) {
        s[j] = g.order[i + min(j, cnt - 1)];
        hr[j] = reinterpret_cast<const float4*>(a.h + static_cast<long long>(s[j]) * a.F) +
                2 * lane;
        d[j] = 0.f;
      }
#pragma unroll 4
      for (int c = 0; c < chunks; ++c) {
        const uint4 wv = __ldg(wr + 32 * c);
#pragma unroll
        for (int j = 0; j < kB; ++j) d[j] = dot8f(wv, hr[j][64 * c], hr[j][64 * c + 1], d[j]);
      }
#pragma unroll
      for (int j = 0; j < kB; ++j) {
        const float ds = warp_sum(d[j]);
        if (lane == 0 && j < cnt) acc[(s[j] / a.topk) * kWarps + warp] += a.wts[s[j]] * ds;
      }
    }
  }
  __syncwarp();
  for (int t = lane; t < a.M; t += 32)
    a.y[static_cast<long long>(t) * a.K + n] = to_bf16(acc[t * kWarps + warp]);
}

}  // namespace

// The router over M tokens on `stream`: one CTA a token.  x: [M, K] (bf16 when
// x_bf16, else f32), rows x_stride elements apart, 16-byte aligned, K % 4 == 0;
// w: f32 [E, K]; bias: f32 [E] or null; ids / wts: [M, topk]; slots: int64
// [E] or null; valid: bool [M] or null.  Returns a cudaError_t.
extern "C" int pt_moe_route(const void* x, long long x_stride, int x_bf16, const float* w,
                            const float* bias, int* ids, float* wts, unsigned long long* slots,
                            const bool* valid, int M, int K, int E, int topk, int norm,
                            float scale, void* stream) {
  if (M < 1 || K % 4 || x_stride % 4 || E < 1 || E > kMaxExperts || topk < 1 ||
      topk > kMaxTopk || topk > E)
    return static_cast<int>(cudaErrorInvalidValue);
  RouteArgs a{x, x_stride, x_bf16, w, bias, ids, wts, slots, valid, K, E, topk, norm, scale};
  moe_router_kernel<<<M, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The experts of M tokens on `stream`: the up launch (grid F / kWarps) into
// the f32 scratch h [M * topk, F], then the down launch (grid K / kWarps) into
// y [M, K].  x: bf16 [M, K], rows x_stride elements apart (a multiple of 8),
// 16-byte aligned; up: bf16 [E, 2F, K]; down: bf16 [E, K, F]; K and F
// multiples of 256; M <= kMaxTokens and M * topk <= kMaxSlots.  Returns a
// cudaError_t.
extern "C" int pt_moe_experts(const uint16_t* x, long long x_stride, const int* ids,
                              const float* wts, const uint16_t* up, const uint16_t* down, float* h,
                              uint16_t* y, int M, int K, int F, int E, int topk, void* stream) {
  if (M < 1 || M > kMaxTokens || topk < 1 || topk > kMaxTopk || M * topk > kMaxSlots ||
      K % kChunk || F % kChunk || x_stride % 8 || E < 1 || E > kMaxExperts)
    return static_cast<int>(cudaErrorInvalidValue);
  ExpertArgs a{x, x_stride, ids, wts, up, down, h, y, M, K, F, E, topk};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M == 1) {
    moe_up_kernel<true><<<F / kWarps, kThreads, 0, s>>>(a);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    moe_down_kernel<true><<<K / kWarps, kThreads, 0, s>>>(a);
  } else {
    moe_up_kernel<false><<<F / kWarps, kThreads, 0, s>>>(a);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    moe_down_kernel<false><<<K / kWarps, kThreads, 0, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}
