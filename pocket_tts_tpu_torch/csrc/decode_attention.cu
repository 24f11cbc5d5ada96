// Decode attention of the FlowLM backbone over its KV cache, hand-written for
// Hopper (sm_90a): one query position per batch lane against the cache's live
// positions, read at storage width.
//
//   n_b      = min(pos[b] + 1, S)             (the query sits at pos[b])
//   logit_j  = (q[b, h] . k[b, j, h]) / sqrt(D),  j < n_b, f32 sums of exact products
//   p_j      = softmax_j(logit_j), in f32, rounded to q's type
//   out[b,h] = round_to(q's type, sum_j p_j v[b, j, h]), f32 accumulation
//
// q [B, 1, H, D] is bfloat16 or float32 (its batch and head strides given, D
// contiguous); the caches [B, S, H, D] (a batch stride given, [S, H, D]
// contiguous) are float32, bfloat16, float8_e4m3fn or float8_e5m2, the fp8
// ones passed as their raw bytes.  A cache of another type than q is widened
// as the plain version widens it: fp8 and bf16 exactly to f32, an f32 cache
// under a bf16 q first rounded to bf16 (the plain version casts K/V to q's
// type).  pos [B] is int32 or int64 on the device, read by each CTA: no host
// wait, so the launch can be captured in a CUDA graph.
//
// Replaces: XLA's fusion of the K/V convert into the attention dot
// (pocket_tts_tpu/ops/attention.py:28-48, reached from causal_cache_attention
// at :82-100); no Pallas kernel.  Eager PyTorch has no such fusion: the plain
// route widens the whole max_seq cache to f32 (a write and a read of 2-4x its
// bytes), masks the dead tail and runs two f32 einsums, ~15 launches a layer.
//
// What bounds it on the card: bytes, the K and V rows up to pos.  At B = 16,
// H = 16, D = 64, bf16, a mean n of 512 is 33.6 MB a layer: 10 us at 3.35
// TB/s; at B = 1 the same is 2.1 MB, 0.6 us, and latency rules.  The design
// reads only those bytes, once, at storage width:
//   * One CTA of 8 warps per (b, h).  D * element bytes / 16 lanes share a
//     key (a 16-byte load each: 8 lanes for a bf16 row of 64, 4 for fp8);
//     a warp covers 32 / that many keys at a time, 8 loads in flight a lane.
//   * Logits to shared memory (S <= 8192 positions, 32 KB), then a block max
//     and a block sum of exp(logit - max), each thread over a fixed stride of
//     keys, the warps combined in order; p = e / sum, rounded to bf16 with
//     __float2bfloat16_rn under a bf16 q.
//   * The V pass accumulates each lane's 16-byte slice of D over its keys in
//     order, a butterfly over the warp's key segments, the 8 warps' partial
//     rows summed in order through shared memory.
//   * Every sum's order depends on (n_b, S, D, the cache type) alone, never
//     on B: a lane alone and the same lane inside a batch are bit-identical.
// Left for later: positions split across a cluster at B = 1 (16 CTAs on 132
// SMs), a TMA ring for the K/V rows, several heads per CTA.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kUnroll = 8;           // 16-byte loads in flight a lane
constexpr int kMaxPositions = 8192;  // logits in shared memory: 32 KB
constexpr int kMaxDim = 256;

enum Kind { kF32 = 0, kBf16 = 1, kE4m3 = 2, kE5m2 = 3 };

template <int KV>
__host__ __device__ constexpr int element_bytes() {
  return KV == kF32 ? 4 : KV == kBf16 ? 2 : 1;
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// Two fp8 values (the low 16 bits of w) -> f32, exact (every fp8 value is a
// half value).
template <int KV>
__device__ __forceinline__ float2 fp8x2_to_float2(uint32_t w) {
  const __half2_raw h = __nv_cvt_fp8x2_to_halfraw2(
      static_cast<__nv_fp8x2_storage_t>(w & 0xFFFFu), KV == kE4m3 ? __NV_E4M3 : __NV_E5M2);
  __half2 hh;
  hh = h;
  return __half22float2(hh);
}

// 16 bytes of a K or V row -> 16 / element bytes floats.  ROUND: an f32 cache
// under a bf16 q, rounded to bf16 as the plain version's cast does.
template <int KV, bool ROUND>
__device__ __forceinline__ void widen(const uint4& w, float* f) {
  const uint32_t words[4] = {w.x, w.y, w.z, w.w};
  if constexpr (KV == kF32) {
#pragma unroll
    for (int i = 0; i < 4; ++i) f[i] = ROUND ? round_bf16(__uint_as_float(words[i]))
                                             : __uint_as_float(words[i]);
  } else if constexpr (KV == kBf16) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(words[i] << 16);
      f[2 * i + 1] = __uint_as_float(words[i] & 0xFFFF0000u);
    }
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 lo = fp8x2_to_float2<KV>(words[i]);
      const float2 hi = fp8x2_to_float2<KV>(words[i] >> 16);
      f[4 * i] = lo.x;
      f[4 * i + 1] = lo.y;
      f[4 * i + 2] = hi.x;
      f[4 * i + 3] = hi.y;
    }
  }
}

__device__ __forceinline__ uint4 load16(const uint8_t* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// Grid: B * H CTAs, CTA b * H + h.  Lane (seg, l), seg = lane / lpk, l = lane
// % lpk, of warp w holds bytes [16 l, 16 l + 16) of the row of key
// j = j0 + u * kps + w * kpw + seg (lpk lanes a key and kpw = 32 / lpk keys a
// warp, as kernels/decode_attention.py launch_plan gives them; kps = kWarps
// kpw a block step, j0 over passes of kUnroll steps).
template <typename QT, int KV>
__global__ void __launch_bounds__(kThreads)
    decode_attention_kernel(const QT* __restrict__ q, const uint8_t* __restrict__ kc,
                            const uint8_t* __restrict__ vc, const void* __restrict__ pos,
                            int pos64, QT* __restrict__ out, int S, int H, int D,
                            long long q_sb, long long q_sh, long long kv_sb, int lpk, int kpw,
                            float scale) {
  constexpr int kEs = element_bytes<KV>();
  constexpr int kVpl = 16 / kEs;  // values of a 16-byte slice
  constexpr bool kRound = sizeof(QT) == 2 && KV == kF32;
  constexpr bool kRoundP = sizeof(QT) == 2;
  extern __shared__ float smem[];
  float* logit = smem;                 // [S]
  float* part = smem + S;              // [kWarps][D]
  float* red = part + kWarps * D;      // [kWarps] maxima
  float* red2 = red + kWarps;          // [kWarps] sums

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const long long p = pos64 ? static_cast<const long long*>(pos)[b]
                            : static_cast<long long>(static_cast<const int*>(pos)[b]);
  // a cursor is never negative; one key keeps the softmax finite if it were
  const int n = p < 0 ? 1 : (p >= S ? S : static_cast<int>(p) + 1);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int kps = kWarps * kpw;
  const int seg = lane / lpk, l = lane % lpk;

  float qv[kVpl];
  const QT* qp = q + b * q_sb + h * q_sh + l * kVpl;
#pragma unroll
  for (int i = 0; i < kVpl; ++i) qv[i] = to_float(qp[i]);

  const size_t row = static_cast<size_t>(H) * D * kEs;  // bytes from one position to the next
  const size_t base = (static_cast<size_t>(b) * kv_sb + static_cast<size_t>(h) * D) * kEs + l * 16;
  const uint8_t* kb = kc + base;
  const uint8_t* vb = vc + base;

  // 1. logits of keys j < n
  for (int j0 = 0; j0 < n; j0 += kUnroll * kps) {
    uint4 w[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = j0 + u * kps + warp * kpw + seg;
      w[u] = j < n ? load16(kb + j * row) : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float f[kVpl];
      widen<KV, kRound>(w[u], f);
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < kVpl; ++i) s = fmaf(qv[i], f[i], s);
      for (int off = lpk >> 1; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
      const int j = j0 + u * kps + warp * kpw + seg;
      if (l == 0 && j < n) logit[j] = s * scale;
    }
  }
  __syncthreads();

  // 2. block max, then the block sum of exp(logit - max) in a fixed order
  float mx = __int_as_float(0xff800000);  // -inf
  for (int j = threadIdx.x; j < n; j += kThreads) mx = fmaxf(mx, logit[j]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  if (lane == 0) red[warp] = mx;
  __syncthreads();
  mx = red[0];
#pragma unroll
  for (int i = 1; i < kWarps; ++i) mx = fmaxf(mx, red[i]);
  float sum = 0.f;
  for (int j = threadIdx.x; j < n; j += kThreads) {
    const float e = expf(logit[j] - mx);
    logit[j] = e;
    sum += e;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (lane == 0) red2[warp] = sum;
  __syncthreads();
  float total = red2[0];
#pragma unroll
  for (int i = 1; i < kWarps; ++i) total += red2[i];

  // 3. sum_j p_j v_j: each lane over its keys in order
  float acc[kVpl];
#pragma unroll
  for (int i = 0; i < kVpl; ++i) acc[i] = 0.f;
  for (int j0 = 0; j0 < n; j0 += kUnroll * kps) {
    uint4 w[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = j0 + u * kps + warp * kpw + seg;
      w[u] = j < n ? load16(vb + j * row) : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = j0 + u * kps + warp * kpw + seg;
      if (j < n) {
        float pj = logit[j] / total;
        if (kRoundP) pj = round_bf16(pj);
        float f[kVpl];
        widen<KV, kRound>(w[u], f);
#pragma unroll
        for (int i = 0; i < kVpl; ++i) acc[i] = fmaf(pj, f[i], acc[i]);
      }
    }
  }
  // the warp's key segments, then the warps in order
  for (int off = lpk; off < 32; off <<= 1) {
#pragma unroll
    for (int i = 0; i < kVpl; ++i) acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], off);
  }
  if (seg == 0) {
#pragma unroll
    for (int i = 0; i < kVpl; ++i) part[warp * D + l * kVpl + i] = acc[i];
  }
  __syncthreads();
  QT* o = out + (static_cast<size_t>(b) * H + h) * D;
  for (int d = threadIdx.x; d < D; d += kThreads) {
    float v = part[d];
#pragma unroll
    for (int i = 1; i < kWarps; ++i) v += part[i * D + d];
    store(o + d, v);
  }
}

struct Launch {
  const void *q, *k, *v, *pos;
  int pos64;
  void* out;
  int B, S, H, D;
  long long q_sb, q_sh, kv_sb;
  int lpk, kpw, smem;
  float scale;
  cudaStream_t stream;
};

template <typename QT, int KV>
int launch(const Launch& a) {
  decode_attention_kernel<QT, KV><<<a.B * a.H, kThreads, a.smem, a.stream>>>(
      static_cast<const QT*>(a.q), static_cast<const uint8_t*>(a.k),
      static_cast<const uint8_t*>(a.v), a.pos, a.pos64, static_cast<QT*>(a.out), a.S, a.H, a.D,
      a.q_sb, a.q_sh, a.kv_sb, a.lpk, a.kpw, a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename QT>
int dispatch(int kv_kind, const Launch& a) {
  switch (kv_kind) {
    case kF32:
      return launch<QT, kF32>(a);
    case kBf16:
      return launch<QT, kBf16>(a);
    case kE4m3:
      return launch<QT, kE4m3>(a);
    case kE5m2:
      return launch<QT, kE5m2>(a);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// out [B, 1, H, D] (contiguous, q's type) = attention of q against the first
// min(pos[b] + 1, S) positions of the caches, on `stream`, launched as
// kernels/decode_attention.py launch_plan says: lpk lanes a key, kpw keys a
// warp, smem bytes of dynamic shared memory.  q_kind: 0 float32, 1 bfloat16;
// kv_kind: 0 float32, 1 bfloat16, 2 float8_e4m3fn, 3 float8_e5m2.  Strides
// in elements: q_sb, q_sh of q (D contiguous); kv_sb of both caches ([S, H,
// D] contiguous).  pos64 = 1 for int64 pos, 0 for int32.  lpk 16-byte slices
// must make a row (a power of two up to 32), D <= 256, 1 <= S <= 8192, smem
// hold the logits, the warps' rows and the reductions within 48 KB; the
// caches' base and batch stride 16-byte aligned.  Returns a cudaError_t.
extern "C" int pt_decode_attention(const void* q, const void* k, const void* v, const void* pos,
                                   int pos64, void* out, int B, int S, int H, int D,
                                   long long q_sb, long long q_sh, long long kv_sb, int q_kind,
                                   int kv_kind, int lpk, int kpw, int smem, float scale,
                                   void* stream_ptr) {
  const int es = kv_kind == kF32 ? 4 : kv_kind == kBf16 ? 2 : 1;
  const long long need = (static_cast<long long>(S) + kWarps * D + 2 * kWarps) * sizeof(float);
  if (B < 1 || H < 1 || S < 1 || S > kMaxPositions || D < 1 || D > kMaxDim ||
      lpk < 1 || lpk > 32 || (lpk & (lpk - 1)) != 0 || lpk * 16 != D * es || kpw * lpk != 32 ||
      smem < need || smem > 48 * 1024 || kv_kind < 0 || kv_kind > kE5m2 ||
      (q_kind != 0 && q_kind != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const Launch a{q, k, v, pos, pos64, out, B, S, H, D, q_sb, q_sh, kv_sb,
                 lpk, kpw, smem, scale, static_cast<cudaStream_t>(stream_ptr)};
  return q_kind == 1 ? dispatch<__nv_bfloat16>(kv_kind, a) : dispatch<float>(kv_kind, a);
}
