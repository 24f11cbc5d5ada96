// Flow block chain of the SimpleMLPAdaLN flow net, hand-written for Hopper (sm_90a).
//
// Replaces: the Pallas TPU kernel `flow_blocks` (body `_kernel`, wrapper
// `flow_step_pallas`) in pocket_tts_tpu/ops/pallas/flow_kernel.py.  For each of
// `depth` AdaLN ResBlocks:
//   mod = silu(y) @ ada_w^T + ada_b            -> shift | scale | gate
//   z   = LN_f32(h; ln_w, ln_b, eps=1e-6) * (1 + scale) + shift
//   z   = silu(z @ mlp1^T + b1) @ mlp2^T + b2
//   h   = h + gate * z
// All in float32 with float32 accumulation.
//
// What bounds it on the card: at flagship size (dim 512, depth 6) one call
// reads 6 * (1536 + 512 + 512) * 512 * 4 B = 31.5 MB of stacked f32 weights
// and does only ~16 MFLOP at B = 1.  It is bound by weight bytes and by launch
// latency, never by arithmetic; the whole weight set fits in the 50 MB L2.
//
// What the design does about it:
//   * The TPU grid runs its blocks in order on one core and carries h in VMEM.
//     Hopper runs CTAs in parallel and in no order, so the dependent chain is
//     cut into launches on one stream instead: one launch computes every
//     block's modulation at once (silu(y) does not depend on h), then two
//     launches per block, 1 + 2 * depth in all.
//   * Every product is a skinny GEMV: one warp per output row, the row held
//     in registers after coalesced 16-byte loads along the contiguous input
//     dimension, so each weight byte is read once per call and applied to all
//     B rows; float32 FMA accumulation and a warp-shuffle reduction.
//   * The LayerNorm of the B rows of h (at most 1024 f32 each) is recomputed
//     by every CTA of the first launch of a block into shared memory: cheaper
//     than a separate launch, since h is tiny next to the weights.
//   * The second launch of a block updates h in place: each element of h is
//     read and written by exactly one lane.
// A single persistent cooperative launch, bf16 weights and wgmma are later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// The C entry returns cudaGetLastError() after each launch (0 = success).

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;  // warps per CTA, one output row each
constexpr int kThreads = kWarps * 32;
constexpr int kMaxChunks = 8;  // float4 chunks per lane: dim <= 8 * 32 * 4 = 1024

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float silu(float x) { return x / (1.0f + expf(-x)); }

// Row `w` of length dim into registers: lane l holds float4 chunks l + 32 c.
__device__ __forceinline__ void load_row(const float* __restrict__ w, int dim, int lane,
                                         float4 (&r)[kMaxChunks]) {
  const float4* w4 = reinterpret_cast<const float4*>(w);
  const int n4 = dim >> 2;
#pragma unroll
  for (int c = 0; c < kMaxChunks; ++c) {
    const int i = lane + 32 * c;
    r[c] = i < n4 ? __ldg(w4 + i) : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// Full-warp dot product of the register row with x[0:dim]; every lane gets the sum.
__device__ __forceinline__ float dot_row(const float4 (&r)[kMaxChunks], const float* x,
                                         int dim, int lane) {
  const float4* x4 = reinterpret_cast<const float4*>(x);
  const int n4 = dim >> 2;
  float acc = 0.f;
#pragma unroll
  for (int c = 0; c < kMaxChunks; ++c) {
    const int i = lane + 32 * c;
    if (i < n4) {
      const float4 a = x4[i];
      acc = fmaf(r[c].x, a.x, acc);
      acc = fmaf(r[c].y, a.y, acc);
      acc = fmaf(r[c].z, a.z, acc);
      acc = fmaf(r[c].w, a.w, acc);
    }
  }
  return warp_sum(acc);
}

// mod[i, b, j] = sy[b, :] . ada_w[i, j, :] + ada_b[i, j] for every block i at once.
__global__ void __launch_bounds__(kThreads)
    mod_kernel(const float* __restrict__ sy, const float* __restrict__ ada_w,
               const float* __restrict__ ada_b, float* __restrict__ mod, int batch, int dim,
               int rows) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;  // whole warp leaves together
  const int three_dim = 3 * dim;
  const int blk = row / three_dim;
  const int j = row - blk * three_dim;
  float4 w[kMaxChunks];
  load_row(ada_w + static_cast<size_t>(row) * dim, dim, lane, w);
  const float bias = ada_b[row];
  for (int b = 0; b < batch; ++b) {
    const float acc = dot_row(w, sy + static_cast<size_t>(b) * dim, dim, lane);
    if (lane == 0) mod[(static_cast<size_t>(blk) * batch + b) * three_dim + j] = acc + bias;
  }
}

// u[b, r] = silu(z[b, :] . mlp1_w[r, :] + mlp1_b[r]) with
// z = LN(h) * (1 + scale) + shift, rebuilt by each CTA in shared memory.
__global__ void __launch_bounds__(kThreads)
    mlp1_kernel(const float* h, const float* __restrict__ mod_i, const float* __restrict__ ln_w,
                const float* __restrict__ ln_b, const float* __restrict__ w1,
                const float* __restrict__ b1, float* __restrict__ u, int batch, int dim) {
  extern __shared__ float4 smem4[];
  float* z = reinterpret_cast<float*>(smem4);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row = blockIdx.x * kWarps + warp;
  const bool active = row < dim;
  float4 w[kMaxChunks];
  if (active) load_row(w1 + static_cast<size_t>(row) * dim, dim, lane, w);  // in flight during LN

  const float inv_dim = 1.0f / static_cast<float>(dim);
  for (int b = warp; b < batch; b += kWarps) {
    const float* hb = h + static_cast<size_t>(b) * dim;
    float s = 0.f;
    for (int k = lane; k < dim; k += 32) s += hb[k];
    const float mean = warp_sum(s) * inv_dim;
    float v = 0.f;
    for (int k = lane; k < dim; k += 32) {
      const float d = hb[k] - mean;
      v = fmaf(d, d, v);
    }
    const float rstd = 1.0f / sqrtf(warp_sum(v) * inv_dim + 1e-6f);
    const float* shift = mod_i + static_cast<size_t>(b) * 3 * dim;
    const float* scale = shift + dim;
    for (int k = lane; k < dim; k += 32) {
      const float y = (hb[k] - mean) * rstd * ln_w[k] + ln_b[k];
      z[b * dim + k] = y * (1.0f + scale[k]) + shift[k];
    }
  }
  __syncthreads();
  if (!active) return;
  const float bias = b1[row];
  for (int b = 0; b < batch; ++b) {
    const float acc = dot_row(w, z + b * dim, dim, lane) + bias;
    if (lane == 0) u[static_cast<size_t>(b) * dim + row] = silu(acc);
  }
}

// h_out[b, r] = h_in[b, r] + gate[b, r] * (u[b, :] . mlp2_w[r, :] + mlp2_b[r]).
// h_in and h_out may alias (in-place update): one lane owns each element.
__global__ void __launch_bounds__(kThreads)
    mlp2_kernel(const float* h_in, const float* __restrict__ mod_i, const float* __restrict__ u,
                const float* __restrict__ w2, const float* __restrict__ b2, float* h_out,
                int batch, int dim) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= dim) return;
  float4 w[kMaxChunks];
  load_row(w2 + static_cast<size_t>(row) * dim, dim, lane, w);
  const float bias = b2[row];
  for (int b = 0; b < batch; ++b) {
    const float acc = dot_row(w, u + static_cast<size_t>(b) * dim, dim, lane) + bias;
    if (lane == 0) {
      const size_t o = static_cast<size_t>(b) * dim + row;
      const float gate = mod_i[static_cast<size_t>(b) * 3 * dim + 2 * dim + row];
      h_out[o] = h_in[o] + gate * acc;
    }
  }
}

}  // namespace

// Runs the whole chain on `stream`.  Shapes (all f32, contiguous, 16-byte aligned):
// sy, h0, out, u [batch, dim]; mod [depth, batch, 3 dim]; ada_w [depth, 3 dim, dim];
// ada_b [depth, 3 dim]; ln_w, ln_b, mlp1_b, mlp2_b [depth, dim];
// mlp1_w, mlp2_w [depth, dim, dim].  Requires dim % 4 == 0, dim <= 1024 and
// batch * dim * 4 bytes of shared memory per CTA.  Returns a cudaError_t.
extern "C" int pt_flow_blocks_f32(const float* sy, const float* h0, const float* ada_w,
                                  const float* ada_b, const float* ln_w, const float* ln_b,
                                  const float* mlp1_w, const float* mlp1_b, const float* mlp2_w,
                                  const float* mlp2_b, float* mod, float* u, float* out,
                                  int batch, int dim, int depth, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int rows = depth * 3 * dim;
  mod_kernel<<<(rows + kWarps - 1) / kWarps, kThreads, 0, stream>>>(sy, ada_w, ada_b, mod,
                                                                     batch, dim, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const size_t smem = static_cast<size_t>(batch) * dim * sizeof(float);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(mlp1_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int grid = (dim + kWarps - 1) / kWarps;
  const size_t dd = static_cast<size_t>(dim) * dim;
  for (int i = 0; i < depth; ++i) {
    const float* h_in = i == 0 ? h0 : out;
    const float* mod_i = mod + static_cast<size_t>(i) * batch * 3 * dim;
    mlp1_kernel<<<grid, kThreads, smem, stream>>>(h_in, mod_i, ln_w + i * dim, ln_b + i * dim,
                                                  mlp1_w + i * dd, mlp1_b + i * dim, u, batch,
                                                  dim);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    mlp2_kernel<<<grid, kThreads, 0, stream>>>(h_in, mod_i, u, mlp2_w + i * dd,
                                               mlp2_b + i * dim, out, batch, dim);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}
