// Weight-only int8 / int4 matrix-vector product for small batches, hand-written
// for Hopper (sm_90a).
//
//   y[m, n] = scale[n] * sum_k x[m, k] * q[n, k]  (+ bias[n])
//
// q is [N, row_bytes]: int8 (row_bytes = K), or uint8 split-half int4
// (row_bytes = K / 2: byte j of a row holds element j in its low nibble and
// element j + K / 2 in its high nibble, each offset by 8).  x is [M, K]
// contiguous, M <= 32; x, scale, bias and y share one type T (float or
// __nv_bfloat16); the sum runs in float32 and the scale is applied once per
// output, after it.
//
// Replaces: XLA's fusion of `QTensor.dequant` into the consuming matmul
// (pocket_tts_tpu/ops/qtensor.py:61-93); no Pallas kernel.  Eager PyTorch has
// no such fusion: dequantizing first would read 1 byte per int8 weight, write a
// 2-byte bf16 copy and read it again, 5x the bytes of the int8 read.
//
// What bounds it on the card: bytes.  At M = 1 the FlowLM backbone's ff1
// (4096 x 1024, int8) is 4.2 MB, 1.25 us at 3.35 TB/s, against 8.4 MFLOP of
// arithmetic; one decode frame's quantized backbone is 69.2 MB in int8 and
// 34.6 MB in int4.
//
// What the design does about it:
//   * One warp per output row.  Each lane owns 16 consecutive bytes of the row
//     in each 512-byte chunk and issues all of its 16-byte loads (up to 8
//     chunks: rows of at most 4096 bytes) before it computes, so a row's whole
//     read is in flight at once; a grid of N / 8 blocks covers every row once.
//   * x is staged in shared memory as float32, one 512-byte chunk of K (both
//     halves of it in int4) for all M rows at a time, permuted so that the
//     lanes' 128-bit reads of one group of 4 weights touch 512 consecutive bytes
//     (no bank conflicts).  Weights are converted in registers (int8, or two
//     nibbles minus 8) and each is applied to the M rows from registers.
//   * One butterfly reduction per row of x; lane m writes y[m, n].
//   * Rows whose length or base address is not a multiple of 16 bytes (odd
//     shapes) are read byte by byte in the same lane layout.
// There is no wgmma: at M = 16 the shared-memory reads of the staged x (4
// bytes per multiply-add) and not the weight bytes set the pace.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarps = 8;  // output rows per block
constexpr int kThreads = kWarps * 32;
constexpr int kChunkBytes = 512;  // q bytes of a row per chunk: 32 lanes x 16
constexpr int kMaxChunks = 8;     // rows of at most 4096 bytes
constexpr int kMaxRows = 32;      // rows of x

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Float index, inside a chunk's staged x row, of the chunk's byte j: lane
// j / 16, byte i = j % 16 of the lane's slice; group i / 4 of all 32 lanes is
// 32 consecutive float4s.
__device__ __forceinline__ int stage_index(int j) {
  const int lane = j >> 4, i = j & 15;
  return ((i >> 2) << 7) + (lane << 2) + (i & 3);
}

template <typename T, int MB, bool PACKED>
__global__ void __launch_bounds__(kThreads)
    qlinear_kernel(const T* __restrict__ x, const uint8_t* __restrict__ q,
                   const T* __restrict__ scale, const T* __restrict__ bias, T* __restrict__ y,
                   int M, int N, int K, int row_bytes, int chunks, int aligned) {
  extern __shared__ float4 smem[];  // [PACKED ? 2 : 1][MB][kChunkBytes] floats
  float* xs = reinterpret_cast<float*>(smem);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n = blockIdx.x * kWarps + warp;
  const bool live = n < N;

  // 1. every 16-byte slice this lane owns in row n, all loads issued at once
  uint4 w[kMaxChunks];
  const uint8_t* row = q + static_cast<size_t>(live ? n : 0) * row_bytes;
#pragma unroll
  for (int c = 0; c < kMaxChunks; ++c) {
    w[c] = make_uint4(0u, 0u, 0u, 0u);
    const int off = c * kChunkBytes + lane * 16;
    if (c < chunks && live && off < row_bytes) {
      if (aligned) {  // row_bytes % 16 == 0: the slice lies wholly in the row
        w[c] = __ldg(reinterpret_cast<const uint4*>(row + off));
      } else {
        uint32_t words[4] = {0u, 0u, 0u, 0u};
#pragma unroll
        for (int i = 0; i < 16; ++i)
          if (off + i < row_bytes) words[i >> 2] |= static_cast<uint32_t>(row[off + i]) << (8 * (i & 3));
        w[c] = make_uint4(words[0], words[1], words[2], words[3]);
      }
    }
  }

  float acc[MB];
#pragma unroll
  for (int m = 0; m < MB; ++m) acc[m] = 0.f;

#pragma unroll
  for (int c = 0; c < kMaxChunks; ++c) {
    if (c >= chunks) break;  // uniform over the block
    // 2. stage x for this chunk (zero past the row and past M)
    __syncthreads();
    const int base = c * kChunkBytes;
    for (int t = threadIdx.x; t < MB * kChunkBytes; t += kThreads) {
      const int m = t / kChunkBytes, j = t % kChunkBytes, jj = base + j;
      float lo = 0.f, hi = 0.f;
      if (m < M && jj < row_bytes) {
        const T* xr = x + static_cast<size_t>(m) * K;
        lo = to_f32(xr[jj]);
        if (PACKED) hi = to_f32(xr[row_bytes + jj]);
      }
      xs[m * kChunkBytes + stage_index(j)] = lo;
      if (PACKED) xs[(MB + m) * kChunkBytes + stage_index(j)] = hi;
    }
    __syncthreads();
    if (!live) continue;

    // 3. convert this lane's 16 bytes, apply them to the MB staged rows
    const uint32_t words[4] = {w[c].x, w[c].y, w[c].z, w[c].w};
    float wl[16], wh[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const uint32_t b = (words[i >> 2] >> (8 * (i & 3))) & 0xFFu;
      if (PACKED) {
        wl[i] = static_cast<float>(static_cast<int>(b & 0xFu) - 8);
        wh[i] = static_cast<float>(static_cast<int>(b >> 4) - 8);
      } else {
        wl[i] = static_cast<float>(static_cast<int8_t>(b));
        wh[i] = 0.f;
      }
    }
    const float4* xs4 = reinterpret_cast<const float4*>(xs);
#pragma unroll
    for (int m = 0; m < MB; ++m) {
      float a = acc[m];
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        const float4 v = xs4[m * (kChunkBytes / 4) + g * 32 + lane];
        a = fmaf(v.x, wl[4 * g], a);
        a = fmaf(v.y, wl[4 * g + 1], a);
        a = fmaf(v.z, wl[4 * g + 2], a);
        a = fmaf(v.w, wl[4 * g + 3], a);
        if (PACKED) {
          const float4 h = xs4[(MB + m) * (kChunkBytes / 4) + g * 32 + lane];
          a = fmaf(h.x, wh[4 * g], a);
          a = fmaf(h.y, wh[4 * g + 1], a);
          a = fmaf(h.z, wh[4 * g + 2], a);
          a = fmaf(h.w, wh[4 * g + 3], a);
        }
      }
      acc[m] = a;
    }
  }
  if (!live) return;

  // 4. one butterfly per row of x; lane m writes y[m, n]
  float mine = 0.f;
#pragma unroll
  for (int m = 0; m < MB; ++m) {
    float a = acc[m];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) a += __shfl_xor_sync(0xffffffffu, a, off);
    if (m == lane) mine = a;
  }
  if (lane < M) {
    float r = mine * to_f32(scale[n]);
    if (bias != nullptr) r += to_f32(bias[n]);
    y[static_cast<size_t>(lane) * N + n] = from_f32<T>(r);
  }
}

template <typename T, int MB, bool PACKED>
int launch(const void* x, const void* q, const void* scale, const void* bias, void* y, int M,
           int N, int K, int row_bytes, int aligned, cudaStream_t stream) {
  const int smem = (PACKED ? 2 : 1) * MB * kChunkBytes * static_cast<int>(sizeof(float));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        qlinear_kernel<T, MB, PACKED>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int chunks = (row_bytes + kChunkBytes - 1) / kChunkBytes;
  qlinear_kernel<T, MB, PACKED><<<(N + kWarps - 1) / kWarps, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const uint8_t*>(q), static_cast<const T*>(scale),
      static_cast<const T*>(bias), static_cast<T*>(y), M, N, K, row_bytes, chunks, aligned);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool PACKED>
int dispatch_rows(const void* x, const void* q, const void* scale, const void* bias, void* y,
                  int M, int N, int K, int row_bytes, int aligned, cudaStream_t s) {
  if (M <= 1) return launch<T, 1, PACKED>(x, q, scale, bias, y, M, N, K, row_bytes, aligned, s);
  if (M <= 2) return launch<T, 2, PACKED>(x, q, scale, bias, y, M, N, K, row_bytes, aligned, s);
  if (M <= 4) return launch<T, 4, PACKED>(x, q, scale, bias, y, M, N, K, row_bytes, aligned, s);
  if (M <= 8) return launch<T, 8, PACKED>(x, q, scale, bias, y, M, N, K, row_bytes, aligned, s);
  if (M <= 16) return launch<T, 16, PACKED>(x, q, scale, bias, y, M, N, K, row_bytes, aligned, s);
  return launch<T, 32, PACKED>(x, q, scale, bias, y, M, N, K, row_bytes, aligned, s);
}

}  // namespace

// y [M, N] = scale * (x [M, K] @ q^T) (+ bias), on `stream`.  q [N, row_bytes]
// int8 (packed = 0, row_bytes = K) or split-half int4 (packed = 1, row_bytes =
// K / 2); x, scale [N], bias [N] (or null) and y are bfloat16 (is_bf16 = 1) or
// float32, contiguous.  aligned = 1 promises q's base and row_bytes are
// multiples of 16.  1 <= M <= 32, 1 <= row_bytes <= 4096.  Returns a
// cudaError_t.
extern "C" int pt_qlinear(const void* x, const void* q, const void* scale, const void* bias,
                          void* y, int M, int N, int K, int row_bytes, int packed, int is_bf16,
                          int aligned, void* stream_ptr) {
  if (M < 1 || M > kMaxRows || N < 1 || row_bytes < 1 ||
      row_bytes > kMaxChunks * kChunkBytes || K != (packed ? 2 : 1) * row_bytes)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream_ptr);
  if (is_bf16) {
    return packed ? dispatch_rows<__nv_bfloat16, true>(x, q, scale, bias, y, M, N, K, row_bytes,
                                                       aligned, s)
                  : dispatch_rows<__nv_bfloat16, false>(x, q, scale, bias, y, M, N, K,
                                                        row_bytes, aligned, s);
  }
  return packed ? dispatch_rows<float, true>(x, q, scale, bias, y, M, N, K, row_bytes, aligned, s)
                : dispatch_rows<float, false>(x, q, scale, bias, y, M, N, K, row_bytes, aligned,
                                              s);
}
