// Weight-only int8 / int4 matrix products for small batches, hand-written for
// Hopper (sm_90a).
//
//   y[m, n] = scale[n] * sum_k x[m, k] * q[n, k]  (+ bias[n])
//
// q is [N, row_bytes]: int8 (row_bytes = K), or uint8 split-half int4
// (row_bytes = K / 2: byte j of a row holds element j in its low nibble and
// element j + K / 2 in its high nibble, each offset by 8).  x is [M, K]
// contiguous, M <= 32; x, scale, bias and y share one type; the sum runs in
// float32 and the scale is applied once per output, after it.
//
// Replaces: XLA's fusion of `QTensor.dequant` into the consuming matmul
// (pocket_tts_tpu/ops/qtensor.py:61-93); no Pallas kernel.  Eager PyTorch has
// no such fusion: dequantizing first would read 1 byte per int8 weight, write a
// 2-byte bf16 copy and read it again, 5x the bytes of the int8 read.
//
// What bounds it on the card: bytes.  At M = 1 the FlowLM backbone's ff1
// (4096 x 1024, int8) is 4.2 MB, 1.25 us at 3.35 TB/s, against 8.4 MFLOP of
// arithmetic (268 MFLOP at M = 32: still 0.27 us on the bf16 tensor cores).
//
// Two routes, chosen by the type of x:
//
// bf16 x (the backbone: every decode frame's 18 backbone products, the input
// linear) -- `qlinear_mma_kernel`, on the tensor cores.
//   * Operands swapped: y^T = W x^T, so the weight rows are the MMA's M (16)
//     and the <= 32 rows of x its N, in tiles of 8.  The instruction is
//     `mma.sync.m16n8k16` bf16 -> f32 with A from registers: `wgmma` wants a
//     64-row warpgroup tile and 8-column steps too, and its register-A form
//     needs the same in-register conversion; at these sizes the product is
//     ~1% of the time and the weight stream is the rest, so the simpler
//     per-warp instruction loses nothing and keeps every warp independent.
//   * K is permuted inside each 64-byte chunk of a row so that a lane's one
//     16-byte load of weight row r IS its A fragments for four MMAs: lane
//     (g = lane / 4, t = lane % 4) loads bytes [16 t, 16 t + 16) of rows g
//     and g + 8; byte 16 t + 4 s + e feeds MMA s at k slot 2 t + e (e < 2)
//     or 2 t + 8 + (e - 2).  Its B fragments for the same four MMAs are then
//     x[m, 16 t .. 16 t + 15] of the chunk, natural order: two 16-byte shared
//     loads (the same count ldmatrix.x4 would take, without permuting x).
//     Int4: the low nibbles of the 16 bytes are the A fragments against the
//     first half of x, the high nibbles against the second half (K / 2 on).
//   * Conversion in registers, exact (|q| <= 127): int8 through the f32
//     magic number 2^23 (byte_perm, one subtract, the top halves packed),
//     int4 by or-ing each nibble into the mantissa of the bf16 128 and one
//     bf16x2 subtract of 136.
//   * x is staged once per CTA in shared memory as bf16, rows padded by 16
//     bytes (the 8 lanes of a load phase hit distinct banks), zero past M and
//     past K.  Each CTA stages only its own K range.
//   * Every weight load of a warp (up to 4 chunks x 2 rows = 8 x 16 bytes a
//     lane, 32 KB a CTA) is issued first, then the scale and bias of the row
//     the thread will finish, then x in batches of 4 loads a thread: the whole
//     matrix is in flight at once on a 128+ CTA grid, and no load waits
//     behind another's latency (a loop that loads once per trip pays one
//     memory latency per trip).
//   * The grid fills the card on every frame shape: a CTA of 8 warps owns RT
//     16-row tiles (warp w: tile w % RT, K slice w / RT of 8 / RT), and K is
//     split further across a thread-block cluster of CS CTAs (<= 8, the
//     portable limit).  Every warp pushes its partial sums straight into the
//     shared memory of the CTA that finishes those rows (distributed shared
//     memory stores, one cluster barrier), which adds the slices in a fixed
//     order (cluster rank 0 first, then K slice 0 first): deterministic, one
//     launch, no workspace, no atomics, no remote loads.  A plan with one
//     CTA per cluster launches without the cluster attribute, which costs
//     launch time and changes nothing for one CTA.  The tiling, split and order come
//     from (N, K, format) alone (kernels/qlinear.py launch_plan), never from
//     M, so a lane's y is bit-identical alone and inside a batch.
//   * The scale (and bias) is applied once, after the f32 sum.
//
// f32 x (the flow net's 3 quantized linears, the codec, the f32 reference
// model) -- `qlinear_f32_kernel`, on the CUDA cores.  These products are at
// most 0.5 MFLOP at the flow net's shapes and their byte bounds 0.003-0.25
// us: latency, not arithmetic, so the design spreads short rows over lanes
// and SMs and keeps every load in flight at once.
//   * A row takes the lanes its bytes need (lpr, a power of two up to 32, 16
//     bytes each): a warp holds 32 / lpr rows, reduced by a segmented
//     butterfly over the row's lanes (in_w's 16- and 32-byte rows: 32 rows
//     a warp, where one warp per row left 31 or 30 of 32 lanes idle).
//   * K is split across the warps of a CTA (kw slices, step c * kw + ks of
//     the row to slice ks) when N is small, so final_w's 32 rows spread over
//     8 CTAs; the slices are added in order through shared memory.
//   * CTAs of 4 or 8 warps, as many as reach ~128 CTAs with the fewest CTAs
//     past that (each stages x), then the fewest slices a lane, then the most
//     rows a warp.  On a grid under 64 CTAs a CTA takes at most 4 rows of x
//     and grid.y the rest: at M = 16 the flow net's small products run on 4x
//     the CTAs, each with a quarter of the staging and of the sums.
//   * x is staged once per CTA over K only, in tiles of at most 1024
//     elements a row, with float4 loads (8 in flight a thread), permuted so
//     the lanes' 128-bit reads are conflict-free and the rows of a warp read
//     the same addresses (a broadcast).
//   * The plan depends on (N, K, format) alone (kernels/qlinear.py
//     launch_plan_f32), never on M: a row of x gives the same y, bit for bit,
//     alone and inside M = 16 / 32.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 8;  // warps per block, both routes
constexpr int kThreads = kWarps * 32;
constexpr int kMaxRows = 32;  // rows of x

// -- bf16 route: tensor cores -------------------------------------------------

constexpr int kMmaChunk = 64;     // q bytes of a row per chunk: 4 lanes x 16
constexpr int kMaxChunksWarp = 4;  // chunks a warp loads at once (8 x 16 B a lane)
constexpr int kMaxCluster = 8;     // portable cluster size
constexpr int kMaxXExtent = 2048;  // x elements of a row staged per CTA

// Two signed bytes (b_lo, b_hi of `w`, selected by `sel`) -> bf16x2, exact.
// 0x4B000000 | u is the float 2^23 + u; u = byte ^ 0x80 = byte + 128.
__device__ __forceinline__ uint32_t s8x2_to_bf16x2(uint32_t wx, uint32_t sel_lo, uint32_t sel_hi) {
  const float lo = __uint_as_float(__byte_perm(wx, 0x4B000000u, sel_lo)) - 8388736.f;
  const float hi = __uint_as_float(__byte_perm(wx, 0x4B000000u, sel_hi)) - 8388736.f;
  // |value| <= 128: the low 16 bits of each float are zero, its top half is
  // the bf16 value
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

__device__ __forceinline__ uint32_t bf16x2_sub(uint32_t a, uint32_t b) {
  __nv_bfloat162 va, vb;
  memcpy(&va, &a, 4);
  memcpy(&vb, &b, 4);
  const __nv_bfloat162 r = __hsub2(va, vb);
  uint32_t out;
  memcpy(&out, &r, 4);
  return out;
}

// One 32-bit word of int8 weights (bytes 4s .. 4s + 3 of a lane's slice) ->
// the pair of A registers it feeds: (k slots 2t, 2t+1) and (2t+8, 2t+9).
__device__ __forceinline__ void s8_frag(uint32_t w, uint32_t& p01, uint32_t& p23) {
  const uint32_t wx = w ^ 0x80808080u;
  p01 = s8x2_to_bf16x2(wx, 0x7440u, 0x7441u);
  p23 = s8x2_to_bf16x2(wx, 0x7442u, 0x7443u);
}

// One 32-bit word of packed int4 -> A register pairs of the low nibbles (first
// half of K) and the high nibbles (second half).  0x4300 | n is the bf16
// 128 + n; minus 136 gives n - 8.
__device__ __forceinline__ void s4_frag(uint32_t w, uint32_t& lo01, uint32_t& lo23,
                                        uint32_t& hi01, uint32_t& hi23) {
  const uint32_t t01 = __byte_perm(w, 0u, 0x4140u);  // bytes 0, 1 at bits 0 and 16
  const uint32_t t23 = __byte_perm(w, 0u, 0x4342u);
  const uint32_t k136 = 0x43084308u;
  lo01 = bf16x2_sub((t01 & 0x000F000Fu) | 0x43004300u, k136);
  lo23 = bf16x2_sub((t23 & 0x000F000Fu) | 0x43004300u, k136);
  hi01 = bf16x2_sub(((t01 >> 4) & 0x000F000Fu) | 0x43004300u, k136);
  hi23 = bf16x2_sub(((t23 >> 4) & 0x000F000Fu) | 0x43004300u, k136);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint4 load_slice(const uint8_t* row, int off, int row_bytes,
                                            bool aligned) {
  if (aligned) {  // volatile: issued here, before x is staged, not sunk to its use
    uint4 v;
    asm volatile("ld.global.nc.v4.u32 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
                 : "l"(row + off));
    return v;
  }
  uint32_t words[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int i = 0; i < 16; ++i)
    if (off + i < row_bytes) words[i >> 2] |= static_cast<uint32_t>(row[off + i]) << (8 * (i & 3));
  return make_uint4(words[0], words[1], words[2], words[3]);
}

// Grid: (N tiles / RT) x CS CTAs, clusters of CS along x.  CTA (block b,
// rank r): rows [b * 16 RT, (b + 1) * 16 RT), bytes [r * span, (r + 1) *
// span) of every row, span = (8 / RT) * cpw * 64.  Warp w: tile w % RT, bytes
// [(w / RT) * cpw * 64, ...) of the CTA's span.  MT = tiles of 8 rows of x.
template <int MT, bool PACKED>
__global__ void __launch_bounds__(kThreads)
    qlinear_mma_kernel(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ q,
                       const __nv_bfloat16* __restrict__ scale,
                       const __nv_bfloat16* __restrict__ bias, __nv_bfloat16* __restrict__ y,
                       int M, int N, int K, int row_bytes, int aligned, int xvec, int rt, int cs,
                       int cpw) {
  constexpr int MB = 8 * MT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int kw = kWarps / rt;
  const int span = kw * cpw * kMmaChunk;           // bytes of a row per CTA
  const int extent = span * (PACKED ? 2 : 1);      // x elements per staged row
  const int xs_stride = extent + 8;                // + 16 bytes: no bank conflicts
  const int rows = 16 * rt;                        // output rows per CTA
  const int own = rows / cs;                       // output rows each rank finishes
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  float* recv = reinterpret_cast<float*>(smem_raw + static_cast<size_t>(MB) * xs_stride * 2);
  // recv: [cs * kw][MB][own] the partial sums of this rank's own rows, one
  // slice per (source rank, K slice), written by every warp of the cluster

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());  // K split across the cluster
  const int block = blockIdx.x / cs;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int tile = warp % rt, ks = warp / rt;
  const int b0 = rank * span;  // first byte of the CTA's span
  const int wb0 = b0 + ks * cpw * kMmaChunk;

  // 1. every weight load of this warp, issued at once
  const int r0 = block * rows + tile * 16 + g, r1 = r0 + 8;
  const uint8_t* row0 = q + static_cast<size_t>(r0 < N ? r0 : 0) * row_bytes;
  const uint8_t* row1 = q + static_cast<size_t>(r1 < N ? r1 : 0) * row_bytes;
  uint4 w0[kMaxChunksWarp], w1[kMaxChunksWarp];
#pragma unroll
  for (int c = 0; c < kMaxChunksWarp; ++c) {
    w0[c] = w1[c] = make_uint4(0u, 0u, 0u, 0u);
    const int off = wb0 + c * kMmaChunk + t * 16;
    if (c < cpw && off < row_bytes) {
      if (r0 < N) w0[c] = load_slice(row0, off, row_bytes, aligned);
      if (r1 < N) w1[c] = load_slice(row1, off, row_bytes, aligned);
    }
  }

  // the scale and bias of the one row this thread finishes (own divides
  // kThreads), loaded now so their latency hides under the weights'
  const int lr = threadIdx.x % own;
  const int n_out = block * rows + rank * own + lr;
  float sc = 0.f, bi = 0.f;
  if (n_out < N) {
    sc = __bfloat162float(scale[n_out]);
    if (bias != nullptr) bi = __bfloat162float(bias[n_out]);
  }

  // every CTA of the cluster must be running before another writes its shared
  // memory: arrive now, wait just before the pushes
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");

  // 2. stage x[:, the CTA's K range] as bf16; zero past M and past K
  if (xvec) {  // K (and row_bytes for int4) a multiple of 8, x 16-byte aligned
    const int groups = extent / 8;
    // kBatch loads in flight a thread, then their stores
    constexpr int kBatch = 4;
    for (int i0 = threadIdx.x; i0 < MB * groups; i0 += kBatch * kThreads) {
      uint4 v[kBatch];
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        const int i = i0 + b * kThreads, m = i / groups, kl = (i % groups) * 8;
        const int half = PACKED && kl >= span;
        const int j = b0 + kl - (half ? span : 0);  // byte of the row
        v[b] = make_uint4(0u, 0u, 0u, 0u);
        if (i < MB * groups && m < M && j < row_bytes)
          v[b] = *reinterpret_cast<const uint4*>(x + static_cast<size_t>(m) * K + j +
                                                 (half ? row_bytes : 0));
      }
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        const int i = i0 + b * kThreads;
        if (i < MB * groups)
          *reinterpret_cast<uint4*>(xs + (i / groups) * xs_stride + (i % groups) * 8) = v[b];
      }
    }
  } else {
    for (int i = threadIdx.x; i < MB * extent; i += kThreads) {
      const int m = i / extent, kl = i % extent;
      const int half = PACKED && kl >= span;
      const int j = b0 + kl - (half ? span : 0);
      __nv_bfloat16 v = __float2bfloat16_rn(0.f);
      if (m < M && j < row_bytes) v = x[static_cast<size_t>(m) * K + j + (half ? row_bytes : 0)];
      xs[m * xs_stride + kl] = v;
    }
  }
  __syncthreads();

  // 3. the MMAs: chunk c, sub-step s, x tile j; one K order for every M
  float acc[MT][4];
#pragma unroll
  for (int j = 0; j < MT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll
  for (int c = 0; c < kMaxChunksWarp; ++c) {
    if (c >= cpw || wb0 + c * kMmaChunk >= row_bytes) break;  // uniform over the warp
    const int kl = (ks * cpw + c) * kMmaChunk + t * 16;  // x element of B's first k
    const uint32_t a0w[4] = {w0[c].x, w0[c].y, w0[c].z, w0[c].w};
    const uint32_t a1w[4] = {w1[c].x, w1[c].y, w1[c].z, w1[c].w};
#pragma unroll
    for (int j = 0; j < MT; ++j) {
      const __nv_bfloat16* xr = xs + (8 * j + g) * xs_stride + kl;
      const uint4 xl0 = *reinterpret_cast<const uint4*>(xr);
      const uint4 xl1 = *reinterpret_cast<const uint4*>(xr + 8);
      const uint32_t bl[8] = {xl0.x, xl0.y, xl0.z, xl0.w, xl1.x, xl1.y, xl1.z, xl1.w};
      uint32_t bh[8];
      if (PACKED) {
        const uint4 xh0 = *reinterpret_cast<const uint4*>(xr + span);
        const uint4 xh1 = *reinterpret_cast<const uint4*>(xr + span + 8);
        bh[0] = xh0.x, bh[1] = xh0.y, bh[2] = xh0.z, bh[3] = xh0.w;
        bh[4] = xh1.x, bh[5] = xh1.y, bh[6] = xh1.z, bh[7] = xh1.w;
      }
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        if (PACKED) {
          uint32_t l0, l2, h0, h2, l1, l3, h1, h3;
          s4_frag(a0w[s], l0, l2, h0, h2);  // row g
          s4_frag(a1w[s], l1, l3, h1, h3);  // row g + 8
          mma_bf16(acc[j], l0, l1, l2, l3, bl[2 * s], bl[2 * s + 1]);
          mma_bf16(acc[j], h0, h1, h2, h3, bh[2 * s], bh[2 * s + 1]);
        } else {
          uint32_t p0, p2, p1, p3;
          s8_frag(a0w[s], p0, p2);
          s8_frag(a1w[s], p1, p3);
          mma_bf16(acc[j], p0, p1, p2, p3, bl[2 * s], bl[2 * s + 1]);
        }
      }
    }
  }

  // 4. push the partial sums to the rank that finishes each row, through
  // distributed shared memory: lane (g, t) holds rows g, g + 8 x columns
  // 8j + 2t, 8j + 2t + 1 (only columns < M are sent)
  const int slot = rank * kw + ks;
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = tile * 16 + g + 8 * half;
    float* dst = cluster.map_shared_rank(recv, r / own) +
                 static_cast<size_t>(slot) * MB * own + r % own;
#pragma unroll
    for (int j = 0; j < MT; ++j) {
      const int m = 8 * j + 2 * t;
      if (m < M) dst[m * own] = acc[j][2 * half];
      if (m + 1 < M) dst[(m + 1) * own] = acc[j][2 * half + 1];
    }
  }
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");  // every push visible

  // 5. this rank's rows [rank * own, (rank + 1) * own): the slices summed in
  // order (source rank 0 first, K slice 0 first), scaled, the bias added
  const int slots = cs * kw;
  if (n_out < N) {
    for (int m = threadIdx.x / own; m < M; m += kThreads / own) {
      float v = 0.f;
      for (int q = 0; q < slots; ++q) v += recv[(static_cast<size_t>(q) * MB + m) * own + lr];
      y[static_cast<size_t>(m) * N + n_out] = __float2bfloat16_rn(v * sc + bi);
    }
  }
}

template <int MT, bool PACKED>
int launch_mma(const void* x, const void* q, const void* scale, const void* bias, void* y, int M,
               int N, int K, int row_bytes, int aligned, int xvec, int rt, int cs, int cpw,
               int smem, cudaStream_t stream) {
  static int configured = 48 * 1024;  // dynamic shared memory the kernel is allowed
  auto kernel = qlinear_mma_kernel<MT, PACKED>;
  if (smem > configured) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = smem;
  }
  const int tiles = (N + 15) / 16;
  if (cs == 1) {  // a plain launch: a one-CTA cluster launch costs more and does the same
    kernel<<<(tiles + rt - 1) / rt, kThreads, smem, stream>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(q),
        static_cast<const __nv_bfloat16*>(scale), static_cast<const __nv_bfloat16*>(bias),
        static_cast<__nv_bfloat16*>(y), M, N, K, row_bytes, aligned, xvec, rt, cs, cpw);
    return static_cast<int>(cudaGetLastError());
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>((tiles + rt - 1) / rt * cs));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(cs);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(q),
      static_cast<const __nv_bfloat16*>(scale), static_cast<const __nv_bfloat16*>(bias),
      static_cast<__nv_bfloat16*>(y), M, N, K, row_bytes, aligned, xvec, rt, cs, cpw);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <bool PACKED>
int dispatch_mma(const void* x, const void* q, const void* scale, const void* bias, void* y,
                 int M, int N, int K, int row_bytes, int aligned, int xvec, int rt, int cs,
                 int cpw, int smem, cudaStream_t s) {
  if (M <= 8)
    return launch_mma<1, PACKED>(x, q, scale, bias, y, M, N, K, row_bytes, aligned, xvec, rt, cs,
                                 cpw, smem, s);
  if (M <= 16)
    return launch_mma<2, PACKED>(x, q, scale, bias, y, M, N, K, row_bytes, aligned, xvec, rt, cs,
                                 cpw, smem, s);
  return launch_mma<4, PACKED>(x, q, scale, bias, y, M, N, K, row_bytes, aligned, xvec, rt, cs,
                               cpw, smem, s);
}

// -- f32 route: CUDA cores ----------------------------------------------------

constexpr int kF32MaxChunks = 8;     // 16-byte slices of a row a lane holds
constexpr int kF32MaxExtent = 1024;  // x elements of a staged row per K tile
constexpr int kF32Batch = 8;         // float4 loads of x in flight a thread

// A CTA of `warps` warps: warp w is K slice ks = w % kw of row group rw = w /
// kw; its lanes hold 32 / lpr rows, lpr lanes a row (lane = rg * lpr + l).
// Row slice (16 bytes) s = step * lpr + l; step = c * kw + ks for the lane's
// chunk c < cpl.  x is staged per K tile of tile_chunks chunks (tile_chunks *
// kw steps, tb = that x lpr x 16 bytes of the row): element j of a step's
// lpr * 16 goes to ((j % 16) / 4 * lpr + j / 16) * 4 + j % 4, so that lane l's
// float4 g of the step is float4 g * lpr + l (conflict-free; the rows of a
// warp read the same addresses); int4's high halves (x[:, K/2 + j]) follow at
// + tb.
template <bool PACKED>
__device__ __forceinline__ void stage_x_f32(const float* __restrict__ x, float* xs, int M, int rows,
                                            int K, int row_bytes, int xvec, int lg_lpr, int b0,
                                            int lg_tb) {
  // every extent here is a power of two: the index arithmetic is shifts and
  // masks (a runtime division is a long dependent chain for one warp a
  // scheduler)
  const int tb = 1 << lg_tb, lg_step = lg_lpr + 4;
  const int lg_ext = lg_tb + (PACKED ? 1 : 0);
  auto dest = [&](int e) {  // staged index of tile element e
    const int jl = e & (tb - 1), jj = jl & ((1 << lg_step) - 1);
    return (PACKED ? (e >> lg_tb) << lg_tb : 0) + ((jl >> lg_step) << lg_step) +
           ((((jj & 15) >> 2) << lg_lpr) + (jj >> 4)) * 4 + (jj & 3);
  };
  auto src = [&](int m, int e) {  // index into x, or -1 past the row or past M
    const int j = b0 + (e & (tb - 1));
    return j < row_bytes && m < M ? m * K + j + (PACKED && (e >> lg_tb) ? row_bytes : 0) : -1;
  };
  const int threads = blockDim.x;
  if (xvec) {  // K and row_bytes multiples of 4, x 16-byte aligned
    const int lg_groups = lg_ext - 2, total = rows << lg_groups;
    for (int i0 = threadIdx.x; i0 < total; i0 += kF32Batch * threads) {
      float4 v[kF32Batch];
#pragma unroll
      for (int u = 0; u < kF32Batch; ++u) {
        const int i = i0 + u * threads;
        v[u] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (i < total) {
          const int s = src(i >> lg_groups, (i & ((1 << lg_groups) - 1)) << 2);
          if (s >= 0) v[u] = *reinterpret_cast<const float4*>(x + s);
        }
      }
#pragma unroll
      for (int u = 0; u < kF32Batch; ++u) {
        const int i = i0 + u * threads;
        if (i < total)
          *reinterpret_cast<float4*>(xs + ((i >> lg_groups) << lg_ext) +
                                     dest((i & ((1 << lg_groups) - 1)) << 2)) = v[u];
      }
    }
  } else {
    for (int i = threadIdx.x; i < rows << lg_ext; i += threads) {
      const int m = i >> lg_ext, e = i & ((1 << lg_ext) - 1);
      const int s = src(m, e);
      xs[(m << lg_ext) + dest(e)] = s >= 0 ? x[s] : 0.f;
    }
  }
}

template <int MB, bool PACKED>
__global__ void __launch_bounds__(kThreads)
    qlinear_f32_kernel(const float* __restrict__ x, const uint8_t* __restrict__ q,
                       const float* __restrict__ scale, const float* __restrict__ bias,
                       float* __restrict__ y, int M, int N, int K, int row_bytes, int aligned,
                       int xvec, int kw, int lpr, int cpl, int tile_chunks) {
  extern __shared__ __align__(16) float smem_f32[];
  // grid.y splits the rows of x in blocks of MB: each row's sum is the same
  // in any block, so the split changes no bit of y
  x += static_cast<size_t>(blockIdx.y) * MB * K;
  y += static_cast<size_t>(blockIdx.y) * MB * N;
  M = min(M - static_cast<int>(blockIdx.y) * MB, MB);
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rpw = 32 / lpr, rows_cta = (warps / kw) * rpw;
  const int ks = warp % kw, rg = lane / lpr, l = lane % lpr;
  const int r = (warp / kw) * rpw + rg;  // the lane's row in the CTA
  const int n = blockIdx.x * rows_cta + r;
  const bool live = n < N;
  const int step_bytes = lpr * 16;
  const int tb = tile_chunks * kw * step_bytes;  // q bytes of a row per K tile
  const int ext = tb * (PACKED ? 2 : 1);
  float* xs = smem_f32;            // [MB][ext], rows past M zero
  float* part = xs + MB * ext;     // [kw][rows_cta][MB], kw > 1

  // 1. every 16-byte slice this lane owns in row n, all loads issued at once
  uint4 w[kF32MaxChunks];
  const uint8_t* row = q + static_cast<size_t>(live ? n : 0) * row_bytes;
#pragma unroll
  for (int c = 0; c < kF32MaxChunks; ++c) {
    w[c] = make_uint4(0u, 0u, 0u, 0u);
    const int off = (c * kw + ks) * step_bytes + l * 16;
    if (c < cpl && live && off < row_bytes) w[c] = load_slice(row, off, row_bytes, aligned);
  }
  // the scale and bias of the row this thread finishes, loaded now so their
  // latency hides under the weights': its own row (kw = 1), or row
  // threadIdx.x % rows_cta of the CTA (kw > 1; rows_cta divides the block)
  const int fin = kw == 1 ? n : blockIdx.x * rows_cta + threadIdx.x % rows_cta;
  float sc = 0.f, bi = 0.f;
  if (fin < N) {
    sc = scale[fin];
    if (bias != nullptr) bi = bias[fin];
  }

  // 2. chunk by chunk, x staged once per K tile; one order for every M
  float acc[MB];
#pragma unroll
  for (int m = 0; m < MB; ++m) acc[m] = 0.f;
  int staged = -1;
#pragma unroll
  for (int c = 0; c < kF32MaxChunks; ++c) {
    if (c >= cpl) break;  // uniform over the block
    const int t = c >> (__ffs(tile_chunks) - 1);
    if (t != staged) {
      if (staged >= 0) __syncthreads();
      stage_x_f32<PACKED>(x, xs, M, MB, K, row_bytes, xvec, __ffs(lpr) - 1, t * tb,
                          __ffs(tb) - 1);
      __syncthreads();
      staged = t;
    }
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
    const int so = ((c - t * tile_chunks) * kw + ks) * step_bytes;  // the step in the tile
#pragma unroll
    for (int m = 0; m < MB; ++m) {  // no exit past M: the MB chains interleave
      const float4* lo = reinterpret_cast<const float4*>(xs + m * ext + so);
      const float4* hi = reinterpret_cast<const float4*>(xs + m * ext + tb + so);
      float a = acc[m];
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        const float4 v = lo[g * lpr + l];
        a = fmaf(v.x, wl[4 * g], a);
        a = fmaf(v.y, wl[4 * g + 1], a);
        a = fmaf(v.z, wl[4 * g + 2], a);
        a = fmaf(v.w, wl[4 * g + 3], a);
        if (PACKED) {
          const float4 h = hi[g * lpr + l];
          a = fmaf(h.x, wh[4 * g], a);
          a = fmaf(h.y, wh[4 * g + 1], a);
          a = fmaf(h.z, wh[4 * g + 2], a);
          a = fmaf(h.w, wh[4 * g + 3], a);
        }
      }
      acc[m] = a;
    }
  }

  // 3. a butterfly over the row's lpr lanes; then the K slices in order
  for (int off = lpr >> 1; off > 0; off >>= 1) {
#pragma unroll
    for (int m = 0; m < MB; ++m) acc[m] += __shfl_xor_sync(0xffffffffu, acc[m], off);
  }
  if (kw == 1) {
    if (!live) return;
#pragma unroll
    for (int m = 0; m < MB; ++m)
      if (m < M && (m % lpr) == l) y[static_cast<size_t>(m) * N + n] = acc[m] * sc + bi;
    return;
  }
#pragma unroll
  for (int m = 0; m < MB; ++m)
    if (m < M && (m % lpr) == l) part[(ks * rows_cta + r) * MB + m] = acc[m];
  __syncthreads();
  if (fin >= N) return;
  const int rr = threadIdx.x % rows_cta;
  for (int m = threadIdx.x / rows_cta; m < M; m += blockDim.x / rows_cta) {
    float v = part[rr * MB + m];
    for (int s = 1; s < kw; ++s) v += part[(s * rows_cta + rr) * MB + m];
    y[static_cast<size_t>(m) * N + fin] = v * sc + bi;
  }
}

template <int MB, bool PACKED>
int launch_f32(const void* x, const void* q, const void* scale, const void* bias, void* y, int M,
               int N, int K, int row_bytes, int aligned, int xvec, int warps, int kw, int lpr,
               int cpl, int tile_chunks, cudaStream_t stream) {
  static int configured = 48 * 1024;  // dynamic shared memory the kernel is allowed
  auto kernel = qlinear_f32_kernel<MB, PACKED>;
  const int rows_cta = (warps / kw) * (32 / lpr);
  const int ext = tile_chunks * kw * lpr * 16 * (PACKED ? 2 : 1);
  const int smem = (MB * ext + (kw > 1 ? kw * rows_cta * MB : 0)) * static_cast<int>(sizeof(float));
  if (smem > configured) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = smem;
  }
  const dim3 grid((N + rows_cta - 1) / rows_cta, (M + MB - 1) / MB);
  kernel<<<grid, warps * 32, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const uint8_t*>(q),
      static_cast<const float*>(scale), static_cast<const float*>(bias), static_cast<float*>(y),
      M, N, K, row_bytes, aligned, xvec, kw, lpr, cpl, tile_chunks);
  return static_cast<int>(cudaGetLastError());
}

// x_rows: the most rows of x a CTA takes (a power of two); more rows take
// more CTAs along grid.y.
template <bool PACKED>
int dispatch_f32(const void* x, const void* q, const void* scale, const void* bias, void* y,
                 int M, int N, int K, int row_bytes, int aligned, int xvec, int warps, int kw,
                 int lpr, int cpl, int tile_chunks, int x_rows, cudaStream_t s) {
#define PT_F32(MB)                                                                            \
  return launch_f32<MB, PACKED>(x, q, scale, bias, y, M, N, K, row_bytes, aligned, xvec, warps, \
                                kw, lpr, cpl, tile_chunks, s)
  const int mr = M < x_rows ? M : x_rows;
  if (mr <= 1) PT_F32(1);
  if (mr <= 2) PT_F32(2);
  if (mr <= 4) PT_F32(4);
  if (mr <= 8) PT_F32(8);
  if (mr <= 16) PT_F32(16);
  PT_F32(32);
#undef PT_F32
}

}  // namespace

// f32 route.  y [M, N] = scale * (x [M, K] @ q^T) (+ bias), on `stream`.  q
// [N, row_bytes] int8 (packed = 0, row_bytes = K) or split-half int4 (packed =
// 1, row_bytes = K / 2); x, scale [N], bias [N] (or null) and y float32,
// contiguous.  aligned = 1 promises q's base and row_bytes are multiples of
// 16; xvec = 1 promises K and row_bytes multiples of 4 and x 16-byte aligned.
// Launched as kernels/qlinear.py launch_plan_f32 says: CTAs of `warps` warps
// (2-8), kw K slices a row (dividing warps), lpr lanes a row (1-32, a power of
// two), cpl 16-byte slices a lane (1-8, covering the row), x staged in K
// tiles of tile_chunks chunks (a power of two; at most 1024 elements a row),
// at most x_rows rows of x a CTA (1-32, a power of two; grid.y takes the
// rest).  1 <= M <= 32.
// Returns a cudaError_t.
extern "C" int pt_qlinear_f32(const void* x, const void* q, const void* scale, const void* bias,
                              void* y, int M, int N, int K, int row_bytes, int packed,
                              int aligned, int xvec, int warps, int kw, int lpr, int cpl,
                              int tile_chunks, int x_rows, void* stream_ptr) {
  const long long covered = static_cast<long long>(cpl) * kw * lpr * 16;
  const int ext = tile_chunks * kw * lpr * 16 * (packed ? 2 : 1);
  if (M < 1 || M > kMaxRows || N < 1 || row_bytes < 1 || K != (packed ? 2 : 1) * row_bytes ||
      warps < 2 || warps > kWarps || kw < 1 || warps % kw != 0 || lpr < 1 || lpr > 32 ||
      (lpr & (lpr - 1)) != 0 || cpl < 1 || cpl > kF32MaxChunks || covered < row_bytes ||
      tile_chunks < 1 || (tile_chunks & (tile_chunks - 1)) != 0 || ext > kF32MaxExtent ||
      x_rows < 1 || x_rows > kMaxRows || (x_rows & (x_rows - 1)) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream_ptr);
  return packed ? dispatch_f32<true>(x, q, scale, bias, y, M, N, K, row_bytes, aligned, xvec,
                                     warps, kw, lpr, cpl, tile_chunks, x_rows, s)
                : dispatch_f32<false>(x, q, scale, bias, y, M, N, K, row_bytes, aligned, xvec,
                                      warps, kw, lpr, cpl, tile_chunks, x_rows, s);
}

// bf16 route, the same function with x, scale, bias and y bfloat16, on the
// tensor cores, launched as kernels/qlinear.py launch_plan says: rt 16-row
// tiles per CTA (1, 2, 4 or 8; 8 / rt warps split its K span), a cluster of
// cs CTAs (1-8) splitting K, cpw 64-byte chunks per warp (1-4), smem bytes of
// dynamic shared memory.  aligned as above; xvec = 1 promises K (and, packed,
// row_bytes) a multiple of 8 and x 16-byte aligned.  Returns a cudaError_t.
extern "C" int pt_qlinear_bf16(const void* x, const void* q, const void* scale, const void* bias,
                               void* y, int M, int N, int K, int row_bytes, int packed,
                               int aligned, int xvec, int rt, int cs, int cpw, int smem,
                               void* stream_ptr) {
  const int span = (rt > 0 ? kWarps / rt : 0) * cpw * kMmaChunk;
  if (M < 1 || M > kMaxRows || N < 1 || row_bytes < 1 || K != (packed ? 2 : 1) * row_bytes ||
      (rt != 1 && rt != 2 && rt != 4 && rt != 8) || cs < 1 || cs > kMaxCluster ||
      (16 * rt) % cs != 0 || cpw < 1 || cpw > kMaxChunksWarp || span * cs < row_bytes ||
      span * (packed ? 2 : 1) > kMaxXExtent)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream_ptr);
  return packed ? dispatch_mma<true>(x, q, scale, bias, y, M, N, K, row_bytes, aligned, xvec, rt,
                                     cs, cpw, smem, s)
                : dispatch_mma<false>(x, q, scale, bias, y, M, N, K, row_bytes, aligned, xvec, rt,
                                      cs, cpw, smem, s);
}
