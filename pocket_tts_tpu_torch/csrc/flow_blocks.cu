// Flow block chain of the SimpleMLPAdaLN flow net, hand-written for Hopper (sm_90a).
//
// Replaces: the Pallas TPU kernel `flow_blocks` (body `_kernel`, wrapper
// `flow_step_pallas`) in pocket_tts_tpu/ops/pallas/flow_kernel.py.  For each of
// `depth` AdaLN ResBlocks:
//   mod = silu(y) @ ada_w^T + ada_b            -> shift | scale | gate
//   z   = LN_f32(h; ln_w, ln_b, eps=1e-6) * (1 + scale) + shift
//   z   = silu(z @ mlp1^T + b1) @ mlp2^T + b2
//   h   = h + gate * z
// All in float32 with float32 accumulation on the CUDA cores (TF32 would break
// the reference's Precision.HIGHEST contract).
//
// What bounds it on the card: at flagship size (dim 512, depth 6) one call
// must read 6 * (1536 + 512 + 512) * 512 * 4 B = 31.5 MB of f32 weights, which
// the main path finds cold (the bf16 backbone, 151 MB per frame, streams
// through the 50 MB L2 between two calls): 9.4 us at 3.35 TB/s.  The
// arithmetic is 2 * B * 7.86 M FLOP: 15.7 MFLOP at B = 1, 252 at B = 16, 0.23
// and 3.8 us at 67 TFLOP/s.  Bytes set the bound up to B ~ 40.
//
// What the design does about it:
//   * One persistent cooperative launch per call (grid = SMs x occupancy, from
//     the wrapper's launch plan), with a grid-wide barrier after the
//     modulations, after each u and after each h: the 2 * depth dependent
//     matrix-vector stages no longer pay a launch each.  The barrier is one
//     release add per CTA on a per-call counter and a spin of acquire loads
//     (grid_arrive, grid_wait).
//   * The 2 * depth chain matrices (mlp1_w, mlp2_w: 12.6 MB at flagship size)
//     are cut into row slices, one per CTA and stage.  At entry one thread of
//     each CTA issues a bulk asynchronous copy (cp.async.bulk, one mbarrier per
//     slice) of every slice it owns, in chain order, into shared memory, so
//     the whole chain is requested from HBM at once and arrives at bandwidth
//     while block 0's modulations run; stage k waits only for its own slice.
//     Where the slices do not all fit (large dim x depth), the same kernel
//     keeps a ring of `slots` slices and refills a slot once its stage is
//     consumed.  The small operands every CTA reads (h0, the norms' weights,
//     the mlps' biases) are prefetched into L2 at entry.
//   * The modulations (18.9 MB) do not depend on h.  Each CTA owns a
//     contiguous range of modulation rows and streams it through a ring of
//     `mslots` chunks of 8 rows and their 8 biases (bulk copies again, one
//     mbarrier per chunk, the first ones issued before the chain's), one row
//     per warp.  Block 0's run first; block i + 1's run in the window between
//     the CTA's arrival at the barrier after u of block i and its wait there,
//     time it would otherwise spend spinning, and the arrival after h of block
//     i publishes them.  This was chosen over running all blocks' modulations
//     first: that puts all 18.9 MB before the chain's first stage, where the
//     interleaving hides most of it behind barriers.
//   * Activations (sy, z, u) are staged once per stage in shared memory, in B
//     tiles of `tile` lanes where B * dim * 4 would crowd out the weights.  A
//     warp applies one weight row (registers) to a group of G lanes at a time
//     (G = 1, 2, 4, 8: the batch rounded up to a power of two, at most 8) with
//     G partial sums, and one reduce-scatter gives the G sums (9 shuffles for
//     G = 8 instead of 8 warp reductions of 5); B = 1 reads no padding.  The
//     first warps own the chain tasks and wait for their weight slice while
//     the last warps run the LayerNorms or stage u, so that wait is off the
//     critical path; ring refills are issued by a thread other than the one
//     that spins at the next grid barrier.
//   * What is left on the critical path at B = 1 is latency: 12 grid barriers
//     (an L2 round trip for the release and one for the spin) and, per stage,
//     one L2 round trip for its inputs.  At B = 16 the LayerNorms (two lanes
//     per warp in series) and the shared-memory reads of the staged lanes
//     (each row re-reads them) add to it.
//   * h is updated in place in `out`: every read of the whole h (the LayerNorm
//     of stage A) happens before the grid barrier that ends stage A, every
//     write of h (stage B) after it, and stage B reads and writes each element
//     of h in the one lane that owns it.
//
// Lane independence: the result of a lane b does not depend on B or on what
// the other lanes hold.  Every dot product is summed in the same order (each
// lane's float4 chunks in order, then a butterfly over xor 16, 8, 4, 2, 1 of
// the same pairs for every value: the reduce-scatter pairs the same lanes as a
// warp all-reduce, and f32 addition is commutative), the LayerNorm of a lane
// is one warp's fixed-order sum, there are no atomics in any sum, and the
// lanes of a group are never mixed.  So a lane is bit-identical at B = 1 and
// inside any batch, run to run; the batcher's lanes rely on that.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// The C entries return a cudaError_t (0 = success).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxChunks = 8;  // float4 chunks per lane: dim <= 8 * 32 * 4 = 1024
constexpr unsigned kFull = 0xffffffffu;
constexpr int kRefiller = 32;  // issues ring refills while thread 0 spins at a grid barrier

struct Params {
  const float* sy;
  const float* h0;
  const float* ada_w;
  const float* ada_b;
  const float* ln_w;
  const float* ln_b;
  const float* mlp1_w;
  const float* mlp1_b;
  const float* mlp2_w;
  const float* mlp2_b;
  float* mod;  // [depth, batch, 3 dim]
  float* u;    // [batch, dim]
  float* out;  // [batch, dim], h in place
  unsigned int* bar;  // grid barrier state {count, generation}, zeroed per call
  int batch, dim, depth;
  int rows;   // chain rows per CTA and stage
  int slots;  // weight slices held in shared memory: 2 * depth = all resident
  int mrows;   // modulation rows per CTA and block
  int mslots;  // chunks of kWarps modulation rows in the shared-memory ring
  int tile;   // batch lanes staged per pass, a multiple of the group
};

__host__ __device__ constexpr int bar_bytes(int slots) { return (slots * 8 + 15) / 16 * 16; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar)) : "memory");
}

// The one arrival of `bar`'s phase, which then completes once `bytes` have landed.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// One bulk copy global -> shared of `bytes` (a multiple of 16, both ends 16-byte
// aligned), counted on `bar`.
__device__ __forceinline__ void bulk_copy(float* dst, const float* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void bulk_load(float* dst, const float* src, uint32_t bytes,
                                          uint64_t* bar) {
  mbar_expect(bar, bytes);
  bulk_copy(dst, src, bytes, bar);
}

// Orders this CTA's generic-proxy accesses to shared memory (made before a
// __syncthreads) before the bulk copies this thread issues next.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Asks for `bytes` (a multiple of 16) at `src` to be brought into L2; nothing waits on it.
__device__ __forceinline__ void prefetch_l2(const float* src, uint32_t bytes) {
  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n" ::"l"(src), "r"(bytes) : "memory");
}

// Wait for the completion of the phase of `bar` with the given parity.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ float silu(float x) { return x / (1.0f + expf(-x)); }

// Which of the G values reduce_group leaves in `lane`: its top log2(G) bits.
template <int G>
__device__ __forceinline__ int group_lane(int lane) {
  return lane / (32 / G);
}

// Reduce-scatter of G per-lane partial sums (G = 1, 2, 4 or 8): returns the
// warp sum of a[group_lane<G>(lane)], complete in the lanes whose low
// 5 - log2(G) bits are 0.  Each value is combined over the pairs xor 16, 8,
// 4, 2, 1, the same tree as warp_sum for any G, so the sum equals
// warp_sum(a[j]) bit for bit (f32 addition is commutative).
template <int G>
__device__ __forceinline__ float reduce_group(float (&a)[G], int lane) {
  int off = 16;
#pragma unroll
  for (int half = G / 2; half >= 1; half /= 2, off /= 2) {
    const bool hi = lane & off;
#pragma unroll
    for (int j = 0; j < half; ++j) {
      const float send = hi ? a[j] : a[j + half];
      a[j] = (hi ? a[j + half] : a[j]) + __shfl_xor_sync(kFull, send, off);
    }
  }
  float v = a[0];
#pragma unroll
  for (; off >= 1; off /= 2) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// Grid-wide barrier of a cooperative launch (all CTAs are co-resident), split in
// two so that a CTA can work between its arrival and its wait.  Arrival k
// (0, 1, ...): thread 0 of each CTA adds 1 to the call's counter with release
// semantics.  Wait k: thread 0 spins with acquire loads until the counter reads
// (k + 1) * gridDim.x; the __syncthreads after it extends the acquire to the
// CTA.  No fence.sc and no separate fence.  The C entry zeroes the counter before the launch
// (a memset node in a CUDA graph).  Data written before an arrival is read
// after the matching wait through L2 (ld.global.cg), never a stale L1 line.
__device__ __forceinline__ void grid_arrive(unsigned int* count) {
  __syncthreads();
  if (threadIdx.x == 0)
    asm volatile("red.release.gpu.global.add.u32 [%0], 1;\n" ::"l"(count) : "memory");
}

__device__ __forceinline__ void grid_wait(unsigned int* count, int& k) {
  if (threadIdx.x == 0) {
    const unsigned int target = static_cast<unsigned int>(k + 1) * gridDim.x;
    unsigned int now;
    do {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(now) : "l"(count) : "memory");
    } while (now < target);
  }
  ++k;
  __syncthreads();
}

// Row `w` (shared) into registers: lane l holds chunks l + 32 c.
template <int NC>
__device__ __forceinline__ void load_row_shared(const float* w, int n4, int lane,
                                                float4 (&r)[NC]) {
  const float4* w4 = reinterpret_cast<const float4*>(w);
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int i = lane + 32 * c;
    r[c] = i < n4 ? w4[i] : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// Warp sum of row . x[g] for the G staged lanes x[0..G-1] (shared, n4 float4
// each); lane `lane` gets the sum of lane group_lane<G>(lane).
template <int G, int NC>
__device__ __forceinline__ float group_dot(const float4 (&r)[NC], const float4* x4,
                                           int n4, int lane) {
  float acc[G];
#pragma unroll
  for (int g = 0; g < G; ++g) acc[g] = 0.f;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int i = lane + 32 * c;
    if (i < n4) {
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float4 a = x4[g * n4 + i];
        acc[g] = fmaf(r[c].x, a.x, acc[g]);
        acc[g] = fmaf(r[c].y, a.y, acc[g]);
        acc[g] = fmaf(r[c].z, a.z, acc[g]);
        acc[g] = fmaf(r[c].w, a.w, acc[g]);
      }
    }
  }
  return reduce_group<G>(acc, lane);
}

// Stages rows [b0, b0 + nb) of the [batch, dim] activation `src` into X, from
// the last warp down: the first warps, which own the chain tasks, are free to
// wait for their weight slice meanwhile.
__device__ __forceinline__ void stage_rows(float4* X4, const float* src, int b0, int nb, int n4) {
  const float4* s4 = reinterpret_cast<const float4*>(src) + static_cast<size_t>(b0) * n4;
  for (int e = kThreads - 1 - threadIdx.x; e < nb * n4; e += kThreads) X4[e] = __ldcg(s4 + e);
}

// z = LN(h) * (1 + scale) + shift for one lane, by one warp, into x4 (shared).
// The row, its modulation and the norm's weights are all requested at once
// (one round trip to L2); the sums run over each lane's chunks in order, then
// warp_sum.
template <int NC>
__device__ __forceinline__ void layer_norm_modulate(const float* h, const float* mod_b,
                                                    const float* ln_w, const float* ln_b,
                                                    float4* x4, int n4, float inv_dim,
                                                    int lane) {
  const float4* h4 = reinterpret_cast<const float4*>(h);
  const float4* shift4 = reinterpret_cast<const float4*>(mod_b);
  const float4* scale4 = shift4 + n4;
  const float4* w4 = reinterpret_cast<const float4*>(ln_w);
  const float4* b4 = reinterpret_cast<const float4*>(ln_b);
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 hv[NC], sh[NC], sc[NC], wv[NC], bv[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int i = lane + 32 * c;
    const bool in = i < n4;
    hv[c] = in ? __ldcg(h4 + i) : zero;
    sh[c] = in ? __ldcg(shift4 + i) : zero;
    sc[c] = in ? __ldcg(scale4 + i) : zero;
    wv[c] = in ? __ldg(w4 + i) : zero;
    bv[c] = in ? __ldg(b4 + i) : zero;
  }
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < NC; ++c) s += (hv[c].x + hv[c].y) + (hv[c].z + hv[c].w);
  const float mean = warp_sum(s) * inv_dim;
  float v = 0.f;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    if (lane + 32 * c < n4) {
      const float dx = hv[c].x - mean, dy = hv[c].y - mean, dz = hv[c].z - mean,
                  dw = hv[c].w - mean;
      v = fmaf(dx, dx, v);
      v = fmaf(dy, dy, v);
      v = fmaf(dz, dz, v);
      v = fmaf(dw, dw, v);
    }
  }
  const float rstd = 1.0f / sqrtf(warp_sum(v) * inv_dim + 1e-6f);
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int i = lane + 32 * c;
    if (i < n4) {
      float4 z;
      z.x = ((hv[c].x - mean) * rstd * wv[c].x + bv[c].x) * (1.0f + sc[c].x) + sh[c].x;
      z.y = ((hv[c].y - mean) * rstd * wv[c].y + bv[c].y) * (1.0f + sc[c].y) + sh[c].y;
      z.z = ((hv[c].z - mean) * rstd * wv[c].z + bv[c].z) * (1.0f + sc[c].z) + sh[c].z;
      z.w = ((hv[c].w - mean) * rstd * wv[c].w + bv[c].w) * (1.0f + sc[c].w) + sh[c].w;
      x4[i] = z;
    }
  }
}

// One chain stage of this CTA on the staged lanes [b0, b0 + nb): each warp task
// is one owned row applied to one group of G lanes.  Stage A (second = false)
// writes u = silu(acc + b1); stage B writes h += gate * (acc + b2) in place.
template <int G, int NC>
__device__ __forceinline__ void chain_tasks(const Params& p, const float* wslot, int row0,
                                            int nrows, const float4* X4, int b0, int nb,
                                            const float* h_in, const float* mod_i, int blk,
                                            bool second) {
  const int dim = p.dim, n4 = dim >> 2;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ngroups = (nb + G - 1) / G;
  const float* bias = (second ? p.mlp2_b : p.mlp1_b) + static_cast<size_t>(blk) * dim;
  for (int t = warp; t < nrows * ngroups; t += kWarps) {
    const int r = t % nrows, g = t / nrows;
    const int bl = g * G + group_lane<G>(lane), row = row0 + r;
    const bool writer = lane % (32 / G) == 0 && bl < nb;
    const size_t o = static_cast<size_t>(b0 + bl) * dim + row;
    float bias_r = 0.f, h_r = 0.f, gate = 0.f;
    if (writer) {  // in flight during the dot product
      bias_r = __ldg(bias + row);
      if (second) {
        h_r = __ldcg(h_in + o);
        gate = __ldcg(mod_i + static_cast<size_t>(b0 + bl) * 3 * dim + 2 * dim + row);
      }
    }
    float4 w[NC];
    load_row_shared<NC>(wslot + static_cast<size_t>(r) * dim, n4, lane, w);
    const float v = group_dot<G, NC>(w, X4 + static_cast<size_t>(g) * G * n4, n4, lane);
    if (!writer) continue;
    const float acc = v + bias_r;
    if (second) {
      p.out[o] = h_r + gate * acc;
    } else {
      p.u[o] = silu(acc);
    }
  }
}

template <int G, int NC>
__global__ void __launch_bounds__(kThreads, 1) flow_chain_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int dim = p.dim, n4 = dim >> 2, batch = p.batch;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int stages = 2 * p.depth;
  const int ntiles = (batch + p.tile - 1) / p.tile;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);  // chain slots, then mod slots
  uint64_t* mbars = bars + p.slots;
  float* wslots = reinterpret_cast<float*>(smem + bar_bytes(p.slots + p.mslots));
  const size_t slice = static_cast<size_t>(p.rows) * dim;  // floats per chain slot
  const size_t chunk_w = static_cast<size_t>(kWarps) * dim;
  const size_t chunk = chunk_w + kWarps;  // floats per mod slot: kWarps rows, their biases
  float* mring = wslots + p.slots * slice;
  float4* X4 = reinterpret_cast<float4*>(mring + p.mslots * chunk);  // z or u, one tile
  float4* SY4 = X4 + static_cast<size_t>(p.tile) * n4;                // silu(y), one tile
  const int row0 = blockIdx.x * p.rows;
  const int nrows = max(0, min(p.rows, dim - row0));
  const uint32_t slice_bytes = static_cast<uint32_t>(nrows) * dim * 4;
  const size_t dd = static_cast<size_t>(dim) * dim;
  int nbar = 0;
  auto stage_src = [&](int s) {
    return ((s & 1) ? p.mlp2_w : p.mlp1_w) + (s >> 1) * dd + static_cast<size_t>(row0) * dim;
  };
  // Stage s lives in slot s % slots; its n-th use of that slot completes phase n.
  auto wait_stage = [&](int s) { mbar_wait(&bars[s % p.slots], (s / p.slots) & 1); };
  auto refill = [&](int s) {  // by the refiller, once stage s is consumed by the whole CTA
    const int next = s + p.slots;
    if (nrows > 0 && next < stages)
      bulk_load(wslots + (s % p.slots) * slice, stage_src(next), slice_bytes,
                &bars[s % p.slots]);
  };
  auto load_slices = [&](int from, int to) {  // by one thread
    if (nrows > 0)
      for (int s = from; s < to; ++s)
        bulk_load(wslots + s * slice, stage_src(s), slice_bytes, &bars[s]);
  };

  // Modulation rows of block i owned by this CTA: [i * 3 dim + mrow0, + my_mrows),
  // in chunks of kWarps rows (one per warp), each with its kWarps biases (mrows
  // is a multiple of 4, so both copies are 16-byte aligned).  Chunk use q = ((i *
  // ntiles) + t) * cpb + k (block i, batch tile t, chunk k) lives in mod slot q %
  // mslots.
  const int mrow0 = blockIdx.x * p.mrows;
  const int my_mrows = max(0, min(p.mrows, 3 * dim - mrow0));
  const int cpb = (my_mrows + kWarps - 1) / kWarps;
  const int nq = p.depth * ntiles * cpb;
  auto load_chunk = [&](int q) {
    const int k = q % cpb, blk = q / (cpb * ntiles);
    const uint32_t rows = min(kWarps, my_mrows - k * kWarps);
    const size_t row = static_cast<size_t>(blk) * 3 * dim + mrow0 + k * kWarps;
    float* dst = mring + (q % p.mslots) * chunk;
    uint64_t* bar = &mbars[q % p.mslots];
    mbar_expect(bar, rows * (dim + 1) * 4);
    bulk_copy(dst, p.ada_w + row * dim, rows * dim * 4, bar);
    bulk_copy(dst + chunk_w, p.ada_b + row, rows * 4, bar);
  };
  // mod[blk] for this CTA's rows and every lane: its chunks stream through the
  // ring, one row per warp, applied to the staged silu(y) of each tile; a warp
  // with no row in a chunk does not wait for it.  A slot whose next use falls
  // in the same step is refilled at once, behind a CTA barrier; mod_refill
  // issues the others later, off the critical path.
  auto mod_step = [&](int blk) {
    const int q_end = (blk + 1) * ntiles * cpb;
    for (int t = 0; t < ntiles; ++t) {
      const int b0 = t * p.tile, nb = min(p.tile, batch - b0);
      const int ngroups = (nb + G - 1) / G;
      if (ntiles > 1) {  // one tile stays staged from the start
        __syncthreads();
        stage_rows(SY4, p.sy, b0, nb, n4);
        __syncthreads();
      }
      for (int k = 0; k < cpb; ++k) {
        const int q = (blk * ntiles + t) * cpb + k;
        const int r = k * kWarps + warp;
        const float* slot = mring + (q % p.mslots) * chunk;
        if (r < my_mrows) {
          mbar_wait(&mbars[q % p.mslots], (q / p.mslots) & 1);
          const float bias = slot[chunk_w + warp];
          float4 w[NC];
          load_row_shared<NC>(slot + static_cast<size_t>(warp) * dim, n4, lane, w);
          for (int g = 0; g < ngroups; ++g) {
            const float v = group_dot<G, NC>(w, SY4 + static_cast<size_t>(g) * G * n4, n4, lane);
            const int bl = g * G + group_lane<G>(lane);
            if (lane % (32 / G) == 0 && bl < nb)
              p.mod[(static_cast<size_t>(blk) * batch + b0 + bl) * 3 * dim + mrow0 + r] = v + bias;
          }
        }
        if (q + p.mslots < q_end) {  // the slot is needed again in this step
          __syncthreads();
          if (threadIdx.x == 0) {
            fence_proxy_async();
            load_chunk(q + p.mslots);
          }
        }
      }
    }
  };
  // The refills mod_step(blk) left, by the refiller once the whole CTA is past it.
  auto mod_refill = [&](int blk) {
    const int q_end = (blk + 1) * ntiles * cpb;
    for (int q = max(blk * ntiles * cpb, q_end - p.mslots); q < q_end; ++q)
      if (q + p.mslots < nq) load_chunk(q + p.mslots);
  };

  // 0. the first mod chunks and the first two chain slices, requested at once;
  // the other slices follow once block 0's modulations are done
  const int early = min(p.slots, 2);
  if (threadIdx.x == 0) {
    for (int k = 0; k < p.slots + p.mslots; ++k) mbar_init(&bars[k]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int q = 0; q < min(p.mslots, nq); ++q) load_chunk(q);
    if (blockIdx.x == gridDim.x - 1) {  // h0 and the norms' and mlps' vectors, read by all
      const uint32_t vec = static_cast<uint32_t>(p.depth) * dim * 4;
      prefetch_l2(p.h0, static_cast<uint32_t>(batch) * dim * 4);
      prefetch_l2(p.ln_w, vec);
      prefetch_l2(p.ln_b, vec);
      prefetch_l2(p.mlp1_b, vec);
      prefetch_l2(p.mlp2_b, vec);
    }
    load_slices(0, early);
  }
  if (ntiles == 1) stage_rows(SY4, p.sy, 0, batch, n4);
  __syncthreads();

  // 1. block 0's modulations, then the chain.  Block i + 1's modulations are
  // computed between this CTA's arrival at the barrier after u (stage A of
  // block i) and its wait there: off the critical path, and published by the
  // arrival after h (stage B of block i), before stage A of block i + 1.
  mod_step(0);
  grid_arrive(p.bar);
  if (threadIdx.x == kRefiller) {
    load_slices(early, p.slots);
    fence_proxy_async();
    mod_refill(0);
  }
  grid_wait(p.bar, nbar);

  // 2. per block: stage A (LN, modulate, mlp1), stage B (mlp2, gated residual)
  const float inv_dim = 1.0f / static_cast<float>(dim);
  for (int i = 0; i < p.depth; ++i) {
    const float* h_in = i == 0 ? p.h0 : p.out;
    const float* mod_i = p.mod + static_cast<size_t>(i) * batch * 3 * dim;
    const float* ln_w = p.ln_w + static_cast<size_t>(i) * dim;
    const float* ln_b = p.ln_b + static_cast<size_t>(i) * dim;
    for (int b0 = 0; b0 < batch; b0 += p.tile) {
      const int nb = min(p.tile, batch - b0);
      // the warps with chain tasks wait for their slice while the last warps run the LayerNorms
      if (nrows > 0 && warp < nrows * ((nb + G - 1) / G)) wait_stage(2 * i);
      for (int bl = kWarps - 1 - warp; bl < nb; bl += kWarps) {  // z of lane b0 + bl
        layer_norm_modulate<NC>(h_in + static_cast<size_t>(b0 + bl) * dim,
                                mod_i + static_cast<size_t>(b0 + bl) * 3 * dim, ln_w, ln_b,
                                X4 + static_cast<size_t>(bl) * n4, n4, inv_dim, lane);
      }
      __syncthreads();
      if (nrows > 0) {
        chain_tasks<G, NC>(p, wslots + ((2 * i) % p.slots) * slice, row0, nrows, X4, b0, nb,
                           h_in, mod_i, i, false);
      }
      if (b0 + p.tile < batch) __syncthreads();  // X is restaged by the next tile
    }
    grid_arrive(p.bar);  // u complete; every read of h for the LayerNorm is done
    if (i + 1 < p.depth) mod_step(i + 1);
    __syncthreads();  // the mod chunks and stage 2i's slice are consumed
    if (threadIdx.x == kRefiller) {
      fence_proxy_async();
      if (i + 1 < p.depth) mod_refill(i + 1);
      refill(2 * i);
    }
    grid_wait(p.bar, nbar);

    for (int b0 = 0; b0 < batch; b0 += p.tile) {
      const int nb = min(p.tile, batch - b0);
      if (nrows > 0 && warp < nrows * ((nb + G - 1) / G)) wait_stage(2 * i + 1);
      stage_rows(X4, p.u, b0, nb, n4);
      __syncthreads();
      if (nrows > 0) {
        chain_tasks<G, NC>(p, wslots + ((2 * i + 1) % p.slots) * slice, row0, nrows, X4, b0,
                           nb, h_in, mod_i, i, true);
      }
      __syncthreads();
    }
    if (i + 1 < p.depth) {  // h and block i + 1's modulations complete
      grid_arrive(p.bar);
      if (threadIdx.x == kRefiller) {
        fence_proxy_async();
        refill(2 * i + 1);
      }
      grid_wait(p.bar, nbar);
    }
  }
}

}  // namespace

template <int G>
static const void* kernel_for_chunks(int nc) {
  switch (nc) {
    case 1: return reinterpret_cast<const void*>(flow_chain_kernel<G, 1>);
    case 2: return reinterpret_cast<const void*>(flow_chain_kernel<G, 2>);
    case 4: return reinterpret_cast<const void*>(flow_chain_kernel<G, 4>);
    case 8: return reinterpret_cast<const void*>(flow_chain_kernel<G, 8>);
    default: return nullptr;
  }
}

// The kernel for `group` batch lanes per warp task (1, 2, 4 or 8) at width
// `dim`: NC float4 chunks per lane, dim / 128 rounded up to a power of two.
static const void* kernel_for(int group, int dim) {
  const int n4 = dim / 4;
  const int nc = n4 <= 32 ? 1 : n4 <= 64 ? 2 : n4 <= 128 ? 4 : 8;
  switch (group) {
    case 1: return kernel_for_chunks<1>(nc);
    case 2: return kernel_for_chunks<2>(nc);
    case 4: return kernel_for_chunks<4>(nc);
    case 8: return kernel_for_chunks<8>(nc);
    default: return nullptr;
  }
}

// Shared-memory attribute and occupancy of the kernel for `group` and `dim` at
// `smem_bytes` per CTA: *blocks_per_sm CTAs of kThreads fit on one SM.
extern "C" int pt_flow_blocks_occupancy(int group, int dim, int smem_bytes, int* blocks_per_sm) {
  const void* fn = kernel_for(group, dim);
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err =
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, fn, kThreads, static_cast<size_t>(smem_bytes)));
}

// Runs the whole chain as one cooperative launch on `stream`.  Shapes (all f32,
// contiguous, 16-byte aligned): sy, h0, out, u [batch, dim]; mod [depth, batch,
// 3 dim]; ada_w [depth, 3 dim, dim]; ada_b [depth, 3 dim]; ln_w, ln_b, mlp1_b,
// mlp2_b [depth, dim]; mlp1_w, mlp2_w [depth, dim, dim].  dim % 4 == 0, dim <=
// 1024.  `bar` is 16 bytes of scratch for the grid barrier, zeroed here on
// `stream` before the launch.  The launch plan (grid, rows, slots, mrows,
// mslots, group, tile, smem_bytes) comes from kernels/flow_blocks.py:launch_plan;
// smem_bytes must equal bar_bytes(slots + mslots) + (slots * rows * dim + mslots
// * kWarps * (dim + 1) + 2 * tile * dim) * 4, and mrows be a multiple of 4.
// Returns a cudaError_t.
extern "C" int pt_flow_blocks_f32(const float* sy, const float* h0, const float* ada_w,
                                  const float* ada_b, const float* ln_w, const float* ln_b,
                                  const float* mlp1_w, const float* mlp1_b, const float* mlp2_w,
                                  const float* mlp2_b, float* mod, float* u, float* out,
                                  unsigned int* bar, int batch, int dim, int depth, int grid,
                                  int rows, int slots, int mrows, int mslots, int group,
                                  int tile, int smem_bytes, void* stream_ptr) {
  const void* fn = kernel_for(group, dim);
  if (fn == nullptr ||
      smem_bytes != bar_bytes(slots + mslots) +
                        (slots * rows * dim + mslots * kWarps * (dim + 1) + 2 * tile * dim) * 4 ||
      tile % group || slots < 1 || slots > 2 * depth || grid * rows < dim || mslots < 1 ||
      mrows % 4 || grid * mrows < 3 * dim || dim % 4 || dim > 4 * 32 * kMaxChunks)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err =
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaMemsetAsync(bar, 0, 16, static_cast<cudaStream_t>(stream_ptr));
  if (err != cudaSuccess) return static_cast<int>(err);
  Params p{sy,  h0,  ada_w, ada_b, ln_w, ln_b, mlp1_w, mlp1_b, mlp2_w, mlp2_b, mod,
           u,   out, bar,   batch, dim,  depth, rows,  slots,  mrows, mslots, tile};
  void* args[] = {&p};
  err = cudaLaunchCooperativeKernel(fn, dim3(grid), dim3(kThreads), args,
                                    static_cast<size_t>(smem_bytes),
                                    static_cast<cudaStream_t>(stream_ptr));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
