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
// What bounds it on the card.  At B = 1 (H = 16, D = 64, bf16) the K and V
// rows up to pos 511 are 2.1 MB, 0.6 us at 3.35 TB/s: latency rules, the
// dependent trips on the critical path (pos, then the rows) and the steps
// that wait on another SM.  At B = 16 the same rows are 33.6 MB, 10 us:
// bytes rule, with each CTA's fixed steps (a cluster's barriers and
// exchanges cost more than a CTA's share of the bytes there).  The design:
//   * One order for every launch: logical ranks.  The R = min(L, ceil(n /
//     mk)) ranks with keys (L = min(8, ceil(S / mk)), mk = 128 keys) split
//     [0, n) evenly in rank order; each rank's sums run in a fixed order
//     over a team of 4 warps (kernels/decode_attention.py launch_plan), and
//     the ranks' maxima, sums and rows combine in rank order.  So every
//     sum's order depends on (n_b, S, D, the cache type) alone, never on B
//     or on which schedule below runs.
//   * Two schedules of that order, chosen by launch_plan from B x H: a
//     thread-block cluster of one CTA a rank (decode_attention_kernel, L <=
//     8, the portable limit) while the launch has at most 256 CTAs (B <= 2
//     at H = 16: latency rules); a CTA alone per (b, h) of up to four teams
//     (decode_attention_solo_kernel, solo_body) above (bytes rule; its many
//     warps hide the loads, and no cluster step is paid).  A cluster whose
//     one rank holds every key (n <= mk) hands it to CTA 0's solo_body.
//   * Every byte requested up front in a cluster: each CTA issues all of
//     its K rows, then all of its V rows, as 16-byte cp.async copies into
//     shared memory, one commit group per ring tile, before it computes
//     anything; it waits for the K group alone, so V's bytes arrive while
//     the logits, the max and the sum are computed.  cp.async rather than
//     cp.async.bulk: each thread tracks its own copies by commit group, so
//     no byte count has to match the copies exactly (a mismatch hangs the
//     card), and a row of 64 to 512 bytes is 4 to 32 copies spread over the
//     CTA's threads.  Where a rank's share does not fit (S > 2048 at
//     128-byte rows, or wider rows), the tiles stream through a ring of
//     kRingStages buffers, K tiles first.  The CTA alone reads K and V
//     straight into registers and requests its first V rows before the
//     softmax.
//   * The softmax exactly as one CTA would take it, across the cluster
//     through distributed shared memory: each rank with keys pushes its max
//     into the shared memory of every rank with keys (st.async, 4 bytes
//     completing a transaction on the receiver's mbarrier), and each reads
//     all R maxima once its barrier has the R pushes; the same for the sums
//     of exp(l - M), added in rank order, for one total; p = e / total,
//     rounded to bf16 under a bf16 q.  A push lands in one trip;
//     cluster.sync() followed by a read of the peer's memory is two.
//   * Each warp accumulates a partial row [D] over its keys; each row is
//     pushed in 16-byte pieces to the rank that finishes those columns,
//     which adds the (rank, warp) rows in order, rounds once to q's type and
//     writes them.  Two cluster barriers, each split: arrive once the
//     mbarriers are set, wait before the first push; arrive once every push
//     to this CTA has landed, wait before leaving.  A rank with no keys
//     would contribute max -inf, sum 0 and a zero row: it joins both
//     barriers and leaves at once.
// Left for later: several heads a CTA (the K/V rows of one position's heads
// are contiguous) or persistent CTAs walking (b, h) pairs, which would pay
// the fixed steps once for many heads; at B = 16 the CTA alone is slower
// than one CTA of 8 warps on e4m3fn caches at long positions.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 4;              // warps of a team, which takes one logical rank at a time
constexpr int kThreads = kWarps * 32;  // threads of a team, and of a CTA of a cluster
// cluster CTAs an SM keeps: a launch of clusters has at most 256 CTAs
// (kernels/decode_attention.py CTA_TARGET), so two an SM, and the kernel
// (with solo_body inlined for a lone rank) has registers to spare
constexpr int kMinBlocks = 2;
constexpr int kSoloTeams = 4;          // teams of a CTA that takes a (b, h) alone
constexpr int kMaxCluster = 8;        // portable cluster size, and the most logical ranks
constexpr int kRingBytes = 64 * 1024; // K/V staging of one CTA
constexpr int kRingStages = 4;        // ring depth where the tiles do not fit at once
constexpr int kUnroll = 4;            // steps of keys a warp takes at once
constexpr int kMaxPositions = 8192;
constexpr int kMaxDim = 256;
constexpr int kMaxSmem = 227 * 1024;  // dynamic shared memory a CTA may opt into

// Phase marks for scripts/decode_attention_probe.py, which builds this file
// with DA_PROBE defined; they compile to nothing otherwise.
#ifdef DA_PROBE
constexpr int kProbeCtas = 8192;
__device__ unsigned long long probe_t[kProbeCtas][12];  // clock64 at marks 0-10, entry time
#define DA_MARK(k)                                                                     \
  do {                                                                                 \
    if (threadIdx.x == 0 && blockIdx.x < kProbeCtas) probe_t[blockIdx.x][k] = clock64(); \
  } while (0)
#define DA_ENTRY()                                            \
  do {                                                        \
    if (threadIdx.x == 0 && blockIdx.x < kProbeCtas) {        \
      unsigned long long t;                                   \
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));   \
      probe_t[blockIdx.x][11] = t;                            \
      probe_t[blockIdx.x][10] = 0; /* set again at the exit */ \
    }                                                         \
    DA_MARK(0);                                               \
  } while (0)
#else
#define DA_MARK(k) \
  do {             \
  } while (0)
#define DA_ENTRY() \
  do {             \
  } while (0)
#endif

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

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most stages - 1 of this thread's commit groups are pending.
__device__ __forceinline__ void cp_async_wait_ring(int stages) {
  if (stages == 2)
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  else
    asm volatile("cp.async.wait_group 3;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The shared::cluster address of the same shared memory byte in CTA `rank`.
__device__ __forceinline__ uint32_t peer_addr(uint32_t addr, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

// Store v into a peer CTA's shared memory; the 4 bytes complete a
// transaction on the peer's mbarrier.
__device__ __forceinline__ void push(uint32_t peer, float v, uint32_t peer_bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];\n"
               ::"r"(peer), "r"(__float_as_uint(v)), "r"(peer_bar) : "memory");
}

// The same for v[0 .. 3], 16 bytes to a 16-byte aligned address.
__device__ __forceinline__ void push4(uint32_t peer, const float* v, uint32_t peer_bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], {%1, %2, %3, %4}, "
      "[%5];\n" ::"r"(peer), "r"(__float_as_uint(v[0])), "r"(__float_as_uint(v[1])),
      "r"(__float_as_uint(v[2])), "r"(__float_as_uint(v[3])), "r"(peer_bar) : "memory");
}

// The barrier (set up with one arrival) completes its phase 0 once `bytes`
// have been pushed to this CTA.
__device__ __forceinline__ void expect_bytes(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void wait_bytes(uint64_t* bar) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_addr(bar)) : "memory");
  } while (!done);
}

// Floats of the shared memory solo_body takes: the logits [room], the
// (rank, warp) rows [slots][kWarps][D], the warps' maxima and the ranks'
// warps' sums.
__host__ __device__ inline int solo_floats(int room, int D, int slots) {
  return ((room + 3) & ~3) + slots * kWarps * D + (kSoloTeams + kMaxCluster) * kWarps;
}

// One (b, h) by one CTA of blockDim.x / kThreads teams, with the order of
// decode_attention_kernel and the K and V rows read straight into registers
// (no staging, barrier or exchange to wait on).  For the logits lane (seg,
// l) of warp w takes key w * kpw + seg + m * (warps * kpw); team t takes the
// logical ranks t, t + teams, ..., each exactly as a CTA of a cluster would:
// the sums per thread over the rank's keys t, t + kThreads, ..., the V rows
// per lane over keys j0 + w * kpw + seg + m kps.  n live keys, at most room
// of them, at most slots ranks with keys; qv the lane's slice of q.
template <typename QT, int KV>
__device__ __forceinline__ void solo_body(const float* qv, const uint8_t* __restrict__ kc,
                                          const uint8_t* __restrict__ vc, QT* __restrict__ out,
                                          int n, int bh, int b, int h, int H, int D,
                                          long long kv_sb, int vr, int mk, int lpk, float scale,
                                          unsigned char* smem_raw, int room, int slots) {
  constexpr int kEs = element_bytes<KV>();
  constexpr int kVpl = 16 / kEs;
  constexpr bool kRound = sizeof(QT) == 2 && KV == kF32;
  constexpr bool kRoundP = sizeof(QT) == 2;
  float* logit = reinterpret_cast<float*>(smem_raw);  // [room]
  float* rows = logit + ((room + 3) & ~3);            // [slots][kWarps][D]
  float* red = rows + slots * kWarps * D;             // [warps] maxima, [R][kWarps] sums
  float* sums = red + kSoloTeams * kWarps;
  const int nthreads = blockDim.x, warps = nthreads >> 5, teams = warps / kWarps;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int team = warp / kWarps, tw = warp % kWarps;
  const int tt = static_cast<int>(threadIdx.x) % kThreads;
  const int lpk_shift = __ffs(lpk) - 1;
  const int kpw = 32 >> lpk_shift;
  const int kps = kWarps * kpw;
  const int seg = lane >> lpk_shift, l = lane & (lpk - 1);
  const int ranks = min(vr, (n + mk - 1) / mk);
  const size_t stride = static_cast<size_t>(H) * D * kEs;
  const size_t base = (static_cast<size_t>(b) * kv_sb + static_cast<size_t>(h) * D) * kEs + l * 16;
  const uint8_t* kb = kc + base;
  const uint8_t* vb = vc + base;

  // 1. logits: kUnroll keys a lane in flight over every warp
  float mx = __int_as_float(0xff800000);  // -inf
  const int wide = warps * kpw;  // keys a step of every warp
  for (int step = 0; step < n; step += kUnroll * wide) {  // uniform over the warp
    const int j0 = step + warp * kpw + seg;
    uint4 w[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = j0 + u * wide;
      w[u] = j < n ? __ldg(reinterpret_cast<const uint4*>(kb + j * stride))
                   : make_uint4(0u, 0u, 0u, 0u);
    }
    float s[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float f[kVpl];
      widen<KV, kRound>(w[u], f);
      s[u] = 0.f;
#pragma unroll
      for (int e = 0; e < kVpl; ++e) s[u] = fmaf(qv[e], f[e], s[u]);
    }
    for (int off = lpk >> 1; off > 0; off >>= 1) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) s[u] += __shfl_xor_sync(0xffffffffu, s[u], off);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = j0 + u * wide;
      if (l == 0 && j < n) {
        logit[j] = s[u] * scale;
        mx = fmaxf(mx, s[u] * scale);
      }
    }
  }
  // the first kUnroll V rows of the lane's first rank, requested now: they
  // land while the softmax runs
  const int slot = tw * kpw + seg;
  uint4 w[kUnroll];
  {
    const int a = team * n / ranks, end = (team + 1) * n / ranks;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int jj = a + slot + u * kps;
      if (team < ranks && jj < end)
        w[u] = __ldg(reinterpret_cast<const uint4*>(vb + jj * stride));
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  if (lane == 0) red[warp] = mx;
  __syncthreads();
  mx = red[lane < warps ? lane : 0];  // the warps' maxima, folded by shuffles
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));

  // 2. each rank's sum of exp(logit - max), by its team, in the order of a
  // CTA of a cluster; the total over the ranks in rank order
  for (int r = team; r < ranks; r += teams) {
    const int a = r * n / ranks, end = (r + 1) * n / ranks;
    float sum = 0.f;
    for (int j = a + tt; j < end; j += kThreads) {
      const float e = expf(logit[j] - mx);
      logit[j] = e;
      sum += e;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (lane == 0) sums[r * kWarps + tw] = sum;
  }
  __syncthreads();
  float total = 0.f;
  for (int r = 0; r < ranks; ++r) {
    float t = sums[r * kWarps];
#pragma unroll
    for (int i = 1; i < kWarps; ++i) t += sums[r * kWarps + i];
    total = r == 0 ? t : total + t;
  }
  for (int r = team; r < ranks; r += teams) {  // p_j, by the thread that wrote e_j
    const int a = r * n / ranks, end = (r + 1) * n / ranks;
    for (int j = a + tt; j < end; j += kThreads) {
      const float pj = logit[j] / total;
      logit[j] = kRoundP ? round_bf16(pj) : pj;
    }
  }
  __syncthreads();

  // 3. each rank's V rows, by its team: each lane over its keys in order
  for (int r = team; r < ranks; r += teams) {
    const int a = r * n / ranks, end = (r + 1) * n / ranks;
    float acc[kVpl];
#pragma unroll
    for (int e = 0; e < kVpl; ++e) acc[e] = 0.f;
    for (int j = a + slot; j < end; j += kUnroll * kps) {
      float pj[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int jj = j + u * kps;
        if (jj < end) {
          pj[u] = logit[jj];
          // w holds the first step of the team's first rank already
          if (r != team || j != a + slot)
            w[u] = __ldg(reinterpret_cast<const uint4*>(vb + jj * stride));
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (j + u * kps < end) {
          float f[kVpl];
          widen<KV, kRound>(w[u], f);
#pragma unroll
          for (int e = 0; e < kVpl; ++e) acc[e] = fmaf(pj[u], f[e], acc[e]);
        }
      }
    }
    for (int off = lpk; off < 32; off <<= 1) {
#pragma unroll
      for (int e = 0; e < kVpl; ++e) acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], off);
    }
    if (seg == 0) {
#pragma unroll
      for (int e = 0; e < kVpl; ++e) rows[(r * kWarps + tw) * D + l * kVpl + e] = acc[e];
    }
  }
  __syncthreads();

  // 4. the (rank, warp) rows in order, rounded once
  for (int c = threadIdx.x; c < D; c += nthreads) {
    float v = 0.f;
    for (int slot = 0; slot < ranks * kWarps; ++slot) v += rows[slot * D + c];
    store(out + static_cast<size_t>(bh) * D + c, v);
  }
}

// A (b, h) alone: grid B * H CTAs of `teams` teams, no cluster (the many
// warps of a large batch hide the loads' latency; no cluster step is paid).
template <typename QT, int KV>
__global__ void __launch_bounds__(kSoloTeams * kThreads, 2)
    decode_attention_solo_kernel(const QT* __restrict__ q, const uint8_t* __restrict__ kc,
                                 const uint8_t* __restrict__ vc, const void* __restrict__ pos,
                                 int pos64, QT* __restrict__ out, int S, int H, int D,
                                 long long q_sb, long long q_sh, long long kv_sb, int vr, int mk,
                                 int lpk, float scale) {
  constexpr int kVpl = 16 / element_bytes<KV>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int l = threadIdx.x & (lpk - 1);
  const long long p = pos64 ? static_cast<const long long*>(pos)[b]
                            : static_cast<long long>(static_cast<const int*>(pos)[b]);
  float qv[kVpl];
  const QT* qp = q + b * q_sb + h * q_sh + l * kVpl;
#pragma unroll
  for (int i = 0; i < kVpl; ++i) qv[i] = to_float(qp[i]);
  const int n = p < 0 ? 1 : (p >= S ? S : static_cast<int>(p) + 1);
  solo_body<QT, KV>(qv, kc, vc, out, n, bh, b, h, H, D, kv_sb, vr, mk, lpk, scale, smem_raw, S,
                    vr);
}

// Floats of the partial rows pushed to one rank, for any R <= vr ranks with
// keys: R x kWarps rows of ceil(D / R) columns <= kWarps (D + vr - 1), rounded
// up to whole 16 bytes.
__host__ __device__ inline int recv_floats(int D, int vr) {
  return (kWarps * (D + vr - 1) + 3) & ~3;
}

// Grid: B * H * vr CTAs in clusters of vr, cluster b * H + h; CTA r of a
// cluster is logical rank r.  The R = min(vr, ceil(n / mk)) ranks with keys
// take keys [r n / R, (r + 1) n / R), at most kpr of them, through
// `tile`-key tiles, K tiles then V tiles, sequence element i in ring buffer
// i % stages (stages 2 or 4; a tile of several holds whole steps of keys).
// Within a tile, lane (seg, l), seg = lane / lpk, l = lane % lpk, of warp w
// holds bytes [16 l, 16 l + 16) of the row of tile key jt = jt0 + w * kpw +
// seg (lpk lanes a key, kpw = 32 / lpk keys a warp, jt0 in steps of kps =
// kWarps kpw), as kernels/decode_attention.py launch_plan gives them.
template <typename QT, int KV>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    decode_attention_kernel(const QT* __restrict__ q, const uint8_t* __restrict__ kc,
                            const uint8_t* __restrict__ vc, const void* __restrict__ pos,
                            int pos64, QT* __restrict__ out, int S, int H, int D,
                            long long q_sb, long long q_sh, long long kv_sb, int vr, int mk,
                            int lpk, int kpr, int tile, int stages, float scale) {
  constexpr int kEs = element_bytes<KV>();
  constexpr int kVpl = 16 / kEs;  // values of a 16-byte slice
  constexpr bool kRound = sizeof(QT) == 2 && KV == kF32;
  constexpr bool kRoundP = sizeof(QT) == 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  DA_ENTRY();
  const int row = D * kEs;  // bytes of a K or V row
  uint8_t* ring = smem_raw;  // [stages][tile][row]
  float* logit = reinterpret_cast<float*>(smem_raw + static_cast<size_t>(stages) * tile * row);
  float* recv = logit + ((kpr + 3) & ~3);  // [R][kWarps][cols] partial rows pushed here
  float* red = recv + recv_floats(D, vr);  // [2][kWarps] the warps' max, sum
  float* maxes = red + 2 * kWarps;         // [kMaxCluster] every rank's max, pushed here
  float* sums = maxes + kMaxCluster;       // [kMaxCluster] every rank's sum, pushed here
  uint64_t* bars = reinterpret_cast<uint64_t*>(sums + kMaxCluster);  // maxes, sums, recv

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int bh = blockIdx.x / vr;
  const int b = bh / H, h = bh % H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int lpk_shift = __ffs(lpk) - 1;
  const int kpw = 32 >> lpk_shift;
  const int kps = kWarps * kpw;
  const int seg = lane >> lpk_shift, l = lane & (lpk - 1);
  // pos and q in one trip, under the barriers' set-up
  const long long p = pos64 ? static_cast<const long long*>(pos)[b]
                            : static_cast<long long>(static_cast<const int*>(pos)[b]);
  float qv[kVpl];
  const QT* qp = q + b * q_sb + h * q_sh + l * kVpl;
#pragma unroll
  for (int i = 0; i < kVpl; ++i) qv[i] = to_float(qp[i]);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < 3; ++i)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bars + i))
                   : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // a cursor is never negative; one key keeps the softmax finite if it were
  const int n = p < 0 ? 1 : (p >= S ? S : static_cast<int>(p) + 1);
  const int ranks = min(vr, (n + mk - 1) / mk);  // R, the ranks with keys
  if (rank >= ranks || ranks == 1) {
    // no keys: max -inf, sum 0 and a zero row change no rank's result, so
    // nothing is pushed; the CTA joins both cluster barriers and leaves.
    // One rank holding every key (a short cache): CTA 0 takes it alone, in
    // the same order, with no cluster step on its path
    asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
    asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
    asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
    if (rank == 0 && ranks == 1)
      solo_body<QT, KV>(qv, kc, vc, out, n, bh, b, h, H, D, kv_sb, vr, mk, lpk, scale, smem_raw,
                        kpr, 1);
    return;
  }
  const int cols = (D + ranks - 1) / ranks;  // output columns each rank finishes
  const int j0 = rank * n / ranks;
  const int len = (rank + 1) * n / ranks - j0;
  const int tiles = (len + tile - 1) / tile;
  const int seq = 2 * tiles;
  DA_MARK(1);

  const size_t stride = static_cast<size_t>(H) * row;  // bytes from one position to the next
  const size_t base = (static_cast<size_t>(b) * kv_sb + static_cast<size_t>(h) * D) * kEs +
                      static_cast<size_t>(j0) * stride;

  // 1. every K and V row of this rank requested: one commit group per ring
  // slot, stages of them now (empty past the sequence), one more per tile
  // consumed
  auto issue = [&](int i) {
    if (i < seq) {
      const int ti = i < tiles ? i : i - tiles;
      const uint8_t* src = (i < tiles ? kc : vc) + base + static_cast<size_t>(ti) * tile * stride;
      uint8_t* dst = ring + static_cast<size_t>(i & (stages - 1)) * tile * row;
      const int rows = min(tile, len - ti * tile);
      for (int c = threadIdx.x; c < (rows << lpk_shift); c += kThreads) {
        const int r = c >> lpk_shift, piece = c & (lpk - 1);
        cp_async16(dst + r * row + piece * 16, src + r * stride + piece * 16);
      }
    }
    cp_async_commit();
  };
  for (int i = 0; i < stages; ++i) issue(i);
  DA_MARK(2);

  // every rank with keys must be running, its barriers set for the bytes the
  // R ranks push to it, before another pushes to it: arrive now, wait just
  // before the first push
  if (threadIdx.x == 0) {
    const int own = min(cols, D - rank * cols);  // columns this rank finishes
    expect_bytes(bars, ranks * 4);
    expect_bytes(bars + 1, ranks * 4);
    expect_bytes(bars + 2, ranks * kWarps * max(own, 0) * 4);
  }
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");

  // 2. logits of the rank's keys, tile by tile, and each lane's max of them
  float mx = __int_as_float(0xff800000);  // -inf
  for (int i = 0; i < tiles; ++i) {
    cp_async_wait_ring(stages);
    __syncthreads();
    if (i == 0) DA_MARK(3);
    const uint8_t* buf = ring + static_cast<size_t>(i & (stages - 1)) * tile * row + l * 16;
    const int first = i * tile, rows = min(tile, len - first);
    // kUnroll steps of keys at once, uniform over the warp (shuffles below)
    for (int step = 0; step < rows; step += kUnroll * kps) {
      const int jt0 = step + warp * kpw + seg;
      float s[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int jt = jt0 + u * kps;
        const uint4 w = jt < rows ? *reinterpret_cast<const uint4*>(buf + jt * row)
                                  : make_uint4(0u, 0u, 0u, 0u);
        float f[kVpl];
        widen<KV, kRound>(w, f);
        s[u] = 0.f;
#pragma unroll
        for (int e = 0; e < kVpl; ++e) s[u] = fmaf(qv[e], f[e], s[u]);
      }
      for (int off = lpk >> 1; off > 0; off >>= 1) {
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) s[u] += __shfl_xor_sync(0xffffffffu, s[u], off);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int jt = jt0 + u * kps;
        if (l == 0 && jt < rows) {
          logit[first + jt] = s[u] * scale;
          mx = fmaxf(mx, s[u] * scale);
        }
      }
    }
    __syncthreads();  // the buffer is free again
    issue(i + stages);
  }
  DA_MARK(4);

  // 3. the rank's max pushed to every rank with keys; each reads them all
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  if (lane == 0) red[warp] = mx;
  __syncthreads();
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");  // every CTA is set
  if (threadIdx.x < ranks) {
    float m = red[0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) m = fmaxf(m, red[w]);
    const int to = static_cast<int>(threadIdx.x);
    push(peer_addr(smem_addr(maxes + rank), to), m, peer_addr(smem_addr(bars), to));
  }
  wait_bytes(bars);
  mx = maxes[0];
  for (int r = 1; r < ranks; ++r) mx = fmaxf(mx, maxes[r]);
  DA_MARK(5);

  // 4. the rank's sum of exp(logit - max) in a fixed order (per thread over
  // keys t, t + kThreads, ..., the warp, the warps in order) pushed to every
  // rank; each adds the R sums in rank order
  float sum = 0.f;
  for (int j = threadIdx.x; j < len; j += kThreads) {
    const float e = expf(logit[j] - mx);
    logit[j] = e;
    sum += e;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (lane == 0) red[kWarps + warp] = sum;
  __syncthreads();
  if (threadIdx.x < ranks) {
    float t = red[kWarps];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) t += red[kWarps + w];
    const int to = static_cast<int>(threadIdx.x);
    push(peer_addr(smem_addr(sums + rank), to), t, peer_addr(smem_addr(bars + 1), to));
  }
  wait_bytes(bars + 1);
  float total = sums[0];
  for (int r = 1; r < ranks; ++r) total += sums[r];
  // p_j = e_j / total, rounded to q's type, each key once (the thread that
  // wrote e_j)
  for (int j = threadIdx.x; j < len; j += kThreads) {
    const float pj = logit[j] / total;
    logit[j] = kRoundP ? round_bf16(pj) : pj;
  }
  DA_MARK(6);

  // 5. sum_j p_j v_j over the rank's keys: each lane over its keys in order
  float acc[kVpl];
#pragma unroll
  for (int e = 0; e < kVpl; ++e) acc[e] = 0.f;
  for (int i = tiles; i < seq; ++i) {
    cp_async_wait_ring(stages);
    __syncthreads();
    if (i == tiles) DA_MARK(7);
    const uint8_t* buf = ring + static_cast<size_t>(i & (stages - 1)) * tile * row + l * 16;
    const int first = (i - tiles) * tile, rows = min(tile, len - first);
    // kUnroll of the lane's keys loaded at once, added in order
    for (int jt0 = warp * kpw + seg; jt0 < rows; jt0 += kUnroll * kps) {
      float pj[kUnroll];
      uint4 w[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int jt = jt0 + u * kps;
        if (jt < rows) {
          pj[u] = logit[first + jt];
          w[u] = *reinterpret_cast<const uint4*>(buf + jt * row);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (jt0 + u * kps < rows) {
          float f[kVpl];
          widen<KV, kRound>(w[u], f);
#pragma unroll
          for (int e = 0; e < kVpl; ++e) acc[e] = fmaf(pj[u], f[e], acc[e]);
        }
      }
    }
    __syncthreads();
    issue(i + stages);
  }
  // the warp's key segments, then the warp's row pushed to the ranks that
  // finish its columns (slot rank * kWarps + warp there)
  for (int off = lpk; off < 32; off <<= 1) {
#pragma unroll
    for (int e = 0; e < kVpl; ++e) acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], off);
  }
  if (seg == 0) {
    const uint32_t slot = smem_addr(recv + (rank * kWarps + warp) * cols);
    if ((cols & 3) == 0) {  // 4 columns at a time: one owner, 16-byte aligned
#pragma unroll
      for (int e = 0; e < kVpl; e += 4) {
        const int d = l * kVpl + e, o = d / cols;
        push4(peer_addr(slot + (d - o * cols) * 4, o), acc + e,
              peer_addr(smem_addr(bars + 2), o));
      }
    } else {
#pragma unroll
      for (int e = 0; e < kVpl; ++e) {
        const int d = l * kVpl + e, o = d / cols;
        push(peer_addr(slot + (d - o * cols) * 4, o), acc[e], peer_addr(smem_addr(bars + 2), o));
      }
    }
  }
  DA_MARK(8);
  wait_bytes(bars + 2);
  DA_MARK(9);
  // the last cluster barrier, split: arrive once every push to this CTA has
  // landed, wait before leaving, so that no CTA leaves while one of its
  // pushes is still on its way
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");

  // 6. rank r's slice of D: the (rank, warp) rows in order, rounded once
  for (int c = threadIdx.x; c < cols && rank * cols + c < D; c += kThreads) {
    float vals[kMaxCluster * kWarps];
#pragma unroll
    for (int slot = 0; slot < kMaxCluster * kWarps; ++slot)
      vals[slot] = slot < ranks * kWarps ? recv[slot * cols + c] : 0.f;
    float v = 0.f;
#pragma unroll
    for (int slot = 0; slot < kMaxCluster * kWarps; ++slot)
      if (slot < ranks * kWarps) v += vals[slot];
    store(out + static_cast<size_t>(bh) * D + rank * cols + c, v);
  }
  DA_MARK(10);
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

struct Launch {
  const void *q, *k, *v, *pos;
  int pos64;
  void* out;
  int B, S, H, D;
  long long q_sb, q_sh, kv_sb;
  int cs, vr, mk, teams, lpk, kpr, tile, stages, smem;
  float scale;
  cudaStream_t stream;
};

template <typename QT, int KV>
int launch_solo(const Launch& a) {
  auto kernel = decode_attention_solo_kernel<QT, KV>;
  if (a.smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, a.smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<a.B * a.H, a.teams * kThreads, a.smem, a.stream>>>(
      static_cast<const QT*>(a.q), static_cast<const uint8_t*>(a.k),
      static_cast<const uint8_t*>(a.v), a.pos, a.pos64, static_cast<QT*>(a.out), a.S, a.H, a.D,
      a.q_sb, a.q_sh, a.kv_sb, a.vr, a.mk, a.lpk, a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename QT, int KV>
int launch(const Launch& a) {
  if (a.cs == 1) return launch_solo<QT, KV>(a);
  auto kernel = decode_attention_kernel<QT, KV>;
  // the opt-in holds for the current device's context: set it on each call
  // that needs it (a cheap host call), never cached across devices
  if (a.smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, a.smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(a.B * a.H * a.vr));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(a.smem);
  cfg.stream = a.stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(a.vr);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const QT*>(a.q), static_cast<const uint8_t*>(a.k),
      static_cast<const uint8_t*>(a.v), a.pos, a.pos64, static_cast<QT*>(a.out), a.S, a.H, a.D,
      a.q_sb, a.q_sh, a.kv_sb, a.vr, a.mk, a.lpk, a.kpr, a.tile, a.stages, a.scale);
  if (err != cudaSuccess) return static_cast<int>(err);
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
// kernels/decode_attention.py launch_plan says: vr logical ranks of at
// least mk keys, lpk lanes a key; cs = vr: clusters of one CTA a rank, at
// most kpr keys a rank, tiles of `tile` keys through a ring of `stages`
// buffers; cs = 1: a CTA of `teams` teams a (b, h) alone (tile and stages
// unused); smem bytes of dynamic shared memory.  q_kind: 0 float32, 1
// bfloat16; kv_kind: 0 float32, 1 bfloat16, 2 float8_e4m3fn, 3 float8_e5m2.
// Strides in elements: q_sb, q_sh of q (D contiguous); kv_sb of both caches
// ([S, H, D] contiguous).  pos64 = 1 for int64 pos, 0 for int32.  lpk
// 16-byte slices must make a row (a power of two up to 32), D <= 256, 1 <=
// S <= 8192, 1 <= vr <= 8, teams 1 (cs = vr) or at most min(vr, kSoloTeams)
// (cs = 1), kpr cover a rank's largest share, a tile of several hold whole
// steps of keys, the ring fit kRingBytes, smem hold what the kernel lays out
// within 227 KB; the caches' base and batch stride 16-byte aligned.  Returns
// a cudaError_t.
extern "C" int pt_decode_attention(const void* q, const void* k, const void* v, const void* pos,
                                   int pos64, void* out, int B, int S, int H, int D,
                                   long long q_sb, long long q_sh, long long kv_sb, int q_kind,
                                   int kv_kind, int cs, int vr, int mk, int teams, int lpk,
                                   int kpr, int tile, int stages, int smem, float scale,
                                   void* stream_ptr) {
  const int es = kv_kind == kF32 ? 4 : kv_kind == kBf16 ? 2 : 1;
  if (B < 1 || H < 1 || S < 1 || S > kMaxPositions || D < 1 || D > kMaxDim || vr < 1 ||
      vr > kMaxCluster || (cs != 1 && cs != vr) || mk < 1 || teams < 1 ||
      teams > (cs == 1 ? (vr < kSoloTeams ? vr : kSoloTeams) : 1) || lpk < 1 || lpk > 32 ||
      (lpk & (lpk - 1)) != 0 || lpk * 16 != D * es || kv_kind < 0 || kv_kind > kE5m2 ||
      (q_kind != 0 && q_kind != 1) || smem > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  if (cs == 1) {  // a (b, h) alone: the logits and the rows in shared memory
    if (smem < static_cast<long long>(solo_floats(S, D, vr)) * sizeof(float))
      return static_cast<int>(cudaErrorInvalidValue);
  } else {
    const int share = (S + vr - 1) / vr;  // a rank's largest share
    const int kps = kWarps * 32 / lpk;
    const long long staged =
        static_cast<long long>(stages) * tile * D * es +
        (((kpr + 3) & ~3) + recv_floats(D, vr) + 2 * kWarps + 2 * kMaxCluster) *
            static_cast<long long>(sizeof(float)) +
        3 * static_cast<long long>(sizeof(uint64_t));
    // a lone rank of at most kpr keys goes through solo_body
    const long long alone = static_cast<long long>(solo_floats(kpr, D, 1)) * sizeof(float);
    if ((stages != 2 && stages != kRingStages) || kpr < (S < mk ? S : mk) || kpr < share ||
        kpr > S || tile < 1 || (tile < kpr && tile % kps != 0) ||
        static_cast<long long>(stages) * tile * D * es > kRingBytes || smem < staged ||
        smem < alone)
      return static_cast<int>(cudaErrorInvalidValue);
  }
  const Launch a{q,     k,  v,  pos, pos64, out,   B,   S,    H,      D,    q_sb,  q_sh,
                 kv_sb, cs, vr, mk,  teams, lpk,   kpr, tile, stages, smem, scale,
                 static_cast<cudaStream_t>(stream_ptr)};
  return q_kind == 1 ? dispatch<__nv_bfloat16>(kv_kind, a) : dispatch<float>(kv_kind, a);
}

#ifdef DA_PROBE
// The probe's records: [kProbeCtas][12] unsigned 64-bit words into `host`.
extern "C" int pt_probe_read(void* host) {
  return static_cast<int>(cudaMemcpyFromSymbol(host, probe_t, sizeof(probe_t)));
}
#endif
