// Fused score + softmax + V attention (Atleus MHA-2/MHA-3) for Hopper
// (sm_90a), on the tensor cores, with a contiguous and a paged entry point.
//
// Replaces: the Pallas TPU kernel `flash_attention_kernel` in
//   src/repro/kernels/flash_attention/kernel.py (body _attn_kernel):
//   s = (q * D^-1/2) . k, optional softcap c * tanh(s / c), mask
//   0 <= kv_pos <= q_pos (and q_pos - kv_pos < window), online softmax and
//   p . v, all in f32, GQA through head // group; a row that sees no key
//   gives 0. `paged_flash_attention` computes the same function with K/V
//   read straight from one layer's page pool (P, Hkv, page, D) through the
//   block table, in place of the gather that materializes the context in
//   src/repro/models/attention.py (_paged_attend).
//
// Precision: 3xTF32. Both products (q.k and p.v) multiply two inexact f32
//   operands, and the port holds the kernel to 2e-5 of the f32 result. One
//   TF32 rounding of each operand leaves ~1e-3 and two bf16 pieces ~1.5e-5
//   (75% of the tolerance) at causal T = S = 512, D = 64. So each operand
//   x is split into big = x rounded to TF32 and small = x - big (exact)
//   truncated to TF32, and each product is small.big + big.small +
//   big.big on mma.sync.m16n8k8 tf32 with f32 accumulation; small.small
//   and small's truncation leave ~2^-20 |x||y|. The split is two integer
//   ops, a subtract and a mask, cheaper than two cvt.rna.tf32.f32 (each
//   warp splits every K/V value it reads). tests/test_torch_flash_split.py
//   emulates the scheme (tiles, pieces, online softmax, the split-KV
//   combine) on the CPU and shows one TF32 piece failing the tolerance.
//
// What bounds it on H100: at decode (one query row per slot) the kernel
//   reads each kv head's visible K/V once for 4*D*G flops per key, so it
//   is bound by bytes (8 KB per key across the 8 kv heads at D = 64). At
//   prefill (T = S = 512, causal) it does ~T*S/2*4*D flops per q head
//   against scores that never leave the SM: bound by tensor-core
//   operations (three TF32 products at 495 TFLOP/s).
//
// What the design does about it:
//   - One block of 4 warps per (batch row, kv head, row tile[, KV split]).
//     Its rows are (query row, q head) pairs of that kv head's GQA group,
//     row R = t * G + g, so each K/V tile is read once per group and row
//     tile and shared by all G q heads.
//   - Prefill and chunks (G*T > 16 rows): 64-row tiles, 16 rows a warp;
//     K/V tiles of 64 keys stream through a double-buffered cp.async ring
//     in dynamic shared memory that all warps share. Rows are padded (K to
//     D + 8 floats, V to D + 4) so that the fragment loads are free of
//     bank conflicts; K's are 8-byte loads (the d order inside a k8 step
//     is permuted to match).
//   - Decode (G*T <= 16 rows: 4 at llama's G = 4): warp split. All 4
//     warps hold the same 16 rows, and warp w takes every 4th live tile
//     (16 keys) through two buffers of its own (its next tile lands while
//     it computes); the warps' (m, l, acc) are combined in shared memory
//     in warp order. Operands are not swapped
//     (12 of the 16 mma rows idle at G = 4): the decode kernel waits on
//     bytes and latency, not on the tensor cores, and one fragment layout
//     serves both kernels.
//   - The paged kernel loads the block's block-table row into shared
//     memory once; each key is D*4 contiguous bytes of its page, copied as
//     16-byte chunks. Keys that cannot be read (a -1 page, past lens +
//     chunk_lens or past S) are zero-filled and masked.
//   - Scores sit in mma accumulator fragments; softcap and the mask apply
//     there, then the online softmax (FA2 form: running max m, sum l and
//     the output accumulator in registers, expf in f32). The accumulator
//     layout of the score mma is reused as the A operand of p.v by
//     permuting the keys inside each 8-key step (logical k = t is key 2t,
//     k = t + 4 is key 2t + 1; V's B fragment follows the same order), so
//     p never leaves registers.
//   - Tile skipping: before the loop each block lists the tiles that hold
//     a key some row of the block may see, from the positions themselves
//     (the contiguous kernel scans kv_pos, so any explicit positions
//     work; the paged kernel reads its block-table row and stops at
//     min(lens + chunk_lens, max q_pos + 1)). A tile outside the list is
//     neither loaded nor multiplied: causal prefill skips the upper
//     triangle, decode reads only the live context.
//   - Split-KV when the row tiles leave SMs idle (decode; also prefill of
//     one short sequence): the live tiles are split evenly over up to
//     kMaxSplit blocks, aiming at two blocks per SM. Each block writes its
//     rows' (m, l, acc) to a workspace that the wrapper owns (one per
//     stream); a ticket elects the block that finishes last, which
//     combines the partials in split order (a split that saw no key has
//     l = 0 and weighs 0) and rearms the ticket. One launch, no atomics
//     on the output: the same inputs give the same bits.
//   Not yet: wgmma, TMA and warp specialisation (an FA3-style forward).
//
// Backward (`flash_attention_bwd`, for LoRA fine-tuning): replaces the
//   FlashAttention-2 backward that the JAX package writes in plain JAX as
//   the custom VJP of its blocked attention (src/repro/models/attention.py,
//   _flash_bwd_scoped): from (q, k, v, out, lse, dout) it recomputes
//   p = exp(cap(s) - lse) under the same mask, with D_i = sum(dout . out)
//   per row, ds = p (dp - D_i) times the softcap's 1 - tanh^2, dv = p^T
//   dout, dk = ds^T (q D^-1/2) and dq = ds k D^-1/2; dk and dv sum over the
//   GQA group that shares a kv head. Bound at the training shapes (T = S =
//   512, causal) by arithmetic (f32, ~14 D flops per visible pair over
//   both kernels against O((T + S) D) bytes). Design (simple and right
//   first): f32 FMAs outside the tensor cores, three kernels, no atomics
//   (the same inputs give the same bits):
//   - flash_bwd_delta_kernel: D_i, one warp per row.
//   - flash_bwd_dkdv_kernel<D>: one block per (64 keys, batch row, kv
//     head); K and V stay in shared memory while the block walks the
//     group's query rows (R = t G + g, as the forward) 64 at a time: S and
//     dP as 4 x 4 register tiles a thread, p and ds to shared memory, then
//     dK and dV accumulate in registers. Query tiles that no key of the
//     block can see (causal, window) are skipped.
//   - flash_bwd_dq_kernel<D>: one block per (64 query rows, batch row, kv
//     head) walks the key tiles some row can see, recomputes S, dP and ds,
//     and accumulates dq in registers.
//   Rows padded to D + 1 floats keep the shared-memory reads free of bank
//   conflicts. Not yet: tensor cores, one fused kernel.
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kMaxSplit = 32;   // KV splits of one row tile, at most

// Floats of the ring: 128 key rows of K and V (two stages of 64-key tiles,
// or two 16-key tiles for each of four warps), and room for the combines'
// scratch (which reuses it after the loop).
constexpr int kRingKeys = 128;
__host__ __device__ constexpr int ring_floats(int D, int RB) {
  return kRingKeys * (2 * D + 12) > RB * (2 * kMaxSplit + 1)
             ? kRingKeys * (2 * D + 12)
             : RB * (2 * kMaxSplit + 1);
}

struct Params {
  const float* q;
  const float* k;
  const float* v;
  const int* q_pos;
  const int* kv_pos;        // contiguous only
  const int* block_table;   // paged only (nullptr: contiguous)
  const int* lens;
  const int* chunk_lens;
  float* out;
  float* lse;               // (B, Hq, T) log-sum-exp of each row, or null
  float* partials;          // splits > 1: [tile][split][RB][D + 2]
  int* tickets;             // splits > 1: [tile]
  int T, Hq, Hkv, G, S, nb, page, window;
  float softcap, scale;
  int rows, row_tiles, splits, n_tiles;
};

// ---------------------------------------------------------------------------
// device helpers
// ---------------------------------------------------------------------------

// x = big + small + O(2^-21 |x|), both TF32 (the low 13 bits zero): big
// is x rounded to nearest, ties away (as cvt.rna.tf32.f32, in two integer
// ops), small the exact rest x - big, truncated.
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big)) & 0xffffe000u;
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a.b in 3xTF32: small.big + big.small + big.big
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ab)[4],
                                     const uint32_t (&as)[4], uint32_t bb0,
                                     uint32_t bb1, uint32_t bs0, uint32_t bs1) {
  mma_tf32(d, as, bb0, bb1);
  mma_tf32(d, ab, bs0, bs1);
  mma_tf32(d, ab, bb0, bb1);
}

// cp.async of `bytes` (<= size) from global, zero-filling the rest
__device__ __forceinline__ void cp_async16(void* s, const void* g, int bytes) {
  const uint32_t sa = static_cast<uint32_t>(__cvta_generic_to_shared(s));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(sa),
               "l"(g), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* s, const void* g) {
  const uint32_t sa = static_cast<uint32_t>(__cvta_generic_to_shared(s));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(sa), "l"(g)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// A ticket of a split-KV sum: the returned count tells a block whether it
// is the last of its row tile. acq_rel at gpu scope: after a
// __syncthreads, it publishes the block's partial stores (release) and,
// for the last block, makes every other block's visible to the loads
// after the next __syncthreads (acquire).
__device__ __forceinline__ int draw_ticket(int* ticket) {
  int old;
  asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;\n"
               : "=r"(old)
               : "l"(ticket)
               : "memory");
  return old;
}

// ---------------------------------------------------------------------------
// the kernel
// ---------------------------------------------------------------------------

constexpr int kWarps = 4;   // warps of a block

// Grid (splits, row_tiles, B * Hkv), kWarps warps a block.
// q, out: (B, T, Hq, D); q_pos: (B, T). Row R of (b, h) is query row
//   R / G of q head h * G + R % G.
// Contiguous: k, v (B, S, Hkv, D), kv_pos (B, S).
// Paged: k, v are one layer's pool (P, Hkv, page, D); key s of row b lives
//   in page block_table[b, s / page] at row s % page; it is visible iff
//   that entry is >= 0 and s < lens[b] + chunk_lens[b], and its position
//   is s.
// Two ways to cut a block's work (WS):
//   rows (WS false): 64 rows, each warp its own 16; tiles of 64 keys in a
//     ring of two stages that all warps share.
//   warp split (WS true, G*T <= 16 rows: decode): 16 rows that every warp
//     holds; warp w takes every kWarps-th tile of 16 keys through two
//     buffers of its own, and the warps' (m, l, acc) are combined in
//     shared memory (in warp order) before the block's epilogue.
// Fragments (g = lane / 4, t = lane % 4): the m16n8k8 accumulator holds
//   (row g, cols 2t, 2t+1) and (row g + 8, same cols); A holds (g, t),
//   (g + 8, t), (g, t + 4), (g + 8, t + 4); B holds (k t, n g), (k t + 4,
//   n g).
template <int D, bool WS>
__global__ void __launch_bounds__(kWarps * 32, 3)
flash_kernel(const Params p) {
  constexpr int NW = kWarps, NT = NW * 32;
  constexpr int KT = WS ? 16 : 64;     // keys of a tile
  constexpr int RB = WS ? 16 : 16 * NW;   // rows of a block
  constexpr int LDK = D + 8;           // padded shared K row, floats
  constexpr int LDV = D + 4;           // padded shared V row, floats
  constexpr int KS = D / 8;            // k8 steps over D
  constexpr int NJ = KT / 8;           // 8-key steps over a tile
  constexpr int CH = D / 4;            // 16-byte chunks of one key row
  constexpr int kBuf = KT * (LDK + LDV);   // one tile: K then V, floats
  static_assert(NJ * 4 <= 32, "the visibility mask is one word");
  static_assert((WS ? 2 * NW : 2) * kBuf <= ring_floats(D, RB),
                "the ring holds the tile buffers");
  static_assert(RB * (2 * kMaxSplit + 1) <= ring_floats(D, RB) &&
                    (!WS || NW * 16 * (D + 2) <= ring_floats(D, RB)),
                "the ring holds the combines' scratch");

  extern __shared__ __align__(16) float smem[];
  float* ring = smem;   // tile buffers, then the combines' scratch
  int* kpos_s = reinterpret_cast<int*>(smem + ring_floats(D, RB));
  int* live = kpos_s + kRingKeys;  // kpos_s: [buffers][KT]; live: [n_tiles]
  int* bt_s = live + p.n_tiles;    // [nb]
  __shared__ int s_minq[NW], s_maxq[NW], s_count;
  __shared__ bool s_last;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int split = blockIdx.x, rt = blockIdx.y;
  const int bh = blockIdx.z, b = bh / p.Hkv, h = bh % p.Hkv;
  const bool paged = p.block_table != nullptr;
  const int row0 = rt * RB, wrow0 = row0 + (WS ? 0 : warp * 16);
  const bool warp_live = wrow0 < p.rows;
  // the warps whose rows the epilogue writes (warp split: warp 0 holds
  // the combined rows)
  const bool holds = WS ? warp == 0 : warp_live;

  int s_end = p.S;   // keys past this are invisible to every row
  if (paged) {
    for (int i = tid; i < p.nb; i += NT)
      bt_s[i] = p.block_table[static_cast<size_t>(b) * p.nb + i];
    s_end = min(p.nb * p.page, p.lens[b] + p.chunk_lens[b]);
  }

  // this thread's rows g and g + 8: positions, and the block's range
  int qp[2];
  size_t qoff[2];
  int mn = INT_MAX, mx = INT_MIN;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int R = wrow0 + g + 8 * r;
    const int tq = R / p.G, gq = R - tq * p.G;
    qoff[r] = ((static_cast<size_t>(b) * p.T + tq) * p.Hq + h * p.G + gq) * D;
    qp[r] = -1;   // an absent row sees no key
    if (R < p.rows) {
      qp[r] = p.q_pos[static_cast<size_t>(b) * p.T + tq];
      mn = min(mn, qp[r]);
      mx = max(mx, qp[r]);
    }
  }
  mn = __reduce_min_sync(0xffffffffu, mn);
  mx = __reduce_max_sync(0xffffffffu, mx);
  if (lane == 0) {
    s_minq[warp] = mn;
    s_maxq[warp] = mx;
  }
  __syncthreads();
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    mn = min(mn, s_minq[w]);
    mx = max(mx, s_maxq[w]);
  }
  const long long lo_ll =
      p.window > 0 ? static_cast<long long>(mn) - p.window + 1 : 0;
  const int lo = static_cast<int>(lo_ll < 0 ? 0 : lo_ll);
  const int hi = mx;   // a visible key's position lies in [lo, hi]

  // the tiles holding a key that some row of the block may see
  for (int tile = tid; tile < p.n_tiles; tile += NT) {
    const int s0 = tile * KT;
    bool any = false;
    if (paged) {
      const int a = max(s0, lo), e = min(min(s0 + KT, s_end), hi + 1) - 1;
      for (int pg = a / p.page; a <= e && pg <= e / p.page; ++pg)
        any |= bt_s[pg] >= 0;
    } else if (lo <= hi) {
      const int* kp = p.kv_pos + static_cast<size_t>(b) * p.S + s0;
      if (p.S % 4 == 0) {   // whole int4s, all loads in flight at once
        int4 v[KT / 4];
#pragma unroll
        for (int j = 0; j < KT / 4; ++j)
          v[j] = s0 + 4 * j < p.S ? reinterpret_cast<const int4*>(kp)[j]
                                  : make_int4(-1, -1, -1, -1);
#pragma unroll
        for (int j = 0; j < KT / 4; ++j)
          any |= (v[j].x >= lo && v[j].x <= hi) |
                 (v[j].y >= lo && v[j].y <= hi) |
                 (v[j].z >= lo && v[j].z <= hi) |
                 (v[j].w >= lo && v[j].w <= hi);
      } else {
        const int n = min(KT, p.S - s0);
#pragma unroll 8
        for (int j = 0; j < n; ++j) {
          const int pos = kp[j];
          any |= pos >= lo && pos <= hi;
        }
      }
    }
    live[tile] = any;
  }
  __syncthreads();
  if (warp == 0) {   // compact in place, in tile order
    int count = 0;
    for (int base = 0; base < p.n_tiles; base += 32) {
      const int i = base + lane;
      const bool f = i < p.n_tiles && live[i];
      const unsigned bal = __ballot_sync(0xffffffffu, f);
      if (f) live[count + __popc(bal & ((1u << lane) - 1u))] = i;
      count += __popc(bal);
    }
    if (lane == 0) s_count = count;
  }
  __syncthreads();
  const int count = s_count;
  const int i0 = static_cast<int>(static_cast<long long>(count) * split /
                                  p.splits);
  const int i1 = static_cast<int>(static_cast<long long>(count) *
                                  (split + 1) / p.splits);

  // copy tile `tile` into buffer `bi`, threads `first`, first + `step`, ...
  auto issue = [&](int tile, int bi, int first, int step) {
    const int s0 = tile * KT;
    float* ks = ring + bi * kBuf;
    float* vs = ks + KT * LDK;
    for (int c = first; c < KT * CH; c += step) {
      const int j = c / CH, part = c - j * CH;
      const int s = s0 + j;
      size_t off = 0;
      bool ok;
      if (paged) {
        const int pid = s < s_end ? bt_s[s / p.page] : -1;
        ok = pid >= 0;
        if (ok)
          off = ((static_cast<size_t>(pid) * p.Hkv + h) * p.page +
                 s % p.page) * D;
      } else {
        ok = s < p.S;
        if (ok) off = ((static_cast<size_t>(b) * p.S + s) * p.Hkv + h) * D;
      }
      off += part * 4;
      cp_async16(ks + j * LDK + part * 4, p.k + (ok ? off : 0), ok ? 16 : 0);
      cp_async16(vs + j * LDV + part * 4, p.v + (ok ? off : 0), ok ? 16 : 0);
    }
    int* kps = kpos_s + bi * KT;
    for (int j = first; j < KT; j += step) {
      const int s = s0 + j;
      if (paged)
        kps[j] = s < s_end && bt_s[s / p.page] >= 0 ? s : -1;
      else if (s < p.S)
        cp_async4(kps + j, p.kv_pos + static_cast<size_t>(b) * p.S + s);
      else
        kps[j] = -1;
    }
  };

  // the first tile's copy is in flight while q is loaded
  if (WS) {
    if (i0 + warp < i1) issue(live[i0 + warp], 2 * warp, lane, 32);
  } else if (i0 < i1) {
    issue(live[i0], 0, tid, NT);
  }
  cp_async_commit();

  // q fragments of this warp's rows, scaled, as TF32 pieces. Inside each
  // k8 step the d order is free (it is summed over): logical k = t is
  // d = 2t and k = t + 4 is d = 2t + 1, for q here and for K below, so
  // each thread's two values of a row are one 8-byte load.
  uint32_t qb[KS][4], qs[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float2 x = make_float2(0.f, 0.f);
      if (wrow0 + g + 8 * r < p.rows)
        x = *reinterpret_cast<const float2*>(p.q + qoff[r] + kk * 8 + 2 * t);
      split_tf32(x.x * p.scale, qb[kk][r], qs[kk][r]);
      split_tf32(x.y * p.scale, qb[kk][r + 2], qs[kk][r + 2]);
    }

  float acc[KS][4];
#pragma unroll
  for (int n = 0; n < KS; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  // one tile of this warp's rows from buffer bi: scores, softcap, mask,
  // online softmax, acc += p . v
  auto compute = [&](int bi) {
    const float* ks = ring + bi * kBuf;
    const float* vs = ks + KT * LDK;
    const int* kps = kpos_s + bi * KT;

    float sc[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float2 kv = *reinterpret_cast<const float2*>(
            ks + (j * 8 + g) * LDK + kk * 8 + 2 * t);
        uint32_t bb0, bs0, bb1, bs1;
        split_tf32(kv.x, bb0, bs0);
        split_tf32(kv.y, bb1, bs1);
        mma3(sc[j], qb[kk], qs[kk], bb0, bb1, bs0, bs1);
      }

    uint32_t vis = 0;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kp = kps[j * 8 + 2 * t + (e & 1)];
        const int q = qp[e >> 1];
        bool ok = kp >= 0 && kp <= q;
        if (p.window > 0) ok = ok && q - kp < p.window;
        float s = sc[j][e];
        if (p.softcap > 0.f) s = p.softcap * tanhf(s / p.softcap);
        sc[j][e] = ok ? s : kNegInf;
        vis |= static_cast<uint32_t>(ok) << (j * 4 + e);
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        mx = fmaxf(mx, fmaxf(sc[j][2 * r], sc[j][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[r], mx);
      const float corr = expf(m[r] - m_new);
      m[r] = m_new;
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 2 * r; e < 2 * r + 2; ++e) {
          const float pe = (vis >> (j * 4 + e)) & 1u
                               ? expf(sc[j][e] - m_new) : 0.f;
          sc[j][e] = pe;
          rs += pe;
        }
      l[r] = l[r] * corr + rs;
#pragma unroll
      for (int n = 0; n < KS; ++n) {
        acc[n][2 * r] *= corr;
        acc[n][2 * r + 1] *= corr;
      }
    }

    // acc += p . v; logical k t <-> key 2t, k t + 4 <-> key 2t + 1
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      uint32_t pb[4], ps[4];
      split_tf32(sc[j][0], pb[0], ps[0]);
      split_tf32(sc[j][2], pb[1], ps[1]);
      split_tf32(sc[j][1], pb[2], ps[2]);
      split_tf32(sc[j][3], pb[3], ps[3]);
      const float* v0 = vs + (j * 8 + 2 * t) * LDV + g;
#pragma unroll
      for (int n = 0; n < KS; ++n) {
        uint32_t bb0, bs0, bb1, bs1;
        split_tf32(v0[n * 8], bb0, bs0);
        split_tf32(v0[LDV + n * 8], bb1, bs1);
        mma3(acc[n], pb, ps, bb0, bb1, bs0, bs1);
      }
    }
  };

  if (WS) {
    // warp w: tiles i0 + w, i0 + w + NW, ... through its own two buffers
    for (int i = i0 + warp, it = 0; i < i1; i += NW, ++it) {
      if (i + NW < i1) issue(live[i + NW], 2 * warp + ((it + 1) & 1), lane, 32);
      cp_async_commit();
      cp_async_wait<1>();
      __syncwarp();   // tile i has landed for every lane
      compute(2 * warp + (it & 1));
      __syncwarp();   // every lane is done with its buffer
    }
  } else {
    for (int i = i0; i < i1; ++i) {
      const int stage = (i - i0) & 1;
      if (i + 1 < i1) issue(live[i + 1], stage ^ 1, tid, NT);
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();   // tile i has landed for every thread
      if (warp_live) compute(stage);
      __syncthreads();   // every warp is done with this stage
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }

  if (WS) {
    // combine the warps' (m, l, acc) of the same 16 rows into warp 0, in
    // warp order (a warp that saw no key has l = 0 and weighs 0)
    __syncthreads();   // every buffer is consumed: the ring is free
    float* xa = ring;                     // [NW][16][D]
    float* xm = ring + NW * 16 * D;       // [NW][16][2]
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int rl = g + 8 * r;
#pragma unroll
      for (int n = 0; n < KS; ++n)
        *reinterpret_cast<float2*>(xa + (warp * 16 + rl) * D + n * 8 +
                                   2 * t) =
            make_float2(acc[n][2 * r], acc[n][2 * r + 1]);
      if (t == 0)
        *reinterpret_cast<float2*>(xm + 2 * (warp * 16 + rl)) =
            make_float2(m[r], l[r]);
    }
    __syncthreads();
    if (warp == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int rl = g + 8 * r;
        float M = kNegInf, wt[NW];
#pragma unroll
        for (int w = 0; w < NW; ++w) {
          const float2 ml = *reinterpret_cast<const float2*>(
              xm + 2 * (w * 16 + rl));
          if (ml.y > 0.f) M = fmaxf(M, ml.x);
        }
        float L = 0.f;
#pragma unroll
        for (int w = 0; w < NW; ++w) {
          const float2 ml = *reinterpret_cast<const float2*>(
              xm + 2 * (w * 16 + rl));
          wt[w] = ml.y > 0.f ? expf(ml.x - M) : 0.f;
          L += ml.y * wt[w];
        }
#pragma unroll
        for (int n = 0; n < KS; ++n) {
          float2 sum = make_float2(0.f, 0.f);
#pragma unroll
          for (int w = 0; w < NW; ++w) {
            const float2 a = *reinterpret_cast<const float2*>(
                xa + (w * 16 + rl) * D + n * 8 + 2 * t);
            sum.x = fmaf(a.x, wt[w], sum.x);
            sum.y = fmaf(a.y, wt[w], sum.y);
          }
          acc[n][2 * r] = sum.x;
          acc[n][2 * r + 1] = sum.y;
        }
        m[r] = M;
        l[r] = L;
      }
    }
  }

  if (p.splits == 1) {
    if (!holds) return;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int R = wrow0 + g + 8 * r;
      if (R >= p.rows) continue;
      if (p.lse != nullptr && t == 0) {
        const int tq = R / p.G;
        p.lse[(static_cast<size_t>(b) * p.Hq + h * p.G + (R - tq * p.G)) *
                  p.T + tq] = m[r] + logf(fmaxf(l[r], 1e-30f));
      }
      const float inv = 1.f / fmaxf(l[r], 1e-30f);
      float* o = p.out + qoff[r] + 2 * t;
#pragma unroll
      for (int n = 0; n < KS; ++n)
        *reinterpret_cast<float2*>(o + n * 8) =
            make_float2(acc[n][2 * r] * inv, acc[n][2 * r + 1] * inv);
    }
    return;
  }

  // split-KV: store this split's rows, then the last block of the row
  // tile combines all splits in split order
  const size_t tile_id = static_cast<size_t>(bh) * p.row_tiles + rt;
  constexpr int kPart = RB * (D + 2);   // acc [RB][D], then (m, l) [RB]
  float* parts = p.partials + tile_id * p.splits * kPart;
  if (holds) {
    float* mine = parts + static_cast<size_t>(split) * kPart;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int rl = wrow0 - row0 + g + 8 * r;
      if (row0 + rl >= p.rows) continue;
      if (l[r] > 0.f) {
#pragma unroll
        for (int n = 0; n < KS; ++n)
          *reinterpret_cast<float2*>(mine + rl * D + n * 8 + 2 * t) =
              make_float2(acc[n][2 * r], acc[n][2 * r + 1]);
      }
      if (t == 0)
        *reinterpret_cast<float2*>(mine + RB * D + 2 * rl) =
            make_float2(m[r], l[r]);
    }
  }
  __syncthreads();
  if (tid == 0) s_last = draw_ticket(p.tickets + tile_id) == p.splits - 1;
  __syncthreads();
  if (!s_last) return;

  // weights exp(m_j - M) of each split's rows (0 for a split that saw no
  // key) and 1 / sum_j l_j w_j, in shared memory (the ring is free). The
  // loads of all splits are issued before any is used (from L2: __ldcg,
  // this SM's L1 is not coherent with the other blocks' stores).
  float* wsm = ring;                      // [RB][kMaxSplit]: m_j, then w_j
  float* lsm = ring + RB * kMaxSplit;     // [RB][kMaxSplit]: l_j
  float* inv_s = lsm + RB * kMaxSplit;    // [RB]
  const int n_rows = min(RB, p.rows - row0);
  constexpr int kInFlight = 4;   // (row, split) loads a thread has in flight
  for (int f0 = 0; f0 < n_rows * p.splits; f0 += kInFlight * NT) {
    float2 ml[kInFlight];
#pragma unroll
    for (int q = 0; q < kInFlight; ++q) {
      const int f = f0 + q * NT + tid;
      const int rl = f / p.splits, j = f - rl * p.splits;
      ml[q] = f < n_rows * p.splits
                  ? __ldcg(reinterpret_cast<const float2*>(
                        parts + static_cast<size_t>(j) * kPart + RB * D +
                        2 * rl))
                  : make_float2(0.f, 0.f);
    }
#pragma unroll
    for (int q = 0; q < kInFlight; ++q) {
      const int f = f0 + q * NT + tid;
      const int rl = f / p.splits, j = f - rl * p.splits;
      if (f < n_rows * p.splits) {
        wsm[rl * kMaxSplit + j] = ml[q].x;
        lsm[rl * kMaxSplit + j] = ml[q].y;
      }
    }
  }
  __syncthreads();
  for (int rl = tid; rl < n_rows; rl += NT) {
    float* w = wsm + rl * kMaxSplit;
    const float* lj = lsm + rl * kMaxSplit;
    float M = kNegInf;
    for (int j = 0; j < p.splits; ++j)
      if (lj[j] > 0.f) M = fmaxf(M, w[j]);
    float L = 0.f;
    for (int j = 0; j < p.splits; ++j) {
      w[j] = lj[j] > 0.f ? expf(w[j] - M) : 0.f;
      L += lj[j] * w[j];
    }
    inv_s[rl] = 1.f / fmaxf(L, 1e-30f);
    if (p.lse != nullptr) {
      const int R = row0 + rl, tq = R / p.G;
      p.lse[(static_cast<size_t>(b) * p.Hq + h * p.G + (R - tq * p.G)) * p.T +
            tq] = M + logf(fmaxf(L, 1e-30f));
    }
  }
  __syncthreads();
  // each thread sums two float4s of the output over the splits, a batch
  // of splits at a time, all of a batch's loads in flight together
  constexpr int kBatch = 8;
  for (int f0 = tid; f0 < n_rows * CH; f0 += 2 * NT) {
    float4 sum[2];
    int rl[2], c[2];
    bool ok[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int f = f0 + e * NT;
      ok[e] = f < n_rows * CH;
      rl[e] = ok[e] ? f / CH : 0;
      c[e] = 4 * (f - rl[e] * CH);
      sum[e] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    for (int j0 = 0; j0 < p.splits; j0 += kBatch) {
      float4 a[2][kBatch];
      float wq[2][kBatch];
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int q = 0; q < kBatch; ++q) {
          wq[e][q] = ok[e] && j0 + q < p.splits
                         ? wsm[rl[e] * kMaxSplit + j0 + q] : 0.f;
          a[e][q] = wq[e][q] != 0.f
                        ? __ldcg(reinterpret_cast<const float4*>(
                              parts + static_cast<size_t>(j0 + q) * kPart +
                              rl[e] * D + c[e]))
                        : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int q = 0; q < kBatch; ++q) {
          sum[e].x = fmaf(a[e][q].x, wq[e][q], sum[e].x);
          sum[e].y = fmaf(a[e][q].y, wq[e][q], sum[e].y);
          sum[e].z = fmaf(a[e][q].z, wq[e][q], sum[e].z);
          sum[e].w = fmaf(a[e][q].w, wq[e][q], sum[e].w);
        }
    }
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      if (!ok[e]) continue;
      const float inv = inv_s[rl[e]];
      const int R = row0 + rl[e];
      const int tq = R / p.G, gq = R - tq * p.G;
      float* o = p.out +
                 ((static_cast<size_t>(b) * p.T + tq) * p.Hq + h * p.G + gq) *
                     D +
                 c[e];
      *reinterpret_cast<float4*>(o) = make_float4(
          sum[e].x * inv, sum[e].y * inv, sum[e].z * inv, sum[e].w * inv);
    }
  }
  if (tid == 0) p.tickets[tile_id] = 0;   // ready for the next call
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// SMs of the card (of the first device asked: one card model)
int sm_count() {
  static int sms = 0;
  int dev = 0;
  if (sms == 0 && (cudaGetDevice(&dev) != cudaSuccess ||
                   cudaDeviceGetAttribute(
                       &sms, cudaDevAttrMultiProcessorCount, dev) !=
                       cudaSuccess))
    sms = 132;
  return sms;
}

// How one call is cut: warp split (WS) for G*T <= 16 rows, else row
// tiles of 64; KT keys a tile; and the KV split.
struct Plan {
  bool ws;
  int kt, rb, rows, row_tiles, n_tiles, splits;
  size_t partials, tickets;   // workspace the call needs (floats, ints)
};

Plan plan(int B, int T, int Hq, int Hkv, int S, int D) {
  Plan pl;
  const int G = Hq / Hkv;
  pl.rows = T * G;
  pl.ws = pl.rows <= 16;
  pl.kt = pl.ws ? 16 : 64;
  pl.rb = pl.ws ? 16 : 16 * kWarps;
  pl.row_tiles = (pl.rows + pl.rb - 1) / pl.rb;
  pl.n_tiles = (S + pl.kt - 1) / pl.kt;
  // two blocks for every SM (three fit, but then the blocks of a decode
  // call no longer start in one wave)
  const long long blocks = static_cast<long long>(B) * Hkv * pl.row_tiles;
  const long long want = 2LL * sm_count();
  long long splits = blocks >= want ? 1 : (want + blocks - 1) / blocks;
  splits = splits < pl.n_tiles ? splits : pl.n_tiles;
  splits = splits < kMaxSplit ? splits : kMaxSplit;
  pl.splits = static_cast<int>(splits < 1 ? 1 : splits);
  pl.partials = pl.tickets = 0;
  if (pl.splits > 1) {
    pl.tickets = static_cast<size_t>(blocks);
    pl.partials = pl.tickets * pl.splits * pl.rb * (D + 2);
  }
  return pl;
}

size_t smem_bytes(const Plan& pl, int D, int nb) {
  return (static_cast<size_t>(ring_floats(D, pl.rb)) + kRingKeys +
          pl.n_tiles + nb) * 4;
}

// a block's shared memory (232,448 bytes on the H100), less room for the
// kernel's few static bytes
constexpr size_t kSmemMax = 232448 - 1024;

template <int D, bool WS>
int launch_one(const Params& p, dim3 grid, size_t smem, cudaStream_t stream) {
  // raise the dynamic shared memory limit when a call needs more than the
  // last raise on this device
  static size_t raised[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64)
    return static_cast<int>(cudaErrorInvalidDevice);
  if (smem > raised[dev]) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_kernel<D, WS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    raised[dev] = smem;
  }
  flash_kernel<D, WS><<<grid, kWarps * 32, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

int launch(Params p, int B, int D, const Plan& pl, size_t n_partials,
           size_t n_tickets, cudaStream_t stream) {
  const long long bhkv = static_cast<long long>(B) * p.Hkv;
  if (bhkv > 65535 || pl.row_tiles > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (pl.splits > 1 && (p.partials == nullptr || p.tickets == nullptr ||
                        n_partials < pl.partials || n_tickets < pl.tickets))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(pl, D, p.block_table ? p.nb : 0);
  if (smem > kSmemMax) return static_cast<int>(cudaErrorInvalidValue);
  p.rows = pl.rows;
  p.row_tiles = pl.row_tiles;
  p.splits = pl.splits;
  p.n_tiles = pl.n_tiles;
  const dim3 grid(pl.splits, pl.row_tiles, static_cast<unsigned>(bhkv));
#define REPRO_FLASH_CASE(DIM)                                           \
  case DIM:                                                             \
    return pl.ws ? launch_one<DIM, true>(p, grid, smem, stream)         \
                 : launch_one<DIM, false>(p, grid, smem, stream);
  switch (D) {
    REPRO_FLASH_CASE(8)
    REPRO_FLASH_CASE(16)
    REPRO_FLASH_CASE(32)
    REPRO_FLASH_CASE(64)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_FLASH_CASE
}

bool shapes_ok(int B, int T, int Hq, int Hkv, int S, int D) {
  return B > 0 && T > 0 && Hq > 0 && Hkv > 0 && S >= 0 && Hq % Hkv == 0 &&
         (D == 8 || D == 16 || D == 32 || D == 64);
}

Params base_params(const void* q, const void* k, const void* v,
                   const void* q_pos, void* out, void* partials,
                   void* tickets, int T, int Hq, int Hkv, int S, int D,
                   int window, float softcap) {
  Params p{};
  p.q = static_cast<const float*>(q);
  p.k = static_cast<const float*>(k);
  p.v = static_cast<const float*>(v);
  p.q_pos = static_cast<const int*>(q_pos);
  p.out = static_cast<float*>(out);
  p.partials = static_cast<float*>(partials);
  p.tickets = static_cast<int*>(tickets);
  p.T = T;
  p.Hq = Hq;
  p.Hkv = Hkv;
  p.G = Hq / Hkv;
  p.S = S;
  p.window = window;
  p.softcap = softcap;
  p.scale = 1.f / sqrtf(static_cast<float>(D));
  return p;
}

}  // namespace

// The split-KV workspace a call with these shapes needs: returns the f32
// partials and sets *tickets to the ticket ints (both 0 when the call does
// not split). S is the key count (nb * page for the paged entry point).
// The caller zeroes the tickets once: every call leaves them at 0, so the
// same workspace serves every later call on its stream.
extern "C" size_t flash_attention_workspace(int B, int T, int Hq, int Hkv,
                                            int S, int D, size_t* tickets) {
  *tickets = 0;
  if (!shapes_ok(B, T, Hq, Hkv, S, D)) return 0;
  const Plan pl = plan(B, T, Hq, Hkv, S, D);
  *tickets = pl.tickets;
  return pl.partials;
}

// Both entry points return cudaGetLastError() after the launch
// (cudaErrorInvalidValue for shapes the kernel does not take, or a
// workspace smaller than flash_attention_workspace asks for), allocate
// nothing and do not synchronise. window <= 0: no window; softcap <= 0:
// none. Every pointer is 16-byte aligned. `lse` (contiguous entry point
// only; null to skip it) receives each row's log-sum-exp of its scaled,
// softcapped, masked scores, (B, Hq, T) f32: m + log(max(l, 1e-30)) as
// the JAX package's blocked attention saves it for its backward.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               const void* q_pos, const void* kv_pos,
                               void* out, void* lse, void* partials,
                               size_t n_partials,
                               void* tickets, size_t n_tickets, int B, int T,
                               int Hq, int S, int Hkv, int D, int window,
                               float softcap, void* stream) {
  if (!shapes_ok(B, T, Hq, Hkv, S, D))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p = base_params(q, k, v, q_pos, out, partials, tickets, T, Hq, Hkv,
                         S, D, window, softcap);
  p.kv_pos = static_cast<const int*>(kv_pos);
  p.lse = static_cast<float*>(lse);
  const Plan pl = plan(B, T, Hq, Hkv, S, D);
  return launch(p, B, D, pl, n_partials, n_tickets,
                static_cast<cudaStream_t>(stream));
}

extern "C" int paged_flash_attention(
    const void* q, const void* kp, const void* vp, const void* q_pos,
    const void* block_table, const void* lens, const void* chunk_lens,
    void* out, void* partials, size_t n_partials, void* tickets,
    size_t n_tickets, int B, int T, int Hq, int Hkv, int D, int nb, int page,
    int window, float softcap, void* stream) {
  if (nb <= 0 || page <= 0 || static_cast<long long>(nb) * page > INT_MAX ||
      !shapes_ok(B, T, Hq, Hkv, nb * page, D))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p = base_params(q, kp, vp, q_pos, out, partials, tickets, T, Hq, Hkv,
                         nb * page, D, window, softcap);
  p.block_table = static_cast<const int*>(block_table);
  p.lens = static_cast<const int*>(lens);
  p.chunk_lens = static_cast<const int*>(chunk_lens);
  p.nb = nb;
  p.page = page;
  const Plan pl = plan(B, T, Hq, Hkv, nb * page, D);
  return launch(p, B, D, pl, n_partials, n_tickets,
                static_cast<cudaStream_t>(stream));
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

namespace {

constexpr int kBT = 64;          // rows of a query tile, keys of a key tile
constexpr int kBThreads = 256;   // 16 x 16

struct BwdParams {
  const float* q;
  const float* k;
  const float* v;
  const int* q_pos;
  const int* kv_pos;
  const float* out;
  const float* dout;
  const float* lse;     // (B, Hq, T)
  float* delta;         // (B, Hq, T): D_i
  float* dq;
  float* dk;
  float* dv;
  int T, Hq, Hkv, G, S, window;
  float softcap, scale;
  int rows;             // T * G rows of a kv head's group
};

// Threads of the dK/dV (and dq) accumulation: DG groups along d, each
// NDT values; the other 256 / DG groups along the tile's 64 keys (rows).
template <int D>
struct BwdMap {
  static constexpr int NDT = D >= 64 ? 4 : (D >= 32 ? 2 : 1);
  static constexpr int DG = D / NDT;
  static constexpr int CG = kBThreads / DG;
  static constexpr int NC = kBT / CG;
};

// shared floats of both D-templated kernels: four [64][D + 1] tiles, two
// [64][65] tiles, four [64] rows
__host__ __device__ constexpr int bwd_smem_floats(int D) {
  return 4 * kBT * (D + 1) + 2 * kBT * (kBT + 1) + 4 * kBT;
}

// Grid (ceil(B T Hq / 8)), 256 threads: one warp per (b, t, hq) row.
__global__ void __launch_bounds__(kBThreads)
flash_bwd_delta_kernel(const float* __restrict__ out,
                       const float* __restrict__ dout,
                       float* __restrict__ delta, int n_rows, int T, int Hq,
                       int D) {
  const int row = blockIdx.x * (kBThreads / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= n_rows) return;   // a whole warp leaves together
  const float* o = out + static_cast<size_t>(row) * D;
  const float* d = dout + static_cast<size_t>(row) * D;
  float sum = 0.f;
  for (int e = lane; e < D; e += 32) sum = fmaf(o[e], d[e], sum);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (lane == 0) {
    const int b = row / (T * Hq), rem = row - b * T * Hq;
    const int t = rem / Hq, hq = rem - t * Hq;
    delta[(static_cast<size_t>(b) * Hq + hq) * T + t] = sum;
  }
}

// Row r of a query tile that starts at group row R0: its offset into
// q/out/dout (B, T, Hq, D) and into lse/delta (B, Hq, T), and its position.
struct RowRef {
  size_t qoff, loff;
  int pos;
};

__device__ __forceinline__ RowRef row_ref(const BwdParams& p, int b, int h,
                                          int R, int D) {
  RowRef ref{0, 0, -1};   // an absent row sees no key
  if (R < p.rows) {
    const int tq = R / p.G, hq = h * p.G + (R - tq * p.G);
    ref.qoff = ((static_cast<size_t>(b) * p.T + tq) * p.Hq + hq) * D;
    ref.loff = (static_cast<size_t>(b) * p.Hq + hq) * p.T + tq;
    ref.pos = p.q_pos[static_cast<size_t>(b) * p.T + tq];
  }
  return ref;
}

// the tile's scaled q and dout rows, lse, D_i and positions
template <int D>
__device__ __forceinline__ void load_rows(const BwdParams& p, int b, int h,
                                          int R0, float* qs, float* dos,
                                          float* lse_s, float* del_s,
                                          int* qpos_s) {
  constexpr int LD = D + 1;
  for (int e = threadIdx.x; e < kBT * D; e += kBThreads) {
    const int r = e / D, d = e - r * D;
    const RowRef ref = row_ref(p, b, h, R0 + r, D);
    const bool ok = R0 + r < p.rows;
    qs[r * LD + d] = ok ? p.q[ref.qoff + d] * p.scale : 0.f;
    dos[r * LD + d] = ok ? p.dout[ref.qoff + d] : 0.f;
  }
  for (int r = threadIdx.x; r < kBT; r += kBThreads) {
    const RowRef ref = row_ref(p, b, h, R0 + r, D);
    const bool ok = R0 + r < p.rows;
    lse_s[r] = ok ? p.lse[ref.loff] : 0.f;
    del_s[r] = ok ? p.delta[ref.loff] : 0.f;
    qpos_s[r] = ref.pos;
  }
}

// the key tile's K and V rows (zeros past S)
template <int D>
__device__ __forceinline__ void load_keys(const BwdParams& p, int b, int h,
                                          int s0, float* ks, float* vs) {
  constexpr int LD = D + 1;
  for (int e = threadIdx.x; e < kBT * D; e += kBThreads) {
    const int c = e / D, d = e - c * D;
    const int s = s0 + c;
    const size_t off = ((static_cast<size_t>(b) * p.S + s) * p.Hkv + h) * D + d;
    ks[c * LD + d] = s < p.S ? p.k[off] : 0.f;
    vs[c * LD + d] = s < p.S ? p.v[off] : 0.f;
  }
}

// p and ds of this thread's 4 x 4 (row, key) pairs: rows ty + 16 i, keys
// tx + 16 j; written to ps (if not null) and dss, [64][65].
template <int D>
__device__ __forceinline__ void scores(const BwdParams& p, const float* qs,
                                       const float* dos, const float* ks,
                                       const float* vs, const float* lse_s,
                                       const float* del_s, const int* qpos_s,
                                       const int* kpos_s, float* ps,
                                       float* dss) {
  constexpr int LD = D + 1;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  float sc[4][4], dp[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) sc[i][j] = dp[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    float a[4], o[4], kk[4], vv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a[i] = qs[(ty + 16 * i) * LD + d];
      o[i] = dos[(ty + 16 * i) * LD + d];
      kk[i] = ks[(tx + 16 * i) * LD + d];
      vv[i] = vs[(tx + 16 * i) * LD + d];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        sc[i][j] = fmaf(a[i], kk[j], sc[i][j]);
        dp[i][j] = fmaf(o[i], vv[j], dp[i][j]);
      }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const int qp = qpos_s[r];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j;
      const int kp = kpos_s[c];
      bool ok = kp >= 0 && kp <= qp;
      if (p.window > 0) ok = ok && qp - kp < p.window;
      float s = sc[i][j], dcap = 1.f;
      if (p.softcap > 0.f) {
        const float th = tanhf(s / p.softcap);
        s = p.softcap * th;
        dcap = 1.f - th * th;
      }
      const float pe = ok ? expf(s - lse_s[r]) : 0.f;
      if (ps != nullptr) ps[r * (kBT + 1) + c] = pe;
      dss[r * (kBT + 1) + c] = pe * (dp[i][j] - del_s[r]) * dcap;
    }
  }
}

// Grid (ceil(S / 64), B * Hkv), 256 threads.
template <int D>
__global__ void __launch_bounds__(kBThreads, 2)
flash_bwd_dkdv_kernel(const BwdParams p) {
  using Map = BwdMap<D>;
  constexpr int LD = D + 1;
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;
  float* vs = ks + kBT * LD;
  float* qs = vs + kBT * LD;
  float* dos = qs + kBT * LD;
  float* ps = dos + kBT * LD;
  float* dss = ps + kBT * (kBT + 1);
  float* lse_s = dss + kBT * (kBT + 1);
  float* del_s = lse_s + kBT;
  int* qpos_s = reinterpret_cast<int*>(del_s + kBT);
  int* kpos_s = qpos_s + kBT;
  __shared__ int s_kmin, s_kmax;

  const int tid = threadIdx.x;
  const int s0 = blockIdx.x * kBT;
  const int bh = blockIdx.y, b = bh / p.Hkv, h = bh - b * p.Hkv;
  if (tid == 0) {
    s_kmin = INT_MAX;
    s_kmax = INT_MIN;
  }
  load_keys<D>(p, b, h, s0, ks, vs);
  __syncthreads();
  if (tid < kBT) {
    const int s = s0 + tid;
    const int kp = s < p.S ? p.kv_pos[static_cast<size_t>(b) * p.S + s] : -1;
    kpos_s[tid] = kp;
    if (kp >= 0) {
      atomicMin(&s_kmin, kp);
      atomicMax(&s_kmax, kp);
    }
  }
  __syncthreads();
  const int kmin = s_kmin, kmax = s_kmax;

  const int dg = tid % Map::DG, cg = tid / Map::DG;
  float dk[Map::NC][Map::NDT], dv[Map::NC][Map::NDT];
#pragma unroll
  for (int j = 0; j < Map::NC; ++j)
#pragma unroll
    for (int i = 0; i < Map::NDT; ++i) dk[j][i] = dv[j][i] = 0.f;

  for (int R0 = 0; R0 < p.rows; R0 += kBT) {
    // skip a query tile that no key of this block can see
    bool may = false;
    if (tid < kBT) {
      const int pos = row_ref(p, b, h, R0 + tid, D).pos;
      may = pos >= 0 && pos >= kmin &&
            (p.window <= 0 ||
             static_cast<long long>(pos) - p.window < kmax);
    }
    if (!__syncthreads_or(may)) continue;
    load_rows<D>(p, b, h, R0, qs, dos, lse_s, del_s, qpos_s);
    __syncthreads();
    scores<D>(p, qs, dos, ks, vs, lse_s, del_s, qpos_s, kpos_s, ps, dss);
    __syncthreads();
#pragma unroll 4
    for (int r = 0; r < kBT; ++r) {
      float o[Map::NDT], a[Map::NDT];
#pragma unroll
      for (int i = 0; i < Map::NDT; ++i) {
        o[i] = dos[r * LD + dg + Map::DG * i];
        a[i] = qs[r * LD + dg + Map::DG * i];
      }
#pragma unroll
      for (int j = 0; j < Map::NC; ++j) {
        const int c = cg + Map::CG * j;
        const float pe = ps[r * (kBT + 1) + c];
        const float ds = dss[r * (kBT + 1) + c];
#pragma unroll
        for (int i = 0; i < Map::NDT; ++i) {
          dv[j][i] = fmaf(pe, o[i], dv[j][i]);
          dk[j][i] = fmaf(ds, a[i], dk[j][i]);
        }
      }
    }
  }

#pragma unroll
  for (int j = 0; j < Map::NC; ++j) {
    const int s = s0 + cg + Map::CG * j;
    if (s >= p.S) continue;
    const size_t off = ((static_cast<size_t>(b) * p.S + s) * p.Hkv + h) * D;
#pragma unroll
    for (int i = 0; i < Map::NDT; ++i) {
      p.dk[off + dg + Map::DG * i] = dk[j][i];
      p.dv[off + dg + Map::DG * i] = dv[j][i];
    }
  }
}

// Grid (ceil(rows / 64), B * Hkv), 256 threads.
template <int D>
__global__ void __launch_bounds__(kBThreads, 2)
flash_bwd_dq_kernel(const BwdParams p) {
  using Map = BwdMap<D>;
  constexpr int LD = D + 1;
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;
  float* vs = ks + kBT * LD;
  float* qs = vs + kBT * LD;
  float* dos = qs + kBT * LD;
  float* dss = dos + kBT * LD;
  float* lse_s = dss + 2 * kBT * (kBT + 1);
  float* del_s = lse_s + kBT;
  int* qpos_s = reinterpret_cast<int*>(del_s + kBT);
  int* kpos_s = qpos_s + kBT;
  __shared__ int s_qmin, s_qmax;

  const int tid = threadIdx.x;
  const int R0 = blockIdx.x * kBT;
  const int bh = blockIdx.y, b = bh / p.Hkv, h = bh - b * p.Hkv;
  if (tid == 0) {
    s_qmin = INT_MAX;
    s_qmax = INT_MIN;
  }
  load_rows<D>(p, b, h, R0, qs, dos, lse_s, del_s, qpos_s);
  __syncthreads();
  if (tid < kBT && qpos_s[tid] >= 0) {
    atomicMin(&s_qmin, qpos_s[tid]);
    atomicMax(&s_qmax, qpos_s[tid]);
  }
  __syncthreads();
  const int qmin = s_qmin, qmax = s_qmax;

  const int dg = tid % Map::DG, rg = tid / Map::DG;
  float dq[Map::NC][Map::NDT];
#pragma unroll
  for (int j = 0; j < Map::NC; ++j)
#pragma unroll
    for (int i = 0; i < Map::NDT; ++i) dq[j][i] = 0.f;

  for (int s0 = 0; s0 < p.S; s0 += kBT) {
    // skip a key tile that no row of this block can see
    bool may = false;
    if (tid < kBT) {
      const int s = s0 + tid;
      const int kp = s < p.S ? p.kv_pos[static_cast<size_t>(b) * p.S + s] : -1;
      kpos_s[tid] = kp;
      may = kp >= 0 && kp <= qmax &&
            (p.window <= 0 || static_cast<long long>(kp) >
                                  static_cast<long long>(qmin) - p.window);
    }
    if (!__syncthreads_or(may)) continue;
    load_keys<D>(p, b, h, s0, ks, vs);
    __syncthreads();
    scores<D>(p, qs, dos, ks, vs, lse_s, del_s, qpos_s, kpos_s, nullptr,
              dss);
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < kBT; ++c) {
      float kk[Map::NDT];
#pragma unroll
      for (int i = 0; i < Map::NDT; ++i) kk[i] = ks[c * LD + dg + Map::DG * i];
#pragma unroll
      for (int j = 0; j < Map::NC; ++j) {
        const float ds = dss[(rg + Map::CG * j) * (kBT + 1) + c];
#pragma unroll
        for (int i = 0; i < Map::NDT; ++i) dq[j][i] = fmaf(ds, kk[i], dq[j][i]);
      }
    }
  }

#pragma unroll
  for (int j = 0; j < Map::NC; ++j) {
    const int R = R0 + rg + Map::CG * j;
    if (R >= p.rows) continue;
    const RowRef ref = row_ref(p, b, h, R, D);
#pragma unroll
    for (int i = 0; i < Map::NDT; ++i)
      p.dq[ref.qoff + dg + Map::DG * i] = dq[j][i] * p.scale;
  }
}

template <int D>
int launch_bwd(const BwdParams& p, int B, cudaStream_t stream) {
  static size_t raised[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64)
    return static_cast<int>(cudaErrorInvalidDevice);
  const size_t smem = static_cast<size_t>(bwd_smem_floats(D)) * 4;
  if (smem > raised[dev]) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_bwd_dkdv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(flash_bwd_dq_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    raised[dev] = smem;
  }
  const unsigned bhkv = static_cast<unsigned>(B * p.Hkv);
  flash_bwd_dkdv_kernel<D>
      <<<dim3((p.S + kBT - 1) / kBT, bhkv), kBThreads, smem, stream>>>(p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  flash_bwd_dq_kernel<D>
      <<<dim3((p.rows + kBT - 1) / kBT, bhkv), kBThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The backward of flash_attention (contiguous layout): dq (B, T, Hq, D),
// dk and dv (B, S, Hkv, D), f32, from q, k, v, q_pos, kv_pos (as the
// forward), its out and lse, and dout (B, T, Hq, D). `delta` is scratch of
// B * Hq * T floats that the caller owns. Three launches on `stream`
// (D_i, then dk/dv, then dq); returns cudaGetLastError() after the last
// (cudaErrorInvalidValue for shapes the kernels do not take). Allocates
// nothing, does not synchronise. window <= 0: no window; softcap <= 0:
// none.
extern "C" int flash_attention_bwd(const void* q, const void* k,
                                   const void* v, const void* q_pos,
                                   const void* kv_pos, const void* out,
                                   const void* dout, const void* lse,
                                   void* delta, void* dq, void* dk, void* dv,
                                   int B, int T, int Hq, int S, int Hkv,
                                   int D, int window, float softcap,
                                   void* stream) {
  if (!shapes_ok(B, T, Hq, Hkv, S, D) || S <= 0 ||
      static_cast<long long>(B) * Hkv > 65535 ||
      static_cast<long long>(B) * T * Hq > INT_MAX / 64 ||
      (static_cast<long long>(T) * (Hq / Hkv) + kBT - 1) / kBT > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  BwdParams p{};
  p.q = static_cast<const float*>(q);
  p.k = static_cast<const float*>(k);
  p.v = static_cast<const float*>(v);
  p.q_pos = static_cast<const int*>(q_pos);
  p.kv_pos = static_cast<const int*>(kv_pos);
  p.out = static_cast<const float*>(out);
  p.dout = static_cast<const float*>(dout);
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<float*>(delta);
  p.dq = static_cast<float*>(dq);
  p.dk = static_cast<float*>(dk);
  p.dv = static_cast<float*>(dv);
  p.T = T;
  p.Hq = Hq;
  p.Hkv = Hkv;
  p.G = Hq / Hkv;
  p.S = S;
  p.window = window;
  p.softcap = softcap;
  p.scale = 1.f / sqrtf(static_cast<float>(D));
  p.rows = T * p.G;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_rows = B * T * Hq;
  flash_bwd_delta_kernel<<<(n_rows + kBThreads / 32 - 1) / (kBThreads / 32),
                           kBThreads, 0, st>>>(p.out, p.dout, p.delta,
                                               n_rows, T, Hq, D);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  switch (D) {
    case 8:
      return launch_bwd<8>(p, B, st);
    case 16:
      return launch_bwd<16>(p, B, st);
    case 32:
      return launch_bwd<32>(p, B, st);
    case 64:
      return launch_bwd<64>(p, B, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
