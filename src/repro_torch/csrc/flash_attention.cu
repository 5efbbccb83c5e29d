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
//   src/repro/models/attention.py (_paged_attend). `ring_flash_attention`
//   does the same for a sliding-window layer's per-slot ring (B, Hkv, W,
//   D) and the chunk's own K/V (B, T, Hkv, D), in place of the
//   concatenation [ring ; chunk] of _paged_attend's ring branch: the keys'
//   positions are computed in the kernel from the slot lengths. Head dims
//   8 to 256 forward (gemma2's 256; 128 for later models), 8 to 64
//   backward.
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
//   is bound by bytes (8 KB per key across the 8 kv heads at D = 64; 16 KB
//   at gemma2's D = 256, whose rings of 4096 keys make a decode tick's
//   largest byte stream). At prefill (T = S = 512, causal) it does
//   ~T*S/2*4*D flops per q head against scores that never leave the SM:
//   bound by tensor-core operations (three TF32 products at 495 TFLOP/s).
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
//     min(lens + chunk_lens, max q_pos + 1); the ring kernel computes each
//     key's position). A tile outside the list is neither loaded nor
//     multiplied: causal prefill skips the upper triangle, decode reads
//     only the live context, a window's keys behind it are skipped.
//   - Head dims 128 and 256: a thread's D/2-float accumulator and q's D/2
//     TF32 pieces (each of big and small) no longer fit 255 registers
//     together, so from D = 128 q is kept, scaled, in shared memory and
//     split per k8 step (the same pieces), and a block holds one SM
//     (launch bounds 1: up to 255 registers); at D = 256 tiles are 32 keys
//     (8 at decode) so that two stages of K and V stay within a block's
//     227 KB (about 134 KB, and 68 KB of q at 64 rows).
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
//   512, causal) by arithmetic: both passes recompute S and dP, 14 D flops
//   per visible (query head, key) pair, three TF32 products each, against
//   O((T + S) D) bytes. Design: three kernels, no atomics on any output
//   (the same inputs give the same bits):
//   - flash_bwd_delta_kernel: D_i, one warp per row.
//   - flash_bwd_dkdv_kernel<D>: a block of 4 warps owns 64 keys of a kv
//     head (K and V stay in shared memory) and streams the group's query
//     rows (R = t G + g, as the forward) 32 at a time through a
//     double-buffered cp.async ring (70 KB at D = 64: three blocks fit on
//     an SM). Each warp computes S^T = K Q^T and
//     dP^T = V dO^T for its 16 keys with keys as the mma rows, so that
//     p^T and ds^T land in the accumulator layout, which is the A operand
//     of dV += P^T dO and dK += dS^T q in registers (rows of a k8 step
//     permuted as the forward's p.v).
//   - flash_bwd_dq_kernel<D>: a block owns 64 group rows (q and dO stay in
//     shared memory) and streams the keys 32 at a time: S, dP, then
//     dQ += dS K from the accumulators the same way.
//   - All five products run on mma.sync.m16n8k8 in 3xTF32 (split_tf32,
//     mma3), as the forward: one TF32 piece leaves ~1e-3, the tolerance is
//     1e-4 (tests/test_torch_flash_bwd_split.py emulates the scheme on the
//     CPU and shows one piece failing). Shared rows are padded to D + 4
//     floats, so every fragment load, along d or along rows, is free of
//     bank conflicts.
//   - Causal balance: streamed tiles that no pair of the block can see are
//     skipped (a list built from the positions, as the forward). Key tile
//     0 then streams every query tile and the last row tile every key
//     tile, ~1.8x the mean. So a block takes at most `per` live streamed
//     tiles (bwd_pass: about two blocks per SM over a causal call's live
//     pairs), a longer list is split over blocks, and the block that draws
//     the last ticket sums the splits' dk/dv (or dq) fragments in split
//     order from the workspace (as the forward's split-KV). The longest
//     tiles come first in the grid. On the H100 at one train microbatch,
//     64-row streamed tiles (two blocks an SM) and four blocks per SM in
//     the plan (more, smaller splits) both timed slower
//     (benchmarks/torch_flash_bwd_tiles.py).
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kMaxSplit = 32;   // KV splits of one row tile, at most

// Keys of a tile: 64 (row tiles) or 16 (warp split), halved twice at
// D = 256 so that two stages of K and V still fit a block's shared memory.
__host__ __device__ constexpr int tile_keys(int D, bool ws) {
  return ws ? (D >= 256 ? 8 : 16) : (D >= 256 ? 32 : 64);
}
// Key rows of the ring (two stages of tiles, or two tiles for each of four
// warps): 128, 64 at D = 256.
__host__ __device__ constexpr int ring_keys(int D) {
  return D >= 256 ? 64 : 128;
}
// Floats of the ring: its key rows of K and V, and room for the combines'
// scratch (which reuses it after the loop).
__host__ __device__ constexpr int ring_floats(int D, int RB) {
  return ring_keys(D) * (2 * D + 12) > RB * (2 * kMaxSplit + 1)
             ? ring_keys(D) * (2 * D + 12)
             : RB * (2 * kMaxSplit + 1);
}
// From D = 128 a warp's q pieces (D/2 registers a thread for each of big
// and small) no longer fit beside its D/2-float accumulator: q is kept,
// scaled, in shared memory ([RB][D + 8]) and split per k8 step.
__host__ __device__ constexpr bool q_in_smem(int D) { return D >= 128; }
__host__ __device__ constexpr int q_floats(int D, int RB) {
  return q_in_smem(D) ? RB * (D + 8) : 0;
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
  const float* kc;          // ring only: the chunk's own K, V
  const float* vc;
  float* out;
  float* lse;               // (B, Hq, T) log-sum-exp of each row, or null
  float* partials;          // splits > 1: [tile][split][RB][D + 2]
  int* tickets;             // splits > 1: [tile]
  int T, Hq, Hkv, G, S, nb, page, W, window;
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
// Ring (RING, `ring_flash_attention`): keys s < W are one sliding layer's
//   ring k, v (B, Hkv, W, D), where slot s holds the latest position
//   congruent to s mod W below lens[b]: last - ((last - s) mod W) with
//   last = lens[b] - 1 (negative, so invisible, for a slot not yet
//   written); keys W + t are the chunk's own kc, vc (B, T, Hkv, D) at
//   q_pos[b, t], visible for t < chunk_lens[b]. One launch reads both, so
//   the ring is never copied next to the chunk.
// Two ways to cut a block's work (WS):
//   rows (WS false): 64 rows, each warp its own 16; tiles of 64 keys (32
//     at D = 256) in a ring of two stages that all warps share.
//   warp split (WS true, G*T <= 16 rows: decode): 16 rows that every warp
//     holds; warp w takes every kWarps-th tile of 16 keys (8 at D = 256)
//     through two buffers of its own, and the warps' (m, l, acc) are
//     combined in shared memory (in warp order) before the block's
//     epilogue.
// Fragments (g = lane / 4, t = lane % 4): the m16n8k8 accumulator holds
//   (row g, cols 2t, 2t+1) and (row g + 8, same cols); A holds (g, t),
//   (g + 8, t), (g, t + 4), (g + 8, t + 4); B holds (k t, n g), (k t + 4,
//   n g).
template <int D, bool WS, bool RING>
__device__ __forceinline__ void flash_body(const Params& p) {
  constexpr int NW = kWarps, NT = NW * 32;
  constexpr int KT = tile_keys(D, WS);     // keys of a tile
  constexpr int RB = WS ? 16 : 16 * NW;   // rows of a block
  constexpr int LDK = D + 8;           // padded shared K row, floats
  constexpr int LDV = D + 4;           // padded shared V row, floats
  constexpr int LDQ = D + 8;           // padded shared q row, floats
  constexpr bool QS = q_in_smem(D);
  constexpr int KS = D / 8;            // k8 steps over D
  constexpr int NJ = KT / 8;           // 8-key steps over a tile
  constexpr int CH = D / 4;            // 16-byte chunks of one key row
  constexpr int kBuf = KT * (LDK + LDV);   // one tile: K then V, floats
  static_assert(NJ * 4 <= 32, "the visibility mask is one word");
  static_assert((WS ? 2 * NW : 2) * kBuf <= ring_floats(D, RB) &&
                    (WS ? 2 * NW : 2) * KT <= ring_keys(D),
                "the ring holds the tile buffers");
  static_assert(RB * (2 * kMaxSplit + 1) <= ring_floats(D, RB) &&
                    (!WS || NW * 16 * (D + 2) <= ring_floats(D, RB)),
                "the ring holds the combines' scratch");

  extern __shared__ __align__(16) float smem[];
  float* ring = smem;   // tile buffers, then the combines' scratch
  float* q_s = smem + ring_floats(D, RB);   // QS: [RB][LDQ], scaled
  int* kpos_s = reinterpret_cast<int*>(q_s + q_floats(D, RB));
  int* live = kpos_s + ring_keys(D);  // kpos_s: [buffers][KT]; live: [n_tiles]
  int* bt_s = live + p.n_tiles;    // [nb]
  __shared__ int s_minq[NW], s_maxq[NW], s_count;
  __shared__ bool s_last;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int split = blockIdx.x, rt = blockIdx.y;
  const int bh = blockIdx.z, b = bh / p.Hkv, h = bh % p.Hkv;
  const bool paged = !RING && p.block_table != nullptr;
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
  // RING: the position of key s (-1: invisible)
  const int last = RING ? p.lens[b] - 1 : 0;
  const int clen = RING ? p.chunk_lens[b] : 0;
  if (RING) s_end = p.W + clen;
  auto ring_pos = [&](int s) -> int {
    if (s < p.W) {
      int d = (last - s) % p.W;
      d += d < 0 ? p.W : 0;
      const int pos = last - d;
      return pos < 0 ? -1 : pos;
    }
    return s < s_end ? p.q_pos[static_cast<size_t>(b) * p.T + (s - p.W)]
                     : -1;
  };

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
    if (RING) {
      for (int j = 0; j < KT && lo <= hi; ++j) {
        const int pos = ring_pos(s0 + j);
        any |= pos >= lo && pos <= hi;
      }
    } else if (paged) {
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
      const float* kb = p.k;
      const float* vb = p.v;
      if (RING) {
        ok = ring_pos(s) >= 0;
        if (s >= p.W) {
          kb = p.kc;
          vb = p.vc;
          if (ok)
            off = ((static_cast<size_t>(b) * p.T + (s - p.W)) * p.Hkv + h) *
                  D;
        } else if (ok) {
          off = ((static_cast<size_t>(b) * p.Hkv + h) * p.W + s) * D;
        }
      } else if (paged) {
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
      cp_async16(ks + j * LDK + part * 4, ok ? kb + off : p.k, ok ? 16 : 0);
      cp_async16(vs + j * LDV + part * 4, ok ? vb + off : p.v, ok ? 16 : 0);
    }
    int* kps = kpos_s + bi * KT;
    for (int j = first; j < KT; j += step) {
      const int s = s0 + j;
      if (RING)
        kps[j] = ring_pos(s);
      else if (paged)
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
  // each thread's two values of a row are one 8-byte load. QS: the block's
  // rows, scaled, in shared memory, split per k8 step by `qfrag`.
  uint32_t qb[QS ? 1 : KS][4], qs[QS ? 1 : KS][4];
  if constexpr (QS) {
    for (int c = tid; c < RB * (D / 2); c += NT) {
      const int rl = c / (D / 2), d = 2 * (c - rl * (D / 2));
      const int R = row0 + rl;
      float2 x = make_float2(0.f, 0.f);
      if (R < p.rows) {
        const int tq = R / p.G;
        x = *reinterpret_cast<const float2*>(
            p.q + ((static_cast<size_t>(b) * p.T + tq) * p.Hq + h * p.G +
                   (R - tq * p.G)) * D + d);
      }
      *reinterpret_cast<float2*>(q_s + rl * LDQ + d) =
          make_float2(x.x * p.scale, x.y * p.scale);
    }
    __syncthreads();
  } else {
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float2 x = make_float2(0.f, 0.f);
        if (wrow0 + g + 8 * r < p.rows)
          x = *reinterpret_cast<const float2*>(p.q + qoff[r] + kk * 8 +
                                               2 * t);
        split_tf32(x.x * p.scale, qb[kk][r], qs[kk][r]);
        split_tf32(x.y * p.scale, qb[kk][r + 2], qs[kk][r + 2]);
      }
  }
  // the A fragment of k8 step kk, as TF32 pieces
  auto qfrag = [&](int kk, uint32_t (&ab)[4], uint32_t (&as)[4]) {
    if constexpr (QS) {
      const float* q0 = q_s + (wrow0 - row0 + g) * LDQ + kk * 8 + 2 * t;
      const float2 x0 = *reinterpret_cast<const float2*>(q0);
      const float2 x1 = *reinterpret_cast<const float2*>(q0 + 8 * LDQ);
      split_tf32(x0.x, ab[0], as[0]);
      split_tf32(x1.x, ab[1], as[1]);
      split_tf32(x0.y, ab[2], as[2]);
      split_tf32(x1.y, ab[3], as[3]);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        ab[e] = qb[kk][e];
        as[e] = qs[kk][e];
      }
    }
  };

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
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t ab[4], as[4];
      qfrag(kk, ab, as);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float2 kv = *reinterpret_cast<const float2*>(
            ks + (j * 8 + g) * LDK + kk * 8 + 2 * t);
        uint32_t bb0, bs0, bb1, bs1;
        split_tf32(kv.x, bb0, bs0);
        split_tf32(kv.y, bb1, bs1);
        mma3(sc[j], ab, as, bb0, bb1, bs0, bs1);
      }
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

// From D = 128 a thread's accumulator alone is D/2 registers: one block an
// SM lets it take up to 255 (three cap it at 170).
template <int D, bool WS>
__global__ void __launch_bounds__(kWarps * 32, (D >= 128 ? 1 : 3))
flash_kernel(const Params p) {
  flash_body<D, WS, false>(p);
}

template <int D, bool WS>
__global__ void __launch_bounds__(kWarps * 32, (D >= 128 ? 1 : 3))
ring_flash_kernel(const Params p) {
  flash_body<D, WS, true>(p);
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
  pl.kt = tile_keys(D, pl.ws);
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
  return (static_cast<size_t>(ring_floats(D, pl.rb)) + q_floats(D, pl.rb) +
          ring_keys(D) + pl.n_tiles + nb) * 4;
}

// a block's shared memory (232,448 bytes on the H100), less room for the
// kernel's few static bytes
constexpr size_t kSmemMax = 232448 - 1024;

template <int D, bool WS, bool RING>
int launch_one(const Params& p, dim3 grid, size_t smem, cudaStream_t stream) {
  // raise the dynamic shared memory limit when a call needs more than the
  // last raise on this device
  static size_t raised[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64)
    return static_cast<int>(cudaErrorInvalidDevice);
  auto kernel = RING ? ring_flash_kernel<D, WS> : flash_kernel<D, WS>;
  if (smem > raised[dev]) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    raised[dev] = smem;
  }
  kernel<<<grid, kWarps * 32, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

int launch(Params p, int B, int D, const Plan& pl, size_t n_partials,
           size_t n_tickets, cudaStream_t stream, bool ring = false) {
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
#define REPRO_FLASH_CASE(DIM)                                              \
  case DIM:                                                                \
    if (ring)                                                              \
      return pl.ws ? launch_one<DIM, true, true>(p, grid, smem, stream)    \
                   : launch_one<DIM, false, true>(p, grid, smem, stream);  \
    return pl.ws ? launch_one<DIM, true, false>(p, grid, smem, stream)     \
                 : launch_one<DIM, false, false>(p, grid, smem, stream);
  switch (D) {
    REPRO_FLASH_CASE(8)
    REPRO_FLASH_CASE(16)
    REPRO_FLASH_CASE(32)
    REPRO_FLASH_CASE(64)
    REPRO_FLASH_CASE(128)
    REPRO_FLASH_CASE(256)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_FLASH_CASE
}

// head dims of the forward kernels, and of the backward kernels
bool shapes_ok(int B, int T, int Hq, int Hkv, int S, int D) {
  return B > 0 && T > 0 && Hq > 0 && Hkv > 0 && S >= 0 && Hq % Hkv == 0 &&
         (D == 8 || D == 16 || D == 32 || D == 64 || D == 128 || D == 256);
}
bool bwd_shapes_ok(int B, int T, int Hq, int Hkv, int S, int D) {
  return shapes_ok(B, T, Hq, Hkv, S, D) && D <= 64;
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

// One sliding layer's ring kr, vr (B, Hkv, W, D) and the chunk's own kc, vc
// (B, T, Hkv, D), read in one launch (see flash_body, RING): the W ring
// keys' positions from lens, the chunk's from q_pos where t <
// chunk_lens[b]. The split workspace is flash_attention_workspace's for
// S = W + T.
extern "C" int ring_flash_attention(
    const void* q, const void* kr, const void* vr, const void* kc,
    const void* vc, const void* q_pos, const void* lens,
    const void* chunk_lens, void* out, void* partials, size_t n_partials,
    void* tickets, size_t n_tickets, int B, int T, int Hq, int Hkv, int D,
    int W, int window, float softcap, void* stream) {
  if (W <= 0 || static_cast<long long>(W) + T > INT_MAX ||
      !shapes_ok(B, T, Hq, Hkv, W + T, D))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p = base_params(q, kr, vr, q_pos, out, partials, tickets, T, Hq, Hkv,
                         W + T, D, window, softcap);
  p.kc = static_cast<const float*>(kc);
  p.vc = static_cast<const float*>(vc);
  p.lens = static_cast<const int*>(lens);
  p.chunk_lens = static_cast<const int*>(chunk_lens);
  p.W = W;
  const Plan pl = plan(B, T, Hq, Hkv, W + T, D);
  return launch(p, B, D, pl, n_partials, n_tickets,
                static_cast<cudaStream_t>(stream), true);
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

namespace {

constexpr int kBT = 64;    // keys (dk/dv) or rows (dq) of a block
// Rows (dk/dv) or keys (dq) of a streamed tile, blocks an SM holds (the
// launch bounds) and blocks for every SM that bwd_pass aims at: of the
// variants benchmarks/torch_flash_bwd_tiles.py builds and times, these
// were fastest at one train microbatch on the H100 (PERF.md).
constexpr int kBS = 32;
constexpr int kBMinBlocks = 3;
constexpr int kBWaves = 2;
constexpr int kBWarps = 4;         // 16 keys (dk/dv) or 16 rows (dq) a warp
constexpr int kBThreads = kBWarps * 32;
constexpr int kDeltaThreads = 256;

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
  float* partials;      // split tiles: [tile][split][thread][fragment]
  int* tickets;         // split tiles: [tile]
  int T, Hq, Hkv, G, S, window;
  float softcap, scale;
  int rows;             // T * G rows of a kv head's group
  int n_stat, n_str;    // stationary and streamed tiles (this launch)
  int per;              // streamed tiles per block, at most (this launch)
};

// Grid (ceil(B T Hq / 8)), 256 threads: one warp per (b, t, hq) row.
__global__ void __launch_bounds__(kDeltaThreads)
flash_bwd_delta_kernel(const float* __restrict__ out,
                       const float* __restrict__ dout,
                       float* __restrict__ delta, int n_rows, int T, int Hq,
                       int D) {
  const int row = blockIdx.x * (kDeltaThreads / 32) + (threadIdx.x >> 5);
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

// Group row R of kv head (b, h): its offset into q/out/dout (B, T, Hq, D)
// and into lse/delta (B, Hq, T), and its position (-1: absent, sees no key).
struct RowRef {
  size_t qoff, loff;
  int pos;
};

__device__ __forceinline__ RowRef row_ref(const BwdParams& p, int b, int h,
                                          int R, int D) {
  RowRef ref{0, 0, -1};
  if (R < p.rows) {
    const int tq = R / p.G, hq = h * p.G + (R - tq * p.G);
    ref.qoff = ((static_cast<size_t>(b) * p.T + tq) * p.Hq + hq) * D;
    ref.loff = (static_cast<size_t>(b) * p.Hq + hq) * p.T + tq;
    ref.pos = p.q_pos[static_cast<size_t>(b) * p.T + tq];
  }
  return ref;
}

// q/out/dout offset of group row R (-1 past the group's rows)
__device__ __forceinline__ long long row_qoff(const BwdParams& p, int b,
                                              int h, int R, int D) {
  if (R >= p.rows) return -1;
  const int tq = R / p.G, hq = h * p.G + (R - tq * p.G);
  return ((static_cast<long long>(b) * p.T + tq) * p.Hq + hq) * D;
}

// cp.async of ROWS rows x D floats into a [ROWS][D + 4] tile: row r from
// src + off(r), zeros where off(r) < 0. Threads first, first + step, ...
template <int D, int ROWS, typename Off>
__device__ __forceinline__ void tile_async(float* dst, const float* src,
                                           Off off, int first, int step) {
  constexpr int CH = D / 4, LD = D + 4;
  for (int c = first; c < ROWS * CH; c += step) {
    const int r = c / CH, part = c - r * CH;
    const long long o = off(r);
    cp_async16(dst + r * LD + part * 4, src + (o >= 0 ? o + part * 4 : 0),
               o >= 0 ? 16 : 0);
  }
}

// Compacts the streamed tiles whose flag `live[i]` is set (i < n) in place,
// in tile order, by warp 0; returns their count to every thread.
__device__ __forceinline__ int compact(int* live, int n, int* s_count) {
  __syncthreads();
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    int count = 0;
    for (int base = 0; base < n; base += 32) {
      const int i = base + lane;
      const bool f = i < n && live[i];
      const unsigned bal = __ballot_sync(0xffffffffu, f);
      if (f) live[count + __popc(bal & ((1u << lane) - 1u))] = i;
      count += __popc(bal);
    }
    if (lane == 0) *s_count = count;
  }
  __syncthreads();
  return *s_count;
}

// The split of a stationary tile's `count` live streamed tiles over
// ceil(count / per) blocks: this block's [i0, i1); false when it has none
// (a tile with no live tile has one split, which writes zeros).
__device__ __forceinline__ bool my_range(int count, int per, int rank,
                                         int& splits, int& i0, int& i1) {
  splits = count > per ? (count + per - 1) / per : 1;
  if (rank >= splits) return false;
  i0 = static_cast<int>(static_cast<long long>(count) * rank / splits);
  i1 = static_cast<int>(static_cast<long long>(count) * (rank + 1) / splits);
  return true;
}

// A split tile: every block stores its fragments `acc` at its rank; the one
// that draws the last ticket sums all splits in rank order into `acc` and
// returns true (the others return false). As the crossbar kernels' split.
template <int NF>
__device__ __forceinline__ bool sum_splits(float (&acc)[NF], float* parts,
                                           int* ticket, int splits, int rank,
                                           bool* s_last) {
  static_assert(NF % 4 == 0, "fragments go as float4s");
  constexpr int NQ = NF / 4;
  float4* frags = reinterpret_cast<float4*>(parts);
  const int tid = threadIdx.x;
#pragma unroll
  for (int i = 0; i < NQ; ++i)
    frags[(rank * kBThreads + tid) * NQ + i] =
        make_float4(acc[4 * i], acc[4 * i + 1], acc[4 * i + 2],
                    acc[4 * i + 3]);
  __syncthreads();
  if (tid == 0) *s_last = draw_ticket(ticket) == splits - 1;
  __syncthreads();
  if (!*s_last) return false;
#pragma unroll
  for (int i = 0; i < NF; ++i) acc[i] = 0.f;
  for (int q = 0; q < splits; ++q) {
    float4 v[NQ];
#pragma unroll
    for (int i = 0; i < NQ; ++i)   // L2 (__ldcg: L1 is not coherent)
      v[i] = __ldcg(frags + (q * kBThreads + tid) * NQ + i);
#pragma unroll
    for (int i = 0; i < NQ; ++i) {
      acc[4 * i] += v[i].x;
      acc[4 * i + 1] += v[i].y;
      acc[4 * i + 2] += v[i].z;
      acc[4 * i + 3] += v[i].w;
    }
  }
  if (tid == 0) *ticket = 0;   // ready for the next call
  return true;
}

// p = exp(cap(s) - lse) under the mask and ds = p (dp - D_i) cap'(s), in
// place of s and dp
__device__ __forceinline__ void p_and_ds(const BwdParams& p, int qp, int kp,
                                         float lse, float di, float& s,
                                         float& dp) {
  bool ok = kp >= 0 && kp <= qp;
  if (p.window > 0) ok = ok && qp - kp < p.window;
  float x = s, dcap = 1.f;
  if (p.softcap > 0.f) {
    const float th = tanhf(x / p.softcap);
    x = p.softcap * th;
    dcap = 1.f - th * th;
  }
  const float pe = ok ? expf(x - lse) : 0.f;
  s = pe;
  dp = pe * (dp - di) * dcap;
}

// Floats of one streamed stage: dk/dv streams q and dout rows with their
// lse, D_i and positions; dq streams K and V rows with their positions.
template <int D>
__host__ __device__ constexpr int dkdv_stage_floats() {
  return 2 * kBS * (D + 4) + 3 * kBS;
}
template <int D>
__host__ __device__ constexpr int dq_stage_floats() {
  return 2 * kBS * (D + 4) + kBS;
}

// Grid (splits, B * Hkv, key tiles), kBThreads threads: key tile
// blockIdx.z, so that causal key tile 0 (the one every row sees) starts
// first. Warp w owns keys 16 w .. 16 w + 15 of the tile. Per query tile
// (kBS group rows): S^T = (K D^-1/2) Q^T and dP^T = V dO^T with keys as
// the mma rows (8-row n-steps, d the reduction), then p and ds in the
// accumulators, whose layout is the A operand of dV += P^T dO and
// dK += dS^T q (the rows of a k8 step permuted: logical k t is row 2t,
// k t + 4 row 2t + 1); dK takes its D^-1/2 at the end.
template <int D>
__global__ void __launch_bounds__(kBThreads, kBMinBlocks)
flash_bwd_dkdv_kernel(const BwdParams p) {
  constexpr int LD = D + 4, KS = D / 8, NR = kBS / 8;
  constexpr int kStageF = dkdv_stage_floats<D>();
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;                   // K [64][LD]
  float* vs = ks + kBT * LD;          // V [64][LD]
  float* ring = vs + kBT * LD;        // 2 stages: q, dout, lse, D_i, q_pos
  int* live = reinterpret_cast<int*>(ring + 2 * kStageF);   // [n_str]
  __shared__ int kpos_s[kBT], s_kmin, s_kmax, s_count;
  __shared__ bool s_last;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int rank = blockIdx.x, bh = blockIdx.y, kt = blockIdx.z;
  const int b = bh / p.Hkv, h = bh - b * p.Hkv;
  const int s0 = kt * kBT;

  // this tile's K and V (zeros past S) land while the row tiles are listed
  auto key_off = [&](int r) -> long long {
    const int s = s0 + r;
    return s < p.S ? ((static_cast<long long>(b) * p.S + s) * p.Hkv + h) * D
                   : -1;
  };
  tile_async<D, kBT>(ks, p.k, key_off, tid, kBThreads);
  tile_async<D, kBT>(vs, p.v, key_off, tid, kBThreads);
  cp_async_commit();

  if (tid == 0) {
    s_kmin = INT_MAX;
    s_kmax = INT_MIN;
  }
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
  const int kw = 16 * warp;   // this warp's keys: kw .. kw + 15
  const int kp[2] = {kpos_s[kw + g], kpos_s[kw + g + 8]};
  // the query tiles holding a row that may see a key of this tile
  for (int i = tid; i < p.n_str; i += kBThreads) {
    const int t0 = i * kBS / p.G;
    const int t1 = (min((i + 1) * kBS, p.rows) - 1) / p.G;
    bool any = false;
    for (int tq = t0; tq <= t1; ++tq) {
      const int pos = p.q_pos[static_cast<size_t>(b) * p.T + tq];
      any |= pos >= 0 && pos >= kmin &&
             (p.window <= 0 || static_cast<long long>(pos) - p.window < kmax);
    }
    live[i] = any;
  }
  const int count = compact(live, p.n_str, &s_count);
  int splits, i0, i1;
  if (!my_range(count, p.per, rank, splits, i0, i1)) {
    cp_async_wait<0>();
    return;
  }

  auto issue = [&](int tile, int st) {
    float* qs = ring + st * kStageF;
    float* dos = qs + kBS * LD;
    float* lse_s = dos + kBS * LD;
    float* del_s = lse_s + kBS;
    int* qpos_s = reinterpret_cast<int*>(del_s + kBS);
    const int R0 = tile * kBS;
    auto row_off = [&](int r) { return row_qoff(p, b, h, R0 + r, D); };
    tile_async<D, kBS>(qs, p.q, row_off, tid, kBThreads);
    tile_async<D, kBS>(dos, p.dout, row_off, tid, kBThreads);
    for (int r = tid; r < kBS; r += kBThreads) {
      const RowRef ref = row_ref(p, b, h, R0 + r, D);
      if (R0 + r < p.rows) {
        cp_async4(lse_s + r, p.lse + ref.loff);
        cp_async4(del_s + r, p.delta + ref.loff);
      } else {
        lse_s[r] = 0.f;
        del_s[r] = 0.f;
      }
      qpos_s[r] = ref.pos;
    }
  };

  if (i0 < i1) issue(live[i0], 0);
  cp_async_commit();

  float dkv[2][KS][4];   // [0]: dK, [1]: dV; (key g (+8), d 8j + 2t (+1))
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int j = 0; j < KS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dkv[a][j][e] = 0.f;

  for (int i = i0; i < i1; ++i) {
    const int st = (i - i0) & 1;
    if (i + 1 < i1) issue(live[i + 1], st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();   // K, V and query tile i have landed for every thread
    const float* qs = ring + st * kStageF;
    const float* dos = qs + kBS * LD;
    const float* lse_s = dos + kBS * LD;
    const float* del_s = lse_s + kBS;
    const int* qpos_s = reinterpret_cast<const int*>(del_s + kBS);

    float sT[NR][4], dpT[NR][4];   // (key g (+8), row 8n + 2t (+1))
#pragma unroll
    for (int n = 0; n < NR; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sT[n][e] = dpT[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t kb[4], ksm[4], vb[4], vsm[4];
      const float* ka = ks + (kw + g) * LD + 8 * kk + t;
      const float* va = vs + (kw + g) * LD + 8 * kk + t;
#pragma unroll
      for (int e = 0; e < 4; ++e) {   // (g, t), (g + 8, t), (g, t + 4), ...
        const int o = (e & 1) * 8 * LD + (e >> 1) * 4;
        split_tf32(ka[o] * p.scale, kb[e], ksm[e]);
        split_tf32(va[o], vb[e], vsm[e]);
      }
#pragma unroll
      for (int n = 0; n < NR; ++n) {
        const float* qr = qs + (8 * n + g) * LD + 8 * kk + t;
        const float* dr = dos + (8 * n + g) * LD + 8 * kk + t;
        uint32_t bb0, bs0, bb1, bs1;
        split_tf32(qr[0], bb0, bs0);
        split_tf32(qr[4], bb1, bs1);
        mma3(sT[n], kb, ksm, bb0, bb1, bs0, bs1);
        split_tf32(dr[0], bb0, bs0);
        split_tf32(dr[4], bb1, bs1);
        mma3(dpT[n], vb, vsm, bb0, bb1, bs0, bs1);
      }
    }
#pragma unroll
    for (int n = 0; n < NR; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int rl = 8 * n + 2 * t + (e & 1);
        p_and_ds(p, qpos_s[rl], kp[e >> 1], lse_s[rl], del_s[rl], sT[n][e],
                 dpT[n][e]);
      }
    // dV += P^T dO and dK += dS^T q, 8 query rows a k step
#pragma unroll
    for (int kk = 0; kk < NR; ++kk) {
      uint32_t pb[4], ps[4], db[4], dsm[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {   // (g, 2t), (g + 8, 2t), (g, 2t + 1), ..
        const int f = (e >> 1) | ((e & 1) << 1);
        split_tf32(sT[kk][f], pb[e], ps[e]);
        split_tf32(dpT[kk][f], db[e], dsm[e]);
      }
      const float* o0 = dos + (8 * kk + 2 * t) * LD + g;
      const float* q0 = qs + (8 * kk + 2 * t) * LD + g;
#pragma unroll
      for (int j = 0; j < KS; ++j) {
        uint32_t bb0, bs0, bb1, bs1;
        split_tf32(o0[8 * j], bb0, bs0);
        split_tf32(o0[LD + 8 * j], bb1, bs1);
        mma3(dkv[1][j], pb, ps, bb0, bb1, bs0, bs1);
        split_tf32(q0[8 * j], bb0, bs0);
        split_tf32(q0[LD + 8 * j], bb1, bs1);
        mma3(dkv[0][j], db, dsm, bb0, bb1, bs0, bs1);
      }
    }
    __syncthreads();   // every warp is done with this stage
  }
  cp_async_wait<0>();

  if (splits > 1) {
    const size_t tile = static_cast<size_t>(bh) * p.n_stat + kt;
    float flat[8 * KS];
#pragma unroll
    for (int i = 0; i < 8 * KS; ++i)
      flat[i] = dkv[i / (4 * KS)][(i / 4) % KS][i % 4];
    if (!sum_splits(flat, p.partials + tile * gridDim.x * kBThreads * (8 * KS),
                    p.tickets + tile, splits, rank, &s_last))
      return;
#pragma unroll
    for (int i = 0; i < 8 * KS; ++i)
      dkv[i / (4 * KS)][(i / 4) % KS][i % 4] = flat[i];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int s = s0 + kw + g + 8 * r;
    if (s >= p.S) continue;
    const size_t off = ((static_cast<size_t>(b) * p.S + s) * p.Hkv + h) * D;
#pragma unroll
    for (int j = 0; j < KS; ++j) {
      *reinterpret_cast<float2*>(p.dk + off + 8 * j + 2 * t) = make_float2(
          dkv[0][j][2 * r] * p.scale, dkv[0][j][2 * r + 1] * p.scale);
      *reinterpret_cast<float2*>(p.dv + off + 8 * j + 2 * t) =
          make_float2(dkv[1][j][2 * r], dkv[1][j][2 * r + 1]);
    }
  }
}

// Grid (splits, B * Hkv, row tiles), kBThreads threads: row tile
// n_stat - 1 - blockIdx.z, so that the causal row tiles that see the most
// keys start first. Warp w owns group rows 16 w .. 16 w + 15 of the tile.
// Per key tile (kBS keys): S = (q D^-1/2) K^T and dP = dO V^T (rows as the
// mma rows), then ds in the accumulators, the A operand of dQ += dS K
// (keys of a k8 step permuted as in dk/dv).
template <int D>
__global__ void __launch_bounds__(kBThreads, kBMinBlocks)
flash_bwd_dq_kernel(const BwdParams p) {
  constexpr int LD = D + 4, KS = D / 8, NK = kBS / 8;
  constexpr int kStageF = dq_stage_floats<D>();
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                   // q [64][LD]
  float* dos = qs + kBT * LD;         // dout [64][LD]
  float* ring = dos + kBT * LD;       // 2 stages: K, V, kv_pos
  int* live = reinterpret_cast<int*>(ring + 2 * kStageF);   // [n_str]
  __shared__ int s_qmin, s_qmax, s_count;
  __shared__ bool s_last;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int rank = blockIdx.x, bh = blockIdx.y;
  const int rt = p.n_stat - 1 - static_cast<int>(blockIdx.z);
  const int b = bh / p.Hkv, h = bh - b * p.Hkv;
  const int R0 = rt * kBT;

  auto row_off = [&](int r) { return row_qoff(p, b, h, R0 + r, D); };
  tile_async<D, kBT>(qs, p.q, row_off, tid, kBThreads);
  tile_async<D, kBT>(dos, p.dout, row_off, tid, kBThreads);
  cp_async_commit();

  // this thread's rows g and g + 8 of its warp
  const int rw = 16 * warp;
  RowRef ref[2];
  float lse_r[2], del_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    ref[r] = row_ref(p, b, h, R0 + rw + g + 8 * r, D);
    const bool ok = R0 + rw + g + 8 * r < p.rows;
    lse_r[r] = ok ? p.lse[ref[r].loff] : 0.f;
    del_r[r] = ok ? p.delta[ref[r].loff] : 0.f;
  }
  if (tid == 0) {
    s_qmin = INT_MAX;
    s_qmax = INT_MIN;
  }
  __syncthreads();
  if (tid < kBT) {
    const int pos = row_ref(p, b, h, R0 + tid, D).pos;
    if (pos >= 0) {
      atomicMin(&s_qmin, pos);
      atomicMax(&s_qmax, pos);
    }
  }
  __syncthreads();
  const int qmin = s_qmin, qmax = s_qmax;
  // the key tiles holding a key that some row of this tile may see
  for (int i = tid; i < p.n_str; i += kBThreads) {
    const int n = min(kBS, p.S - i * kBS);
    const int* kp = p.kv_pos + static_cast<size_t>(b) * p.S + i * kBS;
    bool any = false;
#pragma unroll 8
    for (int j = 0; j < n; ++j) {
      const int pos = kp[j];
      any |= pos >= 0 && pos <= qmax &&
             (p.window <= 0 || static_cast<long long>(pos) >
                                   static_cast<long long>(qmin) - p.window);
    }
    live[i] = any;
  }
  const int count = compact(live, p.n_str, &s_count);
  int splits, i0, i1;
  if (!my_range(count, p.per, rank, splits, i0, i1)) {
    cp_async_wait<0>();
    return;
  }

  auto issue = [&](int tile, int st) {
    float* kst = ring + st * kStageF;
    float* vst = kst + kBS * LD;
    int* kpos_s = reinterpret_cast<int*>(vst + kBS * LD);
    const int s0 = tile * kBS;
    auto key_off = [&](int r) -> long long {
      const int s = s0 + r;
      return s < p.S
                 ? ((static_cast<long long>(b) * p.S + s) * p.Hkv + h) * D
                 : -1;
    };
    tile_async<D, kBS>(kst, p.k, key_off, tid, kBThreads);
    tile_async<D, kBS>(vst, p.v, key_off, tid, kBThreads);
    for (int r = tid; r < kBS; r += kBThreads) {
      if (s0 + r < p.S)
        cp_async4(kpos_s + r,
                  p.kv_pos + static_cast<size_t>(b) * p.S + s0 + r);
      else
        kpos_s[r] = -1;
    }
  };

  if (i0 < i1) issue(live[i0], 0);
  cp_async_commit();

  float dq[KS][4];   // (row g (+8), d 8j + 2t (+1))
#pragma unroll
  for (int j = 0; j < KS; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[j][e] = 0.f;

  for (int i = i0; i < i1; ++i) {
    const int st = (i - i0) & 1;
    if (i + 1 < i1) issue(live[i + 1], st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();   // q, dout and key tile i have landed
    const float* kst = ring + st * kStageF;
    const float* vst = kst + kBS * LD;
    const int* kpos_s = reinterpret_cast<const int*>(vst + kBS * LD);

    float sc[NK][4], dp[NK][4];   // (row g (+8), key 8n + 2t (+1))
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t qb[4], qsm[4], ob[4], osm[4];
      const float* qa = qs + (rw + g) * LD + 8 * kk + t;
      const float* oa = dos + (rw + g) * LD + 8 * kk + t;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int o = (e & 1) * 8 * LD + (e >> 1) * 4;
        split_tf32(qa[o] * p.scale, qb[e], qsm[e]);
        split_tf32(oa[o], ob[e], osm[e]);
      }
#pragma unroll
      for (int n = 0; n < NK; ++n) {
        const float* kr = kst + (8 * n + g) * LD + 8 * kk + t;
        const float* vr = vst + (8 * n + g) * LD + 8 * kk + t;
        uint32_t bb0, bs0, bb1, bs1;
        split_tf32(kr[0], bb0, bs0);
        split_tf32(kr[4], bb1, bs1);
        mma3(sc[n], qb, qsm, bb0, bb1, bs0, bs1);
        split_tf32(vr[0], bb0, bs0);
        split_tf32(vr[4], bb1, bs1);
        mma3(dp[n], ob, osm, bb0, bb1, bs0, bs1);
      }
    }
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        p_and_ds(p, ref[e >> 1].pos, kpos_s[8 * n + 2 * t + (e & 1)],
                 lse_r[e >> 1], del_r[e >> 1], sc[n][e], dp[n][e]);
    // dQ += dS K, 8 keys a k step
#pragma unroll
    for (int n = 0; n < NK; ++n) {
      uint32_t db[4], dsm[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        split_tf32(dp[n][(e >> 1) | ((e & 1) << 1)], db[e], dsm[e]);
      const float* k0 = kst + (8 * n + 2 * t) * LD + g;
#pragma unroll
      for (int j = 0; j < KS; ++j) {
        uint32_t bb0, bs0, bb1, bs1;
        split_tf32(k0[8 * j], bb0, bs0);
        split_tf32(k0[LD + 8 * j], bb1, bs1);
        mma3(dq[j], db, dsm, bb0, bb1, bs0, bs1);
      }
    }
    __syncthreads();   // every warp is done with this stage
  }
  cp_async_wait<0>();

  if (splits > 1) {
    const size_t tile = static_cast<size_t>(bh) * p.n_stat + rt;
    float flat[4 * KS];
#pragma unroll
    for (int i = 0; i < 4 * KS; ++i) flat[i] = dq[i / 4][i % 4];
    if (!sum_splits(flat, p.partials + tile * gridDim.x * kBThreads * (4 * KS),
                    p.tickets + tile, splits, rank, &s_last))
      return;
#pragma unroll
    for (int i = 0; i < 4 * KS; ++i) dq[i / 4][i % 4] = flat[i];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (R0 + rw + g + 8 * r >= p.rows) continue;
#pragma unroll
    for (int j = 0; j < KS; ++j)
      *reinterpret_cast<float2*>(p.dq + ref[r].qoff + 8 * j + 2 * t) =
          make_float2(dq[j][2 * r] * p.scale, dq[j][2 * r + 1] * p.scale);
  }
}

// How one pass of a backward call is cut: its stationary and streamed
// tiles, the streamed tiles a block takes at most, and the most splits of
// a stationary tile.
struct BwdPass {
  int n_stat, n_str, per, splits;
};

// A block takes at most `per` streamed tiles, so that the blocks of a
// causal call (about half of the tile pairs live) come to about
// kBWaves for every SM: the longest lists (key tile 0, the last
// row tiles) are cut to the size of the rest, and the blocks fill the card
// in about equal waves.
BwdPass bwd_pass(long long bh, int n_stat, int n_str) {
  BwdPass ps{n_stat, n_str, 1, 1};
  long long pairs = bh * n_stat * n_str / 2;
  pairs = pairs > 0 ? pairs : 1;
  const long long want = static_cast<long long>(kBWaves) * sm_count();
  const long long per = (pairs + want - 1) / want;
  ps.per = static_cast<int>(per < n_str ? per : n_str);
  ps.splits = (n_str + ps.per - 1) / ps.per;
  return ps;
}

struct BwdPlan {
  BwdPass kv, q;               // the dk/dv pass and the dq pass
  size_t partials, tickets;    // the workspace both need (one after another)
};

BwdPlan bwd_plan(int B, int T, int Hq, int Hkv, int S, int D) {
  const long long bh = static_cast<long long>(B) * Hkv;
  const long long rows = static_cast<long long>(T) * (Hq / Hkv);
  BwdPlan pl;
  pl.kv = bwd_pass(bh, static_cast<int>((S + kBT - 1) / kBT),
                   static_cast<int>((rows + kBS - 1) / kBS));
  pl.q = bwd_pass(bh, static_cast<int>((rows + kBT - 1) / kBT),
                  static_cast<int>((S + kBS - 1) / kBS));
  // dk/dv fragments: D floats a thread; dq: D / 2
  const size_t kv = pl.kv.splits > 1 ? static_cast<size_t>(bh) * pl.kv.n_stat *
                                           pl.kv.splits * kBThreads * D
                                     : 0;
  const size_t q = pl.q.splits > 1 ? static_cast<size_t>(bh) * pl.q.n_stat *
                                         pl.q.splits * kBThreads * (D / 2)
                                   : 0;
  pl.partials = kv > q ? kv : q;
  const size_t tk = pl.kv.splits > 1 ? static_cast<size_t>(bh) * pl.kv.n_stat
                                     : 0;
  const size_t tq = pl.q.splits > 1 ? static_cast<size_t>(bh) * pl.q.n_stat
                                    : 0;
  pl.tickets = tk > tq ? tk : tq;
  return pl;
}

template <int D>
int launch_bwd(BwdParams p, int B, const BwdPlan& pl, cudaStream_t stream) {
  static bool raised[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64)
    return static_cast<int>(cudaErrorInvalidDevice);
  const size_t smem_kv =
      (2 * kBT * (D + 4) + 2 * dkdv_stage_floats<D>() + pl.kv.n_str) * 4;
  const size_t smem_q =
      (2 * kBT * (D + 4) + 2 * dq_stage_floats<D>() + pl.q.n_str) * 4;
  if (smem_kv > kSmemMax || smem_q > kSmemMax)
    return static_cast<int>(cudaErrorInvalidValue);
  if (!raised[dev]) {   // allow the most; each launch asks for what it needs
    cudaError_t e = cudaFuncSetAttribute(
        flash_bwd_dkdv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(kSmemMax));
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(flash_bwd_dq_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kSmemMax));
    if (e != cudaSuccess) return static_cast<int>(e);
    raised[dev] = true;
  }
  const unsigned bhkv = static_cast<unsigned>(B * p.Hkv);
  p.n_stat = pl.kv.n_stat;
  p.n_str = pl.kv.n_str;
  p.per = pl.kv.per;
  flash_bwd_dkdv_kernel<D>
      <<<dim3(pl.kv.splits, bhkv, pl.kv.n_stat), kBThreads, smem_kv,
         stream>>>(p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  p.n_stat = pl.q.n_stat;
  p.n_str = pl.q.n_str;
  p.per = pl.q.per;
  flash_bwd_dq_kernel<D>
      <<<dim3(pl.q.splits, bhkv, pl.q.n_stat), kBThreads, smem_q, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The split workspace that flash_attention_bwd needs for these shapes:
// returns the f32 partials and sets *tickets to the ticket ints (both 0
// when no tile is split). As flash_attention_workspace: the caller zeroes
// the tickets once, and every call leaves them at 0.
extern "C" size_t flash_attention_bwd_workspace(int B, int T, int Hq,
                                                int Hkv, int S, int D,
                                                size_t* tickets) {
  *tickets = 0;
  if (!bwd_shapes_ok(B, T, Hq, Hkv, S, D) || S <= 0) return 0;
  const BwdPlan pl = bwd_plan(B, T, Hq, Hkv, S, D);
  *tickets = pl.tickets;
  return pl.partials;
}

// The backward of flash_attention (contiguous layout): dq (B, T, Hq, D),
// dk and dv (B, S, Hkv, D), f32, from q, k, v, q_pos, kv_pos (as the
// forward), its out and lse, and dout (B, T, Hq, D). `delta` is scratch of
// B * Hq * T floats that the caller owns, and the split workspace is
// flash_attention_bwd_workspace's. Three launches on `stream` (D_i, then
// dk/dv, then dq); returns cudaGetLastError() after the last
// (cudaErrorInvalidValue for shapes the kernels do not take or a smaller
// workspace). Allocates nothing, does not synchronise. window <= 0: no
// window; softcap <= 0: none.
extern "C" int flash_attention_bwd(const void* q, const void* k,
                                   const void* v, const void* q_pos,
                                   const void* kv_pos, const void* out,
                                   const void* dout, const void* lse,
                                   void* delta, void* dq, void* dk, void* dv,
                                   void* partials, size_t n_partials,
                                   void* tickets, size_t n_tickets, int B,
                                   int T, int Hq, int S, int Hkv, int D,
                                   int window, float softcap, void* stream) {
  if (!bwd_shapes_ok(B, T, Hq, Hkv, S, D) || S <= 0 ||
      static_cast<long long>(B) * Hkv > 65535 ||
      static_cast<long long>(B) * T * Hq > INT_MAX / 64)
    return static_cast<int>(cudaErrorInvalidValue);
  const BwdPlan pl = bwd_plan(B, T, Hq, Hkv, S, D);
  if (pl.kv.n_stat > 65535 || pl.q.n_stat > 65535 ||
      n_partials < pl.partials || n_tickets < pl.tickets ||
      (pl.tickets > 0 && (partials == nullptr || tickets == nullptr)))
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
  p.rows = T * p.G;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_rows = B * T * Hq;
  flash_bwd_delta_kernel<<<(n_rows + kDeltaThreads / 32 - 1) /
                               (kDeltaThreads / 32),
                           kDeltaThreads, 0, st>>>(p.out, p.dout, p.delta,
                                                   n_rows, T, Hq, D);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  switch (D) {
    case 8:
      return launch_bwd<8>(p, B, pl, st);
    case 16:
      return launch_bwd<16>(p, B, pl, st);
    case 32:
      return launch_bwd<32>(p, B, pl, st);
    case 64:
      return launch_bwd<64>(p, B, pl, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
