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
// Precision: 3xTF32 on the tensor cores. Both products (q.k and p.v)
//   multiply two inexact f32 operands, and the port holds the kernel to
//   2e-5 of the f32 result. One TF32 rounding of each operand leaves ~1e-3
//   and two bf16 pieces ~1.5e-5 (75% of the tolerance) at causal T = S =
//   512, D = 64. So each operand x is split into big = x rounded to TF32
//   and small = x - big (exact) truncated to TF32, and each product is
//   small.big + big.small + big.big with f32 accumulation; small.small and
//   small's truncation leave ~2^-20 |x||y|. The split is two integer ops,
//   a subtract and a mask, cheaper than two cvt.rna.tf32.f32. Decode from
//   D = 128 takes no pieces: it runs in f32 on the CUDA cores.
//   tests/test_torch_flash_split.py emulates every scheme (tiles, pieces,
//   online softmax, the split-KV combines, the decode work list) on the
//   CPU and shows one TF32 piece failing the tolerance.
//
// What bounds it on H100: at decode (one query row per slot) the kernel
//   reads each kv head's visible K/V once for 4*D*G flops per key, so it
//   is bound by bytes (8 KB per key across the 8 kv heads at D = 64; 16 KB
//   at gemma2's D = 256, whose rings of 4096 keys make a decode tick's
//   largest byte stream). At prefill (T = S = 512, causal) it does
//   ~T*S/2*4*D flops per q head against scores that never leave the SM:
//   bound by tensor-core operations (three TF32 products at 495 TFLOP/s).
//
// Head dims 8 to 64 (flash_body, mma.sync.m16n8k8):
//   - One block of 4 warps per (batch row, kv head, row tile[, KV split]).
//     Its rows are (query row, q head) pairs of that kv head's GQA group,
//     row R = t * G + g, so each K/V tile is read once per group and row
//     tile and shared by all G q heads.
//   - Prefill and chunks (G*T > 16 rows): 64-row tiles, 16 rows a warp;
//     K/V tiles of 64 keys stream through a double-buffered cp.async ring
//     in dynamic shared memory that all warps share. Rows are padded (K to
//     D + 8 floats, V to D + 4) so that the fragment loads are free of
//     bank conflicts; K's are 8-byte loads (the d order inside a k8 step
//     is permuted to match). Each warp splits the K/V values it reads.
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
//   - Split-KV when the row tiles leave SMs idle (decode; also prefill of
//     one short sequence): the live tiles are split evenly over up to
//     kMaxSplit blocks, aiming at two blocks per SM. Each block writes its
//     rows' (m, l, acc) to a workspace that the wrapper owns (one per
//     stream); a ticket elects the block that finishes last, which
//     combines the partials in split order (a split that saw no key has
//     l = 0 and weighs 0) and rearms the ticket. One launch, no atomics
//     on the output: the same inputs give the same bits.
//
// Head dims 128 and 256, row tiles (G*T > 8 rows; wg_body): the same
//   function, rows, skipping, masks, softmax and split combine, with the
//   products on wgmma and the work on Hopper's asynchronous units:
//   - A block holds a producer warpgroup and two consumer warpgroups, one
//     block an SM (193 KB of shared memory at D = 128, 225 KB at 256). At
//     D = 128 the consumers hold 64 rows each, so 128 rows share each
//     tile; at D = 256, where q's pieces for 64 rows alone take 128 KB,
//     both hold the block's 64 rows and each 128 of the columns: each sums
//     q.k over its columns, the two sums meet in shared memory and are
//     added in warpgroup order (both get the same bits), both run the same
//     softmax, each adds p.v to its columns. Twelve warps launch with 168
//     registers a thread; setmaxnreg takes the producer warpgroup down to
//     56 and the consumers up to 224 (no spill).
//   - q's rows, scaled, are split once at the block's start into big and
//     small planes in shared memory (K-major, 128-byte swizzle).
//   - One producer warp walks the block's live tiles (KT = 32 keys, 16 at
//     D = 256; it finds the next one while the last one's copies land)
//     and lands each tile's raw K and V rows in a stage through
//     cp.async.bulk on an mbarrier's transaction count: a paged tile one
//     copy per page (a page of one kv head is page*D contiguous floats), a
//     ring tile one copy of the slot's stretch, a contiguous tile (rows
//     Hkv*D apart) one copy per key, a lane each; with the tile it stores
//     its keys' positions and whether every row sees every key (most tiles
//     of a causal prefill: they skip the mask). Bulk copies need no tensor
//     map (no libcuda, no host-side descriptor per call). Every head's
//     last row tile, the longest under a causal mask, is issued first.
//   - The consumers split each tile once, in shared memory, into the
//     planes wgmma reads: K big and small as it lies (keys as rows), V
//     transposed (d as rows, keys permuted inside each 8-key step as the
//     scores' accumulator holds them), with 128-byte (K; V at D = 128) or
//     64-byte (V at D = 256, 16-key rows) swizzle; a key that no row may
//     see is 0. The split frees the stage, so the next tile's copy lands
//     under this tile's products.
//   - S = q.k^T: wgmma.m64nKTk8 tf32, A (q's pieces) and B (K's planes)
//     from shared memory, three products a k8 step. p.v: wgmma.m64n128k8
//     with A = p's pieces in registers (the scores' accumulator layout)
//     and B = V^T's planes, three products a k8 step. The mask and online
//     softmax run on the scores' accumulator in base 2 (q is scaled by
//     log2 e: exp2f, not expf); a row whose max held keeps its
//     accumulator as is (x * 1 is x).
//   - Bound at prefill by the consumers' CUDA-core work between the
//     products (the softmax, then the split): benchmarks/
//     torch_flash_fwd_phases.py cuts each phase and times the rest; two
//     warpgroups halve the split a row needs and hide each other's
//     latency. Not yet: ping-pong between the warpgroups (one's softmax
//     under the other's products), and a second block an SM.
//
// Head dims 128 and 256, decode (G*T <= 8 rows; decode_body): bound by
//   bytes, so f32 on the CUDA cores (no pieces, no staging): lanes hold
//   columns, each warp streams 4-key chunks of its keys with 16-byte loads
//   straight to registers, sums its rows' partial dots over the lanes by a
//   transposing butterfly and runs the online softmax on the sums; rows
//   padded to 2, 4 or 8 (flash_decode_kernel<D, RP>). The grid is a whole
//   number of blocks per SM, set by the shapes alone (a captured CUDA
//   graph stays valid while lens change); each block derives the work list
//   from lens / chunk_lens and takes one item (slot, kv head, a range of
//   the slot's 16-key units): an idle slot gets none (its rows are
//   written 0), a long context many. The warps' and the items' partials
//   are combined in order, so the same inputs give the same bits.
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
constexpr float kLog2e = 1.4426950408889634f;   // the D >= 128 kernels'
constexpr float kLn2 = 0.6931471805599453f;     // softmax runs in base 2

// a running max of base-2 scores in base e (a row that saw no key keeps
// the sentinel, as the base-e kernels leave it)
__device__ __forceinline__ float max_to_base_e(float m2) {
  return m2 <= kNegInf ? kNegInf : m2 * kLn2;
}
constexpr int kMaxSplit = 32;   // KV splits of one row tile, at most

// Keys of a tile of the D <= 64 kernels: 64 (row tiles) or 16 (warp
// split).
__host__ __device__ constexpr int tile_keys(bool ws) { return ws ? 16 : 64; }
// Key rows of their ring (two stages of tiles, or two tiles for each of
// four warps).
constexpr int kRingKeys = 128;
// Floats of the ring: its key rows of K and V, and room for the combines'
// scratch (which reuses it after the loop).
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
  const float* kc;          // ring only: the chunk's own K, V
  const float* vc;
  float* out;
  float* lse;               // (B, Hq, T) log-sum-exp of each row, or null
  float* partials;          // splits > 1: [tile][split][RB][D + 2]
  int* tickets;             // splits > 1: [tile]
  int B, T, Hq, Hkv, G, S, nb, page, W, window;
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

// The split combine, run by the block that drew a row tile's last ticket
// (all NT threads): `parts` holds each split's rows, acc [RB][D] then
// (m, l) [RB]; `scratch` is RB * (2 * kMaxSplit + 1) floats of shared
// memory. Each split's rows weigh exp(m_j - M) (0 for a split that saw no
// key) and are summed in split order: the same inputs give the same bits.
template <int D, int RB, int NT, bool NAMED = false>
__device__ __forceinline__ void combine_splits(const Params& p,
                                               const float* parts, int splits,
                                               int b, int h, int row0,
                                               float* scratch) {
  constexpr int CH = D / 4;
  constexpr int kPart = RB * (D + 2);
  const int tid = threadIdx.x;
  // threads 0 .. NT - 1 combine: the whole block, or (NAMED) the ones that
  // meet at barrier 1
  auto sync = [] {
    if constexpr (NAMED)
      asm volatile("bar.sync 1, %0;\n" ::"n"(NT) : "memory");
    else
      __syncthreads();
  };
  // weights exp(m_j - M) of each split's rows (0 for a split that saw no
  // key) and 1 / sum_j l_j w_j, in `scratch`. The
  // loads of all splits are issued before any is used (from L2: __ldcg,
  // this SM's L1 is not coherent with the other blocks' stores).
  float* wsm = scratch;                   // [RB][kMaxSplit]: m_j, then w_j
  float* lsm = scratch + RB * kMaxSplit;  // [RB][kMaxSplit]: l_j
  float* inv_s = lsm + RB * kMaxSplit;    // [RB]
  const int n_rows = min(RB, p.rows - row0);
  constexpr int kInFlight = 4;   // (row, split) loads a thread has in flight
  for (int f0 = 0; f0 < n_rows * splits; f0 += kInFlight * NT) {
    float2 ml[kInFlight];
#pragma unroll
    for (int q = 0; q < kInFlight; ++q) {
      const int f = f0 + q * NT + tid;
      const int rl = f / splits, j = f - rl * splits;
      ml[q] = f < n_rows * splits
                  ? __ldcg(reinterpret_cast<const float2*>(
                        parts + static_cast<size_t>(j) * kPart + RB * D +
                        2 * rl))
                  : make_float2(0.f, 0.f);
    }
#pragma unroll
    for (int q = 0; q < kInFlight; ++q) {
      const int f = f0 + q * NT + tid;
      const int rl = f / splits, j = f - rl * splits;
      if (f < n_rows * splits) {
        wsm[rl * kMaxSplit + j] = ml[q].x;
        lsm[rl * kMaxSplit + j] = ml[q].y;
      }
    }
  }
  sync();
  for (int rl = tid; rl < n_rows; rl += NT) {
    float* w = wsm + rl * kMaxSplit;
    const float* lj = lsm + rl * kMaxSplit;
    float M = kNegInf;
    for (int j = 0; j < splits; ++j)
      if (lj[j] > 0.f) M = fmaxf(M, w[j]);
    float L = 0.f;
    for (int j = 0; j < splits; ++j) {
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
  sync();
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
    for (int j0 = 0; j0 < splits; j0 += kBatch) {
      float4 a[2][kBatch];
      float wq[2][kBatch];
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int q = 0; q < kBatch; ++q) {
          wq[e][q] = ok[e] && j0 + q < splits
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
  static_assert(D <= 64, "head dims 128 and 256 run wg_body");
  constexpr int KT = tile_keys(WS);       // keys of a tile
  constexpr int RB = WS ? 16 : 16 * NW;   // rows of a block
  constexpr int LDK = D + 8;           // padded shared K row, floats
  constexpr int LDV = D + 4;           // padded shared V row, floats
  constexpr int KS = D / 8;            // k8 steps over D
  constexpr int NJ = KT / 8;           // 8-key steps over a tile
  constexpr int CH = D / 4;            // 16-byte chunks of one key row
  constexpr int kBuf = KT * (LDK + LDV);   // one tile: K then V, floats
  static_assert(NJ * 4 <= 32, "the visibility mask is one word");
  static_assert((WS ? 2 * NW : 2) * kBuf <= ring_floats(D, RB) &&
                    (WS ? 2 * NW : 2) * KT <= kRingKeys,
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
    for (int kk = 0; kk < KS; ++kk) {
      const uint32_t(&ab)[4] = qb[kk];
      const uint32_t(&as)[4] = qs[kk];
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

  combine_splits<D, RB, NT>(p, parts, p.splits, b, h, row0, ring);
  if (tid == 0) p.tickets[tile_id] = 0;   // ready for the next call
}

// ---------------------------------------------------------------------------
// head dims 128 and 256: row tiles on wgmma (a producer warpgroup, two
// consumer warpgroups), decode in f32 on the CUDA cores
// ---------------------------------------------------------------------------

// Row tiles (wg_body): keys of a tile (32; 16 at D = 256, where q's pieces
// for 64 rows take 128 KB); raw stages in the load ring (one: a tile's
// split frees it, so the next tile's copy lands under this one's
// products); consumer warpgroups, which split a block's rows at D = 128
// and its columns at D = 256; rows and threads of a block (the consumers,
// then the producer warpgroup).
__host__ __device__ constexpr int wg_keys(int D) { return D >= 256 ? 16 : 32; }
constexpr int kWgStages = 1;
constexpr int kWgGroups = 2;
__host__ __device__ constexpr bool wg_split_columns(int D) { return D >= 256; }
__host__ __device__ constexpr int wg_rows(int D) {
  return wg_split_columns(D) ? 64 : 64 * kWgGroups;
}
// The producer is a whole warpgroup (setmaxnreg moves registers a
// warpgroup at a time; one of its warps issues the copies, three leave), so
// a block is 12 warps, which launch with 168 registers a thread: the
// producer gives back all but 56, the consumers take 224.
constexpr int kWgThreads = 128 * kWgGroups + 128;
constexpr int kProducerRegs = 56, kConsumerRegs = 224;
static_assert(128 * kProducerRegs + 128 * kWgGroups * kConsumerRegs <=
                  65536 && kWgThreads * 168 <= 65536,
              "the register moves fit the register file");
// Bytes of one q piece for 64 rows ([D/32][64 rows][128 B]) and of one K,
// K small, V^T or V^T small plane of a tile; the block's dynamic shared
// memory: q's two pieces for its rows, the four planes, the raw stages (K
// then V, [KT][D] as they lie), and 1024 bytes to align the swizzled
// regions: 193 KB at D = 128, 225 KB at 256.
__host__ __device__ constexpr int wg_q_bytes(int D) { return 64 * D * 4; }
__host__ __device__ constexpr int wg_plane_bytes(int D) {
  return wg_keys(D) * D * 4;
}
__host__ __device__ constexpr int wg_smem_bytes(int D) {
  return 1024 + 2 * (wg_rows(D) / 64) * wg_q_bytes(D) + 4 * wg_plane_bytes(D) +
         2 * kWgStages * wg_plane_bytes(D);
}
// Decode (decode_body, G*T <= 8 rows): rows of an item (padded), keys of a
// unit (tile) and of a chunk, warps and blocks an SM holds.
constexpr int kDecRows = 8;
constexpr int kDecKeys = 16;
constexpr int kDecChunk = 4;
constexpr int kDecWarps = 4;
__host__ __device__ constexpr int dec_blocks_per_sm(int D) {
  return D >= 256 ? 2 : 3;
}

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}
// Wait for the phase of `bar` with this parity to complete. A phase that
// never completes (a lost copy) traps after ~10 s instead of hanging the
// card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  const long long t0 = clock64();
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > (1LL << 34)) asm volatile("trap;");
  }
}
// `bytes` (a multiple of 16) from global to shared memory, both 16-byte
// aligned, completing on `bar`'s transaction count
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}
// the consumer warpgroups' own barrier (id 1; the block's is 0)
template <int NC>
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(NC) : "memory");
}
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// generic-proxy stores to shared memory -> visible to wgmma (async proxy)
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// Registers that a wgmma reads or writes asynchronously: kept live and in
// place across its issue and its wait.
template <int N>
__device__ __forceinline__ void keep(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void keep(uint32_t (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// Byte offset of byte `a` of a K-major tile with RB-byte rows (128 or 64)
// under wgmma's RB-byte swizzle: the 16-byte chunk index is XORed with
// address bits 7.. (row % 8 for 128-byte rows, (row / 2) % 4 for 64-byte
// ones); regions start 1024-aligned.
template <int RB>
__device__ __forceinline__ uint32_t swz(uint32_t a) {
  return a ^ (((a >> 7) & (RB / 16 - 1)) << 4);
}
// wgmma shared-memory descriptor: K-major, RB-byte swizzle (layout 1 for
// 128 B, 2 for 64 B), 8-row groups 8 * RB bytes apart.
template <int RB>
__device__ __forceinline__ uint64_t wg_desc(uint32_t saddr) {
  return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>((8 * RB) >> 4) << 32) |
         (static_cast<uint64_t>(RB == 128 ? 1 : 2) << 62);
}

// d (64 x N f32 fragment) [+]= A (64 x 8, shared) B (8 x N, shared), tf32;
// acc = 0 ignores d's input
__device__ __forceinline__ void wgmma_tf32_m64n16_ss(float (&d)[8],
                                                     uint64_t da, uint64_t db,
                                                     int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(acc));
}
__device__ __forceinline__ void wgmma_tf32_m64n32_ss(float (&d)[16],
                                                     uint64_t da, uint64_t db,
                                                     int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, %16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(da), "l"(db), "r"(acc));
}
template <int N>
__device__ __forceinline__ void wgmma_scores(float (&d)[N / 2], uint64_t da,
                                             uint64_t db, int acc) {
  if constexpr (N == 16)
    wgmma_tf32_m64n16_ss(d, da, db, acc);
  else
    wgmma_tf32_m64n32_ss(d, da, db, acc);
}
// d (64 x 128 f32 fragment) += A (64 x 8, registers) B (8 x 128, shared),
// tf32. A's fragment: a0 (row g, k t), a1 (g + 8, t), a2 (g, t + 4), a3
// (g + 8, t + 4) of each warp's 16 rows, as mma.m16n8k8's.
__device__ __forceinline__ void wgmma_tf32_m64n128_rs(float (&d)[64],
                                                      const uint32_t (&a)[4],
                                                      uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, 1, 1, "
      "1;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

__device__ __forceinline__ void split4(float4 x, uint4& big, uint4& small) {
  split_tf32(x.x, big.x, small.x);
  split_tf32(x.y, big.y, small.y);
  split_tf32(x.z, big.z, small.z);
  split_tf32(x.w, big.w, small.w);
}

// The live-key helpers of one slot b: keys' positions, rows and the tiles
// that may hold a visible key. Tiles of KT keys; the ring's W slots
// and the chunk's T keys tile apart (ceil(W / KT) ring tiles, then
// ceil(T / KT) chunk tiles).
template <int KT, bool RING>
struct Keys {
  struct Src {   // the fields of Params that locate keys
    const int* q_pos;
    const int* kv_pos;
    const int* block_table;
    int T, Hkv, S, nb, page, W;
  } p;
  int b, n_rt, n_tiles, s_end, last, clen;
  bool paged;

  __device__ __forceinline__ Keys(const Params& pp, int b_)
      : p{pp.q_pos, pp.kv_pos, pp.block_table, pp.T, pp.Hkv, pp.S, pp.nb,
          pp.page, pp.W},
        b(b_) {
    paged = !RING && p.block_table != nullptr;
    n_rt = RING ? (p.W + KT - 1) / KT : 0;
    n_tiles = RING ? n_rt + (p.T + KT - 1) / KT : (p.S + KT - 1) / KT;
    s_end = paged ? min(p.nb * p.page, pp.lens[b] + pp.chunk_lens[b]) : p.S;
    last = RING ? pp.lens[b] - 1 : 0;
    clen = RING ? pp.chunk_lens[b] : 0;
  }
  // the position ring slot s < W holds (-1: not yet written)
  __device__ __forceinline__ int ring_pos(int s) const {
    int d = (last - s) % p.W;
    d += d < 0 ? p.W : 0;
    const int pos = last - d;
    return pos < 0 ? -1 : pos;
  }
  // key j of tile k: its position (-1: no key, or invisible to every row)
  __device__ __forceinline__ int pos(int k, int j) const {
    if (RING) {
      if (k < n_rt) {
        const int s = k * KT + j;
        return s < p.W ? ring_pos(s) : -1;
      }
      const int c = (k - n_rt) * KT + j;
      return c < clen ? p.q_pos[static_cast<size_t>(b) * p.T + c] : -1;
    }
    const int s = k * KT + j;
    if (paged)
      return s < s_end && p.block_table[static_cast<size_t>(b) * p.nb +
                                        s / p.page] >= 0
                 ? s
                 : -1;
    return s < p.S ? p.kv_pos[static_cast<size_t>(b) * p.S + s] : -1;
  }
  // key j of tile k (a key, pos >= 0) of kv head h: its row in k / v
  // (chunk: false) or in the chunk's kc / vc (chunk: true)
  __device__ __forceinline__ size_t row(int k, int j, int h,
                                        bool& chunk) const {
    chunk = false;
    if (RING) {
      if (k < n_rt)
        return (static_cast<size_t>(b) * p.Hkv + h) * p.W + k * KT + j;
      chunk = true;
      return (static_cast<size_t>(b) * p.T + (k - n_rt) * KT + j) * p.Hkv +
             h;
    }
    const int s = k * KT + j;
    if (paged) {
      const int pid = p.block_table[static_cast<size_t>(b) * p.nb + s / p.page];
      return (static_cast<size_t>(pid) * p.Hkv + h) * p.page + s % p.page;
    }
    return (static_cast<size_t>(b) * p.S + s) * p.Hkv + h;
  }
  // does tile k hold a key whose position lies in [lo, hi]? (lanes j,
  // j + 32, ... of a warp test its keys)
  __device__ __forceinline__ bool live_warp(int k, int lo, int hi,
                                            int lane) const {
    bool any = false;
    if (lo <= hi)
      for (int j = lane; j < KT; j += 32) {
        const int ps = pos(k, j);
        any |= ps >= lo && ps <= hi;
      }
    return __any_sync(0xffffffffu, any);
  }
  // a slot's units (its tiles that may hold a visible key, in order: the
  // written ring slots' tiles, then the chunk's) and its ring units
  __device__ __forceinline__ static int ring_units(const Params& p, int bb) {
    return (min(max(p.lens[bb], 0), p.W) + KT - 1) / KT;
  }
  __device__ __forceinline__ static int units(const Params& p, int bb) {
    if (RING) return ring_units(p, bb) + (p.chunk_lens[bb] + KT - 1) / KT;
    if (p.block_table != nullptr)
      return (min(p.nb * p.page, p.lens[bb] + p.chunk_lens[bb]) + KT - 1) /
             KT;
    return (p.S + KT - 1) / KT;
  }
};

// Grid (splits, B * Hkv, row_tiles): every head's last row tile (the
// longest under a causal mask) is issued first; two consumer warpgroups (warp w of a warpgroup holds rows 16w .. 16w + 15,
// the wgmma accumulator layout), then the producer warpgroup (one warp of
// it works). D = 128: the
// warpgroups hold 64 rows each (128 a block) and every column. D = 256
// (CS, columns split): both hold the block's 64 rows, and warpgroup c the
// columns 128c .. 128c + 127: it sums q.k over them, the two sums are
// exchanged through shared memory and added in warpgroup order (both get
// the same bits), both run the same softmax, and each adds p.v to its
// columns.
template <int D, bool RING>
__device__ __forceinline__ void wg_body(const Params& p) {
  constexpr int KT = wg_keys(D), RS = kWgStages, NCW = kWgGroups;
  constexpr bool CS = wg_split_columns(D);
  constexpr int RB = wg_rows(D);           // rows of a block
  constexpr int NC = 128 * NCW, NT = kWgThreads, NWT = NT / 32;
  constexpr int KS = CS ? D / 16 : D / 8;  // k8 steps of q.k a warpgroup
  constexpr int NJ = KT / 8;       // k8 steps over a tile's keys (p.v)
  constexpr int QP = wg_q_bytes(D), PL = wg_plane_bytes(D);
  constexpr int VRB = KT * 4;      // bytes of a V^T plane row: 128 or 64
  constexpr int CH = D / 4;        // float4s of a key row
  static_assert(D == 128 || D == 256, "wg_body serves D = 128 and 256");

  extern __shared__ uint8_t wg_smem_raw[];
  uint8_t* sm = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(wg_smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* qpl = sm;   // [RB / 64][big, small][D/32][64 rows][128 B]
  uint8_t* k_big = sm + 2 * (RB / 64) * QP;   // [D/32][KT keys][128 B]
  uint8_t* k_small = k_big + PL;
  uint8_t* v_big = k_small + PL;   // V^T: [D][KT keys, permuted]
  uint8_t* v_small = v_big + PL;
  float* raw = reinterpret_cast<float*>(v_small + PL);   // [RS][K, V][KT][D]
  __shared__ uint64_t full[RS], empty[RS];
  __shared__ int tile_s[RS];
  __shared__ bool full_s[RS];   // every key of the tile visible to every row
  __shared__ int kpos_s[RS][KT];
  __shared__ int s_red[NWT][3];
  __shared__ bool s_last;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, rt = p.row_tiles - 1 - blockIdx.z;
  const int b = bh / p.Hkv, h = bh % p.Hkv;
  const int row0 = rt * RB, split = blockIdx.x;
  const Keys<KT, RING> keys(p, b);

  // this thread's rows g and g + 8 (consumer warps): positions, and the
  // block's range [lo, hi] of a visible key's position
  int qp[2] = {-1, -1};
  size_t qoff[2] = {0, 0};
  const int wg = warp / 4;   // a consumer's warpgroup
  const int wrow0 = row0 + (CS ? warp % 4 : warp) * 16;
  int mn = INT_MAX, mx = INT_MIN;
  if (warp < NC / 32) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int R = wrow0 + g + 8 * r;
      const int tq = R / p.G, gq = R - tq * p.G;
      qoff[r] = ((static_cast<size_t>(b) * p.T + tq) * p.Hq + h * p.G + gq) * D;
      if (R < p.rows) {
        qp[r] = p.q_pos[static_cast<size_t>(b) * p.T + tq];
        mn = min(mn, qp[r]);
        mx = max(mx, qp[r]);
      }
    }
  }
  mn = __reduce_min_sync(0xffffffffu, mn);
  mx = __reduce_max_sync(0xffffffffu, mx);
  if (lane == 0) {
    s_red[warp][0] = mn;
    s_red[warp][1] = mx;
  }
  if (tid < RS) {
    mbar_init(&full[tid], 1);
    mbar_init(&empty[tid], 1);
  }
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  __syncthreads();
#pragma unroll
  for (int w = 0; w < NWT; ++w) {
    mn = min(mn, s_red[w][0]);
    mx = max(mx, s_red[w][1]);
  }
  const long long lo_ll =
      p.window > 0 ? static_cast<long long>(mn) - p.window + 1 : 0;
  const int lo = static_cast<int>(lo_ll < 0 ? 0 : lo_ll);
  const int hi = mx;

  // the live tiles, and this split's share [i0, i1) of them
  int cnt = 0;
  for (int k = warp; k < keys.n_tiles; k += NWT)
    cnt += keys.live_warp(k, lo, hi, lane);
  if (lane == 0) s_red[warp][2] = cnt;
  __syncthreads();
  int count = 0;
#pragma unroll
  for (int w = 0; w < NWT; ++w) count += s_red[w][2];
  const int i0 = static_cast<int>(static_cast<long long>(count) * split /
                                  p.splits);
  const int i1 = static_cast<int>(static_cast<long long>(count) *
                                  (split + 1) / p.splits);

  // The roles never meet again: the producer warpgroup returns when its
  // copies are issued, the consumers end the block (setmaxnreg needs the
  // paths apart).
  if (warp >= NC / 32) {
    setmaxnreg_dec<kProducerRegs>();
    if (warp > NC / 32) return;
    // ---- producer: the live tiles [i0, i1), each into the next stage:
    // its keys' positions, then its K and V rows by bulk copies. The next
    // live tile and its positions are found while this one's copies land
    // and the consumers work. ----
    constexpr int NQ = (KT + 31) / 32;
    int ps[NQ];
    // the first live tile from k0 (n_tiles: none), its positions in ps
    auto scan = [&](int k0) -> int {
      for (int k = k0; k < keys.n_tiles; ++k) {
        bool any = false;
#pragma unroll
        for (int q = 0; q < NQ; ++q) {
          const int j = lane + 32 * q;
          ps[q] = j < KT ? keys.pos(k, j) : -1;
          any |= ps[q] >= lo && ps[q] <= hi;
        }
        if (__any_sync(0xffffffffu, any)) return k;
      }
      return keys.n_tiles;
    };
    int k = scan(0);
    for (int n = 0; n < i0; ++n) k = scan(k + 1);
    for (int it = 0; it < i1 - i0; ++it) {
      const int st = it % RS;
      mbar_wait(&empty[st], ((it / RS) & 1) ^ 1);
      float* rk = raw + static_cast<size_t>(st) * 2 * KT * D;
      float* rv = rk + KT * D;
      uint32_t bytes = 0;
      int kmin = INT_MAX, kmax = INT_MIN;
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        const int j = lane + 32 * q;
        if (j < KT) {
          kpos_s[st][j] = ps[q];
          kmin = min(kmin, ps[q] < 0 ? INT_MIN : ps[q]);
          kmax = max(kmax, ps[q]);
        }
      }
      kmin = __reduce_min_sync(0xffffffffu, kmin);
      kmax = __reduce_max_sync(0xffffffffu, kmax);
      if (lane == 0)
        full_s[st] = kmin >= 0 && kmax <= mn &&
                     (p.window <= 0 ||
                      static_cast<long long>(mx) - kmin < p.window);
      __syncwarp();   // the positions are stored before lane 0 arrives
      // one copy of a run of keys contiguous in memory: a lane's own key
      // (contiguous K/V, the chunk's keys), a page's run (paged) or the
      // ring's run (lane 0)
      auto run = [&](int j0, int n_k, bool issue) {
        bool chunk;
        const size_t r0 = keys.row(k, j0, h, chunk);
        const uint32_t nb = static_cast<uint32_t>(n_k) * D * 4;
        if (!issue) {
          bytes += 2 * nb;
          return;
        }
        const float* kb = chunk ? p.kc : p.k;
        const float* vb = chunk ? p.vc : p.v;
        bulk_load(rk + j0 * D, kb + r0 * D, nb, &full[st]);
        bulk_load(rv + j0 * D, vb + r0 * D, nb, &full[st]);
      };
      for (int pass = 0; pass < 2; ++pass) {
        const bool issue = pass == 1;
        if (issue) {
          bytes = __reduce_add_sync(0xffffffffu, bytes);
          if (lane == 0) {
            tile_s[st] = k;
            mbar_expect_tx(&full[st], bytes);
          }
          __syncwarp();
        }
        if (RING && k < keys.n_rt) {
          if (lane == 0) run(0, min(KT, p.W - k * KT), issue);
        } else if (keys.paged) {
          // the tile's keys below s_end, one run per page that holds one
          const int s0 = k * KT, s1 = min(s0 + KT, keys.s_end);
          for (int pg = s0 / p.page + lane; pg * p.page < s1; pg += 32) {
            if (p.block_table[static_cast<size_t>(b) * p.nb + pg] < 0)
              continue;
            const int a = max(s0, pg * p.page);
            run(a - s0, min(s1, (pg + 1) * p.page) - a, issue);
          }
        } else {
#pragma unroll
          for (int q = 0; q < NQ; ++q)
            if (ps[q] >= 0) run(lane + 32 * q, 1, issue);
        }
      }
      if (it + 1 < i1 - i0) k = scan(k + 1);
    }
    return;
  }
  setmaxnreg_inc<kConsumerRegs>();

  // the warpgroup's 128 output columns from col0: acc[4n + e] holds row g
  // + 8 (e >> 1), column col0 + 8n + 2t + (e & 1)
  const int col0 = CS ? 128 * wg : 0;
  float acc[64];
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;

  if (i1 > i0) {
    // ---- consumers ----
    // q's rows, scaled, as TF32 pieces in shared memory, made once
#pragma unroll 4
    for (int u = tid; u < RB * CH; u += NC) {
      const int rl = u / CH, f = u - rl * CH, R = row0 + rl;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (R < p.rows) {
        const int tq = R / p.G;
        x = *reinterpret_cast<const float4*>(
            p.q + ((static_cast<size_t>(b) * p.T + tq) * p.Hq + h * p.G +
                   (R - tq * p.G)) * D + 4 * f);
      }
      const float sc2 = p.scale * kLog2e;   // scores in base 2
      x = make_float4(x.x * sc2, x.y * sc2, x.z * sc2, x.w * sc2);
      uint4 big, small;
      split4(x, big, small);
      uint8_t* qg = qpl + (rl / 64) * 2 * QP;
      const uint32_t off =
          (f / 8) * (64 * 128) + swz<128>((rl % 64) * 128 + (f % 8) * 16);
      *reinterpret_cast<uint4*>(qg + off) = big;
      *reinterpret_cast<uint4*>(qg + QP + off) = small;
    }
    fence_async_smem();
    const uint32_t qb_a = smem_u32(qpl + (CS ? 0 : wg) * 2 * QP);
    const uint32_t qs_a = qb_a + QP;
    const uint32_t kb_a = smem_u32(k_big), ks_a = smem_u32(k_small);
    const uint32_t vb_a = smem_u32(v_big), vs_a = smem_u32(v_small);

    for (int it = 0; it < i1 - i0; ++it) {
      const int st = it % RS;
      mbar_wait(&full[st], (it / RS) & 1);
      const int* kps = kpos_s[st];
      // every warp is done with the last tile's planes
      consumers_sync<NC>();
      // split the raw tile into the planes, once: K as it lies (keys as
      // rows), V transposed (d as rows), keys inside each 8-key step
      // permuted as the scores' accumulator holds them (logical k = m is
      // key 2m, k = 4 + m is key 2m + 1); keys that no row may see are 0
      const float* rk = raw + static_cast<size_t>(st) * 2 * KT * D;
      const float* rv = rk + KT * D;
#pragma unroll
      for (int u = tid; u < KT * CH; u += NC) {
        const int j = u / CH, f = u - j * CH;
        float4 x = reinterpret_cast<const float4*>(rk)[u];
        if (kps[j] < 0) x = make_float4(0.f, 0.f, 0.f, 0.f);
        uint4 big, small;
        split4(x, big, small);
        const uint32_t off =
            (f / 8) * (KT * 128) + swz<128>(j * 128 + (f % 8) * 16);
        *reinterpret_cast<uint4*>(k_big + off) = big;
        *reinterpret_cast<uint4*>(k_small + off) = small;
      }
#pragma unroll
      for (int u = tid; u < D * (KT / 4); u += NC) {
        const int d = u % D, r = u / D, j8 = r >> 1, odd = r & 1;
        float x[4];
#pragma unroll
        for (int mm = 0; mm < 4; ++mm) {
          const int key = 8 * j8 + 2 * mm + odd;
          x[mm] = kps[key] >= 0 ? rv[key * D + d] : 0.f;
        }
        uint4 big, small;
        split4(make_float4(x[0], x[1], x[2], x[3]), big, small);
        const uint32_t off = swz<VRB>(d * VRB + 32 * j8 + 16 * odd);
        *reinterpret_cast<uint4*>(v_big + off) = big;
        *reinterpret_cast<uint4*>(v_small + off) = small;
      }
      // the positions, for the mask, before the stage is refilled
      const bool full = full_s[st];
      int kp[NJ][2];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        kp[j][0] = kps[j * 8 + 2 * t];
        kp[j][1] = kps[j * 8 + 2 * t + 1];
      }
      fence_async_smem();
      consumers_sync<NC>();
      if (tid == 0) mbar_arrive(&empty[st]);   // the raw stage is free

      // scores: small.big + big.small + big.big per k8 step (CS: over
      // the warpgroup's columns)
      float sc[KT / 2];
#pragma unroll
      for (int i = 0; i < KT / 2; ++i) sc[i] = 0.f;
      keep(sc);
      wgmma_fence();
#pragma unroll
      for (int k8 = 0; k8 < KS; ++k8) {
        const int kk = (CS ? wg * KS : 0) + k8;
        const uint32_t qo = (kk / 4) * (64 * 128) + (kk % 4) * 32;
        const uint32_t ko = (kk / 4) * (KT * 128) + (kk % 4) * 32;
        wgmma_scores<KT>(sc, wg_desc<128>(qs_a + qo), wg_desc<128>(kb_a + ko),
                         k8 > 0);
        wgmma_scores<KT>(sc, wg_desc<128>(qb_a + qo), wg_desc<128>(ks_a + ko),
                         1);
        wgmma_scores<KT>(sc, wg_desc<128>(qb_a + qo), wg_desc<128>(kb_a + ko),
                         1);
      }
      wgmma_commit();
      wgmma_wait_all();
      keep(sc);
      if constexpr (CS) {
        // the two column halves' sums, through the K small plane (both
        // warpgroups' products are done with it), added in warpgroup
        // order: [warpgroup][thread][KT / 2]
        float* xs = reinterpret_cast<float*>(k_small);
        const int tw = tid % 128;
        consumers_sync<NC>();
#pragma unroll
        for (int i = 0; i < KT / 2; ++i)
          xs[(wg * 128 + tw) * (KT / 2) + i] = sc[i];
        consumers_sync<NC>();
#pragma unroll
        for (int i = 0; i < KT / 2; ++i)
          sc[i] = xs[tw * (KT / 2) + i] + xs[(128 + tw) * (KT / 2) + i];
      }

      // softcap, mask, online softmax (as flash_body's, in base 2: q is
      // scaled by log2(e), so p = 2^(s - m)); sc[4j + e] holds row g + 8
      // (e >> 1), key 8j + 2t + (e & 1)
      // A tile whose every key every row of the block sees (the
      // producer's flag: most tiles of a causal prefill) takes no mask.
      uint32_t vis = 0;
      if (full) {
        vis = ~0u;
        if (p.softcap > 0.f) {
#pragma unroll
          for (int i = 0; i < KT / 2; ++i)
            sc[i] = p.softcap * kLog2e * tanhf(sc[i] * (kLn2 / p.softcap));
        }
      } else {
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kpe = kp[j][e & 1];
            const int q = qp[e >> 1];
            bool ok = kpe >= 0 && kpe <= q;
            if (p.window > 0) ok = ok && q - kpe < p.window;
            float s = sc[4 * j + e];
            if (p.softcap > 0.f)
              s = p.softcap * kLog2e * tanhf(s * (kLn2 / p.softcap));
            sc[4 * j + e] = ok ? s : kNegInf;
            vis |= static_cast<uint32_t>(ok) << (j * 4 + e);
          }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mxr = kNegInf;
#pragma unroll
        for (int j = 0; j < NJ; ++j)
          mxr = fmaxf(mxr, fmaxf(sc[4 * j + 2 * r], sc[4 * j + 2 * r + 1]));
        mxr = fmaxf(mxr, __shfl_xor_sync(0xffffffffu, mxr, 1));
        mxr = fmaxf(mxr, __shfl_xor_sync(0xffffffffu, mxr, 2));
        const float m_new = fmaxf(m[r], mxr);
        const float corr = exp2f(m[r] - m_new);
        m[r] = m_new;
        float rs = 0.f;
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int e = 2 * r; e < 2 * r + 2; ++e) {
            const float pe = (vis >> (j * 4 + e)) & 1u
                                 ? exp2f(sc[4 * j + e] - m_new) : 0.f;
            sc[4 * j + e] = pe;
            rs += pe;
          }
        l[r] = l[r] * corr + rs;
        // x * 1 is x: a row whose max held keeps its accumulator as is
        if (corr != 1.f) {
#pragma unroll
          for (int n = 0; n < 16; ++n) {
            acc[4 * n + 2 * r] *= corr;
            acc[4 * n + 2 * r + 1] *= corr;
          }
        }
      }

      // acc += p . v: small.big + big.small + big.big, p from registers
      uint32_t pb[NJ][4], ps[NJ][4];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        split_tf32(sc[4 * j], pb[j][0], ps[j][0]);
        split_tf32(sc[4 * j + 2], pb[j][1], ps[j][1]);
        split_tf32(sc[4 * j + 1], pb[j][2], ps[j][2]);
        split_tf32(sc[4 * j + 3], pb[j][3], ps[j][3]);
      }
      keep(acc);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const uint32_t vo = col0 * VRB + 32 * j;   // V^T rows col0 ..
        wgmma_tf32_m64n128_rs(acc, ps[j], wg_desc<VRB>(vb_a + vo));
        wgmma_tf32_m64n128_rs(acc, pb[j], wg_desc<VRB>(vs_a + vo));
        wgmma_tf32_m64n128_rs(acc, pb[j], wg_desc<VRB>(vb_a + vo));
      }
      wgmma_commit();
      wgmma_wait_all();
      keep(acc);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        keep(pb[j]);
        keep(ps[j]);
      }
    }
  }
  consumers_sync<NC>();   // every consumer is done: the planes are free

  const bool holds = wrow0 < p.rows;
  const bool writes_ml = !CS || wg == 0;   // one warpgroup writes lse, m, l
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  if (p.splits == 1) {
    if (!holds) return;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int R = wrow0 + g + 8 * r;
      if (R >= p.rows) continue;
      if (p.lse != nullptr && t == 0 && writes_ml) {
        const int tq = R / p.G;
        p.lse[(static_cast<size_t>(b) * p.Hq + h * p.G + (R - tq * p.G)) *
                  p.T + tq] = max_to_base_e(m[r]) + logf(fmaxf(l[r], 1e-30f));
      }
      const float inv = 1.f / fmaxf(l[r], 1e-30f);
      float* o = p.out + qoff[r] + col0 + 2 * t;
#pragma unroll
      for (int n = 0; n < 16; ++n)
        *reinterpret_cast<float2*>(o + n * 8) =
            make_float2(acc[4 * n + 2 * r] * inv, acc[4 * n + 2 * r + 1] * inv);
    }
    return;
  }

  // split-KV: store this split's rows, then the block that draws the last
  // ticket of the row tile combines the splits in split order
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
        for (int n = 0; n < 16; ++n)
          *reinterpret_cast<float2*>(mine + rl * D + col0 + n * 8 + 2 * t) =
              make_float2(acc[4 * n + 2 * r], acc[4 * n + 2 * r + 1]);
      }
      if (t == 0 && writes_ml)   // m in base e, as combine_splits weighs it
        *reinterpret_cast<float2*>(mine + RB * D + 2 * rl) =
            make_float2(max_to_base_e(m[r]), l[r]);
    }
  }
  consumers_sync<NC>();
  if (tid == 0) s_last = draw_ticket(p.tickets + tile_id) == p.splits - 1;
  consumers_sync<NC>();
  if (!s_last) return;
  combine_splits<D, RB, NC, true>(p, parts, p.splits, b, h, row0,
                                  reinterpret_cast<float*>(k_big));
  if (tid == 0) p.tickets[tile_id] = 0;   // ready for the next call
}

// One level of a transposing butterfly over a warp: each lane keeps the
// half of its first N values that its lane bit N / 2 selects, adds its
// partner's copy of that half, and moves it to the front.
template <int N, int M>
__device__ __forceinline__ void fold(float (&v)[M], int lane) {
  const bool upper = (lane & (N / 2)) != 0;
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const float keep_v = upper ? v[i + N / 2] : v[i];
    const float send_v = upper ? v[i] : v[i + N / 2];
    v[i] = keep_v + __shfl_xor_sync(0xffffffffu, send_v, N / 2);
  }
}

// Decode (G*T <= 8 rows, padded to RP = 2, 4 or 8): byte-bound, so on the
// CUDA cores in f32, with no shared-memory staging of K/V and no TF32
// pieces. Grid: whole blocks per
// SM, set by the shapes; each block derives the work list from lens /
// chunk_lens (all tiles for the contiguous entry point) and takes one item
// (slot b, kv head h, a range of the slot's units): a live slot's units are
// cut into n ranges, n = 1 + spare * units / (all units * Hkv) (at most its
// units and kMaxSplit; spare: the blocks beyond one per live (slot, head)),
// so an idle slot gets none and a long context many. Warp w takes the
// item's live units w, w + 4, ...: per chunk of 4 keys each lane loads its
// D/32 columns of the 4 K and V rows (16-byte loads straight to registers),
// forms the RP rows x 4 keys partial dots against q (scaled, in shared
// memory), sums the RP * 4 values over the lanes with a transposing
// butterfly (lane L ends with row (L % 4RP) / 4, key L % 4), runs the online
// softmax on them, and adds p.v to its rows' columns. The warps' (m, l,
// acc) are combined in shared memory in warp order, the items of a (slot,
// head) through the workspace in split order (the same inputs give the
// same bits).
template <int D, bool RING, int RP>
__device__ __forceinline__ void decode_body(const Params& p) {
  constexpr int KT = kDecKeys, KC = kDecChunk, NW = kDecWarps, NT = NW * 32;
  constexpr int NV = RP * KC;      // scores of a chunk: one a lane, or fewer
  constexpr int V4 = D / 128;      // float4s of a row a lane holds
  constexpr int CW = D / 32;       // columns of a row a lane holds
  static_assert(NV <= 32 && RP <= kDecRows, "at most one score a lane");
  using KeysT = Keys<KT, RING>;

  __shared__ __align__(16) float q_s[RP][D];          // scaled, 0 past rows
  __shared__ __align__(16) float xa[NW][RP][D];       // the warps' acc
  __shared__ float xm[NW][RP][2];                     // their (m, l)
  __shared__ int s_job[6];
  __shared__ bool s_last;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) {
    long long U = 0;
    int live_slots = 0;
    for (int bb = 0; bb < p.B; ++bb) {
      const int u = KeysT::units(p, bb);
      U += u;
      live_slots += u > 0;
    }
    const long long spare =
        max(0LL, static_cast<long long>(gridDim.x) -
                     static_cast<long long>(live_slots) * p.Hkv);
    long long start = 0;
    s_job[0] = -1;
    for (int bb = 0; bb < p.B; ++bb) {
      const int u = KeysT::units(p, bb);
      if (u == 0) continue;
      long long n = 1 + spare * u / (U * p.Hkv);
      n = min(n, static_cast<long long>(min(u, kMaxSplit)));
      if (blockIdx.x < start + n * p.Hkv) {
        const int i = static_cast<int>(blockIdx.x - start);
        s_job[0] = bb;
        s_job[1] = i / static_cast<int>(n);                 // h
        s_job[2] = i % static_cast<int>(n);                 // split
        s_job[3] = static_cast<int>(n);
        s_job[4] = static_cast<int>(start) + s_job[1] * static_cast<int>(n);
        s_job[5] = u;
        break;
      }
      start += n * p.Hkv;
    }
  }
  __syncthreads();
  // an idle slot's rows see no key: 0 (and its lse that of no key),
  // written by the block whose index its (slot, head) pair falls on
  for (int pr = blockIdx.x; pr < p.B * p.Hkv; pr += gridDim.x) {
    const int bb = pr / p.Hkv, hh = pr - bb * p.Hkv;
    if (KeysT::units(p, bb) != 0) continue;
    for (int i = tid; i < p.rows * (D / 4); i += NT) {
      const int R = i / (D / 4), f = i - R * (D / 4), tq = R / p.G;
      const int hq = hh * p.G + (R - tq * p.G);
      reinterpret_cast<float4*>(
          p.out + ((static_cast<size_t>(bb) * p.T + tq) * p.Hq + hq) * D)[f] =
          make_float4(0.f, 0.f, 0.f, 0.f);
      if (p.lse != nullptr && f == 0)
        p.lse[(static_cast<size_t>(bb) * p.Hq + hq) * p.T + tq] =
            kNegInf + logf(1e-30f);
    }
  }
  if (s_job[0] < 0) return;    // no item: the whole block leaves
  const int b = s_job[0], h = s_job[1], split = s_job[2], n_splits = s_job[3];
  const int u = s_job[5];
  const int u0 = static_cast<int>(static_cast<long long>(u) * split / n_splits);
  const int u1 =
      static_cast<int>(static_cast<long long>(u) * (split + 1) / n_splits);
  const KeysT keys(p, b);
  const int ur = RING ? KeysT::ring_units(p, b) : 0;

  // q's rows, scaled (rows R = t * G + g); the block's position range
  for (int i = tid; i < RP * (D / 4); i += NT) {
    const int R = i / (D / 4), f = i - R * (D / 4);
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (R < p.rows) {
      const int tq = R / p.G;
      x = reinterpret_cast<const float4*>(
          p.q + ((static_cast<size_t>(b) * p.T + tq) * p.Hq + h * p.G +
                 (R - tq * p.G)) * D)[f];
    }
    const float sc2 = p.scale * kLog2e;   // scores in base 2
    reinterpret_cast<float4*>(&q_s[R][0])[f] =
        make_float4(x.x * sc2, x.y * sc2, x.z * sc2, x.w * sc2);
  }
  int mn = INT_MAX, mx = INT_MIN;
  for (int R = 0; R < p.rows; ++R) {
    const int pos = p.q_pos[static_cast<size_t>(b) * p.T + R / p.G];
    mn = min(mn, pos);
    mx = max(mx, pos);
  }
  const long long lo_ll =
      p.window > 0 ? static_cast<long long>(mn) - p.window + 1 : 0;
  const int lo = static_cast<int>(lo_ll < 0 ? 0 : lo_ll);
  const int hi = mx;
  // this lane's score after the butterfly: row r, key kc of a chunk
  const int r = (lane % NV) / KC, kc = lane % KC;
  const int qp = r < p.rows
                     ? p.q_pos[static_cast<size_t>(b) * p.T + r / p.G]
                     : -1;
  __syncthreads();

  float acc[RP][CW];
#pragma unroll
  for (int i = 0; i < RP; ++i)
#pragma unroll
    for (int c = 0; c < CW; ++c) acc[i][c] = 0.f;
  float m = kNegInf, l = 0.f;   // row r's (lanes 4r .. 4r + 3 agree)

  for (int x = u0 + warp; x < u1; x += NW) {
    const int k = x < ur ? x : keys.n_rt + (x - ur);
    if (!keys.live_warp(k, lo, hi, lane)) continue;
    for (int c0 = 0; c0 < KT; c0 += KC) {
      // the 4 keys' positions and rows (every lane: the loads' sources)
      int kp[KC];
      float4 kv[KC][V4], vv[KC][V4];
#pragma unroll
      for (int j = 0; j < KC; ++j) {
        kp[j] = keys.pos(k, c0 + j);
        bool chunk = false;
        const size_t row = kp[j] >= 0 ? keys.row(k, c0 + j, h, chunk) : 0;
        const float4* ks = reinterpret_cast<const float4*>(
            (chunk ? p.kc : p.k) + row * D);
        const float4* vs = reinterpret_cast<const float4*>(
            (chunk ? p.vc : p.v) + row * D);
#pragma unroll
        for (int i = 0; i < V4; ++i) {
          kv[j][i] = kp[j] >= 0 ? __ldg(ks + lane + 32 * i)
                                : make_float4(0.f, 0.f, 0.f, 0.f);
          vv[j][i] = kp[j] >= 0 ? __ldg(vs + lane + 32 * i)
                                : make_float4(0.f, 0.f, 0.f, 0.f);
        }
      }
      // partial dots of the lane's columns: sv[rr * KC + j]
      float sv[NV];
#pragma unroll
      for (int rr = 0; rr < RP; ++rr) {
        float4 qv[V4];
#pragma unroll
        for (int i = 0; i < V4; ++i)
          qv[i] = reinterpret_cast<const float4*>(&q_s[rr][0])[lane + 32 * i];
#pragma unroll
        for (int j = 0; j < KC; ++j) {
          float a = 0.f;
#pragma unroll
          for (int i = 0; i < V4; ++i) {
            a = fmaf(qv[i].x, kv[j][i].x, a);
            a = fmaf(qv[i].y, kv[j][i].y, a);
            a = fmaf(qv[i].z, kv[j][i].z, a);
            a = fmaf(qv[i].w, kv[j][i].w, a);
          }
          sv[rr * KC + j] = a;
        }
      }
      // the transposing butterfly (fold) over the lane bits below NV, then
      // plain sums over the rest: lane L ends with the sum over all lanes
      // of value L % NV
      if constexpr (NV >= 32) fold<32>(sv, lane);
      if constexpr (NV >= 16) fold<16>(sv, lane);
      fold<8>(sv, lane);
      fold<4>(sv, lane);
      fold<2>(sv, lane);
      // the lane bits above the values: plain sums
#pragma unroll
      for (int w = NV; w < 32; w <<= 1)
        sv[0] += __shfl_xor_sync(0xffffffffu, sv[0], w);
      float s = sv[0];   // row r, key kc
      int kpe = kp[0];
#pragma unroll
      for (int j = 1; j < KC; ++j) kpe = kc == j ? kp[j] : kpe;
      bool ok = kpe >= 0 && kpe <= qp;
      if (p.window > 0) ok = ok && qp - kpe < p.window;
      if (p.softcap > 0.f)
        s = p.softcap * kLog2e * tanhf(s * (kLn2 / p.softcap));
      s = ok ? s : kNegInf;
      float mxr = fmaxf(s, __shfl_xor_sync(0xffffffffu, s, 1));
      mxr = fmaxf(mxr, __shfl_xor_sync(0xffffffffu, mxr, 2));
      const float m_new = fmaxf(m, mxr);
      const float corr = exp2f(m - m_new);
      const float pe = ok ? exp2f(s - m_new) : 0.f;
      float rs = pe + __shfl_xor_sync(0xffffffffu, pe, 1);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      l = l * corr + rs;
      m = m_new;
      // acc[rr] = acc[rr] * corr_rr + sum_j p[rr][j] v_j (the lane's
      // columns); corr and p from the lanes that hold them
#pragma unroll
      for (int rr = 0; rr < RP; ++rr) {
        const float cr = __shfl_sync(0xffffffffu, corr, rr * KC);
        float pj[KC];
#pragma unroll
        for (int j = 0; j < KC; ++j)
          pj[j] = __shfl_sync(0xffffffffu, pe, rr * KC + j);
#pragma unroll
        for (int i = 0; i < V4; ++i) {
          float* a = &acc[rr][4 * i];
          a[0] *= cr;
          a[1] *= cr;
          a[2] *= cr;
          a[3] *= cr;
#pragma unroll
          for (int j = 0; j < KC; ++j) {
            a[0] = fmaf(pj[j], vv[j][i].x, a[0]);
            a[1] = fmaf(pj[j], vv[j][i].y, a[1]);
            a[2] = fmaf(pj[j], vv[j][i].z, a[2]);
            a[3] = fmaf(pj[j], vv[j][i].w, a[3]);
          }
        }
      }
    }
  }

  // the warps' (m, l, acc), combined in warp order (a warp that saw no key
  // has l = 0 and weighs 0)
#pragma unroll
  for (int rr = 0; rr < RP; ++rr)
#pragma unroll
    for (int i = 0; i < V4; ++i)
      reinterpret_cast<float4*>(&xa[warp][rr][0])[lane + 32 * i] =
          make_float4(acc[rr][4 * i], acc[rr][4 * i + 1], acc[rr][4 * i + 2],
                      acc[rr][4 * i + 3]);
  if (kc == 0 && lane < NV) {
    xm[warp][r][0] = m;
    xm[warp][r][1] = l;
  }
  __syncthreads();
  const int rows = min(p.rows, RP);
  constexpr int kPart = RP * (D + 2);   // acc [RP][D], then (m, l) [RP]
  float* mine = p.partials + static_cast<size_t>(s_job[4] + split) * kPart;
  for (int i = tid; i < rows * (D / 4); i += NT) {
    const int rr = i / (D / 4), f = i - rr * (D / 4);
    float M = kNegInf, L = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w)
      if (xm[w][rr][1] > 0.f) M = fmaxf(M, xm[w][rr][0]);
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float wt = xm[w][rr][1] > 0.f ? exp2f(xm[w][rr][0] - M) : 0.f;
      L += xm[w][rr][1] * wt;
      const float4 x = reinterpret_cast<const float4*>(&xa[w][rr][0])[f];
      a.x = fmaf(x.x, wt, a.x);
      a.y = fmaf(x.y, wt, a.y);
      a.z = fmaf(x.z, wt, a.z);
      a.w = fmaf(x.w, wt, a.w);
    }
    const int tq = rr / p.G, hq = h * p.G + (rr - tq * p.G);
    if (n_splits == 1) {
      const float inv = 1.f / fmaxf(L, 1e-30f);
      reinterpret_cast<float4*>(
          p.out + ((static_cast<size_t>(b) * p.T + tq) * p.Hq + hq) * D)[f] =
          make_float4(a.x * inv, a.y * inv, a.z * inv, a.w * inv);
      if (p.lse != nullptr && f == 0)
        p.lse[(static_cast<size_t>(b) * p.Hq + hq) * p.T + tq] =
            max_to_base_e(M) + logf(fmaxf(L, 1e-30f));
    } else {
      reinterpret_cast<float4*>(mine + rr * D)[f] = a;
      if (f == 0)
        *reinterpret_cast<float2*>(mine + RP * D + 2 * rr) =
            make_float2(max_to_base_e(M), L);   // base e, for combine_splits
    }
  }
  if (n_splits == 1) return;
  __syncthreads();   // the partials are stored; xa is free for the combine
  const size_t ticket = static_cast<size_t>(b) * p.Hkv + h;
  if (tid == 0) s_last = draw_ticket(p.tickets + ticket) == n_splits - 1;
  __syncthreads();
  if (!s_last) return;
  combine_splits<D, RP, NT>(p, p.partials + static_cast<size_t>(s_job[4]) *
                                                kPart,
                            n_splits, b, h, 0, &xa[0][0][0]);
  if (tid == 0) p.tickets[ticket] = 0;   // ready for the next call
}

// Threads of a block and blocks an SM holds: D <= 64, flash_body (4 warps,
// three blocks); D = 128 and 256, row tiles in wg_body (its consumer
// warpgroups and the producer warpgroup; its shared memory, 193 or 225
// KB, allows one block). Decode at D = 128 and 256 (G*T <= 8) is flash_decode_kernel<D,
// RP> (4 warps; two or three blocks an SM).
__host__ __device__ constexpr int block_threads(int D) {
  return D <= 64 ? kWarps * 32 : kWgThreads;
}

template <int D, bool WS>
__global__ void __launch_bounds__(block_threads(D), (D <= 64 ? 3 : 1))
flash_kernel(const Params p) {
  if constexpr (D <= 64)
    flash_body<D, WS, false>(p);
  else
    wg_body<D, false>(p);
}

template <int D, bool WS>
__global__ void __launch_bounds__(block_threads(D), (D <= 64 ? 3 : 1))
ring_flash_kernel(const Params p) {
  if constexpr (D <= 64)
    flash_body<D, WS, true>(p);
  else
    wg_body<D, true>(p);
}

template <int D, int RP>
__global__ void __launch_bounds__(kDecWarps * 32, dec_blocks_per_sm(D))
flash_decode_kernel(const Params p) {
  decode_body<D, false, RP>(p);
}

template <int D, int RP>
__global__ void __launch_bounds__(kDecWarps * 32, dec_blocks_per_sm(D))
ring_flash_decode_kernel(const Params p) {
  decode_body<D, true, RP>(p);
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

// How one call is cut. D <= 64 (flash_body): warp split (WS) for G*T <= 16
// rows, else row tiles of 64; KT keys a tile; and the KV split, aiming at
// two blocks an SM. D = 128 and 256 (wg_body): row tiles of 64 for G*T >
// 16 rows, split when the row tiles leave SMs idle (one block an SM); for
// G*T <= 16 (WS) a fixed grid of whole blocks per SM, each taking one item
// of the work list that the kernel derives from lens, its partial at its
// own index.
struct Plan {
  bool ws;
  int kt, rb, rows, row_tiles, n_tiles, splits;
  unsigned grid_x;            // WS at D >= 128: blocks of the grid
  size_t partials, tickets;   // workspace the call needs (floats, ints)
};

Plan plan(int B, int T, int Hq, int Hkv, int S, int D) {
  Plan pl;
  const int G = Hq / Hkv;
  const bool wg = D >= 128;
  pl.rows = T * G;
  pl.ws = pl.rows <= (wg ? kDecRows : 16);
  pl.kt = wg ? (pl.ws ? kDecKeys : wg_keys(D)) : tile_keys(pl.ws);
  pl.rb = wg ? (pl.ws ? kDecRows : wg_rows(D)) : (pl.ws ? 16 : 16 * kWarps);
  pl.row_tiles = pl.ws ? 1 : (pl.rows + pl.rb - 1) / pl.rb;
  pl.n_tiles = (S + pl.kt - 1) / pl.kt;
  pl.partials = pl.tickets = 0;
  pl.grid_x = 0;
  const long long blocks = static_cast<long long>(B) * Hkv * pl.row_tiles;
  if (wg && pl.ws) {
    // whole blocks per SM, at least one per (slot, kv head); each block
    // writes its partial at its own index
    const long long sms = sm_count();
    const long long per = dec_blocks_per_sm(D) * sms;
    const long long want = blocks > per ? blocks : per;
    pl.grid_x = static_cast<unsigned>((want + sms - 1) / sms * sms);
    pl.splits = 0;   // per item, from lens
    pl.tickets = static_cast<size_t>(blocks);
    pl.partials = static_cast<size_t>(pl.grid_x) * pl.rb * (D + 2);
    return pl;
  }
  // blocks for every SM: two for flash_body (three fit, but then the
  // blocks of a decode call no longer start in one wave), one for wg_body
  const long long want = (wg ? 1LL : 2LL) * sm_count();
  long long splits = blocks >= want ? 1 : (want + blocks - 1) / blocks;
  splits = splits < pl.n_tiles ? splits : pl.n_tiles;
  splits = splits < kMaxSplit ? splits : kMaxSplit;
  pl.splits = static_cast<int>(splits < 1 ? 1 : splits);
  if (pl.splits > 1) {
    pl.tickets = static_cast<size_t>(blocks);
    pl.partials = pl.tickets * pl.splits * pl.rb * (D + 2);
  }
  return pl;
}

size_t smem_bytes(const Plan& pl, int D, int nb) {
  if (D >= 128) return pl.ws ? 0 : wg_smem_bytes(D);
  return (static_cast<size_t>(ring_floats(D, pl.rb)) + kRingKeys +
          pl.n_tiles + nb) * 4;
}

// a block's shared memory (232,448 bytes on the H100), less room for the
// kernel's few static bytes
constexpr size_t kSmemMax = 232448 - 1024;

template <int D, int RP, bool RING>
int launch_decode(const Params& p, dim3 grid, cudaStream_t stream) {
  auto kernel = RING ? ring_flash_decode_kernel<D, RP>
                     : flash_decode_kernel<D, RP>;
  kernel<<<grid, kDecWarps * 32, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int D, bool RING>
int launch_decode_rows(const Params& p, dim3 grid, cudaStream_t stream) {
  if (p.rows <= 2) return launch_decode<D, 2, RING>(p, grid, stream);
  if (p.rows <= 4) return launch_decode<D, 4, RING>(p, grid, stream);
  return launch_decode<D, kDecRows, RING>(p, grid, stream);
}

template <int D, bool WS, bool RING>
int launch_one(const Params& p, dim3 grid, size_t smem, cudaStream_t stream) {
  if constexpr (D >= 128 && WS) {
    return launch_decode_rows<D, RING>(p, grid, stream);
  } else {
    // raise the dynamic shared memory limit when a call needs more than
    // the last raise on this device
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
    kernel<<<grid, block_threads(D), smem, stream>>>(p);
    return static_cast<int>(cudaGetLastError());
  }
}

int launch(Params p, int B, int D, const Plan& pl, size_t n_partials,
           size_t n_tickets, cudaStream_t stream, bool ring = false) {
  const long long bhkv = static_cast<long long>(B) * p.Hkv;
  if (bhkv > 65535 || pl.row_tiles > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((pl.partials > 0 || pl.tickets > 0) &&
      (p.partials == nullptr || p.tickets == nullptr ||
       n_partials < pl.partials || n_tickets < pl.tickets))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(pl, D, p.block_table ? p.nb : 0);
  if (smem > kSmemMax) return static_cast<int>(cudaErrorInvalidValue);
  p.B = B;
  p.rows = pl.rows;
  p.row_tiles = pl.row_tiles;
  p.splits = pl.splits;
  p.n_tiles = pl.n_tiles;
  // D >= 128 row tiles: (splits, heads, row tiles), so that the longest
  // tiles of every head start first
  const dim3 grid =
      pl.grid_x > 0 ? dim3(pl.grid_x, 1, 1)
      : D >= 128    ? dim3(pl.splits, static_cast<unsigned>(bhkv),
                           pl.row_tiles)
                    : dim3(pl.splits, pl.row_tiles,
                           static_cast<unsigned>(bhkv));
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
