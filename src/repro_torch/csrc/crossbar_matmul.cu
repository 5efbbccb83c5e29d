// Crossbar-wise quantized matmul with post-accumulation dequantization
// (Atleus SS IV.D, Fig. 5) for Hopper (sm_90a), on the tensor cores.
//
// Replaces: the Pallas TPU kernel `crossbar_matmul` in
//   src/repro/kernels/crossbar_matmul/kernel.py (bodies _kernel_int8 and
//   _kernel_int4), i.e. out = x (M,K) f32 @ dequant(codes, scales) (K,N)
//   where each 128-deep K tile's f32 partial sum is multiplied by that
//   128x128 crossbar's one scale and then added to the running sum.
//
// Two kernels; the entry point picks one (picks_decode) by how many bytes
// of codes the decode kernel would read: one pass over the codes per 8
// rows of x, against the prefill kernel's larger fixed cost. On the H100
// the two cross near 96 MiB (chip_smoke.py's crossover cases): decode for
// M <= 48 at 16.8 MB of codes, M <= 8 at 58.7 MB, M <= 768 at 1 MB.
//
// decode (always for M <= 8: the engine's decode tick has M = 8 slots)
//   Bound by reading the K*N code bytes once (16.8 MB at (8192, 2048):
//   5 us at 3.35 TB/s). Design:
//   - Split K across blocks (two for each SM, up to one K tile a warp)
//     and across the 4 warps of a block; each warp owns whole 128-deep K
//     tiles of one 128-wide N tile. Its loads go through a ring of k16
//     steps in shared memory (cp.async, 16 bytes a thread), so bytes in
//     flight cost no registers (124 a thread: 4 blocks fit on an SM).
//     On the H100, 2 stages timed faster than 4, two blocks per SM faster
//     than four on the deepest shapes, and half-tile work units slower.
//   - The product runs on the tensor cores with mma.sync m16n8k16 (bf16,
//     f32 accumulate), operands swapped for the skinny shape:
//     y^T = c^T x^T. The codes' N fills the 16 rows, the 8 decode rows of
//     x are the instruction's n = 8. Why mma.sync and not f32 FMAs: at
//     M = 8, 2*8*K*N FMAs at 67 TFLOP/s already take 80% of the byte
//     bound at (14336, 4096), before any code is converted; one mma covers
//     256 codes. Why not wgmma: its 64-row A tile would be 7/8 padding.
//     The k order inside one k16 step is free (it is summed over) as long
//     as A and B agree; it is chosen so that one thread's 16-byte load of
//     one code row, for 4 rows, is exactly its A fragments for 8 mmas, and
//     its B fragment is 4 consecutive floats of one x row (one float4).
//   - Codes become bf16 four at a time without cvt: a byte-permute puts
//     each biased byte into the mantissa of 2^23, one f32 subtract leaves
//     the exact integer, and a second byte-permute packs the upper halves
//     of two such floats (exact: |c| <= 128 has <= 8 significant bits).
//   - Each K tile's partial is kept apart and added as part * scale after
//     the tile (never folded into x). Partial tiles are summed in a fixed
//     order: first over the warps of a block (shared memory), then over
//     the blocks of an N tile, by the block that finishes last (a ticket
//     in a caller-owned workspace elects it; it reads the other partials
//     from the workspace in rank order). One launch, no atomics on the
//     output: two calls give identical bits. Not a thread-block cluster
//     reducing through distributed shared memory: on the H100 the same
//     grid timed slower launched as clusters, before any reduction.
//   - M > 8 runs ceil(M / 8) row groups, each a pass over the codes (the
//     blocks of one N tile are adjacent in the grid, so later passes find
//     the codes in L2).
//
// prefill (engine chunks M = 8 x C, whole prompts M = T)
//   Bound by arithmetic. Design: 64 x 256 output tiles, two warpgroups of
//   one 128-wide crossbar column each, wgmma m64n128k16 (bf16, f32
//   accumulate) with both operands in shared memory (K-major, 128-byte
//   swizzle), a K loop of 64-deep stages, double-buffered: while the
//   tensor cores run stage c, the threads convert stage c + 1 from
//   registers into the other buffer and load stage c + 2 from device
//   memory into registers. Two stages make one crossbar tile: the partial
//   fragment starts fresh (scale-d = 0) at each tile and is added as
//   part * scale after it. When the output tiles leave SMs idle (small N,
//   or M of a few hundred), K is split across blocks as well and summed
//   in rank order as in the decode kernel.
//   - The weight operand is exact: int8 (|c| <= 127) and int4 (-8..7)
//     codes are exact in bf16.
//   - x is f32 and the port holds the kernel to 1e-4 * max|y| in f32, so
//     x is carried as bf16 pieces: p0 = bf16(x), p1 = bf16(x - p0),
//     p2 = bf16(x - p0 - p1), each subtraction exact. Each piece x code
//     product is exact in f32; one wgmma per piece against the same code
//     descriptor. bf16 x alone leaves up to 2^-8 |x| and breaks 1e-4; two
//     pieces leave 2^-16 |x| (~1.5e-5 |x|), within 1e-4
//     (tests/test_torch_crossbar_split.py shows all three), but on the
//     card they moved both served models' logits measurably further from
//     the plain forward than the f32 kernel had (PERF.md), so x takes
//     three pieces (24 bits: the whole f32 significand, up to one
//     rounding of the last piece). Not TF32: at 495 TFLOP/s it is half
//     the bf16 rate, and with a 10-bit mantissa x would still need pieces.
//   Decode uses the same split.
//
// Both kernels take int8 (Kp, Np) codes or packed int4 uint8 (Kp/2, Np)
// codes (row 2i = low nibble, 2i + 1 = high nibble), mask ragged M and K
// (x beyond M or K reads as 0) and write only up to the original N.
//
// grouped (grouped_crossbar_matmul: a mixture-of-experts layer's expert
//   products). Replaces what the JAX package computes outside any Pallas
//   call as static_einsum("sbcd,sdf->sbcf") over a dequantized (slots, d,
//   f) stack (src/repro/models/moe.py apply_moe, src/repro/core/hetero.py
//   static_einsum), on a buffer of C = T rows per slot. Here the routed
//   (token, slot) assignments lie compactly in one buffer, grouped by
//   slot, each slot's rows padded to the kernel's row tile; y[r] =
//   x[r] @ dequant(codes[s], scales[s]) for the live rows r of slot s, 0
//   in every other row. The slots' bases and counts are read from device
//   memory, so no grid depends on the routing and a CUDA graph replays the
//   call for any routing; a tile of padding only is zeroed without reading
//   a code, so a call reads the codes of the experts its rows hit and no
//   others. The same per-crossbar scaling of each 128-deep K tile's
//   partial sum. Two kernels:
//   - decode (grouped_live_decode_kernel): bound by the codes of the hit
//     experts (8 decode rows on 8 of llama4-scout's (5120, 8192) experts:
//     336 MB, 0.1 ms). The decode kernel's body, but over a work list
//     rather than the buffer's grid: a fixed grid of whole blocks per SM
//     derives from counts the live row groups (L) and their units (row
//     group, N tile, K split), sizing the K split from L, not from the
//     buffer's R / 8 row groups. Over the buffer's grid, 8 rows on one
//     expert left one row group of 8 live: 64 blocks walked all of K alone
//     on a 132-SM card while 448 wrote zeros. And a ring step at int4
//     covers 32 k (four 16-byte code loads a thread, as at int8), so its
//     time follows its bytes.
//   - prefill (grouped_prefill_kernel): the prefill kernel's grid over the
//     buffer's 64-row tiles, the slot taken from the tile (group_of).
//
// transposed (crossbar_matmul_t: the backward of x, dx = g . dequant(W)^T)
//   Replaces what the JAX package gets from autodiff of its dequantize-
//   then-dot_general (src/repro/core/hetero.py static_matmul): dx (M, K) =
//   g (M, N) f32 times the transpose of the same codes, each 128-wide N
//   tile's partial sum scaled by that crossbar's one scale. The codes get
//   no gradient. Bound, at the training shapes (M = 1024 rows of a
//   microbatch, K and N of 512-8192), by arithmetic: 2 M K N flops against
//   K N code bytes and M (K + N) f32 bytes. Design: the prefill kernel's,
//   transposed. 64 x 256 output tiles of dx, two warpgroups of one
//   128-wide crossbar row of K each, wgmma m64n128k16 (bf16, f32
//   accumulate) on g's three bf16 pieces (split_x) against the codes, a
//   reduction over N in 64-deep stages, double-buffered (convert stage
//   c + 1 into shared memory and load stage c + 2 into registers while the
//   tensor cores run stage c). Two stages make one 128-wide N tile, whose
//   partial is added as part * scales[kt][nt], kt being the warpgroup's
//   own crossbar row: one scalar per warpgroup and N tile.
//   - The layout is easier than the forward's: the reduction dim N is
//     contiguous in g's rows and in the codes' rows, so both operands are
//     K-major for wgmma as they lie: a code row k is a row of the B tile,
//     stored (converted to bf16, 128-byte swizzle) without a transpose.
//     int4's packed row k/2 gives two adjacent B rows, k and k + 1.
//   - Where the output tiles leave SMs idle, N is split across blocks and
//     the partial tiles summed in rank order by the block that draws the
//     last ticket, as in the prefill kernel (prefill_per with the roles of
//     K and N swapped), through the same caller-owned workspace: the
//     forward and dx calls run in order on one stream, so one workspace
//     per device serves both. Two calls give identical bits.
//   - g beyond M or N reads as 0 (the codes' padding is then multiplied by
//     0); dx beyond K is not written.
//
// grouped transposed (grouped_crossbar_matmul_t: the backward of the
//   expert products, dx[r] = g[r] . dequant(W_s)^T for the live rows r of
//   slot s, 0 in every other row). Replaces what the JAX package gets from
//   autodiff of static_einsum("sbcd,sdf->sbcf") over the dequantized stack
//   (src/repro/models/moe.py apply_moe). Bound, at a train microbatch
//   (1024 routed rows of llama4-scout over 16 (5120, 8192) experts), by
//   arithmetic, as the transposed kernel. Design: the transposed kernel's
//   body over the buffer's 64-row tiles, the slot taken from the row tile
//   (group_of), as the grouped prefill kernel takes it; so the bases must
//   be multiples of 64 (the prefill kernel's row tile: models/moe.py keeps
//   that tile for an x that needs a gradient); a tile that crosses into
//   another slot is written as NaN, never as a finite wrong dx. A tile of
//   padding only writes its zeros and reads no code.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCrossbar = 128;   // K tile == N tile == quantization block
constexpr size_t kDecodeMaxBytes = size_t(96) << 20;   // see picks_decode

// ---------------------------------------------------------------------------
// shared pieces: code conversion and the split of x
// ---------------------------------------------------------------------------

// Biased code byte `sel & 3` of `word` (u = c + BIAS, 0 <= u < 256) as the
// exact f32 integer c: 2^23 + u by byte-permute, minus 2^23 + BIAS.
template <int BIAS>
__device__ __forceinline__ float code_f32(uint32_t word, uint32_t sel) {
  return __uint_as_float(__byte_perm(word, 0x4B000000u, sel)) -
         (8388608.f + BIAS);
}

// Two exact small integers in f32 -> bf16x2 (`lo` in the low half): the
// upper 16 bits of each, which hold them exactly.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

constexpr int kPieces = 3;   // bf16 pieces that carry f32 x

// (a, b) -> kPieces bf16x2 words p[0] + p[1] + p[2] = (a, b): each piece
// is the bf16 rounding of what the pieces before it left (every
// subtraction is exact in f32).
__device__ __forceinline__ void split_x(float a, float b,
                                        uint32_t (&p)[kPieces]) {
#pragma unroll
  for (int i = 0; i < kPieces; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
    const float2 hf = __bfloat1622float2(h);
    p[i] = bf16x2_bits(h);
    a -= hf.x;
    b -= hf.y;
  }
}

// Four code rows of one thread (rows k..k+3 of a step, 16 columns each as
// four words), biased so that every byte holds u = c + BIAS.
// int8: one 16-byte load per row, u = c ^ 0x80. int4: one 16-byte load per
// packed row, whose low nibbles are row 2p and high nibbles row 2p + 1;
// u = nibble ^ 8, moved into its own byte.
template <int BITS>
__device__ __forceinline__ void bias_rows(const uint4 (&raw)[BITS == 8 ? 4 : 2],
                                          uint32_t (&rw)[4][4]) {
#pragma unroll
  for (int p = 0; p < (BITS == 8 ? 4 : 2); ++p) {
    const uint32_t w[4] = {raw[p].x, raw[p].y, raw[p].z, raw[p].w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if constexpr (BITS == 8) {
        rw[p][q] = w[q] ^ 0x80808080u;
      } else {
        const uint32_t v = w[q] ^ 0x88888888u;
        rw[2 * p][q] = v & 0x0F0F0F0Fu;
        rw[2 * p + 1][q] = (v >> 4) & 0x0F0F0F0Fu;
      }
    }
  }
}

template <int BITS>
__device__ __forceinline__ float code_at(const uint32_t (&rw)[4][4], int row,
                                         int col) {
  return code_f32<BITS == 8 ? 128 : 8>(rw[row][col >> 2], 0x7650u + (col & 3));
}

// ---------------------------------------------------------------------------
// grouped rows (grouped_crossbar_matmul): the rows of x and out are grouped
// by slot. Slot s holds rows bases[s] .. bases[s] + counts[s] - 1 (its live
// rows), then padding up to bases[s + 1]; rows from bases[slots] on are
// padding too. Every base is a multiple of the kernel's row tile (8 rows
// decode, 64 prefill), so a tile lies in one slot.
// ---------------------------------------------------------------------------

// The slot that holds row m0 (*slot; `slots` when none does) and the end
// of its live rows (m0 when the tile holds padding only).
__device__ __forceinline__ int group_of(const int* __restrict__ bases,
                                        const int* __restrict__ counts,
                                        int slots, int m0, int* slot) {
  int s = 0;
  while (s < slots && __ldg(bases + s + 1) <= m0) ++s;
  *slot = s;
  return s < slots ? __ldg(bases + s) + __ldg(counts + s) : m0;
}

// Zeros (or `value`) in out rows m0 .. m0 + rows - 1, columns n0 .. n0 +
// cols - 1 (those below M and N), written by the whole block.
__device__ __forceinline__ void zero_tile(float* __restrict__ out, int m0,
                                          int rows, int n0, int cols, int M,
                                          int N, float value = 0.f) {
  for (int i = threadIdx.x; i < rows * cols; i += blockDim.x) {
    const int m = m0 + i / cols, n = n0 + i % cols;
    if (m < M && n < N) out[static_cast<size_t>(m) * N + n] = value;
  }
}

// ---------------------------------------------------------------------------
// decode: split-K, cp.async ring, mma.sync with swapped operands
// ---------------------------------------------------------------------------

constexpr int kDecWarps = 4;
constexpr int kDecSteps = kCrossbar / 16;  // k16 steps per crossbar tile
constexpr int kDecStages = 2;              // steps in flight per warp
// Bytes of one ring step: 16 rows of 128 code bytes, then the x of each of
// its SUB k16 steps (8 rows x 16 k f32, 16 bytes a lane).
template <int SUB>
__host__ __device__ constexpr int dec_slot() {
  return 16 * 128 + SUB * 32 * 16;
}
template <int SUB>
__host__ __device__ constexpr int dec_smem() {   // 20 KB at SUB = 1
  return kDecWarps * kDecStages * dec_slot<SUB>();
}
static_assert(dec_smem<1>() >= kDecWarps * 8 * (128 + 4) * 4,
              "the ring doubles as the reduction buffer");
constexpr int kDecBlocksPerSm = 2;         // of the 4 that fit (registers)
constexpr int kMaxSplit = 32;              // K splits per N tile, at most
constexpr int kPartial = 8 * kCrossbar;    // one block's partial tile

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// cp.async of `bytes` (<= size) from global, zero-filling the rest
__device__ __forceinline__ void cp_async16(uint32_t saddr, const void* g,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(saddr),
               "l"(g), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t saddr, const void* g,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(saddr),
               "l"(g), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// A ticket of a split-K sum: the returned count tells a block whether it is
// the last of its tile. acq_rel at gpu scope: after a __syncthreads, it
// publishes the block's partial stores (release) and, for the last block,
// makes every other block's visible to the loads after the next
// __syncthreads (acquire).
__device__ __forceinline__ int draw_ticket(int* ticket) {
  int old;
  asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;\n"
               : "=r"(old)
               : "l"(ticket)
               : "memory");
  return old;
}

__device__ __forceinline__ uint4 lds128(uint32_t saddr) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(saddr)
               : "memory");
  return v;
}

// One unit of the decode kernel: rows m0 .. m0 + 7 (x rows from Mx on
// read as 0), N tile nt, K split `rank` of S; `tile` indexes the unit's
// ticket and its partials (tile * S + rank). kDecWarps warps a block.
// Lane (g, t) = (lane / 4, lane % 4). In k16 step s of K tile kt it uses
// code rows k = kt*128 + 16 s + 4 t + i (i < 4), columns n0 + 16 g .. +15,
// and x row m0 + g at those 4 k. The mma's k index 2t + e stands for row
// 4t + e and 2t + 8 + e for row 4t + 2 + e; mma j (< 8) has rows g -> column
// n0 + 16 g + 2 j and g + 8 -> n0 + 16 g + 2 j + 1. So output (m, n) of
// fragment value d[j][v] is m = m0 + 2 t + (v & 1), n = n0 + 16 g + 2 j +
// (v >> 1). Each thread copies (cp.async) exactly the bytes it reads back,
// so the ring needs no barrier: a step's group is waited on by its thread.
// A ring step holds SUB k16 steps: the plain decode kernel takes 1; the
// grouped one takes 2 at int4, so that a step loads 4 code rows of 16
// bytes a thread at either width (32 k of packed int4 rows, the x of
// each k16 step in its own 512 bytes of the slot) and an int4 warp keeps
// as many code bytes in flight as an int8 one. Called by the whole block;
// the ring must be free (every warp past its previous unit).
template <int BITS, int SUB>
__device__ __forceinline__ void decode_body(
    const float* __restrict__ x, const uint8_t* __restrict__ codes,
    const float* __restrict__ scales, float* __restrict__ out,
    float* __restrict__ partials, int* __restrict__ tickets, int M, int K,
    int N, int Kp, int Np, int x_vec, int m0, int Mx, int nt, int rank,
    int S, int tile) {
  static_assert(SUB == 1 || (BITS == 4 && SUB == 2), "k16 sub-steps");
  constexpr int kSub = SUB;                     // k16 sub-steps a ring step
  constexpr int kLoads = BITS == 8 ? 4 : 2 * SUB;   // 16-byte code rows
  constexpr int kSpt = kDecSteps / kSub;        // ring steps a K tile
  constexpr int kSlot = dec_slot<SUB>();
  __shared__ bool last;
  extern __shared__ __align__(16) uint8_t dsmem[];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = nt * kCrossbar;
  const int n_nt = Np / kCrossbar, n_kt = Kp / kCrossbar;
  const int stride = S * kDecWarps;           // K tiles between a warp's own
  const int first = rank * kDecWarps + warp;  // this warp's first K tile
  const int n_tiles = first < n_kt ? (n_kt - first + stride - 1) / stride : 0;
  const int n_steps = n_tiles * kSpt;
  const int xm = m0 + g;
  const float* xrow = x + static_cast<size_t>(xm < Mx ? xm : 0) * K;
  const uint8_t* ccol = codes + n0 + 16 * g;
  const uint32_t ring = static_cast<uint32_t>(__cvta_generic_to_shared(dsmem)) +
                        warp * kDecStages * kSlot;

  // first k of this thread's 4 in sub-step 0 of step `s` of its sequence
  auto k_of = [&](int s) {
    return (first + (s / kSpt) * stride) * kCrossbar + (s % kSpt) * 16 * kSub +
           4 * t;
  };
  // smem row of this thread's code load i (< 4): int8 rows 4t + i; int4
  // sub-step i / 2's packed rows, 8 (i / 2) + 2t + i % 2
  auto srow = [&](int i) {
    return BITS == 8 ? 4 * t + i : 8 * (i >> 1) + 2 * t + (i & 1);
  };
  auto issue = [&](int s) {
    const uint32_t slot = ring + (s % kDecStages) * kSlot;
    const int k = k_of(s);
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int row = BITS == 8 ? k + i : k / 2 + 8 * (i >> 1) + (i & 1);
      cp_async16(slot + srow(i) * 128 + 16 * g,
                 ccol + static_cast<size_t>(row) * Np, 16);
    }
#pragma unroll
    for (int sub = 0; sub < kSub; ++sub) {
      const uint32_t xs = slot + 16 * 128 + sub * 512 + 16 * lane;
      const int kk = k + 16 * sub;
      if (x_vec) {
        const bool live = xm < Mx && kk < K;   // K % 4 == 0: all 4 or none
        cp_async16(xs, live ? xrow + kk : x, live ? 16 : 0);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool live = xm < Mx && kk + e < K;
          cp_async4(xs + 4 * e, live ? xrow + kk + e : x, live ? 4 : 0);
        }
      }
    }
  };

  float acc[8][4], part[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int v = 0; v < 4; ++v) acc[j][v] = part[j][v] = 0.f;

#pragma unroll
  for (int d = 0; d < kDecStages; ++d) {
    if (d < n_steps) issue(d);
    cp_async_commit();   // one group per step, empty ones too
  }
  float scale = 0.f;
  for (int s = 0; s < n_steps; ++s) {
    cp_async_wait<kDecStages - 1>();          // step s has landed
    const uint32_t slot = ring + (s % kDecStages) * kSlot;
    if (s % kSpt == 0)
      scale = __ldg(scales + (first + (s / kSpt) * stride) * n_nt + nt);
#pragma unroll
    for (int sub = 0; sub < kSub; ++sub) {
      uint32_t rw[4][4];
      if constexpr (BITS == 8) {
        uint4 raw[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          raw[i] = lds128(slot + srow(i) * 128 + 16 * g);
        bias_rows<8>(raw, rw);
      } else {
        uint4 raw[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          raw[i] = lds128(slot + srow(2 * sub + i) * 128 + 16 * g);
        bias_rows<4>(raw, rw);
      }
      const uint4 xw = lds128(slot + 16 * 128 + sub * 512 + 16 * lane);
      uint32_t b0[kPieces], b1[kPieces];   // B fragment of each piece of x
      split_x(__uint_as_float(xw.x), __uint_as_float(xw.y), b0);
      split_x(__uint_as_float(xw.z), __uint_as_float(xw.w), b1);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c0 = 2 * j, c1 = 2 * j + 1;
        const uint32_t a[4] = {
            pack_bf16(code_at<BITS>(rw, 0, c0), code_at<BITS>(rw, 1, c0)),
            pack_bf16(code_at<BITS>(rw, 0, c1), code_at<BITS>(rw, 1, c1)),
            pack_bf16(code_at<BITS>(rw, 2, c0), code_at<BITS>(rw, 3, c0)),
            pack_bf16(code_at<BITS>(rw, 2, c1), code_at<BITS>(rw, 3, c1))};
#pragma unroll
        for (int i = 0; i < kPieces; ++i) mma_bf16(part[j], a, b0[i], b1[i]);
      }
    }
    if (s % kSpt == kSpt - 1) {   // post-MVM dequantization
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          acc[j][v] = fmaf(part[j][v], scale, acc[j][v]);
          part[j][v] = 0.f;
        }
    }
    // refill this slot, now that its bytes are in registers and used
    if (s + kDecStages < n_steps) issue(s + kDecStages);
    cp_async_commit();
  }
  cp_async_wait<0>();
  __syncthreads();   // the ring becomes the reduction buffer

  // the decode kernel's fixed-order reduction: the warps of this block,
  // then the S units of this (row group, N tile) in rank order, summed by
  // the one that draws the last ticket
  constexpr int kRedRow = kCrossbar + 4;
  constexpr int kQuads = kPartial / 4 / (kDecWarps * 32);   // float4s a thread
  float* red = reinterpret_cast<float*>(dsmem);   // [kDecWarps][8][kRedRow]
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e)   // v = e and e + 2: columns n, n + 1
      *reinterpret_cast<float2*>(
          red + (warp * 8 + 2 * t + e) * kRedRow + 16 * g + 2 * j) =
          make_float2(acc[j][e], acc[j][e + 2]);
  __syncthreads();
  float4 sum[kQuads];
#pragma unroll
  for (int i = 0; i < kQuads; ++i) {
    const int f = threadIdx.x + i * kDecWarps * 32;   // float4 of the tile
    const int r = f / (kCrossbar / 4), c = 4 * (f % (kCrossbar / 4));
    sum[i] = *reinterpret_cast<const float4*>(red + r * kRedRow + c);
#pragma unroll
    for (int w = 1; w < kDecWarps; ++w) {
      const float4 v =
          *reinterpret_cast<const float4*>(red + (w * 8 + r) * kRedRow + c);
      sum[i].x += v.x;
      sum[i].y += v.y;
      sum[i].z += v.z;
      sum[i].w += v.w;
    }
  }
  auto write_out = [&]() {
#pragma unroll
    for (int i = 0; i < kQuads; ++i) {
      const int f = threadIdx.x + i * kDecWarps * 32;
      const int m = m0 + f / (kCrossbar / 4);
      const int n = n0 + 4 * (f % (kCrossbar / 4));
      const float v[4] = {sum[i].x, sum[i].y, sum[i].z, sum[i].w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (m < M && n + e < N) out[static_cast<size_t>(m) * N + n + e] = v[e];
    }
  };
  if (S == 1) {
    write_out();
    return;
  }
  float4* tiles4 = reinterpret_cast<float4*>(partials) +
                   static_cast<size_t>(tile) * S * (kPartial / 4);
#pragma unroll
  for (int i = 0; i < kQuads; ++i)
    tiles4[rank * (kPartial / 4) + threadIdx.x + i * kDecWarps * 32] = sum[i];
  __syncthreads();
  if (threadIdx.x == 0) last = draw_ticket(tickets + tile) == S - 1;
  __syncthreads();
  if (!last) return;
  constexpr int kBatch = 8;
#pragma unroll
  for (int i = 0; i < kQuads; ++i) sum[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int q0 = 0; q0 < S; q0 += kBatch) {
    float4 v[kBatch][kQuads];
#pragma unroll
    for (int q = 0; q < kBatch; ++q)
#pragma unroll
      for (int i = 0; i < kQuads; ++i)
        v[q][i] = q0 + q < S ? __ldcg(tiles4 + (q0 + q) * (kPartial / 4) +
                                      threadIdx.x + i * kDecWarps * 32)
                             : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int q = 0; q < kBatch; ++q)
#pragma unroll
      for (int i = 0; i < kQuads; ++i) {
        sum[i].x += v[q][i].x;
        sum[i].y += v[q][i].y;
        sum[i].z += v[q][i].z;
        sum[i].w += v[q][i].w;
      }
  }
  write_out();
  if (threadIdx.x == 0) tickets[tile] = 0;   // ready for the next call
}


template <int BITS>
__global__ void __launch_bounds__(kDecWarps * 32, 4)
crossbar_decode_kernel(const float* __restrict__ x,
                       const uint8_t* __restrict__ codes,
                       const float* __restrict__ scales,
                       float* __restrict__ out, float* __restrict__ partials,
                       int* __restrict__ tickets, int M, int K, int N, int Kp,
                       int Np, int x_vec) {
  const int nt = blockIdx.z;
  decode_body<BITS, 1>(x, codes, scales, out, partials, tickets, M, K, N, Kp,
                       Np, x_vec, blockIdx.y * 8, M, nt, blockIdx.x,
                       gridDim.x, blockIdx.y * (Np / kCrossbar) + nt);
}

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

// K splits of the decode kernel: kDecBlocksPerSm blocks for each SM, but no
// more than give each warp one K tile.
int decode_splits(int M, int Kp, int Np) {
  const int tiles = ((M + 7) / 8) * (Np / kCrossbar);
  int S = sm_count() * kDecBlocksPerSm / tiles;
  const int most = (Kp / kCrossbar + kDecWarps - 1) / kDecWarps;
  S = S > most ? most : S;
  S = S > kMaxSplit ? kMaxSplit : S;
  return S < 1 ? 1 : S;
}

// (row group, N tile) pairs of the decode kernel: one ticket each
int decode_tiles(int M, int Np) { return ((M + 7) / 8) * (Np / kCrossbar); }

// f32 partial tiles of the decode kernel: S for each (row group, N tile),
// none when K is not split
size_t decode_partials(int M, int Kp, int Np) {
  const int S = decode_splits(M, Kp, Np);
  return S == 1 ? 0
                : static_cast<size_t>(decode_tiles(M, Np)) * S * kPartial;
}

template <int BITS>
cudaError_t launch_decode(const float* x, const uint8_t* codes,
                          const float* scales, float* out, float* partials,
                          int* tickets, int M, int K, int N, int Kp, int Np,
                          int x_vec, cudaStream_t stream) {
  const dim3 grid(decode_splits(M, Kp, Np), (M + 7) / 8, Np / kCrossbar);
  crossbar_decode_kernel<BITS><<<grid, kDecWarps * 32, dec_smem<1>(), stream>>>(
      x, codes, scales, out, partials, tickets, M, K, N, Kp, Np, x_vec);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// grouped decode: a work list over the live row groups
// ---------------------------------------------------------------------------

// Blocks of the grouped decode grid for each SM: all that fit (registers,
// as the decode kernel's launch bounds allow), so that every unit of a
// list of up to 4 * SMs units runs at once.
constexpr int kGdBlocksPerSm = 4;

// k16 steps in a ring step of the grouped decode kernel (see decode_body)
template <int BITS>
constexpr int kGdSub = BITS == 8 ? 1 : 2;

// K splits of each (live row group, N tile) of the grouped decode kernel:
// as decode_splits, from the L live row groups rather than the buffer's,
// and the grid's blocks: the units (L x N tiles x S) fill it, no more.
__host__ __device__ inline int gd_splits(int live_groups, int Np, int Kp,
                                         int grid) {
  const int tiles = live_groups * (Np / kCrossbar);
  int S = tiles > 0 ? grid / tiles : 1;
  const int most = (Kp / kCrossbar + kDecWarps - 1) / kDecWarps;
  S = S > most ? most : S;
  S = S > kMaxSplit ? kMaxSplit : S;
  return S < 1 ? 1 : S;
}

// Grid: kGdBlocksPerSm blocks for each SM (set by the card alone, so a
// CUDA graph replays the call for any routing), kDecWarps warps a block.
// Each block derives the work list from counts: the live row groups are
// each slot's ceil(counts[s] / 8) groups of 8 rows from bases[s], in slot
// order (L in all: no padding group is among them); a unit is (live row
// group lg, N tile nt, K split rank), numbered u = (nt * L + lg) * S +
// rank (S = gd_splits(L, ...): the splits of one tile are adjacent, then
// the row groups of one N tile, so a slot's second pass over its codes
// follows its first). With no more units than blocks, unit j runs on
// block ceil(j * grid / units): spread over the grid's blocks, and so
// over the SMs (units on blocks 0 .. units - 1 ran 1.3x slower at 320
// units of 528, 8 rows on 8 of llama4-scout's (8192, 5120) experts: they
// shared fewer SMs). With more, block b runs unit b first, then takes the
// next unit left from a counter in the workspace (tickets[grid]) until
// none is, so a block that finishes early takes more (a fixed share, b +
// grid, b + 2 grid, ..., left blocks idle while others ran a second unit:
// 8 tokens top-2 over llama4-scout's experts are 832 units on 528
// blocks), and the last block out (counted in tickets[grid + 1]) sets
// both counters back to 0 for the next call; with no more units than
// blocks no counter is touched (the atomics of 528 blocks on one address
// cost ~3 us). Which block runs a unit does not change its bits: a split
// tile is summed in rank order. Rows from bases[slots] on hold no slot's
// rows: the grid writes their zeros, and reads no code for them. A row
// group's rows past its slot's count read x as 0 and so get exact zeros.
template <int BITS>
__global__ void __launch_bounds__(kDecWarps * 32, kGdBlocksPerSm)
grouped_live_decode_kernel(const float* __restrict__ x,
                           const uint8_t* __restrict__ codes,
                           const float* __restrict__ scales,
                           float* __restrict__ out,
                           float* __restrict__ partials,
                           int* __restrict__ tickets, int M, int K, int N,
                           int Kp, int Np, int x_vec,
                           const int* __restrict__ bases,
                           const int* __restrict__ counts, int slots,
                           size_t code_stride, int scale_stride) {
  __shared__ int s_list[2];   // L, S
  __shared__ int s_unit[4];   // first row, end of the slot's live rows,
                              // slot, unit
  int* next = tickets + gridDim.x;       // the next unit to take
  int* out_of_work = next + 1;           // blocks past their last unit
  if (threadIdx.x == 0) {
    int L = 0;
    for (int s = 0; s < slots; ++s) L += (__ldg(counts + s) + 7) / 8;
    s_list[0] = L;
    s_list[1] = gd_splits(L, Np, Kp, gridDim.x);
  }
  __syncthreads();
  const int L = s_list[0], S = s_list[1];
  const int n_nt = Np / kCrossbar;
  // the rows past the last slot's
  const size_t z0 = static_cast<size_t>(__ldg(bases + slots)) * N;
  const size_t z1 = static_cast<size_t>(M) * N;
  for (size_t i = z0 + static_cast<size_t>(blockIdx.x) * blockDim.x +
                  threadIdx.x;
       i < z1; i += static_cast<size_t>(gridDim.x) * blockDim.x)
    out[i] = 0.f;
  const int units = L * n_nt * S;
  const bool more = units > static_cast<int>(gridDim.x);
  for (int first = 1;; first = 0) {
    if (threadIdx.x == 0) {
      int u = units;   // none left
      if (first && more) {
        u = blockIdx.x;
      } else if (first && units > 0) {   // spread over the grid
        const long long j =
            static_cast<long long>(blockIdx.x) * units / gridDim.x;
        if ((j * gridDim.x + units - 1) / units == blockIdx.x)
          u = static_cast<int>(j);
      } else if (more) {
        u = static_cast<int>(gridDim.x) + atomicAdd(next, 1);
      }
      s_unit[3] = u;
      if (u < units) {   // the slot of the unit's live row group
        const int lg = (u / S) % L;
        int s = 0, r = lg;
        for (;; ++s) {
          const int n = (__ldg(counts + s) + 7) / 8;
          if (r < n) break;
          r -= n;
        }
        s_unit[0] = __ldg(bases + s) + 8 * r;
        s_unit[1] = __ldg(bases + s) + __ldg(counts + s);
        s_unit[2] = s;
      }
    }
    __syncthreads();
    const int u = s_unit[3];
    if (u >= units) break;
    const int m0 = s_unit[0], live = s_unit[1], slot = s_unit[2];
    const int tile = u / S, rank = u - tile * S, nt = tile / L;
    __syncthreads();   // read before the next unit's are written
    decode_body<BITS, kGdSub<BITS>>(
        x, codes + slot * code_stride,
        scales + static_cast<size_t>(slot) * scale_stride, out, partials,
        tickets, M, K, N, Kp, Np, x_vec, m0, live, nt, rank, S, tile);
  }
  if (more && threadIdx.x == 0 &&
      atomicAdd(out_of_work, 1) == gridDim.x - 1) {
    *next = 0;   // every block has taken its last unit: ready for the
    *out_of_work = 0;   // next call
  }
}

// blocks of the grouped decode grid
int gd_grid() { return kGdBlocksPerSm * sm_count(); }

// ---------------------------------------------------------------------------
// prefill: wgmma on bf16 codes and bf16 pieces of x
// ---------------------------------------------------------------------------

constexpr int kPfBM = 64;                 // rows of x per block
constexpr int kPfBN = 2 * kCrossbar;      // columns per block (2 warpgroups)
constexpr int kPfBK = 64;                 // K per stage: one 128-byte row
constexpr int kPfThreads = 256;
constexpr int kAPiece = kPfBM * kPfBK * 2;            // 8 KB per x piece
constexpr int kBTile = kPfBN * kPfBK * 2;             // 32 KB of codes
constexpr int kStage = kPieces * kAPiece + kBTile;    // 56 KB
constexpr int kPfSmem = 2 * kStage + 1024;            // + 1024-byte alignment

// Byte offset of (row, byte) in a K-major tile of 128-byte rows with the
// 128-byte swizzle: the 16-byte chunk index is XORed with row % 8 (the
// layout wgmma reads with layout type 1; tiles start 1024-aligned).
__device__ __forceinline__ uint32_t swz(int row, int byte) {
  return row * 128 + ((((byte >> 4) ^ row) & 7) << 4) + (byte & 15);
}

// wgmma shared-memory descriptor: K-major, 128-byte swizzle, 8-row groups
// 1024 bytes apart.
__device__ __forceinline__ uint64_t smem_desc(uint32_t saddr) {
  return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
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
__device__ __forceinline__ void keep(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 128 f32 fragment) = [d +] A (64 x 16) B (16 x 128)
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da,
                                                 uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
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
      : "l"(da), "l"(db), "r"(acc));
}

// Grid (ceil(Np / 256), ceil(M / 64)), 256 threads = 2 warpgroups; warpgroup
// w computes rows m0..m0+63, columns n0 + 128 w .. +127 (one crossbar).
// Each stage, every thread loads and converts: codes rows 4 kg .. 4 kg + 3
// (kg = lane % 16) of columns 16 ng .. +15 (ng = 2 warp + lane / 16),
// written transposed (K-major) as 8-byte runs of 4 k; x row tid / 4, 16 k
// from 16 (tid % 4), written as 16-byte runs of each piece.
//
// The body is shared with the grouped entry point (GROUPED: the rows of x
// belong to slots, each with its own codes; see group_of).
template <int BITS, bool GROUPED>
__device__ __forceinline__ void prefill_body(
    const float* __restrict__ x, const uint8_t* __restrict__ codes,
    const float* __restrict__ scales, float* __restrict__ out,
    float* __restrict__ partials, int* __restrict__ tickets, int M, int K,
    int N, int Kp, int Np, int x_vec, int per, const int* __restrict__ bases,
    const int* __restrict__ counts, int slots, size_t code_stride,
    int scale_stride) {
  constexpr int kLoads = BITS == 8 ? 4 : 2;
  __shared__ bool last;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t sbase =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem));

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = tid >> 7;
  const int n0 = blockIdx.x * kPfBN, m0 = blockIdx.y * kPfBM;
  const int n_nt = Np / kCrossbar, n_kt = Kp / kCrossbar;
  // this split's crossbar tiles, as 64-deep stages (two per tile)
  const int S = gridDim.z, rank = blockIdx.z;
  int Mx = M;   // rows of x that hold data: the rest read as 0
  if constexpr (GROUPED) {
    int slot;
    const int live = group_of(bases, counts, slots, m0, &slot);
    if (m0 >= live) {   // padding only: zeros, and no code is read
      if (rank == 0) zero_tile(out, m0, kPfBM, n0, kPfBN, M, N);
      return;
    }
    Mx = live;
    codes += slot * code_stride;
    scales += static_cast<size_t>(slot) * scale_stride;
  }
  const int c0 = 2 * rank * per;
  const int c1 = 2 * (n_kt < (rank + 1) * per ? n_kt : (rank + 1) * per);
  const int nt = n0 / kCrossbar + wg;      // this warpgroup's crossbar column
  const bool wg_live = nt < n_nt;

  const int kg = lane & 15, ng = 2 * warp + (lane >> 4);
  const bool c_live = n0 + 16 * ng < Np;
  const uint8_t* ccol = codes + n0 + 16 * ng;
  const int xr = tid >> 2, xk = 16 * (tid & 3);
  const bool x_live = m0 + xr < Mx;
  const float* xrow = x + static_cast<size_t>(x_live ? m0 + xr : 0) * K;

  uint4 craw[kLoads];
  float xraw[16];
  auto load = [&](int c) {
    const int k = c * kPfBK + 4 * kg;
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int row = BITS == 8 ? k + i : k / 2 + i;
      craw[i] = c_live ? __ldg(reinterpret_cast<const uint4*>(
                             ccol + static_cast<size_t>(row) * Np))
                       : make_uint4(0u, 0u, 0u, 0u);
    }
    const int kx = c * kPfBK + xk;
    if (x_live && x_vec && kx + 15 < K) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float4 v = __ldg(reinterpret_cast<const float4*>(xrow + kx) + q);
        xraw[4 * q] = v.x;
        xraw[4 * q + 1] = v.y;
        xraw[4 * q + 2] = v.z;
        xraw[4 * q + 3] = v.w;
      }
    } else {
#pragma unroll
      for (int e = 0; e < 16; ++e)
        xraw[e] = x_live && kx + e < K ? __ldg(xrow + kx + e) : 0.f;
    }
  };
  auto store = [&](int st) {
    uint8_t* a0 = smem + st * kStage;   // piece i at a0 + i * kAPiece
    uint8_t* b = a0 + kPieces * kAPiece;
    uint32_t rw[4][4];
    bias_rows<BITS>(craw, rw);
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const uint2 v = make_uint2(
          pack_bf16(code_at<BITS>(rw, 0, j), code_at<BITS>(rw, 1, j)),
          pack_bf16(code_at<BITS>(rw, 2, j), code_at<BITS>(rw, 3, j)));
      *reinterpret_cast<uint2*>(b + swz(16 * ng + j, 8 * kg)) = v;
    }
    uint32_t pc[8][kPieces];
#pragma unroll
    for (int e = 0; e < 8; ++e) split_x(xraw[2 * e], xraw[2 * e + 1], pc[e]);
#pragma unroll
    for (int i = 0; i < kPieces; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<uint4*>(a0 + i * kAPiece +
                                  swz(xr, 2 * xk + 16 * h)) =
            make_uint4(pc[4 * h][i], pc[4 * h + 1][i], pc[4 * h + 2][i],
                       pc[4 * h + 3][i]);
  };

  float acc[64], part[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = part[i] = 0.f;

  load(c0);
  store(0);
  if (c0 + 1 < c1) load(c0 + 1);
  fence_async_smem();
  __syncthreads();
  for (int c = c0; c < c1; ++c) {   // c0 is even: buffer c & 1 == tile half
    const uint32_t s_a = sbase + (c & 1) * kStage;   // x pieces, then codes
    const uint32_t s_b = s_a + kPieces * kAPiece + wg * (kCrossbar * 128);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kPfBK / 16; ++ks) {
      const uint64_t db = smem_desc(s_b + 32 * ks);
#pragma unroll
      for (int i = 0; i < kPieces; ++i)   // a crossbar tile starts afresh
        wgmma_m64n128k16(part, smem_desc(s_a + i * kAPiece + 32 * ks), db,
                         (c & 1) | (ks > 0) | (i > 0));
    }
    wgmma_commit();
    const float scale =
        (c & 1) && wg_live ? __ldg(scales + (c >> 1) * n_nt + nt) : 0.f;
    if (c + 1 < c1) store((c + 1) & 1);  // its buffer was read at c - 1
    if (c + 2 < c1) load(c + 2);
    wgmma_wait_all();
    keep(part);
    if (c & 1) {                                // post-MVM dequantization
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = fmaf(part[i], scale, acc[i]);
    }
    fence_async_smem();
    __syncthreads();
  }

  // K split: each block stores its fragments; the block that draws the
  // last ticket sums all S in rank order (as in the decode kernel)
  if (S > 1) {
    const int tile = blockIdx.y * gridDim.x + blockIdx.x;
    float4* frags = reinterpret_cast<float4*>(partials) +
                    static_cast<size_t>(tile) * S * kPfThreads * 16;
#pragma unroll
    for (int i = 0; i < 16; ++i)
      frags[(rank * kPfThreads + tid) * 16 + i] = make_float4(
          acc[4 * i], acc[4 * i + 1], acc[4 * i + 2], acc[4 * i + 3]);
    __syncthreads();
    if (tid == 0) last = draw_ticket(tickets + tile) == S - 1;
    __syncthreads();
    if (!last) return;
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    for (int q = 0; q < S; ++q) {
      float4 v[16];
#pragma unroll
      for (int i = 0; i < 16; ++i)   // L2 (__ldcg: L1 is not coherent)
        v[i] = __ldcg(frags + (q * kPfThreads + tid) * 16 + i);
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        acc[4 * i] += v[i].x;
        acc[4 * i + 1] += v[i].y;
        acc[4 * i + 2] += v[i].z;
        acc[4 * i + 3] += v[i].w;
      }
    }
    if (tid == 0) tickets[tile] = 0;   // ready for the next call
  }

  if (!wg_live) return;
  const int w4 = warp & 3, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int n = nt * kCrossbar + 8 * i + 2 * t;
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int m = m0 + 16 * w4 + g + 8 * (v >> 1), nn = n + (v & 1);
      if (m < M && nn < N) out[static_cast<size_t>(m) * N + nn] = acc[4 * i + v];
    }
  }
}

template <int BITS>
__global__ void __launch_bounds__(kPfThreads, 1)
crossbar_prefill_kernel(const float* __restrict__ x,
                        const uint8_t* __restrict__ codes,
                        const float* __restrict__ scales,
                        float* __restrict__ out, float* __restrict__ partials,
                        int* __restrict__ tickets, int M, int K, int N, int Kp,
                        int Np, int x_vec, int per) {
  prefill_body<BITS, false>(x, codes, scales, out, partials, tickets, M, K,
                            N, Kp, Np, x_vec, per, nullptr, nullptr, 0, 0, 0);
}

template <int BITS>
__global__ void __launch_bounds__(kPfThreads, 1)
grouped_prefill_kernel(const float* __restrict__ x,
                       const uint8_t* __restrict__ codes,
                       const float* __restrict__ scales,
                       float* __restrict__ out, float* __restrict__ partials,
                       int* __restrict__ tickets, int M, int K, int N, int Kp,
                       int Np, int x_vec, int per,
                       const int* __restrict__ bases,
                       const int* __restrict__ counts, int slots,
                       size_t code_stride, int scale_stride) {
  prefill_body<BITS, true>(x, codes, scales, out, partials, tickets, M, K, N,
                           Kp, Np, x_vec, per, bases, counts, slots,
                           code_stride, scale_stride);
}

// (M tile, N tile) pairs of the prefill kernel: one ticket each
int prefill_tiles(int M, int Np) {
  return ((Np + kPfBN - 1) / kPfBN) * ((M + kPfBM - 1) / kPfBM);
}

// Crossbar tiles per K split of the prefill kernel: split K only when the
// output tiles alone leave SMs idle (one block fits on an SM).
int prefill_per(int M, int Kp, int Np) {
  const int n_kt = Kp / kCrossbar;
  int S = sm_count() / prefill_tiles(M, Np);
  S = S < 1 ? 1 : (S > n_kt ? n_kt : S);
  return (n_kt + S - 1) / S;
}

int prefill_splits(int M, int Kp, int Np) {
  const int per = prefill_per(M, Kp, Np);
  return (Kp / kCrossbar + per - 1) / per;
}

// f32 fragments of the prefill kernel: S per (M tile, N tile), none when K
// is not split
size_t prefill_partials(int M, int Kp, int Np) {
  const int S = prefill_splits(M, Kp, Np);
  return S == 1 ? 0
                : static_cast<size_t>(prefill_tiles(M, Np)) * S * kPfThreads *
                      64;
}

template <int BITS>
cudaError_t launch_prefill(const float* x, const uint8_t* codes,
                           const float* scales, float* out, float* partials,
                           int* tickets, int M, int K, int N, int Kp, int Np,
                           int x_vec, cudaStream_t stream) {
  static bool configured = false;  // one attribute call per instantiation
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        crossbar_prefill_kernel<BITS>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kPfSmem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid((Np + kPfBN - 1) / kPfBN, (M + kPfBM - 1) / kPfBM,
                  prefill_splits(M, Kp, Np));
  crossbar_prefill_kernel<BITS><<<grid, kPfThreads, kPfSmem, stream>>>(
      x, codes, scales, out, partials, tickets, M, K, N, Kp, Np, x_vec,
      prefill_per(M, Kp, Np));
  return cudaGetLastError();
}

// The grouped entry point's launches: the decode kernel's fixed grid over
// the work list of the live row groups (grouped_live_decode_kernel), the
// prefill kernel's grid over the buffer's R rows, each block reading the
// codes of its row tile's slot.
struct Groups {
  const int* bases;
  const int* counts;
  int slots;
  size_t code_stride;   // bytes of one slot's codes
  int scale_stride;     // scales of one slot
};

template <int BITS>
cudaError_t launch_grouped_decode(const float* x, const uint8_t* codes,
                                  const float* scales, float* out,
                                  float* partials, int* tickets, int R, int K,
                                  int N, int Kp, int Np, int x_vec,
                                  const Groups& gr, cudaStream_t stream) {
  grouped_live_decode_kernel<BITS>
      <<<gd_grid(), kDecWarps * 32, dec_smem<kGdSub<BITS>>(), stream>>>(
          x, codes, scales, out, partials, tickets, R, K, N, Kp, Np, x_vec,
          gr.bases, gr.counts, gr.slots, gr.code_stride, gr.scale_stride);
  return cudaGetLastError();
}

template <int BITS>
cudaError_t launch_grouped_prefill(const float* x, const uint8_t* codes,
                                   const float* scales, float* out,
                                   float* partials, int* tickets, int R,
                                   int K, int N, int Kp, int Np, int x_vec,
                                   const Groups& gr, cudaStream_t stream) {
  static bool configured = false;  // one attribute call per instantiation
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        grouped_prefill_kernel<BITS>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kPfSmem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid((Np + kPfBN - 1) / kPfBN, R / kPfBM,
                  prefill_splits(R, Kp, Np));
  grouped_prefill_kernel<BITS><<<grid, kPfThreads, kPfSmem, stream>>>(
      x, codes, scales, out, partials, tickets, R, K, N, Kp, Np, x_vec,
      prefill_per(R, Kp, Np), gr.bases, gr.counts, gr.slots, gr.code_stride,
      gr.scale_stride);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// transposed: dx = g . dequant(W)^T, wgmma on bf16 pieces of g
// ---------------------------------------------------------------------------

// Grid (ceil(Kp / 256), ceil(M / 64), S), 256 threads = 2 warpgroups;
// warpgroup w computes dx rows m0..m0+63, columns k0 + 128 w .. +127 (its
// crossbar row kt). A stage's shared layout is the prefill kernel's: g's
// pieces (64 rows x 64 n each), then the codes (256 rows of k x 64 n),
// all K-major (along n) with the 128-byte swizzle. Each stage, every
// thread loads and converts 16 n from 16 (tid % 4) of g row tid / 4 (as x
// in the prefill kernel) and of code rows r + 64 i (r = tid / 4; int8,
// i < 4) or packed rows r + 64 i (int4, i < 2: B rows 2 (r + 64 i) and
// 2 (r + 64 i) + 1).
//
// The body is shared with the grouped entry point (GROUPED: the rows of g
// and dx belong to slots, each with its own codes; see group_of). A tile
// of padding only writes its zeros and reads no code; in a live tile the
// rows past the slot's count read g as 0, so their dx is 0 too.
template <int BITS, bool GROUPED>
__device__ __forceinline__ void t_body(
    const float* __restrict__ g, const uint8_t* __restrict__ codes,
    const float* __restrict__ scales, float* __restrict__ out,
    float* __restrict__ partials, int* __restrict__ tickets, int M, int K,
    int N, int Kp, int Np, int g_vec, int per, const int* __restrict__ bases,
    const int* __restrict__ counts, int slots, size_t code_stride,
    int scale_stride) {
  constexpr int kLoads = BITS == 8 ? 4 : 2;
  __shared__ bool last;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t sbase =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem));

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = tid >> 7;
  const int k0 = blockIdx.x * kPfBN, m0 = blockIdx.y * kPfBM;
  const int n_nt = Np / kCrossbar, n_kt = Kp / kCrossbar;
  // this split's N tiles, as 64-deep stages (two per tile)
  const int S = gridDim.z, rank = blockIdx.z;
  int Mg = M;   // rows of g that hold data: the rest read as 0
  if constexpr (GROUPED) {
    int slot;
    const int live = group_of(bases, counts, slots, m0, &slot);
    // a tile that is not inside one slot's rows (a base that is not a
    // multiple of 64) would give another slot's rows this slot's codes:
    // it is written as NaN, never as a finite wrong dx
    if (slot < slots &&
        (__ldg(bases + slot) > m0 ||
         (slot + 1 < slots && __ldg(bases + slot + 1) < m0 + kPfBM))) {
      if (rank == 0)
        zero_tile(out, m0, kPfBM, k0, kPfBN, M, K, __int_as_float(0x7fc00000));
      return;
    }
    if (m0 >= live) {   // padding only: zeros, and no code is read
      if (rank == 0) zero_tile(out, m0, kPfBM, k0, kPfBN, M, K);
      return;
    }
    Mg = live;
    codes += slot * code_stride;
    scales += static_cast<size_t>(slot) * scale_stride;
  }
  const int c0 = 2 * rank * per;
  const int c1 = 2 * (n_nt < (rank + 1) * per ? n_nt : (rank + 1) * per);
  const int kt = k0 / kCrossbar + wg;      // this warpgroup's crossbar row
  const bool wg_live = kt < n_kt;

  const int r = tid >> 2, cn = 16 * (tid & 3);
  const int prow0 = (BITS == 8 ? k0 : k0 / 2) + r;   // first (packed) row
  const int prows = BITS == 8 ? Kp : Kp / 2;
  const bool g_live = m0 + r < Mg;
  const float* grow = g + static_cast<size_t>(g_live ? m0 + r : 0) * N;

  uint4 craw[kLoads];
  float graw[16];
  auto load = [&](int c) {
    const int n = c * kPfBK + cn;
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int row = prow0 + 64 * i;
      craw[i] = row < prows ? __ldg(reinterpret_cast<const uint4*>(
                                  codes + static_cast<size_t>(row) * Np + n))
                            : make_uint4(0u, 0u, 0u, 0u);
    }
    if (g_live && g_vec && n + 15 < N) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float4 v = __ldg(reinterpret_cast<const float4*>(grow + n) + q);
        graw[4 * q] = v.x;
        graw[4 * q + 1] = v.y;
        graw[4 * q + 2] = v.z;
        graw[4 * q + 3] = v.w;
      }
    } else {
#pragma unroll
      for (int e = 0; e < 16; ++e)
        graw[e] = g_live && n + e < N ? __ldg(grow + n + e) : 0.f;
    }
  };
  auto store = [&](int st) {
    uint8_t* a0 = smem + st * kStage;   // piece i at a0 + i * kAPiece
    uint8_t* b = a0 + kPieces * kAPiece;
    uint32_t rw[4][4];
    bias_rows<BITS>(craw, rw);
#pragma unroll
    for (int q = 0; q < 4; ++q) {   // B row of rw[q]: code row k0 + row
      const int row =
          BITS == 8 ? r + 64 * q : 2 * (r + 64 * (q >> 1)) + (q & 1);
      uint32_t w[8];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        w[j] = pack_bf16(code_at<BITS>(rw, q, 2 * j),
                         code_at<BITS>(rw, q, 2 * j + 1));
      *reinterpret_cast<uint4*>(b + swz(row, 2 * cn)) =
          make_uint4(w[0], w[1], w[2], w[3]);
      *reinterpret_cast<uint4*>(b + swz(row, 2 * cn + 16)) =
          make_uint4(w[4], w[5], w[6], w[7]);
    }
    uint32_t pc[8][kPieces];
#pragma unroll
    for (int e = 0; e < 8; ++e) split_x(graw[2 * e], graw[2 * e + 1], pc[e]);
#pragma unroll
    for (int i = 0; i < kPieces; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<uint4*>(a0 + i * kAPiece +
                                  swz(r, 2 * cn + 16 * h)) =
            make_uint4(pc[4 * h][i], pc[4 * h + 1][i], pc[4 * h + 2][i],
                       pc[4 * h + 3][i]);
  };

  float acc[64], part[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = part[i] = 0.f;

  load(c0);
  store(0);
  if (c0 + 1 < c1) load(c0 + 1);
  fence_async_smem();
  __syncthreads();
  for (int c = c0; c < c1; ++c) {   // c0 is even: buffer c & 1 == tile half
    const uint32_t s_a = sbase + (c & 1) * kStage;   // g pieces, then codes
    const uint32_t s_b = s_a + kPieces * kAPiece + wg * (kCrossbar * 128);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kPfBK / 16; ++ks) {
      const uint64_t db = smem_desc(s_b + 32 * ks);
#pragma unroll
      for (int i = 0; i < kPieces; ++i)   // an N tile starts afresh
        wgmma_m64n128k16(part, smem_desc(s_a + i * kAPiece + 32 * ks), db,
                         (c & 1) | (ks > 0) | (i > 0));
    }
    wgmma_commit();
    const float scale =
        (c & 1) && wg_live ? __ldg(scales + kt * n_nt + (c >> 1)) : 0.f;
    if (c + 1 < c1) store((c + 1) & 1);  // its buffer was read at c - 1
    if (c + 2 < c1) load(c + 2);
    wgmma_wait_all();
    keep(part);
    if (c & 1) {                                // post-MVM dequantization
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = fmaf(part[i], scale, acc[i]);
    }
    fence_async_smem();
    __syncthreads();
  }

  // N split: each block stores its fragments; the block that draws the
  // last ticket sums all S in rank order (as in the prefill kernel)
  if (S > 1) {
    const int tile = blockIdx.y * gridDim.x + blockIdx.x;
    float4* frags = reinterpret_cast<float4*>(partials) +
                    static_cast<size_t>(tile) * S * kPfThreads * 16;
#pragma unroll
    for (int i = 0; i < 16; ++i)
      frags[(rank * kPfThreads + tid) * 16 + i] = make_float4(
          acc[4 * i], acc[4 * i + 1], acc[4 * i + 2], acc[4 * i + 3]);
    __syncthreads();
    if (tid == 0) last = draw_ticket(tickets + tile) == S - 1;
    __syncthreads();
    if (!last) return;
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    for (int q = 0; q < S; ++q) {
      float4 v[16];
#pragma unroll
      for (int i = 0; i < 16; ++i)   // L2 (__ldcg: L1 is not coherent)
        v[i] = __ldcg(frags + (q * kPfThreads + tid) * 16 + i);
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        acc[4 * i] += v[i].x;
        acc[4 * i + 1] += v[i].y;
        acc[4 * i + 2] += v[i].z;
        acc[4 * i + 3] += v[i].w;
      }
    }
    if (tid == 0) tickets[tile] = 0;   // ready for the next call
  }

  if (!wg_live) return;
  const int w4 = warp & 3, gq = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int k = kt * kCrossbar + 8 * i + 2 * t;
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int m = m0 + 16 * w4 + gq + 8 * (v >> 1), kk = k + (v & 1);
      if (m < M && kk < K)
        out[static_cast<size_t>(m) * K + kk] = acc[4 * i + v];
    }
  }
}

template <int BITS>
__global__ void __launch_bounds__(kPfThreads, 1)
crossbar_t_kernel(const float* __restrict__ g,
                  const uint8_t* __restrict__ codes,
                  const float* __restrict__ scales, float* __restrict__ out,
                  float* __restrict__ partials, int* __restrict__ tickets,
                  int M, int K, int N, int Kp, int Np, int g_vec, int per) {
  t_body<BITS, false>(g, codes, scales, out, partials, tickets, M, K, N, Kp,
                      Np, g_vec, per, nullptr, nullptr, 0, 0, 0);
}

template <int BITS>
__global__ void __launch_bounds__(kPfThreads, 1)
grouped_t_kernel(const float* __restrict__ g,
                 const uint8_t* __restrict__ codes,
                 const float* __restrict__ scales, float* __restrict__ out,
                 float* __restrict__ partials, int* __restrict__ tickets,
                 int M, int K, int N, int Kp, int Np, int g_vec, int per,
                 const int* __restrict__ bases,
                 const int* __restrict__ counts, int slots,
                 size_t code_stride, int scale_stride) {
  t_body<BITS, true>(g, codes, scales, out, partials, tickets, M, K, N, Kp,
                     Np, g_vec, per, bases, counts, slots, code_stride,
                     scale_stride);
}

// The transposed kernel's plan is the prefill kernel's with the roles of
// K (its output width here) and N (its reduction) swapped: the prefill_*
// helpers take (M, reduction, output width).
template <int BITS>
cudaError_t launch_t(const float* g, const uint8_t* codes,
                     const float* scales, float* out, float* partials,
                     int* tickets, int M, int K, int N, int Kp, int Np,
                     int g_vec, cudaStream_t stream) {
  static bool configured = false;  // one attribute call per instantiation
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        crossbar_t_kernel<BITS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kPfSmem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid((Kp + kPfBN - 1) / kPfBN, (M + kPfBM - 1) / kPfBM,
                  prefill_splits(M, Np, Kp));
  crossbar_t_kernel<BITS><<<grid, kPfThreads, kPfSmem, stream>>>(
      g, codes, scales, out, partials, tickets, M, K, N, Kp, Np, g_vec,
      prefill_per(M, Np, Kp));
  return cudaGetLastError();
}

// The grouped dx: the transposed kernel's grid over the buffer's R rows
// (R / 64 row tiles), each block reading the codes of its row tile's slot.
template <int BITS>
cudaError_t launch_grouped_t(const float* g, const uint8_t* codes,
                             const float* scales, float* out, float* partials,
                             int* tickets, int R, int K, int N, int Kp,
                             int Np, int g_vec, const Groups& gr,
                             cudaStream_t stream) {
  static bool configured = false;  // one attribute call per instantiation
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        grouped_t_kernel<BITS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kPfSmem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid((Kp + kPfBN - 1) / kPfBN, R / kPfBM,
                  prefill_splits(R, Np, Kp));
  grouped_t_kernel<BITS><<<grid, kPfThreads, kPfSmem, stream>>>(
      g, codes, scales, out, partials, tickets, R, K, N, Kp, Np, g_vec,
      prefill_per(R, Np, Kp), gr.bases, gr.counts, gr.slots, gr.code_stride,
      gr.scale_stride);
  return cudaGetLastError();
}

}  // namespace

namespace {

// decode while its passes over the codes (one per 8 rows) read at most
// kDecodeMaxBytes, and always for one pass
bool picks_decode(int M, int Kp, int Np, int bits, int kernel) {
  const size_t passes = static_cast<size_t>((M + 7) / 8);
  const size_t code_bytes = static_cast<size_t>(Kp) * Np * bits / 8;
  return kernel == 1 ||
         (kernel == 0 && (passes == 1 || passes * code_bytes <= kDecodeMaxBytes));
}

}  // namespace

// Workspace that crossbar_matmul needs for these arguments: returns the
// f32 partials it needs and sets *tickets to the int tickets it needs
// (both 0 when K is not split). The caller allocates both and zeroes
// the tickets once: every call leaves them at 0, so the same workspace
// serves every later call on the same stream.
extern "C" size_t crossbar_matmul_workspace(int M, int Kp, int Np, int bits,
                                            int kernel,
                                            int* tickets) {
  *tickets = 0;
  if (M <= 0 || Kp < kCrossbar || Np < kCrossbar) return 0;
  const bool decode = picks_decode(M, Kp, Np, bits, kernel);
  const size_t partials = decode ? decode_partials(M, Kp, Np)
                                 : prefill_partials(M, Kp, Np);
  if (partials > 0)
    *tickets = decode ? decode_tiles(M, Np) : prefill_tiles(M, Np);
  return partials;
}

// kernel: 0 picks by picks_decode, 1 forces decode,
// 2 forces prefill (for measuring the crossover). Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for arguments
// the kernels do not take, or a workspace smaller than
// crossbar_matmul_workspace asks for). Allocates nothing, does not
// synchronise; runs on `stream`.
extern "C" int crossbar_matmul(const void* x, const void* codes,
                               const void* scales, void* out, void* partials,
                               size_t n_partials, void* tickets, int n_tickets,
                               int M, int K, int N, int Kp, int Np, int bits,
                               int kernel, void* stream) {
  if ((bits != 8 && bits != 4) || M <= 0 || K <= 0 || N <= 0 ||
      Kp % kCrossbar != 0 || Np % kCrossbar != 0 || K > Kp || N > Np ||
      (M + kPfBM - 1) / kPfBM > 65535 || Np / kCrossbar > 65535 ||
      kernel < 0 || kernel > 2 ||
      reinterpret_cast<uintptr_t>(codes) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool decode = picks_decode(M, Kp, Np, bits, kernel);
  const size_t need = decode ? decode_partials(M, Kp, Np)
                             : prefill_partials(M, Kp, Np);
  const int need_tickets =
      need == 0 ? 0 : (decode ? decode_tiles(M, Np) : prefill_tiles(M, Np));
  if ((decode && (M + 7) / 8 > 65535) || n_partials < need ||
      n_tickets < need_tickets)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* xf = static_cast<const float*>(x);
  const uint8_t* c = static_cast<const uint8_t*>(codes);
  const float* sc = static_cast<const float*>(scales);
  float* o = static_cast<float*>(out);
  float* pa = static_cast<float*>(partials);
  int* ti = static_cast<int*>(tickets);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int x_vec = reinterpret_cast<uintptr_t>(x) % 16 == 0 && K % 4 == 0;
  cudaError_t err;
  if (decode)
    err = bits == 8 ? launch_decode<8>(xf, c, sc, o, pa, ti, M, K, N, Kp, Np,
                                       x_vec, st)
                    : launch_decode<4>(xf, c, sc, o, pa, ti, M, K, N, Kp, Np,
                                       x_vec, st);
  else
    err = bits == 8
              ? launch_prefill<8>(xf, c, sc, o, pa, ti, M, K, N, Kp, Np, x_vec,
                                  st)
              : launch_prefill<4>(xf, c, sc, o, pa, ti, M, K, N, Kp, Np, x_vec,
                                  st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// Workspace that grouped_crossbar_matmul needs for these arguments, as
// crossbar_matmul_workspace: kernel 1 (decode) one ticket for each block
// of its grid and its two work counters, and at most one partial tile for
// each block (its units fill the grid, so whatever the counts, tiles * S
// <= grid when K is split; none when K is never split); kernel 2
// (prefill) the prefill kernel's over R rows.
extern "C" size_t grouped_crossbar_matmul_workspace(int R, int Kp, int Np,
                                                    int bits, int kernel,
                                                    int* tickets) {
  *tickets = 0;
  if (R <= 0 || Kp < kCrossbar || Np < kCrossbar) return 0;
  if (kernel != 1) {
    const size_t partials = prefill_partials(R, Kp, Np);
    if (partials > 0) *tickets = prefill_tiles(R, Np);
    return partials;
  }
  *tickets = gd_grid() + 2;
  if (gd_splits(1, kCrossbar, Kp, gd_grid()) == 1) return 0;
  return static_cast<size_t>(gd_grid()) * kPartial;
}

// y[r] = x[r] (R, K) f32 @ dequant(codes[s], scales[s]) for every row r of
// slot s's live rows (see group_of: bases (slots + 1) and counts (slots),
// int32 on the device, bases multiples of the row tile), zeros in every
// other row of out (R, N): the expert products of a mixture-of-experts
// layer. codes (slots, Kp or Kp / 2, Np) and scales (slots, Kp / 128,
// Np / 128) are the slots' weights stacked, each as crossbar_matmul takes
// one. kernel 1 runs the grouped decode kernel over 8-row tiles (a grid
// of whole blocks per SM, each deriving the work list of live row groups
// from counts on the device), 2 the prefill kernel over 64-row tiles (a
// grid fixed by R: a block whose tile holds padding only writes its zeros
// and reads no code); R must be a multiple of the tile. Neither grid
// depends on the counts, so a CUDA graph replays the call for any
// routing. The workspace is grouped_crossbar_matmul_workspace's.
// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue for
// arguments the kernels do not take). Allocates nothing, does not
// synchronise; runs on `stream`.
extern "C" int grouped_crossbar_matmul(const void* x, const void* codes,
                                       const void* scales, void* out,
                                       void* partials, size_t n_partials,
                                       void* tickets, int n_tickets,
                                       const void* bases, const void* counts,
                                       int slots, int R, int K, int N, int Kp,
                                       int Np, int bits, int kernel,
                                       void* stream) {
  const int tile = kernel == 1 ? 8 : kPfBM;
  if ((bits != 8 && bits != 4) || (kernel != 1 && kernel != 2) || R <= 0 ||
      R % tile != 0 || slots <= 0 || K <= 0 || N <= 0 ||
      Kp % kCrossbar != 0 || Np % kCrossbar != 0 || K > Kp || N > Np ||
      R / tile > 65535 || Np / kCrossbar > 65535 ||
      reinterpret_cast<uintptr_t>(codes) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool decode = kernel == 1;
  int need_tickets = 0;
  const size_t need =
      grouped_crossbar_matmul_workspace(R, Kp, Np, bits, kernel, &need_tickets);
  if (n_partials < need || n_tickets < need_tickets)
    return static_cast<int>(cudaErrorInvalidValue);
  const Groups gr{static_cast<const int*>(bases),
                  static_cast<const int*>(counts), slots,
                  static_cast<size_t>(Kp) * Np * bits / 8,
                  (Kp / kCrossbar) * (Np / kCrossbar)};
  const float* xf = static_cast<const float*>(x);
  const uint8_t* c = static_cast<const uint8_t*>(codes);
  const float* sc = static_cast<const float*>(scales);
  float* o = static_cast<float*>(out);
  float* pa = static_cast<float*>(partials);
  int* ti = static_cast<int*>(tickets);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int x_vec = reinterpret_cast<uintptr_t>(x) % 16 == 0 && K % 4 == 0;
  cudaError_t err;
  if (decode)
    err = bits == 8 ? launch_grouped_decode<8>(xf, c, sc, o, pa, ti, R, K, N,
                                               Kp, Np, x_vec, gr, st)
                    : launch_grouped_decode<4>(xf, c, sc, o, pa, ti, R, K, N,
                                               Kp, Np, x_vec, gr, st);
  else
    err = bits == 8 ? launch_grouped_prefill<8>(xf, c, sc, o, pa, ti, R, K,
                                                N, Kp, Np, x_vec, gr, st)
                    : launch_grouped_prefill<4>(xf, c, sc, o, pa, ti, R, K,
                                                N, Kp, Np, x_vec, gr, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// Workspace that crossbar_matmul_t needs for these arguments, as
// crossbar_matmul_workspace (the transposed kernel splits N where its
// output tiles leave SMs idle). The same workspace serves both entry
// points when their calls run in order on one stream.
extern "C" size_t crossbar_matmul_t_workspace(int M, int Kp, int Np,
                                              int* tickets) {
  *tickets = 0;
  if (M <= 0 || Kp < kCrossbar || Np < kCrossbar) return 0;
  const size_t partials = prefill_partials(M, Np, Kp);  // N, K swapped
  if (partials > 0) *tickets = prefill_tiles(M, Kp);
  return partials;
}

// dx (M, K) = g (M, N) . dequant(codes, scales)^T, f32: the backward of
// crossbar_matmul with respect to x. Same codes, scales and padding rules
// as crossbar_matmul (columns of dx beyond K are not written). Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for
// arguments the kernel does not take, or a workspace smaller than
// crossbar_matmul_t_workspace asks for). Allocates nothing, does not
// synchronise; runs on `stream`.
extern "C" int crossbar_matmul_t(const void* g, const void* codes,
                                 const void* scales, void* out,
                                 void* partials, size_t n_partials,
                                 void* tickets, int n_tickets, int M, int K,
                                 int N, int Kp, int Np, int bits,
                                 void* stream) {
  if ((bits != 8 && bits != 4) || M <= 0 || K <= 0 || N <= 0 ||
      Kp % kCrossbar != 0 || Np % kCrossbar != 0 || K > Kp || N > Np ||
      (M + kPfBM - 1) / kPfBM > 65535 ||
      reinterpret_cast<uintptr_t>(codes) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t need = prefill_partials(M, Np, Kp);  // N, K swapped
  if (n_partials < need || (need > 0 && n_tickets < prefill_tiles(M, Kp)))
    return static_cast<int>(cudaErrorInvalidValue);
  const float* gf = static_cast<const float*>(g);
  const uint8_t* c = static_cast<const uint8_t*>(codes);
  const float* sc = static_cast<const float*>(scales);
  float* o = static_cast<float*>(out);
  float* pa = static_cast<float*>(partials);
  int* ti = static_cast<int*>(tickets);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int g_vec = reinterpret_cast<uintptr_t>(g) % 16 == 0 && N % 4 == 0;
  const cudaError_t err =
      bits == 8 ? launch_t<8>(gf, c, sc, o, pa, ti, M, K, N, Kp, Np, g_vec, st)
                : launch_t<4>(gf, c, sc, o, pa, ti, M, K, N, Kp, Np, g_vec,
                              st);
  return static_cast<int>(err);
}

// dx[r] = g[r] (R, N) f32 . dequant(codes[s], scales[s])^T for every row r
// of slot s's live rows, zeros in every other row of dx (R, K): the
// backward of grouped_crossbar_matmul with respect to x (its output rows
// outside the live rows are constant 0, so they carry no gradient). The
// codes, scales, bases and counts are grouped_crossbar_matmul's, with the
// prefill kernel's layout: bases multiples of 64 and R a multiple of 64
// (a tile of 64 rows lies in one slot; the caller keeps the bases so, and
// a tile that does not lie in one slot is written as NaN). A grid fixed
// by R; a block whose tile holds padding only writes its zeros and reads
// no code. The workspace is crossbar_matmul_t_workspace's for R rows.
// Returns cudaGetLastError()
// after the launch (cudaErrorInvalidValue for arguments the kernel does
// not take). Allocates nothing, does not synchronise; runs on `stream`.
extern "C" int grouped_crossbar_matmul_t(const void* g, const void* codes,
                                         const void* scales, void* out,
                                         void* partials, size_t n_partials,
                                         void* tickets, int n_tickets,
                                         const void* bases,
                                         const void* counts, int slots,
                                         int R, int K, int N, int Kp, int Np,
                                         int bits, void* stream) {
  if ((bits != 8 && bits != 4) || R <= 0 || R % kPfBM != 0 || slots <= 0 ||
      K <= 0 || N <= 0 || Kp % kCrossbar != 0 || Np % kCrossbar != 0 ||
      K > Kp || N > Np || R / kPfBM > 65535 ||
      reinterpret_cast<uintptr_t>(codes) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t need = prefill_partials(R, Np, Kp);  // N, K swapped
  if (n_partials < need || (need > 0 && n_tickets < prefill_tiles(R, Kp)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Groups gr{static_cast<const int*>(bases),
                  static_cast<const int*>(counts), slots,
                  static_cast<size_t>(Kp) * Np * bits / 8,
                  (Kp / kCrossbar) * (Np / kCrossbar)};
  const float* gf = static_cast<const float*>(g);
  const uint8_t* c = static_cast<const uint8_t*>(codes);
  const float* sc = static_cast<const float*>(scales);
  float* o = static_cast<float*>(out);
  float* pa = static_cast<float*>(partials);
  int* ti = static_cast<int*>(tickets);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int g_vec = reinterpret_cast<uintptr_t>(g) % 16 == 0 && N % 4 == 0;
  const cudaError_t err =
      bits == 8 ? launch_grouped_t<8>(gf, c, sc, o, pa, ti, R, K, N, Kp, Np,
                                      g_vec, gr, st)
                : launch_grouped_t<4>(gf, c, sc, o, pa, ti, R, K, N, Kp, Np,
                                      g_vec, gr, st);
  return static_cast<int>(err);
}
