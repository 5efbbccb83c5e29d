// RWKV6 "Finch" wkv recurrence for Hopper (sm_90a): a register recurrence
// for decode and short chunks, and a chunked kernel on the tensor cores
// for prefill chunks.
//
// Replaces: the Pallas TPU kernel `rwkv6_wkv_kernel` in
//   src/repro/kernels/rwkv6_wkv/kernel.py (body _wkv_kernel), i.e. per head
//     y_t = r_t . (S + u (.) k_t v_t^T),   S <- diag(w_t) S + k_t v_t^T
//   returning y and the final S. w is taken as it comes, anywhere in
//   [0, 1]: w = 1 is how the model masks padded steps, and w =
//   exp(-exp(x)) is exactly 0 in f32 once x >~ 4.5.
//
// What bounds it on H100: at decode (T = 1) each (b, h) reads its 16 KB
//   state and writes it back, 2 * 8 * 64 * 16 KB = 16.8 MB per layer at 8
//   slots, ~5 us at 3.35 TB/s: bytes. A chunk of T steps does 4 T N^2
//   flops per (b, h) against 5 T N floats of r/k/v/w/y and the state: at
//   T = 128 (B = 8, H = 64, N = 64) 1.07 GFLOP against 100.7 MB, 16 us of
//   f32 SIMT work and 30 us of bytes. Walked one step after another (the
//   recurrence kernel) the steps run at ~12% of the f32 rate: each
//   thread's step is a 64-long dependent chain of FMAs fed by broadcast
//   loads, and one 2-warp block per (b, h) leaves most of an SM idle.
//
// What the design does about it:
//   - Decode and short chunks, T < 8: `wkv_kernel`, one block of N
//     threads per (b, h); thread j holds column j of S in registers, read
//     once from s0 and written once, and per step y_j = sum_i r_i S_ij +
//     (sum_i r_i u_i k_i) v_j and S_ij <- w_i S_ij + k_i v_j, with r/k/w/v
//     of kTB steps staged in shared memory. At T = 1 it is at its byte
//     bound. The crossover (CHUNK_MIN_T = 8 in kernels/rwkv6_wkv/ops.py),
//     measured at rwkv6-7b's shapes on one H100 80GB HBM3 at 700 W by
//     chip_smoke.py's crossover cases: at T = 4 the recurrence takes 8.0
//     us against the chunked kernel's 9.4, at T = 8 11.5 against 9.8.
//   - Chunks (N = 64): `wkv_chunk_kernel`, one block of 4 warps per
//     (b, h) walking sub-chunks of kSub = 16 steps and carrying the state
//     from one to the next. Within a sub-chunk that starts at state S,
//       y_t = (r_t * P_t) . S + sum_{s<t} A[t, s] v_s + (r_t . u * k_t) v_t
//       S'  = diag(P_16) S + sum_s (k_s * Q_s)^T v_s,
//     with P_t = prod_{tau<t} w_tau, Q_s = prod_{s<tau<16} w_tau and
//     A[t, s] = sum_i r_t,i k_s,i prod_{s<tau<t} w_tau,i. Every decay is
//     a forward product of w, each factor <= 1: nothing overflows, no log
//     of w is taken and no product of w is divided, so w = 0 and w = 1
//     are exact (the textbook chunked form scales k by 1 / prod w and
//     overflows on the decays a model makes). Carrying the state every
//     16 steps makes the earlier sub-chunks' share of y the first
//     product: the inter-chunk and cross-sub-chunk terms are one product.
//   - Tensor cores: the three products ((r * P) S, A V and (k * Q)^T V:
//     4 T N^2 + 2 T 16 N flops) run on mma.sync.m16n8k8 in 3xTF32, as in
//     csrc/flash_attention.cu: each operand x is split into big = x
//     rounded to TF32 and small = x - big rounded to TF32 (two integer ops
//     each), and each product is small.big + big.small + big.big with
//     f32 accumulation; the kernel is held to 1e-5 of the f32 result.
//     Warp w owns S^T rows j in [16 w, 16 w + 16) as mma accumulators for
//     the whole chunk (32 registers a thread), so every product of a warp
//     reads only shared operands and its own state: y^T = S^T (r * P)^T
//     (A operand: the state accumulators, k permuted within each k8 step
//     so that the accumulator layout is the A layout), + V^T A^T, then
//     S^T <- S^T diag(P_16) + V^T (k * Q). r * P and k * Q, which every
//     warp reads, are split into their TF32 pieces once, where the decay
//     products are made.
//   - f32 SIMT for the rest: the decay products (one thread per column i,
//     forward for r * P, backward for k * Q) and A (warp w takes s in
//     [4 w, 4 w + 4), a group of 8 lanes per s and 8 i per lane, running
//     products over t, one reduce-scatter over the group's lanes).
//   - Loads: r/k/w/v of the next sub-chunk arrive by 16-byte cp.async
//     into the second stage of a two-stage ring while the current one
//     computes; rows are unpadded and 16-byte aligned (v's 16-byte chunks
//     XOR-swizzled by the step, so that the A-operand loads fall in
//     distinct banks). y is staged in shared memory and written by
//     coalesced 16-byte stores. 56.6 KB of shared memory and at most 128
//     registers a thread: four blocks an SM, so the 512 blocks of
//     rwkv6-7b's 8 slots run in one wave on 132 SMs.
//   - Steps past T (a T that is not a multiple of 16) are zero-filled and
//     their w taken as 1: they change nothing. Ragged rows need no special
//     case: the model pads them with k = 0, w = 1. Fixed summation order,
//     no atomics: the same inputs give the same bits.
//   Where it stands (benchmarks/torch_wkv_phases.py, one H100 80GB HBM3
//   at 700 W): 54 us at T = 128 (B = 8, H = 64, N = 64), 1.8x the byte
//   bound. Its loads and stores alone take 35 us; the 3xTF32 products
//   add 15 us, A 13 and the decay products 7 on top of the rest: with 4
//   warps a block the compute hides the memory only in part. Not yet:
//   wgmma for the products, A balanced over the warps (warp 0 walks 16
//   steps, warp 3 four), a chunked kernel for N < 64.
//
// The backward: the gradient of (y, S_T) with respect to r, k, v, w, u and
//   s0, from dy and dS_T. The JAX package has no Pallas backward: it
//   autodiffs its wkv_scan (src/repro/models/rwkv.py), whose scan it
//   checkpoints every 64 steps. Per head and step, with S_t the state after
//   step t:
//     dr_t = S_{t-1} dy_t + u (.) k_t (v_t . dy_t)
//     dk_t = dS_t v_t + u (.) r_t (v_t . dy_t)
//     dv_t = dS_t^T k_t + (r_t . (u (.) k_t)) dy_t
//     dw_t[i] = sum_j dS_t[i, j] S_{t-1}[i, j]
//     du = sum over b and t of r_t (.) k_t (v_t . dy_t)
//     dS_{t-1} = diag(w_t) dS_t + r_t dy_t^T,  ds0 = dS_0.
// What bounds it: 12 N^2 f32 flops per (b, t, h) (the state recomputed,
//   then dr, dk, dv, dw and dS's step) against 9 floats per (b, t, h, i)
//   read or written: at the train microbatch (B 2, T 512, H 64, N 64) 3.2
//   GFLOP, 0.048 ms at 67 TFLOP/s, against 157 MB, 0.047 ms: operations,
//   just. In three TF32 pieces on the tensor cores the products need 0.018
//   ms: then the bytes bound it.
// What the design does about it. dw_t needs S_{t-1} while walking back,
//   and running the state back ((S_t - k v^T) / w) loses it for rwkv's
//   small decays: both kernels sweep the forward first and keep states.
//   - N = 64 (the train path): `wkv_bwd_chunk_kernel`, sub-chunks of kSub
//     = 16 steps as in the chunked forward. Inside one that starts at state
//     S, with dSe the gradient of the state after its last step, P_t, Q_s
//     and D(s, t) the forward products of w before t, after s and between
//     them, A the forward's, H = dY S^T, G = V dSe^T, dA = dY V^T (s < t),
//     vd_t = v_t . dy_t and c_i = sum_j S_ij dSe_ij:
//       dr_t = P_t H_t + sum_{s<t} dA[t, s] k_s D(s, t) + u k_t vd_t
//       dk_s = Q_s G_s + sum_{t>s} dA[t, s] r_t D(s, t) + u r_s vd_s
//       dv_s = (k_s Q_s)^T dSe + sum_{t>s} A[t, s] dy_t + a_s dy_s
//       dw_tau = c P_tau Q_tau + P_tau x_tau + Q_tau y_tau + z_tau
//       dS_in = diag(P_16) dSe + (r * P)^T dY,
//     x_tau = sum_{t>tau} D(tau, t) r_t H_t and y_tau = sum_{s<tau} D(s,
//     tau) k_s G_s (scans), z_tau = sum_{s<tau<t} D(s, tau) D(tau, t) k_s
//     r_t dA[t, s] = sum_s alpha_tau[s] beta_tau[s] (alpha forward, beta
//     backward in tau; beta_s[s] is dk_s's middle term). Every decay is a
//     forward product of w and each in dw leaves w_tau out: nothing is
//     divided, no log is taken, w = 0 and w = 1 stay exact.
//     One block of 16 warps per (b, h): a forward sweep on the tensor
//     cores keeps the state at the start of every sub-chunk in the
//     workspace (67 MB at the microbatch), then the sub-chunks are walked
//     from the last. Four groups of four warps each own 16 key rows i of S
//     and dS (rows evolve independently): dr, dk, dw and du are local to a
//     group, dv is a partial over its rows, the groups' partials summed in
//     group order through shared memory. Warp w of a group owns value
//     columns [16 w, 16 w + 16) of its rows as mma accumulators. The seven
//     products (H, G, dA, (k * Q) dSe, A^T dY, (r * P)^T dY and the
//     sweep's (k * Q)^T V) run on mma.sync.m16n8k8 in 3xTF32, as the
//     forward's; A, the decays and the per-row terms in f32: one thread
//     per (row, step), P, Q, x and y as prefix and suffix scans of affine
//     maps over a row's 16 lanes, z and dr's middle term reduce-scattered
//     over them. Two barriers a sub-chunk: the row pass of one sub-chunk
//     runs in the first phase of the next, beside its products and A.
//     r/k/w/v/dy arrive by cp.async in a two-stage ring. Fixed order
//     everywhere, no atomics: the same inputs give the same bits.
//     A cluster of four blocks, each a group, was tried first: 124
//     clusters of four fit on the card at four blocks an SM, so 128 (b, h)
//     ran in two waves (0.59 ms), and the cluster barriers and remote
//     reads cost 37 of the 248 us of one wave
//     (benchmarks/torch_wkv_bwd_phases.py).
//     Where it stands (one NVIDIA H100 80GB HBM3 at 700.00 W): 0.323 ms
//     at the microbatch (benchmarks/torch_wkv_bwd_phases.py) against the
//     recurrence's 0.646 (chip_smoke.py) and the bytes bound's 0.047, one
//     block an SM (125 registers, 205 KB of shared memory). Issue- and
//     latency-bound in lockstep phases, the same time with 8 blocks on
//     the card as with 128: of 323 us the per-row pass takes 77, the
//     products H, G and dA 68, A 42, the warps' sums 23 and dv's partial
//     18, on top of a skeleton of loads and stores that alone takes 107
//     (HBM: the inputs read twice and the kept states written and read).
//   - N in {8, 16, 32}, and `kernel="recurrent"`: `wkv_bwd_kernel<N>`, one
//     block per (b, h) keeps the state every kCk = 64 steps in the
//     workspace; then, chunk by chunk from the last, that chunk's state
//     every kSt = 8 steps too, and recomputes each 8-step piece's states
//     into shared memory, walking the piece back. Threads [0, N) own row i
//     of the state and of dS: every term but dv is row-local. Threads [N,
//     2N) own column j of dS and give dv_t[j], stepping dS back
//     themselves. f32 FMAs on the SIMT cores; du's per-row parts summed
//     over B by the wrapper, as for the chunked kernel.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTB = 32;  // time steps staged in shared memory at a time

// r/k/v/w (B, T, H, N) f32 with element strides (sb, st, sh, 1); u (H, N);
// s0 / s_final (B, H, N, N) contiguous; y (B, T, H, N) contiguous.
template <int N>
__global__ void __launch_bounds__(N)
wkv_kernel(const float* __restrict__ r, const float* __restrict__ k,
           const float* __restrict__ v, const float* __restrict__ w,
           const float* __restrict__ u, const float* __restrict__ s0,
           float* __restrict__ y, float* __restrict__ s_final, int T, int H,
           long long sb, long long st, long long sh) {
  // rows padded by one so that thread t reading row t (the a_t pass) hits
  // distinct banks
  __shared__ float rs[kTB][N + 1];
  __shared__ float ks[kTB][N + 1];
  __shared__ float ws[kTB][N + 1];
  __shared__ float vs[kTB][N];
  __shared__ float us[N];
  __shared__ float at[kTB];  // a_t of each staged step

  const int j = threadIdx.x;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const long long base = b * sb + h * sh;
  const size_t state = static_cast<size_t>(bh) * N * N;

  float S[N];
#pragma unroll
  for (int i = 0; i < N; ++i) S[i] = s0[state + static_cast<size_t>(i) * N + j];
  us[j] = u[h * N + j];

  for (int t0 = 0; t0 < T; t0 += kTB) {
    const int tb = min(kTB, T - t0);
    __syncthreads();  // the previous time block is no longer read
    for (int t = 0; t < tb; ++t) {
      const long long off = base + (t0 + t) * st + j;
      rs[t][j] = r[off];
      ks[t][j] = k[off];
      ws[t][j] = w[off];
      vs[t][j] = v[off];
    }
    __syncthreads();
    for (int t = j; t < tb; t += N) {
      float a = 0.f;
#pragma unroll 8
      for (int i = 0; i < N; ++i) a = fmaf(rs[t][i] * us[i], ks[t][i], a);
      at[t] = a;
    }
    __syncthreads();
    for (int t = 0; t < tb; ++t) {
      const float vj = vs[t][j];
      // four partial sums break the dependent FMA chain of the y reduction
      float y0 = 0.f, y1 = 0.f, y2 = 0.f, y3 = 0.f;
#pragma unroll
      for (int i = 0; i < N; i += 4) {
        y0 = fmaf(rs[t][i], S[i], y0);
        y1 = fmaf(rs[t][i + 1], S[i + 1], y1);
        y2 = fmaf(rs[t][i + 2], S[i + 2], y2);
        y3 = fmaf(rs[t][i + 3], S[i + 3], y3);
      }
#pragma unroll
      for (int i = 0; i < N; ++i) S[i] = fmaf(ws[t][i], S[i], ks[t][i] * vj);
      const size_t out = ((static_cast<size_t>(b) * T + t0 + t) * H + h) * N + j;
      y[out] = fmaf(at[t], vj, (y0 + y1) + (y2 + y3));
    }
  }
#pragma unroll
  for (int i = 0; i < N; ++i)
    s_final[state + static_cast<size_t>(i) * N + j] = S[i];
}

template <int N>
void launch(const float* r, const float* k, const float* v, const float* w,
            const float* u, const float* s0, float* y, float* s_final, int B,
            int T, int H, long long sb, long long st, long long sh,
            cudaStream_t stream) {
  wkv_kernel<N><<<B * H, N, 0, stream>>>(r, k, v, w, u, s0, y, s_final, T, H,
                                         sb, st, sh);
}

// ---------------------------------------------------------------------------
// the chunked kernel
// ---------------------------------------------------------------------------

constexpr int kSub = 16;      // steps of a sub-chunk
constexpr int kN = 64;        // the head dim it is written for
constexpr int kThreads = 128; // 4 warps, each 16 rows j of S^T
constexpr int kStage = 4 * kSub * kN;   // r, k, w, v of a sub-chunk, floats
constexpr int kLdR = 144;     // rows of r * P as TF32 pieces, floats
constexpr int kLdK = 136;     // rows of k * Q as TF32 pieces, floats
constexpr int kLdA = 20;      // rows of A
constexpr int kLdY = 68;      // rows of the staged y
// two stages, r * P and k * Q pieces, A, y, P_16
constexpr int kSmemFloats = 2 * kStage + kSub * (kLdR + kLdK + kLdA + kLdY) +
                            kN;
constexpr int kSmemBytes = kSmemFloats * 4;
static_assert(kSmemBytes * 4 + 4 * 1024 <= 233472,
              "four blocks fit in an SM's shared memory");

// x = big + small + O(2^-24 |x|), both TF32 (the low 13 bits zero), each
// rounded to nearest, ties away (as cvt.rna.tf32.f32, in two integer ops)
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = (__float_as_uint(x - __uint_as_float(big)) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a.b in 3xTF32, b given as pieces: small.big + big.small + big.big
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ab)[4],
                                     const uint32_t (&as)[4], uint32_t bb0,
                                     uint32_t bb1, uint32_t bs0,
                                     uint32_t bs1) {
  mma_tf32(d, as, bb0, bb1);
  mma_tf32(d, ab, bs0, bs1);
  mma_tf32(d, ab, bb0, bb1);
}

// the same with b in f32, split here
__device__ __forceinline__ void mma3f(float (&d)[4], const uint32_t (&ab)[4],
                                      const uint32_t (&as)[4], float b0,
                                      float b1) {
  uint32_t bb0, bs0, bb1, bs1;
  split_tf32(b0, bb0, bs0);
  split_tf32(b1, bb1, bs1);
  mma3(d, ab, as, bb0, bb1, bs0, bs1);
}

// One step of a reduce-scatter of part[0 .. 2 HALF) over the lane bit
// MASK: part[j] becomes the sum over the lane pair of entry j + HALF * bit.
template <int HALF, int MASK>
__device__ __forceinline__ void reduce_half(float (&part)[kSub], int lane) {
  const bool hi = lane & MASK;
#pragma unroll
  for (int j = 0; j < HALF; ++j) {
    const float send = hi ? part[j] : part[j + HALF];
    const float keep = hi ? part[j + HALF] : part[j];
    part[j] = keep + __shfl_xor_sync(0xffffffffu, send, MASK);
  }
}

// cp.async of `bytes` (0 or 16) from global, zero-filling the rest
__device__ __forceinline__ void cp_async16(void* s, const void* g, int bytes) {
  const uint32_t sa = static_cast<uint32_t>(__cvta_generic_to_shared(s));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(sa),
               "l"(g), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// v of step s, column j, in a stage: 16-byte chunks of a row XOR-swizzled
// by the step, so that the A-operand loads (rows s = q, q + 4, columns j =
// g, g + 8) fall in distinct banks
__device__ __forceinline__ int vcol(int s, int j) { return j ^ ((s & 3) << 3); }

// Grid B * H, kThreads threads, kSmemBytes of dynamic shared memory.
// Fragments of m16n8k8 (g = lane / 4, q = lane % 4): the accumulator holds
//   (row g, cols 2q, 2q+1) and (row g + 8, same cols); A holds (g, q),
//   (g + 8, q), (g, q + 4), (g + 8, q + 4); B holds (k q, n g), (k q + 4,
//   n g). Warp w's state sacc[nn] is S^T rows j = 16 w + g (+ 8), columns
//   i = 8 nn + 2q (+ 1).
__global__ void __launch_bounds__(kThreads, 4)
wkv_chunk_kernel(const float* __restrict__ r, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ w,
                 const float* __restrict__ u, const float* __restrict__ s0,
                 float* __restrict__ y, float* __restrict__ s_final, int T,
                 int H, long long sb, long long st, long long sh) {
  extern __shared__ __align__(16) float sm[];
  // r * P pieces: row t, float4 m = {big, big, small, small} of i = 2m, 2m+1
  float* rp_s = sm + 2 * kStage;
  // k * Q pieces: row s, float2 i = {big, small}
  float* kq_s = rp_s + kSub * kLdR;
  float* a_s = kq_s + kSub * kLdK;       // A         [kSub][kLdA]
  float* y_s = a_s + kSub * kLdA;        // y         [kSub][kLdY]
  float* p_s = y_s + kSub * kLdY;        // P_16      [kN]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const long long base = b * sb + h * sh;
  const size_t state = static_cast<size_t>(bh) * kN * kN;
  const int n_sub = (T + kSub - 1) / kSub;

  // r, k, w, v of sub-chunk c into stage c % 2: 4 x 16 rows of 16 chunks
  // of 16 bytes, eight copies a thread; steps past T are zero-filled
  auto issue = [&](int c) {
    float* dst0 = sm + (c & 1) * kStage;
#pragma unroll
    for (int n = 0; n < 4 * kSub * 16 / kThreads; ++n) {
      const int arr = n >> 1;                       // r, k, w, v
      const int t = ((n & 1) * kThreads + tid) >> 4, part = tid & 15;
      const int tg = c * kSub + t;
      const float* src = arr == 0 ? r : arr == 1 ? k : arr == 2 ? w : v;
      const bool ok = tg < T;
      float* dst = dst0 + (arr * kSub + t) * kN +
                   (arr == 3 ? vcol(t, part * 4) : part * 4);
      cp_async16(dst, src + (ok ? base + tg * st + part * 4 : 0),
                 ok ? 16 : 0);
    }
  };
  // y of sub-chunk c from the staging rows, 16 bytes a store
  auto store_y = [&](int c) {
#pragma unroll
    for (int n = 0; n < kSub * 16 / kThreads; ++n) {
      const int idx = tid + n * kThreads;
      const int t = idx >> 4, part = idx & 15;
      const int tg = c * kSub + t;
      if (tg < T)
        *reinterpret_cast<float4*>(
            y + ((static_cast<size_t>(b) * T + tg) * H + h) * kN + part * 4) =
            *reinterpret_cast<const float4*>(y_s + t * kLdY + part * 4);
    }
  };

  if (n_sub > 0) issue(0);
  cp_async_commit();

  float sacc[8][4];
#pragma unroll
  for (int nn = 0; nn < 8; ++nn)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      sacc[nn][e] = s0[state + static_cast<size_t>(8 * nn + 2 * q + (e & 1)) *
                                   kN + 16 * warp + g + 8 * (e >> 1)];
  // the A pass: lane c8 of group grp holds i = 4 c8 .. and 32 + 4 c8 ..
  const int grp = lane >> 3, c8 = lane & 7;
  const float4 u_lo = *reinterpret_cast<const float4*>(u + h * kN + 4 * c8);
  const float4 u_hi = *reinterpret_cast<const float4*>(u + h * kN + 32 +
                                                       4 * c8);

  for (int c = 0; c < n_sub; ++c) {
    cp_async_wait_all();
    // stage c has landed, and sub-chunk c - 1 is no longer read
    __syncthreads();
    if (c + 1 < n_sub) issue(c + 1);
    cp_async_commit();
    if (c > 0) store_y(c - 1);

    const float* rs = sm + (c & 1) * kStage;
    const float* ks = rs + kSub * kN;
    const float* ws = ks + kSub * kN;
    const float* vs = ws + kSub * kN;
    const int live = min(kSub, T - c * kSub);   // steps past it: w = 1

    // decay products as TF32 pieces: r * P forward (warps 0-1), k * Q
    // backward (2-3), one column i a thread
    if (tid < kN) {
      const int i = tid;
      float* dst = rp_s + 4 * (i >> 1) + (i & 1);
      float p = 1.f;
#pragma unroll
      for (int t = 0; t < kSub; ++t) {
        uint32_t big, small;
        split_tf32(rs[t * kN + i] * p, big, small);
        dst[t * kLdR] = __uint_as_float(big);
        dst[t * kLdR + 2] = __uint_as_float(small);
        p *= t < live ? ws[t * kN + i] : 1.f;
      }
      p_s[i] = p;
    } else {
      const int i = tid - kN;
      float p = 1.f;
#pragma unroll
      for (int t = kSub - 1; t >= 0; --t) {
        uint32_t big, small;
        split_tf32(ks[t * kN + i] * p, big, small);
        *reinterpret_cast<float2*>(kq_s + t * kLdK + 2 * i) =
            make_float2(__uint_as_float(big), __uint_as_float(small));
        p *= t < live ? ws[t * kN + i] : 1.f;
      }
    }

    // A[t, s]: warp w takes s in [4 w, 4 w + 4), one s a group of 8
    // lanes; lane c8 holds i = 4 c8 .. 4 c8 + 3 and 32 + 4 c8 .. ; kd =
    // k_s * prod_{s<tau<t} w_tau, zero up to t = s; the diagonal is r_s .
    // (u * k_s). Steps t < 4 w see no s of the warp and are skipped (a
    // warp-uniform branch).
    {
      const int s = 4 * warp + grp;
      const float* kr = ks + s * kN + 4 * c8;
      const float* rr = rs + s * kN + 4 * c8;
      const float4 k_lo = *reinterpret_cast<const float4*>(kr);
      const float4 k_hi = *reinterpret_cast<const float4*>(kr + 32);
      const float4 r_lo = *reinterpret_cast<const float4*>(rr);
      const float4 r_hi = *reinterpret_cast<const float4*>(rr + 32);
      const float kv[8] = {k_lo.x, k_lo.y, k_lo.z, k_lo.w,
                           k_hi.x, k_hi.y, k_hi.z, k_hi.w};
      const float diag =
          ((r_lo.x * u_lo.x * k_lo.x + r_lo.y * u_lo.y * k_lo.y) +
           (r_lo.z * u_lo.z * k_lo.z + r_lo.w * u_lo.w * k_lo.w)) +
          ((r_hi.x * u_hi.x * k_hi.x + r_hi.y * u_hi.y * k_hi.y) +
           (r_hi.z * u_hi.z * k_hi.z + r_hi.w * u_hi.w * k_hi.w));
      float kd[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) kd[e] = 0.f;
      float part[kSub];
#pragma unroll
      for (int t = 0; t < kSub; ++t) {
        part[t] = 0.f;
        if (t >= 4 * warp) {
          const float* rt = rs + t * kN + 4 * c8;
          const float* wt = ws + t * kN + 4 * c8;
          const float4 a0 = *reinterpret_cast<const float4*>(rt);
          const float4 a1 = *reinterpret_cast<const float4*>(rt + 32);
          const float4 w0 = *reinterpret_cast<const float4*>(wt);
          const float4 w1 = *reinterpret_cast<const float4*>(wt + 32);
          const float rv[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
          const float wv[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
          float d0 = 0.f, d1 = 0.f;
#pragma unroll
          for (int e = 0; e < 8; e += 2) {
            d0 = fmaf(rv[e], kd[e], d0);
            d1 = fmaf(rv[e + 1], kd[e + 1], d1);
          }
          part[t] = t == s ? diag : d0 + d1;
          if (t < 4 * warp + 4) {   // t <= s for some groups
#pragma unroll
            for (int e = 0; e < 8; ++e) kd[e] = t == s ? kv[e] : kd[e] * wv[e];
          } else {
#pragma unroll
            for (int e = 0; e < 8; ++e) kd[e] *= wv[e];
          }
        }
      }
      // reduce-scatter over the group's 8 lanes: lane c8 ends with the
      // sums for t = 8 b2 + 4 b1 + 2 b0 and the next (bits of c8)
      reduce_half<8, 4>(part, lane);
      reduce_half<4, 2>(part, lane);
      reduce_half<2, 1>(part, lane);
      const int t0 = ((c8 >> 2) & 1) * 8 + ((c8 >> 1) & 1) * 4 + (c8 & 1) * 2;
      a_s[t0 * kLdA + s] = part[0];         // 0 above the diagonal
      a_s[(t0 + 1) * kLdA + s] = part[1];
    }
    __syncthreads();

    // y^T = S^T (r * P)^T + V^T A^T for this warp's rows j, 16 steps t;
    // two accumulators per tile (even and odd k8 steps) halve the chain
    // of dependent mma
    float yacc[2][4], yodd[2][4];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) yacc[nt][e] = yodd[nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      // k = q is i = 8 kk + 2q, k = q + 4 is i = 8 kk + 2q + 1
      uint32_t ab[4], as[4];
      split_tf32(sacc[kk][0], ab[0], as[0]);
      split_tf32(sacc[kk][2], ab[1], as[1]);
      split_tf32(sacc[kk][1], ab[2], as[2]);
      split_tf32(sacc[kk][3], ab[3], as[3]);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const float4 x = *reinterpret_cast<const float4*>(
            rp_s + (8 * nt + g) * kLdR + 4 * (4 * kk + q));
        const uint32_t b0 = __float_as_uint(x.x), b1 = __float_as_uint(x.y);
        const uint32_t s0_ = __float_as_uint(x.z), s1_ = __float_as_uint(x.w);
        if (kk & 1)
          mma3(yodd[nt], ab, as, b0, b1, s0_, s1_);
        else
          mma3(yacc[nt], ab, as, b0, b1, s0_, s1_);
      }
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) yacc[nt][e] += yodd[nt][e];
    uint32_t vb[2][4], vsm[2][4];   // V^T: rows j, k = s
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      const int s_lo = 8 * kk + q, s_hi = s_lo + 4, j = 16 * warp + g;
      split_tf32(vs[s_lo * kN + vcol(s_lo, j)], vb[kk][0], vsm[kk][0]);
      split_tf32(vs[s_lo * kN + vcol(s_lo, j + 8)], vb[kk][1], vsm[kk][1]);
      split_tf32(vs[s_hi * kN + vcol(s_hi, j)], vb[kk][2], vsm[kk][2]);
      split_tf32(vs[s_hi * kN + vcol(s_hi, j + 8)], vb[kk][3], vsm[kk][3]);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const float* a0 = a_s + (8 * nt + g) * kLdA + 8 * kk + q;
        mma3f(yacc[nt], vb[kk], vsm[kk], a0[0], a0[4]);
      }
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        y_s[(8 * nt + 2 * q + (e & 1)) * kLdY + 16 * warp + g +
            8 * (e >> 1)] = yacc[nt][e];

    // S^T <- S^T diag(P_16) + V^T (k * Q)
#pragma unroll
    for (int nn = 0; nn < 8; ++nn) {
      const float2 p = *reinterpret_cast<const float2*>(p_s + 8 * nn + 2 * q);
      sacc[nn][0] *= p.x;
      sacc[nn][1] *= p.y;
      sacc[nn][2] *= p.x;
      sacc[nn][3] *= p.y;
    }
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
#pragma unroll
      for (int nn = 0; nn < 8; ++nn) {
        const float* k0 = kq_s + (8 * kk + q) * kLdK + 2 * (8 * nn + g);
        const float2 x0 = *reinterpret_cast<const float2*>(k0);
        const float2 x1 = *reinterpret_cast<const float2*>(k0 + 4 * kLdK);
        mma3(sacc[nn], vb[kk], vsm[kk], __float_as_uint(x0.x),
             __float_as_uint(x1.x), __float_as_uint(x0.y),
             __float_as_uint(x1.y));
      }
  }
  __syncthreads();   // the last sub-chunk's y is staged
  if (n_sub > 0) store_y(n_sub - 1);
#pragma unroll
  for (int nn = 0; nn < 8; ++nn)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      s_final[state + static_cast<size_t>(8 * nn + 2 * q + (e & 1)) * kN +
              16 * warp + g + 8 * (e >> 1)] = sacc[nn][e];
}

cudaError_t launch_chunk(const float* r, const float* k, const float* v,
                         const float* w, const float* u, const float* s0,
                         float* y, float* s_final, int B, int T, int H,
                         long long sb, long long st, long long sh,
                         cudaStream_t stream) {
  // the shared memory a block takes, and the largest carveout, so that
  // four blocks fit an SM (the default carveout may hold fewer)
  static bool configured = false;  // once per process
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        wkv_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmemBytes);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          wkv_chunk_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
          cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  wkv_chunk_kernel<<<B * H, kThreads, kSmemBytes, stream>>>(
      r, k, v, w, u, s0, y, s_final, T, H, sb, st, sh);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// the backward kernel
// ---------------------------------------------------------------------------

constexpr int kCk = 64;            // steps between the sweep's checkpoints
constexpr int kSt = 8;             // steps whose states sit in shared memory
constexpr int kSubs = kCk / kSt;   // kSt-step boundaries of one chunk

template <int N>
constexpr int bwd_smem_bytes() {
  // the states of kSt steps, r/k/v/w/dy of kSt steps, two scalars a step, u
  return (kSt * N * N + 5 * kSt * N + 2 * kSt + N) * 4;
}

// Row i of a state, S[j] = src[j * N + i] (states lie (j, i) in the
// workspace, so that the row threads' accesses are coalesced).
template <int N>
__device__ __forceinline__ void load_row(float (&S)[N], const float* src,
                                         int i) {
#pragma unroll
  for (int j = 0; j < N; ++j) S[j] = src[j * N + i];
}
template <int N>
__device__ __forceinline__ void store_row(float* dst, const float (&S)[N],
                                          int i) {
#pragma unroll
  for (int j = 0; j < N; ++j) dst[j * N + i] = S[j];
}
// S <- diag(w_l) S + k_l v_l^T on row i, for staged step l
template <int N>
__device__ __forceinline__ void advance_row(float (&S)[N], const float* ks,
                                            const float* vs, const float* ws,
                                            int l, int i) {
  const float wt = ws[l * N + i], kt = ks[l * N + i];
#pragma unroll
  for (int j = 0; j < N; ++j) S[j] = fmaf(wt, S[j], kt * vs[l * N + j]);
}

// Grid B * H, 2 N threads, bwd_smem_bytes<N>() of dynamic shared memory.
// r/k/v/w (B, T, H, N) f32 with element strides (sb, st, sh, 1); u (H, N);
// s0, ds (B, H, N, N) contiguous (ds may be null: zero); dy and the four
// gradients (B, T, H, N) contiguous; du_rows (B, H, N): each row's part of
// du; ds0 (B, H, N, N). ws: (ceil(T / kCk) + kSubs) N^2 floats per block.
// Threads [0, N) take row i of the state and of its gradient: S_{t-1}[i, :]
// and dS_t[i, :] give dr_t[i], dk_t[i], dw_t[i] and du's part, and the
// state's advance and dS's step back are row-local. Threads [N, 2N) take
// column j of dS and give dv_t[j] = sum_i dS_t[i, j] k_t[i] + a_t dy_t[j]
// (the one sum across rows), stepping dS back themselves.
template <int N>
__global__ void __launch_bounds__(2 * N)
wkv_bwd_kernel(const float* __restrict__ r, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ w,
               const float* __restrict__ u, const float* __restrict__ s0,
               const float* __restrict__ dy, const float* __restrict__ ds,
               float* __restrict__ dr, float* __restrict__ dk,
               float* __restrict__ dv, float* __restrict__ dw,
               float* __restrict__ du_rows, float* __restrict__ ds0,
               float* __restrict__ ws, int T, int H, long long sb,
               long long st, long long sh) {
  extern __shared__ __align__(16) float smem[];
  float* hist = smem;                 // S_{t0 + l}: [kSt][N (j)][N (i)]
  float* in_r = hist + kSt * N * N;   // r, k, v, w, dy of the staged steps
  float* in_k = in_r + kSt * N;
  float* in_v = in_k + kSt * N;
  float* in_w = in_v + kSt * N;
  float* in_dy = in_w + kSt * N;
  float* a_s = in_dy + kSt * N;       // r_t . (u * k_t)
  float* vd_s = a_s + kSt;            // v_t . dy_t
  float* u_s = vd_s + kSt;

  const int tid = threadIdx.x;
  const bool row = tid < N;
  const int i = row ? tid : tid - N;  // the row i, or the column j
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const long long base = b * sb + h * sh;
  const size_t state = static_cast<size_t>(bh) * N * N;
  const int nc = (T + kCk - 1) / kCk;
  float* ws1 = ws + static_cast<size_t>(bh) * (nc + kSubs) * N * N;
  float* ws2 = ws1 + static_cast<size_t>(nc) * N * N;

  // k, v, w (and with `all` r and dy) of steps [t0, t0 + n) into shared
  // memory, coalesced along the head dim
  auto stage = [&](int t0, int n, bool all) {
    for (int idx = tid; idx < n * N; idx += 2 * N) {
      const int t = idx / N, c = idx % N;
      const long long off = base + (t0 + t) * st + c;
      in_k[idx] = k[off];
      in_v[idx] = v[off];
      in_w[idx] = w[off];
      if (all) {
        in_r[idx] = r[off];
        in_dy[idx] = dy[((static_cast<size_t>(b) * T + t0 + t) * H + h) * N +
                        c];
      }
    }
  };

  if (tid < N) u_s[tid] = u[h * N + tid];
  float S[N];
  if (row) {
#pragma unroll
    for (int j = 0; j < N; ++j)
      S[j] = s0[state + static_cast<size_t>(i) * N + j];
  }
  // 1. the forward sweep: the state at every kCk-step boundary up to the
  // last chunk's first step into ws1
  const int t_last = (nc - 1) * kCk;
  for (int t0 = 0; t0 <= t_last; t0 += kSt) {
    if (row && t0 % kCk == 0)
      store_row<N>(ws1 + static_cast<size_t>(t0 / kCk) * N * N, S, i);
    if (t0 == t_last) break;
    __syncthreads();
    stage(t0, kSt, false);
    __syncthreads();
    if (row)
      for (int l = 0; l < kSt; ++l) advance_row<N>(S, in_k, in_v, in_w, l, i);
  }

  // 2. the chunks from the last: their kSt-step boundaries into ws2, then
  // their kSt-step pieces from the last, each piece's states recomputed
  // into hist and walked back
  float dS[N];
#pragma unroll
  for (int j = 0; j < N; ++j)
    dS[j] = ds == nullptr ? 0.f
            : ds[state + (row ? static_cast<size_t>(i) * N + j
                              : static_cast<size_t>(j) * N + i)];
  float du = 0.f;
  for (int c = nc - 1; c >= 0; --c) {
    const int c0 = c * kCk, c1 = min(T, c0 + kCk);
    const int nsub = (c1 - c0 + kSt - 1) / kSt;
    if (row) load_row<N>(S, ws1 + static_cast<size_t>(c) * N * N, i);
    for (int sc = 0; sc < nsub; ++sc) {
      if (row) store_row<N>(ws2 + static_cast<size_t>(sc) * N * N, S, i);
      if (sc == nsub - 1) break;
      __syncthreads();
      stage(c0 + sc * kSt, kSt, false);
      __syncthreads();
      if (row)
        for (int l = 0; l < kSt; ++l)
          advance_row<N>(S, in_k, in_v, in_w, l, i);
    }
    for (int sc = nsub - 1; sc >= 0; --sc) {
      const int t0 = c0 + sc * kSt, n = min(kSt, c1 - t0);
      __syncthreads();   // the previous piece's inputs are no longer read
      stage(t0, n, true);
      __syncthreads();
      if (tid < n) {
        float a = 0.f;
        for (int c2 = 0; c2 < N; ++c2)
          a = fmaf(in_r[tid * N + c2] * u_s[c2], in_k[tid * N + c2], a);
        a_s[tid] = a;
      } else if (tid >= kSt && tid < kSt + n) {
        const int l = tid - kSt;
        float a = 0.f;
        for (int c2 = 0; c2 < N; ++c2)
          a = fmaf(in_v[l * N + c2], in_dy[l * N + c2], a);
        vd_s[l] = a;
      }
      if (row) {
        load_row<N>(S, ws2 + static_cast<size_t>(sc) * N * N, i);
        for (int l = 0; l < n; ++l) {
#pragma unroll
          for (int j = 0; j < N; ++j) hist[(l * N + j) * N + i] = S[j];
          if (l + 1 < n) advance_row<N>(S, in_k, in_v, in_w, l, i);
        }
      }
      __syncthreads();
      if (row) {
        const float ui = u_s[i];
        for (int l = n - 1; l >= 0; --l) {
          const float rt = in_r[l * N + i], kt = in_k[l * N + i];
          const float wt = in_w[l * N + i], vdy = vd_s[l];
          const float* sp = hist + l * N * N + i;
          float ar0 = 0.f, ar1 = 0.f, ak0 = 0.f, ak1 = 0.f, aw0 = 0.f,
                aw1 = 0.f;
#pragma unroll
          for (int j = 0; j < N; j += 2) {
            const float s_a = sp[j * N], s_b = sp[(j + 1) * N];
            const float dy_a = in_dy[l * N + j], dy_b = in_dy[l * N + j + 1];
            ar0 = fmaf(s_a, dy_a, ar0);
            ar1 = fmaf(s_b, dy_b, ar1);
            ak0 = fmaf(dS[j], in_v[l * N + j], ak0);
            ak1 = fmaf(dS[j + 1], in_v[l * N + j + 1], ak1);
            aw0 = fmaf(dS[j], s_a, aw0);
            aw1 = fmaf(dS[j + 1], s_b, aw1);
            dS[j] = fmaf(wt, dS[j], rt * dy_a);
            dS[j + 1] = fmaf(wt, dS[j + 1], rt * dy_b);
          }
          const size_t out =
              ((static_cast<size_t>(b) * T + t0 + l) * H + h) * N + i;
          dr[out] = fmaf(ui * kt, vdy, ar0 + ar1);
          dk[out] = fmaf(ui * rt, vdy, ak0 + ak1);
          dw[out] = aw0 + aw1;
          du = fmaf(rt * kt, vdy, du);
        }
      } else {
        for (int l = n - 1; l >= 0; --l) {
          const float dyj = in_dy[l * N + i];
          float a0 = 0.f, a1 = 0.f;
#pragma unroll
          for (int c2 = 0; c2 < N; c2 += 2) {
            a0 = fmaf(dS[c2], in_k[l * N + c2], a0);
            a1 = fmaf(dS[c2 + 1], in_k[l * N + c2 + 1], a1);
            dS[c2] = fmaf(in_w[l * N + c2], dS[c2], in_r[l * N + c2] * dyj);
            dS[c2 + 1] = fmaf(in_w[l * N + c2 + 1], dS[c2 + 1],
                              in_r[l * N + c2 + 1] * dyj);
          }
          dv[((static_cast<size_t>(b) * T + t0 + l) * H + h) * N + i] =
              fmaf(a_s[l], dyj, a0 + a1);
        }
      }
    }
  }
  if (row) {
    du_rows[static_cast<size_t>(bh) * N + i] = du;
  } else {
#pragma unroll
    for (int c2 = 0; c2 < N; ++c2)
      ds0[state + static_cast<size_t>(c2) * N + i] = dS[c2];
  }
}

template <int N>
cudaError_t launch_bwd(const float* r, const float* k, const float* v,
                       const float* w, const float* u, const float* s0,
                       const float* dy, const float* ds, float* dr,
                       float* dk, float* dv, float* dw, float* du_rows,
                       float* ds0, float* ws, int B, int T, int H,
                       long long sb, long long st, long long sh,
                       cudaStream_t stream) {
  static bool configured = false;  // once per process and head dim
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        wkv_bwd_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bwd_smem_bytes<N>());
    if (err != cudaSuccess) return err;
    configured = true;
  }
  wkv_bwd_kernel<N><<<B * H, 2 * N, bwd_smem_bytes<N>(), stream>>>(
      r, k, v, w, u, s0, dy, ds, dr, dk, dv, dw, du_rows, ds0, ws, T, H, sb,
      st, sh);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// the chunked backward kernel
// ---------------------------------------------------------------------------

constexpr int kG = 4;                  // row groups of a block
constexpr int kRows = kN / kG;         // key rows i of a group
constexpr int kBThreads = kG * kThreads;   // a group of 4 warps each
constexpr int kLdV = 72;               // rows of the staged v and dy, floats
constexpr int kLdP = 24;               // rows of r * P, k * Q and A
constexpr int kLdS = 17;               // rows of the partials and sums
constexpr int kLdT = 20;               // rows of the row pass's operands
constexpr int kRkw = kSub * kN;        // r, k or w of a stage, floats
constexpr int kBStage = 3 * kRkw + 2 * kSub * kLdV;
// a group's own buffers, from its base
constexpr int kGRp = 0;                          // r * P        [t][i]
constexpr int kGKq = kGRp + kSub * kLdP;         // k * Q        [s][i]
constexpr int kGA = kGKq + kSub * kLdP;          // A's partial  [t][s]
constexpr int kGPl = kGA + kSub * kLdP;          // P_16         [i]
constexpr int kGDse = kGPl + kRows;             // dSe [i][j], dv's operand
constexpr int kGRed = kGDse + kRows * kLdV;      // warps' H, G, dA [3][4]
constexpr int kGSum = kGRed + 12 * kSub * kLdS;  // H [t][i], G [s][i]
// r, k, w [i][t] of two sub-chunks (by parity), dA [s][t]
constexpr int kGT = kGSum + 2 * kSub * kLdS;
constexpr int kGVd = kGT + 7 * kSub * kLdT;      // v_t . dy_t
constexpr int kGC = kGVd + kSub;                 // c [i]
constexpr int kGCp = kGC + kRows;                // warps' c [4][i]
constexpr int kGOut = kGCp + 4 * kRows;          // dr, dk, dw [3][s][i]
constexpr int kGDvx = kGOut + 3 * kSub * kLdS;   // dv's partial [s][j]
constexpr int kGroupFloats = kGDvx + kSub * kLdV;
constexpr int kBSmemBytes = (2 * kBStage + kG * kGroupFloats) * 4;
constexpr int kStateSlot = kN * kN;    // floats of a block's state
static_assert(kBSmemBytes <= 232448, "a block's shared memory");
static_assert(kStateSlot == 8 * kBThreads, "eight state floats a thread");
static_assert(kGroupFloats % 4 == 0 && kGDse % 4 == 0 && kGDvx % 4 == 0 &&
                  kGT % 4 == 0,
              "16-byte aligned buffers");

__device__ __forceinline__ void split4(const float (&x)[4], uint32_t (&big)[4],
                                       uint32_t (&small)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) split_tf32(x[e], big[e], small[e]);
}

// Grid B * H, kBThreads threads, kBSmemBytes of dynamic shared memory.
// Arguments as wkv_bwd_kernel's; r/k/v/w/u/dy 16-byte aligned, ws:
// ceil(T / kSub) N^2 floats per (b, h).
// Group `grp` (warps 4 grp .. 4 grp + 3) owns the key rows i in [16 grp,
// 16 grp + 16) of S and dS: rows evolve independently, so dr, dk, dw and
// du are local to it, and dv is a partial over its rows, the groups'
// partials summed in group order. Warp gw of a group owns the value
// columns j in [16 gw, 16 gw + 16) of those rows as m16n8k8 accumulators,
// S in sacc and dS in dacc: acc[nt][e] is row i = g + 8 (e >> 1) (of the
// group's), column j = 16 gw + 8 nt + 2q + (e & 1).
__global__ void __launch_bounds__(kBThreads, 1)
wkv_bwd_chunk_kernel(const float* __restrict__ r, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ w,
                     const float* __restrict__ u, const float* __restrict__ s0,
                     const float* __restrict__ dy,
                     const float* __restrict__ ds, float* __restrict__ dr,
                     float* __restrict__ dk, float* __restrict__ dv,
                     float* __restrict__ dw, float* __restrict__ du_rows,
                     float* __restrict__ ds0, float* __restrict__ ws, int T,
                     int H, long long sb, long long st, long long sh) {
  extern __shared__ __align__(16) float sm[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int grp = warp >> 2, gw = warp & 3, gt = tid & (kThreads - 1);
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int i0 = grp * kRows, j0 = 16 * gw;
  const long long base = b * sb + h * sh;
  const size_t state = static_cast<size_t>(bh) * kN * kN;
  const int n_sub = (T + kSub - 1) / kSub;

  float* gb = sm + 2 * kBStage + grp * kGroupFloats;   // the group's own
  float* rp_s = gb + kGRp;
  float* kq_s = gb + kGKq;
  float* a_s = gb + kGA;
  float* pl_s = gb + kGPl;
  float* dse_s = gb + kGDse;
  float* out_s = gb + kGOut;
  float* red_s = gb + kGRed;
  float* hs_s = gb + kGSum;                      // H   [t][i]
  float* gs_s = hs_s + kSub * kLdS;              // G   [s][i]
  // the row pass's operands, 16-byte rows: r, k, w [i][t] of sub-chunk c
  // at rkw_s(c), and dA [s][t] (0 for s >= t)
  auto rkw_s = [&](int c) { return gb + kGT + (c & 1) * 3 * kSub * kLdT; };
  float* dat_s = gb + kGT + 6 * kSub * kLdT;
  float* vd_s = gb + kGVd;
  float* c_s = gb + kGC;
  float* cp_s = gb + kGCp;
  float* dvx_s = gb + kGDvx;
  // the block's state at the start of each sub-chunk, in thread order
  float* wsb = ws + static_cast<size_t>(bh) * n_sub * kStateSlot + tid * 8;

  // r (with `all`), k, w and v (with `all`, dy too) of sub-chunk c into
  // stage c % 2, 16 bytes a copy; steps past T get w = 1 and zeros, stored
  // directly (the stage is not being read)
  auto issue = [&](int c, bool all) {
    float* dst0 = sm + (c & 1) * kBStage;
    for (int idx = tid; idx < 3 * kSub * 16; idx += kBThreads) {
      const int arr = idx >> 8, t = (idx >> 4) & 15, part = idx & 15;
      if (arr == 0 && !all) continue;
      const int tg = c * kSub + t;
      float* d = dst0 + arr * kRkw + t * kN + part * 4;
      if (tg < T) {
        const float* src = arr == 0 ? r : arr == 1 ? k : w;
        cp_async16(d, src + base + tg * st + part * 4, 16);
      } else {
        const float f = arr == 2 ? 1.f : 0.f;
        *reinterpret_cast<float4*>(d) = make_float4(f, f, f, f);
      }
    }
    for (int idx = tid; idx < (all ? 2 : 1) * kSub * 16; idx += kBThreads) {
      const int arr = idx >> 8, t = (idx >> 4) & 15, part = idx & 15;
      const int tg = c * kSub + t;
      float* d = dst0 + 3 * kRkw + (arr * kSub + t) * kLdV + part * 4;
      if (tg < T) {
        const float* src =
            arr == 0 ? v + base + tg * st + part * 4
                     : dy + ((static_cast<size_t>(b) * T + tg) * H + h) * kN +
                           part * 4;
        cp_async16(d, src, 16);
      } else {
        *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
  };
  // dv of sub-chunk c: the groups' partials summed in group order
  auto store_dv = [&](int c) {
    const int s = tid >> 5, jj = 2 * (tid & 31);
    const float* src = sm + 2 * kBStage + kGDvx + s * kLdV + jj;
    float2 x = *reinterpret_cast<const float2*>(src);
#pragma unroll
    for (int gg = 1; gg < kG; ++gg) {
      const float2 y =
          *reinterpret_cast<const float2*>(src + gg * kGroupFloats);
      x.x += y.x;
      x.y += y.y;
    }
    const int tg = c * kSub + s;
    if (tg < T)
      *reinterpret_cast<float2*>(
          dv + ((static_cast<size_t>(b) * T + tg) * H + h) * kN + jj) = x;
  };
  // dr, dk, dw of the group's rows of sub-chunk c from its staging rows,
  // 16 bytes a store
  auto store_out = [&](int c) {
    for (int idx = gt; idx < 3 * kSub * 4; idx += kThreads) {
      const int a = idx >> 6, s = (idx >> 2) & 15, part = idx & 3;
      const int tg = c * kSub + s;
      if (tg >= T) continue;
      const float* src = out_s + (a * kSub + s) * kLdS + 4 * part;
      float* dst = (a == 0 ? dr : a == 1 ? dk : dw) +
                   ((static_cast<size_t>(b) * T + tg) * H + h) * kN + i0 +
                   4 * part;
      *reinterpret_cast<float4*>(dst) =
          make_float4(src[0], src[1], src[2], src[3]);
    }
  };

  float sacc[2][4], dacc[2][4];
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const size_t at = state + static_cast<size_t>(i0 + g + 8 * (e >> 1)) *
                                    kN + j0 + 8 * nt + 2 * q + (e & 1);
      sacc[nt][e] = s0[at];
      dacc[nt][e] = ds == nullptr ? 0.f : ds[at];
    }

  // 1. the forward sweep: S <- diag(P_16) S + (k * Q)^T V on the tensor
  // cores, the state at the start of every sub-chunk kept in ws
  if (n_sub > 0) issue(0, n_sub == 1);
  cp_async_commit();
  for (int c = 0; c < n_sub; ++c) {
    float4* keep = reinterpret_cast<float4*>(
        wsb + static_cast<size_t>(c) * kStateSlot);
    keep[0] = make_float4(sacc[0][0], sacc[0][1], sacc[0][2], sacc[0][3]);
    keep[1] = make_float4(sacc[1][0], sacc[1][1], sacc[1][2], sacc[1][3]);
    if (c == n_sub - 1) break;
    cp_async_wait_all();
    __syncthreads();   // stage c has landed, kq_s and pl_s are free
    issue(c + 1, c + 2 == n_sub);   // the last one is the walk's first
    cp_async_commit();
    const float* stg = sm + (c & 1) * kBStage;
    const float* ks = stg + kRkw;
    const float* wsm = stg + 2 * kRkw;
    const float* vs = stg + 3 * kRkw;
    if (gt < kRows) {
      float p = 1.f;
#pragma unroll
      for (int t = kSub - 1; t >= 0; --t) {
        kq_s[t * kLdP + gt] = ks[t * kN + i0 + gt] * p;
        p *= wsm[t * kN + i0 + gt];
      }
      pl_s[gt] = p;
    }
    __syncthreads();
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) sacc[nt][e] *= pl_s[g + 8 * (e >> 1)];
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      const int s_lo = 8 * kk + q;
      const float a[4] = {kq_s[s_lo * kLdP + g], kq_s[s_lo * kLdP + g + 8],
                          kq_s[(s_lo + 4) * kLdP + g],
                          kq_s[(s_lo + 4) * kLdP + g + 8]};
      uint32_t ab[4], as[4];
      split4(a, ab, as);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int j = j0 + 8 * nt + g;
        mma3f(sacc[nt], ab, as, vs[s_lo * kLdV + j], vs[(s_lo + 4) * kLdV + j]);
      }
    }
  }

  // 2. the sub-chunks from the last
  float snext[8];   // the next sub-chunk's state, loaded one ahead
  // the A pass's u of rows 2 pr, 2 pr + 1 (pr = gt % 8)
  const float2 u2 = *reinterpret_cast<const float2*>(u + h * kN + i0 +
                                                     2 * (gt & 7));
  const int il = gt >> 4, sl = gt & 15;   // the row pass: rows il, il + 8
  const float u_row[2] = {u[h * kN + i0 + il], u[h * kN + i0 + il + 8]};
  float du_acc[2] = {0.f, 0.f};
  // 2f, the row pass of sub-chunk c: dr, dk, dw and du of rows il and
  // il + 8, lane sl of a row's 16 its step. It runs in the first phase of
  // sub-chunk c - 1, beside that one's products, with no barrier between
  // them (r, k, w rows are kept by parity for it).
  auto rows = [&](int c) {
    const float* rt_s = rkw_s(c);
    const float* kt_s = rt_s + kSub * kLdT;
    const float* wt_s = kt_s + kSub * kLdT;
    // P, y and Q, x from a prefix and a suffix scan of affine maps over
    // the row's lanes; beta_tau[sl] backward and alpha_tau[sl] forward
    // (the row's w and dA's row sl in registers), then z and dr's middle
    // term summed over the row's lanes (a reduce-scatter: lane sl ends
    // with step sl)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int i = il + 8 * hh;
      const float w1 = wt_s[i * kLdT + sl], r1 = rt_s[i * kLdT + sl];
      const float k1 = kt_s[i * kLdT + sl];
      const float h1 = hs_s[sl * kLdS + i], g1 = gs_s[sl * kLdS + i];
      // steps sl .. 15 of x -> w_t x + r_t H_t composed (the suffix), and
      // steps 0 .. sl of y -> w_t y + k_t G_t (the prefix)
      float qa = w1, xb = r1 * h1, pa = w1, yb1 = k1 * g1;
#pragma unroll
      for (int d = 1; d < kSub; d <<= 1) {
        const float qa2 = __shfl_down_sync(0xffffffffu, qa, d, kSub);
        const float xb2 = __shfl_down_sync(0xffffffffu, xb, d, kSub);
        const float pa2 = __shfl_up_sync(0xffffffffu, pa, d, kSub);
        const float yb2 = __shfl_up_sync(0xffffffffu, yb1, d, kSub);
        if (sl + d < kSub) {
          xb = fmaf(qa, xb2, xb);
          qa *= qa2;
        }
        if (sl >= d) {
          yb1 = fmaf(pa, yb2, yb1);
          pa *= pa2;
        }
      }
      // without step sl's own map: Q_sl, x_sl from lane sl + 1, P_sl, y_sl
      // from lane sl - 1
      float q_s = __shfl_down_sync(0xffffffffu, qa, 1, kSub);
      float x_s = __shfl_down_sync(0xffffffffu, xb, 1, kSub);
      float p_s = __shfl_up_sync(0xffffffffu, pa, 1, kSub);
      float y_s = __shfl_up_sync(0xffffffffu, yb1, 1, kSub);
      if (sl == kSub - 1) {
        q_s = 1.f;
        x_s = 0.f;
      }
      if (sl == 0) {
        p_s = 1.f;
        y_s = 0.f;
      }
      float wv[kSub], dav[kSub];
#pragma unroll
      for (int c4 = 0; c4 < kSub / 4; ++c4) {
        const float4 x = *reinterpret_cast<const float4*>(wt_s + i * kLdT +
                                                          4 * c4);
        const float4 y = *reinterpret_cast<const float4*>(dat_s + sl * kLdT +
                                                          4 * c4);
        wv[4 * c4] = x.x; wv[4 * c4 + 1] = x.y;
        wv[4 * c4 + 2] = x.z; wv[4 * c4 + 3] = x.w;
        dav[4 * c4] = y.x; dav[4 * c4 + 1] = y.y;
        dav[4 * c4 + 2] = y.z; dav[4 * c4 + 3] = y.w;
      }
      float beta[kSub];
      float bt = 0.f, dk_mid = 0.f;
#pragma unroll
      for (int c4 = kSub / 4 - 1; c4 >= 0; --c4) {
        const float4 x = *reinterpret_cast<const float4*>(rt_s + i * kLdT +
                                                          4 * c4);
        const float rv[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
        for (int e = 3; e >= 0; --e) {
          const int t = 4 * c4 + e;
          beta[t] = bt;
          if (t == sl) dk_mid = bt;
          bt = fmaf(wv[t], bt, rv[e] * dav[t]);
        }
      }
      float zc[kSub], drc[kSub];
      float al = 0.f;
#pragma unroll
      for (int c4 = 0; c4 < kSub / 4; ++c4) {
        const float4 x = *reinterpret_cast<const float4*>(kt_s + i * kLdT +
                                                          4 * c4);
        const float kv[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int t = 4 * c4 + e;
          zc[t] = al * beta[t];
          drc[t] = al * dav[t];
          al = t == sl ? kv[e] : al * wv[t];
        }
      }
      reduce_half<8, 8>(zc, lane);
      reduce_half<8, 8>(drc, lane);
      reduce_half<4, 4>(zc, lane);
      reduce_half<4, 4>(drc, lane);
      reduce_half<2, 2>(zc, lane);
      reduce_half<2, 2>(drc, lane);
      reduce_half<1, 1>(zc, lane);
      reduce_half<1, 1>(drc, lane);
      const float vd1 = vd_s[sl], ui = u_row[hh];
      out_s[sl * kLdS + i] = fmaf(ui * k1, vd1, p_s * h1 + drc[0]);
      out_s[(kSub + sl) * kLdS + i] = fmaf(ui * r1, vd1, q_s * g1 + dk_mid);
      out_s[(2 * kSub + sl) * kLdS + i] =
          ((c_s[i] * p_s) * q_s + p_s * x_s) + (q_s * y_s + zc[0]);
      du_acc[hh] = fmaf(r1 * k1, vd1, du_acc[hh]);
    }
  };
  for (int c = n_sub - 1; c >= 0; --c) {
    cp_async_wait_all();
    // stage c has landed, and sub-chunk c + 1 is no longer read
    __syncthreads();
    if (c > 0) issue(c - 1, true);
    cp_async_commit();
    if (c + 1 < n_sub) {
      store_dv(c + 1);
#pragma unroll
      for (int e = 0; e < 8; ++e) sacc[e >> 2][e & 3] = snext[e];
    }
    if (c > 0) {
      const float4* src = reinterpret_cast<const float4*>(
          wsb + static_cast<size_t>(c - 1) * kStateSlot);
      const float4 x0 = src[0], x1 = src[1];
      snext[0] = x0.x; snext[1] = x0.y; snext[2] = x0.z; snext[3] = x0.w;
      snext[4] = x1.x; snext[5] = x1.y; snext[6] = x1.z; snext[7] = x1.w;
    }
    const float* rs = sm + (c & 1) * kBStage;
    const float* ks = rs + kRkw;
    const float* wsm = ks + kRkw;
    const float* vs = wsm + kRkw;
    const float* dys = vs + kSub * kLdV;
    float* rt_s = rkw_s(c);
    float* kt_s = rt_s + kSub * kLdT;
    float* wt_s = kt_s + kSub * kLdT;
    if (c + 1 < n_sub) rows(c + 1);

    // 2a. H = dY S^T, G = V dSe^T and dA = dY V^T over this warp's columns
    // j (k permuted within each k8 step: slot q is j = 8 kk + 2q, slot q +
    // 4 is j + 1, so that the accumulators are the B operand), and c
    {
      float hacc[2][4], gacc[2][4], aacc[2][4];
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) hacc[n][e] = gacc[n][e] = aacc[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const int jj = j0 + 8 * kk + 2 * q;
        const float2 y0 = *reinterpret_cast<const float2*>(dys + g * kLdV + jj);
        const float2 y1 =
            *reinterpret_cast<const float2*>(dys + (g + 8) * kLdV + jj);
        const float2 v0 = *reinterpret_cast<const float2*>(vs + g * kLdV + jj);
        const float2 v1 =
            *reinterpret_cast<const float2*>(vs + (g + 8) * kLdV + jj);
        const float ya[4] = {y0.x, y1.x, y0.y, y1.y};
        const float va[4] = {v0.x, v1.x, v0.y, v1.y};
        uint32_t yb[4], ysm[4], vb[4], vsm[4];
        split4(ya, yb, ysm);
        split4(va, vb, vsm);
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          mma3f(hacc[n], yb, ysm, sacc[kk][2 * n], sacc[kk][2 * n + 1]);
          mma3f(gacc[n], vb, vsm, dacc[kk][2 * n], dacc[kk][2 * n + 1]);
          const float2 vt =
              *reinterpret_cast<const float2*>(vs + (8 * n + g) * kLdV + jj);
          mma3f(aacc[n], yb, ysm, vt.x, vt.y);
        }
      }
      float* red = red_s + gw * kSub * kLdS;
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int at = (g + 8 * (e >> 1)) * kLdS + 8 * n + 2 * q + (e & 1);
          red[at] = hacc[n][e];
          red[4 * kSub * kLdS + at] = gacc[n][e];
          red[8 * kSub * kLdS + at] = aacc[n][e];
        }
      float c_lo = (sacc[0][0] * dacc[0][0] + sacc[0][1] * dacc[0][1]) +
                   (sacc[1][0] * dacc[1][0] + sacc[1][1] * dacc[1][1]);
      float c_hi = (sacc[0][2] * dacc[0][2] + sacc[0][3] * dacc[0][3]) +
                   (sacc[1][2] * dacc[1][2] + sacc[1][3] * dacc[1][3]);
      c_lo += __shfl_xor_sync(0xffffffffu, c_lo, 1);
      c_hi += __shfl_xor_sync(0xffffffffu, c_hi, 1);
      c_lo += __shfl_xor_sync(0xffffffffu, c_lo, 2);
      c_hi += __shfl_xor_sync(0xffffffffu, c_hi, 2);
      if (q == 0) {
        cp_s[gw * kRows + g] = c_lo;
        cp_s[gw * kRows + g + 8] = c_hi;
      }
    }
    // 2b. A's partial over the group's rows: thread (s = gt / 8, rows 2 pr,
    // 2 pr + 1 of the group) runs kd = k_s prod_{s<tau<t} w_tau over t
    // (after t = 15 it is k_s Q_s) and P_t, and the 8 threads of s sum
    // A[t, s] over their rows (a reduce-scatter); the diagonal is r_s . (u *
    // k_s). They also write r * P, k * Q, P_16 and step s of the rows of r,
    // k and w.
    {
      const int s = gt >> 3, pr = gt & 7, col = i0 + 2 * pr;
      const float2 k2 = *reinterpret_cast<const float2*>(ks + s * kN + col);
      const float2 r2 = *reinterpret_cast<const float2*>(rs + s * kN + col);
      const float2 w2 = *reinterpret_cast<const float2*>(wsm + s * kN + col);
      const float diag = r2.x * u2.x * k2.x + r2.y * u2.y * k2.y;
      float kd0 = 0.f, kd1 = 0.f, p0 = 1.f, p1 = 1.f, ps0 = 1.f, ps1 = 1.f;
      float part[kSub];
#pragma unroll
      for (int t = 0; t < kSub; ++t) {
        const float2 rt = *reinterpret_cast<const float2*>(rs + t * kN + col);
        const float2 wt = *reinterpret_cast<const float2*>(wsm + t * kN +
                                                           col);
        part[t] = t == s ? diag : rt.x * kd0 + rt.y * kd1;
        if (t == s) {
          ps0 = p0;
          ps1 = p1;
        }
        kd0 = t == s ? k2.x : kd0 * wt.x;
        kd1 = t == s ? k2.y : kd1 * wt.y;
        p0 *= wt.x;
        p1 *= wt.y;
      }
      *reinterpret_cast<float2*>(rp_s + s * kLdP + 2 * pr) =
          make_float2(r2.x * ps0, r2.y * ps1);
      *reinterpret_cast<float2*>(kq_s + s * kLdP + 2 * pr) =
          make_float2(kd0, kd1);
      if (s == 0) *reinterpret_cast<float2*>(pl_s + 2 * pr) =
          make_float2(p0, p1);
      rt_s[2 * pr * kLdT + s] = r2.x;
      rt_s[(2 * pr + 1) * kLdT + s] = r2.y;
      kt_s[2 * pr * kLdT + s] = k2.x;
      kt_s[(2 * pr + 1) * kLdT + s] = k2.y;
      wt_s[2 * pr * kLdT + s] = w2.x;
      wt_s[(2 * pr + 1) * kLdT + s] = w2.y;
      reduce_half<8, 4>(part, lane);
      reduce_half<4, 2>(part, lane);
      reduce_half<2, 1>(part, lane);
      const int t0 = 2 * (pr & 1) + 4 * ((pr >> 1) & 1) + 8 * (pr >> 2);
      a_s[t0 * kLdP + s] = part[0];
      a_s[(t0 + 1) * kLdP + s] = part[1];
    }
    __syncthreads();
    if (c + 1 < n_sub) store_out(c + 1);

    // 2c. the warps' partials summed in warp order: H, G, dA below the
    // diagonal, vd on it, c
    for (int e = gt; e < 3 * kSub * kRows; e += kThreads) {
      const int p = e >> 8, row = (e >> 4) & 15, col = e & 15;
      const float* src = red_s + (4 * p * kSub + row) * kLdS + col;
      const float x = ((src[0] + src[kSub * kLdS]) + src[2 * kSub * kLdS]) +
                      src[3 * kSub * kLdS];
      if (p < 2) {
        hs_s[(p * kSub + row) * kLdS + col] = x;
      } else {
        dat_s[col * kLdT + row] = col < row ? x : 0.f;
        if (col == row) vd_s[row] = x;
      }
    }
    if (gt < kRows)
      c_s[gt] = ((cp_s[gt] + cp_s[kRows + gt]) + cp_s[2 * kRows + gt]) +
                cp_s[3 * kRows + gt];
    // dY's B pieces (k = t, n = j) for dv's and dS's products
    uint32_t yb[2][2][2], ysm[2][2][2];   // [kk][nt][k q, k q + 4]
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int lo = 8 * kk + q, j = j0 + 8 * nt + g;
        split_tf32(dys[lo * kLdV + j], yb[kk][nt][0], ysm[kk][nt][0]);
        split_tf32(dys[(lo + 4) * kLdV + j], yb[kk][nt][1], ysm[kk][nt][1]);
      }
    float vacc[2][4], vacc2[2][4];   // (k * Q) dSe and A^T dY: two chains
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) vacc[nt][e] = vacc2[nt][e] = 0.f;
    // 2d. dv's partial over the group's rows, this warp's columns:
    // (k * Q) dSe + A^T dY (dSe through shared memory, warp-local)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        *reinterpret_cast<float2*>(dse_s + (g + 8 * hh) * kLdV + j0 + 8 * nt +
                                   2 * q) =
            make_float2(dacc[nt][2 * hh], dacc[nt][2 * hh + 1]);
    __syncwarp();
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      const int lo = 8 * kk + q;
      const float a[4] = {kq_s[g * kLdP + lo], kq_s[(g + 8) * kLdP + lo],
                          kq_s[g * kLdP + lo + 4],
                          kq_s[(g + 8) * kLdP + lo + 4]};
      uint32_t ab[4], as[4];
      split4(a, ab, as);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int j = j0 + 8 * nt + g;
        mma3f(vacc[nt], ab, as, dse_s[lo * kLdV + j],
              dse_s[(lo + 4) * kLdV + j]);
      }
    }
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      const int lo = 8 * kk + q;
      const float a[4] = {a_s[lo * kLdP + g], a_s[lo * kLdP + g + 8],
                          a_s[(lo + 4) * kLdP + g],
                          a_s[(lo + 4) * kLdP + g + 8]};
      uint32_t ab[4], as[4];
      split4(a, ab, as);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
        mma3(vacc2[nt], ab, as, yb[kk][nt][0], yb[kk][nt][1], ysm[kk][nt][0],
             ysm[kk][nt][1]);
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        *reinterpret_cast<float2*>(dvx_s + (g + 8 * hh) * kLdV + j0 + 8 * nt +
                                   2 * q) =
            make_float2(vacc[nt][2 * hh] + vacc2[nt][2 * hh],
                        vacc[nt][2 * hh + 1] + vacc2[nt][2 * hh + 1]);
    // 2e. the gradient into the sub-chunk before: dS <- diag(P_16) dSe +
    // (r * P)^T dY
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) dacc[nt][e] *= pl_s[g + 8 * (e >> 1)];
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      const int lo = 8 * kk + q;
      const float a[4] = {rp_s[lo * kLdP + g], rp_s[lo * kLdP + g + 8],
                          rp_s[(lo + 4) * kLdP + g],
                          rp_s[(lo + 4) * kLdP + g + 8]};
      uint32_t ab[4], as[4];
      split4(a, ab, as);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
        mma3(dacc[nt], ab, as, yb[kk][nt][0], yb[kk][nt][1], ysm[kk][nt][0],
             ysm[kk][nt][1]);
    }
  }
  __syncthreads();   // sub-chunk 0's sums are written
  if (n_sub > 0) rows(0);
  __syncthreads();   // its outputs are staged
  if (n_sub > 0) {
    store_out(0);
    store_dv(0);
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float x = du_acc[hh];
#pragma unroll
    for (int m = 8; m >= 1; m >>= 1) x += __shfl_xor_sync(0xffffffffu, x, m);
    if (sl == 0) du_rows[static_cast<size_t>(bh) * kN + i0 + il + 8 * hh] = x;
  }
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      ds0[state + static_cast<size_t>(i0 + g + 8 * (e >> 1)) * kN + j0 +
          8 * nt + 2 * q + (e & 1)] = dacc[nt][e];
}

cudaError_t launch_bwd_chunk(const float* r, const float* k, const float* v,
                             const float* w, const float* u, const float* s0,
                             const float* dy, const float* ds, float* dr,
                             float* dk, float* dv, float* dw, float* du_rows,
                             float* ds0, float* ws, int B, int T, int H,
                             long long sb, long long st, long long sh,
                             cudaStream_t stream) {
  static bool configured = false;  // once per process
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        wkv_bwd_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kBSmemBytes);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  wkv_bwd_chunk_kernel<<<B * H, kBThreads, kBSmemBytes, stream>>>(
      r, k, v, w, u, s0, dy, ds, dr, dk, dv, dw, du_rows, ds0, ws, T, H, sb,
      st, sh);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace

// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue
// for arguments the kernel does not take: N outside {8, 16, 32, 64}; for
// `chunked`, N other than 64, or r/k/v/w not 16-byte aligned (pointers,
// and strides a multiple of 4 floats). `chunked` picks wkv_chunk_kernel,
// else wkv_kernel. Allocates nothing, does not synchronise; runs on
// `stream`.
extern "C" int rwkv6_wkv(const void* r, const void* k, const void* v,
                         const void* w, const void* u, const void* s0, void* y,
                         void* s_final, int B, int T, int H, int N,
                         long long sb, long long st, long long sh, int chunked,
                         void* stream) {
  if (B <= 0 || T < 0 || H <= 0 || static_cast<long long>(B) * H > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* rf = static_cast<const float*>(r);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  const float* wf = static_cast<const float*>(w);
  const float* uf = static_cast<const float*>(u);
  const float* sf = static_cast<const float*>(s0);
  float* yf = static_cast<float*>(y);
  float* of = static_cast<float*>(s_final);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (chunked) {
    if (N != kN || !aligned16(r) || !aligned16(k) || !aligned16(v) ||
        !aligned16(w) || !aligned16(u) || sb % 4 || st % 4 || sh % 4)
      return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(launch_chunk(rf, kf, vf, wf, uf, sf, yf, of, B,
                                         T, H, sb, st, sh, s));
  }
  switch (N) {
    case 8:  launch<8>(rf, kf, vf, wf, uf, sf, yf, of, B, T, H, sb, st, sh, s); break;
    case 16: launch<16>(rf, kf, vf, wf, uf, sf, yf, of, B, T, H, sb, st, sh, s); break;
    case 32: launch<32>(rf, kf, vf, wf, uf, sf, yf, of, B, T, H, sb, st, sh, s); break;
    case 64: launch<64>(rf, kf, vf, wf, uf, sf, yf, of, B, T, H, sb, st, sh, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// The chunked backward kernel's residency on the current device: blocks an
// SM can hold (its shared memory attribute set first, as for a launch).
// Returns a cudaError_t.
extern "C" int rwkv6_wkv_bwd_occupancy(int* blocks_per_sm) {
  const cudaError_t err = cudaFuncSetAttribute(
      wkv_bwd_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kBSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, wkv_bwd_chunk_kernel, kBThreads, kBSmemBytes));
}

// The backward: the gradient of (y, s_final) with respect to r, k, v, w, u
// and s0 from dy and ds (null: zero). Writes dr, dk, dv, dw (B, T, H, N),
// du_rows (B, H, N; the caller sums over B) and ds0 (B, H, N, N). `chunked`
// picks wkv_bwd_chunk_kernel (N = 64; r/k/v/w/u/dy 16-byte aligned, strides
// a multiple of 4 floats; a workspace of B H ceil(T / 16) N^2 floats), else
// wkv_bwd_kernel (N in {8, 16, 32, 64}; B H (ceil(T / 64) + 8) N^2 floats).
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue for
// arguments the kernel does not take or a smaller workspace. Allocates
// nothing, does not synchronise; runs on `stream`.
extern "C" int rwkv6_wkv_bwd(const void* r, const void* k, const void* v,
                             const void* w, const void* u, const void* s0,
                             const void* dy, const void* ds, void* dr,
                             void* dk, void* dv, void* dw, void* du_rows,
                             void* ds0, void* ws, long long ws_floats, int B,
                             int T, int H, int N, long long sb, long long st,
                             long long sh, int chunked, void* stream) {
  if (B <= 0 || T < 0 || H <= 0 || static_cast<long long>(B) * H > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long need =
      chunked ? static_cast<long long>(B) * H * ((T + kSub - 1) / kSub) * N *
                    N
              : static_cast<long long>(B) * H * ((T + kCk - 1) / kCk + kSubs) *
                    N * N;
  if (ws_floats < need) return static_cast<int>(cudaErrorInvalidValue);
  const float* rf = static_cast<const float*>(r);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  const float* wf = static_cast<const float*>(w);
  const float* uf = static_cast<const float*>(u);
  const float* sf = static_cast<const float*>(s0);
  const float* dyf = static_cast<const float*>(dy);
  const float* dsf = static_cast<const float*>(ds);
  float* o[6] = {static_cast<float*>(dr), static_cast<float*>(dk),
                 static_cast<float*>(dv), static_cast<float*>(dw),
                 static_cast<float*>(du_rows), static_cast<float*>(ds0)};
  float* wsf = static_cast<float*>(ws);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (chunked) {
    if (N != kN || !aligned16(r) || !aligned16(k) || !aligned16(v) ||
        !aligned16(w) || !aligned16(u) || !aligned16(dy) || sb % 4 ||
        st % 4 || sh % 4)
      return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(launch_bwd_chunk(rf, kf, vf, wf, uf, sf, dyf, dsf,
                                             o[0], o[1], o[2], o[3], o[4],
                                             o[5], wsf, B, T, H, sb, st, sh,
                                             s));
  }
  switch (N) {
#define WKV_BWD(NN)                                                        \
  case NN:                                                                 \
    return static_cast<int>(launch_bwd<NN>(rf, kf, vf, wf, uf, sf, dyf,   \
                                           dsf, o[0], o[1], o[2], o[3],   \
                                           o[4], o[5], wsf, B, T, H, sb,  \
                                           st, sh, s));
    WKV_BWD(8)
    WKV_BWD(16)
    WKV_BWD(32)
    WKV_BWD(64)
#undef WKV_BWD
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
