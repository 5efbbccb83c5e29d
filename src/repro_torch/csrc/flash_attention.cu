// Fused score + softmax + V attention (Atleus MHA-2/MHA-3) for Hopper
// (sm_90a), plain f32 SIMT, with a contiguous and a paged entry point.
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
// What bounds it on H100: at decode (one query row per slot) each row
//   reads its whole K/V context once for 4*D flops per key, so it is bound
//   by reading K/V (8 KB per key of a kv-head group at D=64, 8 kv heads).
//   At prefill (T = S = 512) it does T*S*4*D flops per head against T*S
//   scores that never leave the SM, and is bound by f32 arithmetic.
//
// What this simple design does about it: one block per (batch row, q head,
//   4 query rows), one warp per query row. K/V stream through shared memory
//   in tiles of 32 keys (the kv tile is loaded once per block and shared by
//   its 4 rows); lane j scores key j of the tile, the warp reduces the
//   tile's max and sum with shuffles, and the lanes then own D/32 output
//   dims each for the p . v update. The running (m, l, acc) stay in
//   registers, so nothing O(T*S) touches device memory. The paged loop
//   stops at the row's length (lens + chunk_lens), so decode reads only
//   the live context. Not yet: grouping the q heads of one kv head into a
//   block (reads K/V once per group), tensor cores, TMA -- later PRs.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kRows = 4;      // query rows (warps) per block
constexpr int kTile = 32;     // keys per shared-memory tile (one per lane)
constexpr int kThreads = kRows * 32;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// q, out: (B, T, Hq, D); q_pos: (B, T).
// Contiguous (block_table == nullptr): k, v (B, S, Hkv, D), kv_pos (B, S).
// Paged: k, v are one layer's pool (P, Hkv, page, D); key s of row b lives
//   in page block_table[b, s / page] at row s % page; it is visible iff that
//   entry is >= 0 and s < lens[b] + chunk_lens[b], and its position is s.
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, const int* __restrict__ q_pos,
             const int* __restrict__ kv_pos,
             const int* __restrict__ block_table, const int* __restrict__ lens,
             const int* __restrict__ chunk_lens, int nb, int page,
             float* __restrict__ out, int T, int Hq, int S, int Hkv,
             int window, float softcap) {
  constexpr int DPL = (D + 31) / 32;  // output dims per lane
  __shared__ float ks[kTile][D + 1];  // +1: lane j reads row j conflict-free
  __shared__ float vs[kTile][D];
  __shared__ float qs[kRows][D];
  __shared__ int kpos[kTile];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int b = blockIdx.z;
  const int hq = blockIdx.y;
  const int t = blockIdx.x * kRows + warp;
  const bool row_ok = t < T;
  const int hkv = hq / (Hq / Hkv);
  const bool paged = block_table != nullptr;
  const float scale = 1.f / sqrtf(static_cast<float>(D));

  for (int d = lane; d < D; d += 32)
    qs[warp][d] = row_ok
        ? q[((static_cast<size_t>(b) * T + t) * Hq + hq) * D + d] * scale
        : 0.f;
  const int qp = row_ok ? q_pos[static_cast<size_t>(b) * T + t] : 0;

  int s_end = S;
  if (paged) s_end = min(nb * page, lens[b] + chunk_lens[b]);

  float m = kNegInf, l = 0.f;
  float acc[DPL];
#pragma unroll
  for (int i = 0; i < DPL; ++i) acc[i] = 0.f;

  for (int s0 = 0; s0 < s_end; s0 += kTile) {
    __syncthreads();  // previous tile fully consumed (and qs written)
    if (tid < kTile) {
      const int s = s0 + tid;
      int p = -1;
      if (s < s_end) {
        if (paged) {
          const int pid = block_table[static_cast<size_t>(b) * nb + s / page];
          p = pid >= 0 ? s : -1;
        } else {
          p = kv_pos[static_cast<size_t>(b) * S + s];
        }
      }
      kpos[tid] = p;
    }
    __syncthreads();
    for (int i = tid; i < kTile * D; i += kThreads) {
      const int j = i / D, d = i % D;
      const int s = s0 + j;
      float kv = 0.f, vv = 0.f;
      if (kpos[j] >= 0) {
        size_t off;
        if (paged) {
          const int pid = block_table[static_cast<size_t>(b) * nb + s / page];
          off = ((static_cast<size_t>(pid) * Hkv + hkv) * page + s % page) * D
                + d;
        } else {
          off = ((static_cast<size_t>(b) * S + s) * Hkv + hkv) * D + d;
        }
        kv = k[off];
        vv = v[off];
      }
      ks[j][d] = kv;
      vs[j][d] = vv;
    }
    __syncthreads();
    if (!row_ok) continue;

    // lane j scores key s0 + j
    float sc = 0.f;
#pragma unroll 16
    for (int d = 0; d < D; ++d) sc = fmaf(qs[warp][d], ks[lane][d], sc);
    if (softcap > 0.f) sc = softcap * tanhf(sc / softcap);
    const int kp = kpos[lane];
    bool ok = kp >= 0 && kp <= qp;
    if (window > 0) ok = ok && (qp - kp) < window;
    sc = ok ? sc : kNegInf;

    const float m_new = fmaxf(m, warp_max(sc));
    const float p = ok ? expf(sc - m_new) : 0.f;
    const float corr = expf(m - m_new);
    l = l * corr + warp_sum(p);
    m = m_new;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[i] *= corr;
    // lanes own dims lane + 32 i; p of key j is broadcast from lane j
    for (int j = 0; j < kTile; ++j) {
      const float pj = __shfl_sync(0xffffffffu, p, j);
      if (pj == 0.f) continue;  // warp-uniform: masked key
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        const int d = lane + 32 * i;
        if (d < D) acc[i] = fmaf(pj, vs[j][d], acc[i]);
      }
    }
  }

  if (!row_ok) return;
  const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
  for (int i = 0; i < DPL; ++i) {
    const int d = lane + 32 * i;
    if (d < D)
      out[((static_cast<size_t>(b) * T + t) * Hq + hq) * D + d] = acc[i] * inv;
  }
}

int launch(const float* q, const float* k, const float* v, const int* q_pos,
           const int* kv_pos, const int* block_table, const int* lens,
           const int* chunk_lens, int nb, int page, float* out, int B, int T,
           int Hq, int S, int Hkv, int D, int window, float softcap,
           cudaStream_t stream) {
  if (B <= 0 || T <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv != 0 ||
      B > 65535 || Hq > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid((T + kRows - 1) / kRows, Hq, B);
#define REPRO_FLASH_CASE(DIM)                                               \
  case DIM:                                                                 \
    flash_kernel<DIM><<<grid, kThreads, 0, stream>>>(                       \
        q, k, v, q_pos, kv_pos, block_table, lens, chunk_lens, nb, page,    \
        out, T, Hq, S, Hkv, window, softcap);                               \
    break;
  switch (D) {
    REPRO_FLASH_CASE(8)
    REPRO_FLASH_CASE(16)
    REPRO_FLASH_CASE(32)
    REPRO_FLASH_CASE(64)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_FLASH_CASE
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Both entry points return cudaGetLastError() after the launch
// (cudaErrorInvalidValue for shapes the kernel does not take), allocate
// nothing and do not synchronise. window <= 0: no window; softcap <= 0: none.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               const void* q_pos, const void* kv_pos,
                               void* out, int B, int T, int Hq, int S, int Hkv,
                               int D, int window, float softcap,
                               void* stream) {
  return launch(static_cast<const float*>(q), static_cast<const float*>(k),
                static_cast<const float*>(v), static_cast<const int*>(q_pos),
                static_cast<const int*>(kv_pos), nullptr, nullptr, nullptr, 0,
                1, static_cast<float*>(out), B, T, Hq, S, Hkv, D, window,
                softcap, static_cast<cudaStream_t>(stream));
}

extern "C" int paged_flash_attention(const void* q, const void* kp,
                                     const void* vp, const void* q_pos,
                                     const void* block_table, const void* lens,
                                     const void* chunk_lens, void* out, int B,
                                     int T, int Hq, int Hkv, int D, int nb,
                                     int page, int window, float softcap,
                                     void* stream) {
  if (nb <= 0 || page <= 0) return static_cast<int>(cudaErrorInvalidValue);
  return launch(static_cast<const float*>(q), static_cast<const float*>(kp),
                static_cast<const float*>(vp), static_cast<const int*>(q_pos),
                nullptr, static_cast<const int*>(block_table),
                static_cast<const int*>(lens),
                static_cast<const int*>(chunk_lens), nb, page,
                static_cast<float*>(out), B, T, Hq, /*S=*/nb * page, Hkv, D,
                window, softcap, static_cast<cudaStream_t>(stream));
}
