// RWKV6 "Finch" wkv recurrence for Hopper (sm_90a), plain f32 SIMT, with
// the per-head N x N state held in registers for the whole chunk.
//
// Replaces: the Pallas TPU kernel `rwkv6_wkv_kernel` in
//   src/repro/kernels/rwkv6_wkv/kernel.py (body _wkv_kernel), i.e. per head
//     y_t = r_t . (S + u (.) k_t v_t^T),   S <- diag(w_t) S + k_t v_t^T
//   returning y and the final S.
//
// What bounds it on H100: at decode (T = 1) almost nothing is computed per
//   byte: each (b, h) reads its 16 KB state and writes it back, 2 * 8 * 64
//   * 16 KB = 16.8 MB per layer at 8 slots, ~5 us at 3.35 TB/s. At a chunk
//   of T steps the work is 4 * T * N^2 flops per (b, h) against 5 * T * N
//   floats of r/k/v/w/y, so at T = 128 it is bound by f32 arithmetic
//   (67 TFLOP/s) as long as the state never goes back to device memory.
//
// What this simple design does about it: one block per (b, h) and N
//   threads; thread j owns column j of S in N registers, read once from s0
//   and written once as s_final, so the TPU kernel's VMEM-resident state
//   becomes register-resident and the sequential time grid axis becomes a
//   loop inside the block. Then
//     y_j = sum_i r_i S_ij + (sum_i r_i u_i k_i) v_j,
//     S_ij <- w_i S_ij + k_i v_j
//   needs no reduction across threads: the scalar a_t = sum_i r_i u_i k_i
//   is one value per step, computed for a time block at once. r, k, w and
//   v of a time block of kTB steps are staged in shared memory (each row
//   one coalesced read); every thread then reads r_i, k_i, w_i as
//   broadcasts. The (B, T, H, N) layout is read through its strides: no
//   head folding or padding copies. Ragged rows need no special case: the
//   model masks their padded steps to k = 0, w = 1, which leaves S
//   unchanged. Not yet: several heads per block, a time loop split across
//   warps (chunked form with tensor cores) -- later PRs.
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

}  // namespace

// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue for
// arguments the kernel does not take: N outside {8, 16, 32, 64}). Allocates
// nothing, does not synchronise; runs on `stream`.
extern "C" int rwkv6_wkv(const void* r, const void* k, const void* v,
                         const void* w, const void* u, const void* s0, void* y,
                         void* s_final, int B, int T, int H, int N,
                         long long sb, long long st, long long sh,
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
  switch (N) {
    case 8:  launch<8>(rf, kf, vf, wf, uf, sf, yf, of, B, T, H, sb, st, sh, s); break;
    case 16: launch<16>(rf, kf, vf, wf, uf, sf, yf, of, B, T, H, sb, st, sh, s); break;
    case 32: launch<32>(rf, kf, vf, wf, uf, sf, yf, of, B, T, H, sb, st, sh, s); break;
    case 64: launch<64>(rf, kf, vf, wf, uf, sf, yf, of, B, T, H, sb, st, sh, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
