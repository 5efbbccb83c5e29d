// Crossbar-wise quantized matmul with post-accumulation dequantization
// (Atleus SS IV.D, Fig. 5) for Hopper (sm_90a), plain f32 SIMT.
//
// Replaces: the Pallas TPU kernel `crossbar_matmul` in
//   src/repro/kernels/crossbar_matmul/kernel.py (bodies _kernel_int8 and
//   _kernel_int4), i.e. out = x @ dequant(codes, scales) where each 128-deep
//   K tile's f32 partial sum is multiplied by that crossbar's one scale and
//   then added to the running sum.
//
// What bounds it on H100: at decode M is only max_slots (8), so the work is
//   2*M*K*N flops against K*N code bytes -- about 16 flops per byte, far
//   below the ~20 flops/byte where f32 SIMT (67 TFLOP/s over 3.35 TB/s)
//   stops being memory bound: the kernel is bound by reading the codes
//   (16.8 MB for w1/w3 at K=2048, N=8192: ~5 us). At chunked prefill
//   (M = slots x chunk = 1024) it is bound by f32 arithmetic.
//
// What this simple design does about it: one block per (M tile, 128-wide
//   N tile), as the TPU grid's (i, j) axes; a loop over the 128-deep K tiles
//   takes the place of the TPU's sequential K grid axis. The codes stay one
//   (int8) or half a (int4) byte per weight in device memory and are decoded
//   in shared memory, so device traffic is the quantized footprint. The M
//   tile is 8 rows when M is small (decode: no wasted rows, one pass over
//   the codes per M tile) and 64 rows otherwise (prefill: each staged code
//   is reused by 64 rows). Ragged M and K beyond the original K are masked
//   in the kernel instead of padding copies; the output is written only up
//   to the original N. Not yet: tensor cores (wgmma on int8->bf16 codes),
//   TMA, multi-stage pipelining -- later PRs.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBN = 128;        // output columns per block: one crossbar
constexpr int kCrossbar = 128;  // K tile == quantization block
constexpr int kSubK = 32;       // K rows staged in shared memory at a time
constexpr int kThreads = 256;   // 8 row groups x 32 column lanes

// Sign-extend one 4-bit two's-complement nibble.
__device__ __forceinline__ float nibble(uint32_t v) {
  int n = static_cast<int>(v & 0xFu);
  return static_cast<float>(n > 7 ? n - 16 : n);
}

__device__ __forceinline__ float byte_s8(uint32_t word, int e) {
  return static_cast<float>(static_cast<int8_t>((word >> (8 * e)) & 0xFFu));
}

// x (M, K) f32 row-major; codes int8 (Kp, Np) for BITS == 8, uint8
// (Kp / 2, Np) packed along K for BITS == 4 (row 2i = low nibble, row
// 2i + 1 = high nibble); scales f32 (Kp / 128, Np / 128); out (M, N).
template <int BM, int BITS>
__global__ void __launch_bounds__(kThreads)
crossbar_kernel(const float* __restrict__ x, const uint8_t* __restrict__ codes,
                const float* __restrict__ scales, float* __restrict__ out,
                int M, int K, int N, int Kp, int Np) {
  constexpr int TM = BM / 8;      // rows per thread
  constexpr int TN = kBN / 32;    // columns per thread, strided by 32
  __shared__ float xs[BM][kSubK];
  __shared__ __align__(16) float ws[kSubK][kBN];

  const int tid = threadIdx.x;
  const int tx = tid & 31;        // column lane
  const int ty = tid >> 5;        // row group
  const int nt = blockIdx.x;
  const int n0 = nt * kBN;
  const int m0 = blockIdx.y * BM;
  const int n_nt = Np / kBN;
  const int n_kt = Kp / kCrossbar;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int kt = 0; kt < n_kt; ++kt) {
    float part[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) part[i][j] = 0.f;

    for (int ks = 0; ks < kCrossbar; ks += kSubK) {
      const int k0 = kt * kCrossbar + ks;
      __syncthreads();  // the previous sub-tile is no longer read
      // activations: BM x kSubK, masked on ragged M and K >= orig K
      for (int i = tid; i < BM * kSubK; i += kThreads) {
        const int r = i / kSubK, c = i % kSubK;
        const int gm = m0 + r, gk = k0 + c;
        xs[r][c] = (gm < M && gk < K) ? x[static_cast<size_t>(gm) * K + gk]
                                      : 0.f;
      }
      if (BITS == 8) {
        // kSubK x 128 int8 codes = 1024 words of 4 bytes, 4 per thread;
        // a warp reads one 128-byte row of codes
        for (int w = tid; w < kSubK * kBN / 4; w += kThreads) {
          const int r = w / (kBN / 4), cw = w % (kBN / 4);
          const uint32_t word = *reinterpret_cast<const uint32_t*>(
              codes + static_cast<size_t>(k0 + r) * Np + n0 + 4 * cw);
          *reinterpret_cast<float4*>(&ws[r][4 * cw]) = make_float4(
              byte_s8(word, 0), byte_s8(word, 1), byte_s8(word, 2),
              byte_s8(word, 3));
        }
      } else {
        // kSubK / 2 packed rows x 128 bytes = 512 words, 2 per thread
        for (int w = tid; w < (kSubK / 2) * kBN / 4; w += kThreads) {
          const int pr = w / (kBN / 4), cw = w % (kBN / 4);
          const uint32_t word = *reinterpret_cast<const uint32_t*>(
              codes + static_cast<size_t>(k0 / 2 + pr) * Np + n0 + 4 * cw);
          *reinterpret_cast<float4*>(&ws[2 * pr][4 * cw]) = make_float4(
              nibble(word), nibble(word >> 8), nibble(word >> 16),
              nibble(word >> 24));
          *reinterpret_cast<float4*>(&ws[2 * pr + 1][4 * cw]) = make_float4(
              nibble(word >> 4), nibble(word >> 12), nibble(word >> 20),
              nibble(word >> 28));
        }
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < kSubK; ++kk) {
        float w[TN];
#pragma unroll
        for (int j = 0; j < TN; ++j) w[j] = ws[kk][tx + 32 * j];
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float a = xs[ty * TM + i][kk];
#pragma unroll
          for (int j = 0; j < TN; ++j) part[i][j] = fmaf(a, w[j], part[i][j]);
        }
      }
    }
    // post-MVM dequantization: one scale per 128x128 crossbar
    const float s = scales[kt * n_nt + nt];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] += part[i][j] * s;
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty * TM + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx + 32 * j;
      if (gn < N) out[static_cast<size_t>(gm) * N + gn] = acc[i][j];
    }
  }
}

template <int BM>
void launch(const float* x, const uint8_t* codes, const float* scales,
            float* out, int M, int K, int N, int Kp, int Np, int bits,
            cudaStream_t stream) {
  dim3 grid(Np / kBN, (M + BM - 1) / BM);
  if (bits == 8)
    crossbar_kernel<BM, 8><<<grid, kThreads, 0, stream>>>(
        x, codes, scales, out, M, K, N, Kp, Np);
  else
    crossbar_kernel<BM, 4><<<grid, kThreads, 0, stream>>>(
        x, codes, scales, out, M, K, N, Kp, Np);
}

}  // namespace

// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue for
// arguments the kernel does not take). Allocates nothing, does not
// synchronise; runs on `stream`.
extern "C" int crossbar_matmul(const void* x, const void* codes,
                               const void* scales, void* out, int M, int K,
                               int N, int Kp, int Np, int bits, void* stream) {
  if ((bits != 8 && bits != 4) || M <= 0 || K <= 0 || N <= 0 ||
      Kp % kCrossbar != 0 || Np % kBN != 0 || K > Kp || N > Np ||
      (M + 7) / 8 > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* xf = static_cast<const float*>(x);
  const uint8_t* c = static_cast<const uint8_t*>(codes);
  const float* sc = static_cast<const float*>(scales);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= 32)
    launch<8>(xf, c, sc, o, M, K, N, Kp, Np, bits, st);
  else
    launch<64>(xf, c, sc, o, M, K, N, Kp, Np, bits, st);
  return static_cast<int>(cudaGetLastError());
}
