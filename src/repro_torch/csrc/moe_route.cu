// Routing, layout and dispatch (moe_route) and the combine (moe_combine)
// of a mixture-of-experts layer under dropless dispatch, for Hopper
// (sm_90a).
//
// Replaces: no Pallas kernel. The JAX package computes both outside any
// Pallas call, in src/repro/models/moe.py apply_moe (its dropless
// branch): the softmax and top_k of the router's f32 logits, the
// renormalised gates, the load-balance and z losses, each (token, slot)
// assignment's one-hot cumsum rank, the scatter of x into the expert
// buffer, and the gather-and-weight combine. The port's plain versions
// (kernels/moe_route/ops.py: the same ops in torch) are some 50 launches
// of a few us on a few KB each at a decode tick.
//
// Bound: neither the card's bytes nor its operations. A llama4-scout
// decode tick routes 8 tokens over 16 experts and moves 8 rows of 5120
// floats in and out: 0.33 MB, 0.1 us at 3.35 TB/s. What each launch costs
// is its own latency: a chain of dependent block-wide steps. So one block
// does the whole routing, and the grid only spreads the bytes.
//
// moe_route: grid min(n, 2 x SMs) blocks of 256 threads (set by the
//   shapes: a CUDA graph replays it for any routing). Every block routes
//   every token, in chunks of 256 (one token a thread), twice:
//   - pass 1 counts each slot's kept assignments (a slot's hits among a
//     warp's tokens by one ballot, the warps' in order), from which each
//     block sets the slots' padded bases alike (with one chunk, as at a
//     decode tick, pass 2 reuses pass 1's routing and ballots);
//   - pass 2 ranks each assignment: its slot's hits in the chunks and
//     warps before it plus the lanes before it in its warp's ballot, which
//     is the JAX package's cumsum rank over the whole batch in (b, t, k)
//     order (a token takes a slot at most once: its experts are distinct),
//     pads claiming none. Its row is its slot's base plus that rank.
//   Block 0 writes the per-token outputs, the rows, bases and counts, and
//   the aux losses (its per-expert sums reduced by warp butterflies and
//   then warps in order, so two calls give the same bits). Each block
//   copies the x rows of the chunk's tokens b, b + grid, ... into the
//   buffer. Buffer rows that hold no kept assignment are not written: the
//   grouped crossbar kernels read a slot's rows only up to its count (x
//   past it reads as 0) and no row past the last slot's.
// moe_combine: one block a (token, 1024 columns): y = sum over the token's
//   kept assignments, in order, of gate x its buffer row (a product, then
//   a sum, each rounded: the plain version's numbers), plus the shared
//   expert's output where the layer has one.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;           // tokens of a chunk, one a thread
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSlots = 128;          // slots: experts x tpe
constexpr int kMaxTopK = 8;             // experts a token takes
constexpr int kMaxAssign = 16;          // slots a token takes: top_k x tpe
constexpr int kRouteBlocksPerSm = 2;
constexpr int kCombineCols = 1024;      // columns of a combine block

struct RouteArgs {
  const float* logits;   // (n, E)
  const uint8_t* mask;   // (n): real tokens; nullptr when all are
  const float* x;        // (n, d)
  long long* experts;    // (n, k)
  float* gate;           // (n, k)
  float* margin;         // (n)
  float* aux;            // (3): lb_loss, router_z, dropped assignments (0)
  long long* rows;       // (n, k * tpe)
  float* weights;        // (n, k * tpe)
  int* bases;            // (slots + 1)
  int* counts;           // (slots)
  float* xbuf;           // (R, d)
  int n, E, k, tpe, norm, tile, d, vec;
};

struct Shared {
  unsigned wbal[kWarps][kMaxSlots];   // each warp's ballot of each slot
  int pre[kWarps][kMaxSlots];         // rank of the warp's first hit
  int run[kMaxSlots];                 // hits in the chunks before
  int base[kMaxSlots + 1];            // the slots' padded bases
  int row[kThreads][kMaxAssign];      // the chunk's rows (-1: not kept)
  float wsum[kWarps][kMaxSlots];      // block 0: each warp's prob sums
  float psum[kMaxSlots];              // block 0: each expert's prob sum
  int top1[kMaxSlots];                // block 0: tokens whose first it is
  float wz[kWarps];                   // block 0: each warp's lse^2 sum
  float zsum;
};

// One token's routing: its k + 1 largest probabilities in order (chosen
// by their logits, ties to the lower expert; unused places hold -1), its
// max logit and the sum of exp(logit - max), from which each probability
// is exp(l - max) / sum. A thread routes its token alone, so the chain of
// dependent steps is what a launch costs: the selection compares logits
// and only the k + 1 chosen are turned into probabilities.
struct Token {
  float p[kMaxTopK + 1];
  int e[kMaxTopK + 1];
  float mx, sum;
};

__device__ __forceinline__ Token route_token(const RouteArgs& a, int tok) {
  Token r;
  const float* l = a.logits + static_cast<size_t>(tok) * a.E;
  const float ninf = __int_as_float(0xff800000);   // -inf
  // the k + 1 largest logits (the probabilities' order), then the sum of
  // exp(l - max) with its terms independent of one another
  float top_l[kMaxTopK + 1];
#pragma unroll
  for (int j = 0; j <= kMaxTopK; ++j) {
    top_l[j] = ninf;
    r.e[j] = -1;
  }
  const int top = a.k + 1 < a.E ? a.k + 1 : a.E;
  float mx = ninf;
  for (int e = 0; e < a.E; ++e) {
    float v = __ldg(l + e);
    mx = fmaxf(mx, v);
    int ve = e;
#pragma unroll
    for (int j = 0; j <= kMaxTopK; ++j) {
      if (j < top && v > top_l[j]) {
        const float tv = top_l[j];
        const int te = r.e[j];
        top_l[j] = v;
        r.e[j] = ve;
        v = tv;
        ve = te;
      }
    }
  }
  float sum = 0.f;
#pragma unroll 4
  for (int e = 0; e < a.E; ++e) sum += expf(__ldg(l + e) - mx);
#pragma unroll
  for (int j = 0; j <= kMaxTopK; ++j)
    r.p[j] = j < top ? expf(top_l[j] - mx) / sum : -1.f;
  r.mx = mx;
  r.sum = sum;
  return r;
}

// The k gates (renormalised by their sum, at least 1e-9, with norm) and
// each times the token's mask: kept where that is > 0.
__device__ __forceinline__ void gates_of(const RouteArgs& a, const Token& r,
                                         int tok, bool valid,
                                         float (&gate)[kMaxTopK],
                                         float (&sg)[kMaxTopK]) {
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < kMaxTopK; ++j)
    if (j < a.k) s += r.p[j];
  const float den = fmaxf(s, 1e-9f);
  const float m =
      valid && (a.mask == nullptr || a.mask[tok] != 0) ? 1.f : 0.f;
#pragma unroll
  for (int j = 0; j < kMaxTopK; ++j) {
    gate[j] = j < a.k ? (a.norm ? r.p[j] / den : r.p[j]) : 0.f;
    sg[j] = gate[j] * m;
  }
}

// Each warp's ballot of each slot: the lanes whose token keeps an
// assignment to it. Every lane of the block takes part.
__device__ __forceinline__ void ballots(Shared& sh, const RouteArgs& a,
                                        const Token& r,
                                        const float (&sg)[kMaxTopK],
                                        int slots) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int s = 0; s < slots; ++s) {
    const int e = s / a.tpe;
    bool hit = false;
#pragma unroll
    for (int j = 0; j < kMaxTopK; ++j)
      hit |= j < a.k && sg[j] > 0.f && r.e[j] == e;
    const unsigned bal = __ballot_sync(0xffffffffu, hit);
    if (lane == 0) sh.wbal[warp][s] = bal;
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Block 0's sums of one chunk for the aux losses: each expert's
// probabilities and first choices, and the tokens' logsumexp squared.
__device__ __forceinline__ void aux_sums(Shared& sh, const RouteArgs& a,
                                         const Token& r, int tok,
                                         bool valid) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float* l = a.logits + static_cast<size_t>(valid ? tok : 0) * a.E;
#pragma unroll 4
  for (int e = 0; e < a.E; ++e) {
    const float p = valid ? expf(__ldg(l + e) - r.mx) / r.sum : 0.f;
    const float w = warp_sum(p);
    if (lane == 0) sh.wsum[warp][e] = w;
  }
  if (valid) atomicAdd(&sh.top1[r.e[0]], 1);   // integers: any order
  const float lse = r.mx + logf(r.sum);
  const float z = warp_sum(valid ? lse * lse : 0.f);
  if (lane == 0) sh.wz[warp] = z;
}

__device__ __forceinline__ void copy_row(const float* __restrict__ src,
                                         float* __restrict__ dst, int d,
                                         int vec) {
  if (vec) {
    const float4* s4 = reinterpret_cast<const float4*>(src);
    float4* d4 = reinterpret_cast<float4*>(dst);
    for (int i = threadIdx.x; i < d / 4; i += blockDim.x) d4[i] = __ldg(s4 + i);
  } else {
    for (int i = threadIdx.x; i < d; i += blockDim.x) dst[i] = __ldg(src + i);
  }
}

__global__ void __launch_bounds__(kThreads)
moe_route_kernel(const RouteArgs a) {
  __shared__ Shared sh;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int slots = a.E * a.tpe, K = a.k * a.tpe;
  const int G = static_cast<int>(gridDim.x);
  const bool first = blockIdx.x == 0;
  for (int s = tid; s < slots; s += kThreads) {
    sh.run[s] = 0;
    sh.psum[s] = 0.f;
    sh.top1[s] = 0;
  }
  if (tid == 0) sh.zsum = 0.f;
  __syncthreads();
  // one chunk (a decode tick): pass 2 takes pass 1's routing and ballots
  const bool one = a.n <= kThreads;
  Token r;
  float gate[kMaxTopK], sg[kMaxTopK];

  // pass 1: each slot's kept assignments; block 0 also the aux sums
  for (int c0 = 0; c0 < a.n; c0 += kThreads) {
    const int tok = c0 + tid;
    const bool valid = tok < a.n;
    r = route_token(a, valid ? tok : c0);
    gates_of(a, r, tok, valid, gate, sg);
    ballots(sh, a, r, sg, slots);
    if (first) aux_sums(sh, a, r, tok, valid);
    __syncthreads();
    for (int s = tid; s < slots; s += kThreads) {
      int c = sh.run[s];
      for (int w = 0; w < kWarps; ++w) c += __popc(sh.wbal[w][s]);
      sh.run[s] = c;
    }
    if (first) {
      for (int e = tid; e < a.E; e += kThreads) {
        float p = sh.psum[e];
        for (int w = 0; w < kWarps; ++w) p += sh.wsum[w][e];
        sh.psum[e] = p;
      }
      if (tid == 0) {
        float z = sh.zsum;
        for (int w = 0; w < kWarps; ++w) z += sh.wz[w];
        sh.zsum = z;
      }
    }
    __syncthreads();
  }
  if (tid == 0) {
    int b = 0;
    for (int s = 0; s < slots; ++s) {
      sh.base[s] = b;
      b += (sh.run[s] + a.tile - 1) / a.tile * a.tile;
    }
    sh.base[slots] = b;
  }
  __syncthreads();
  if (first) {
    for (int s = tid; s <= slots; s += kThreads) {
      a.bases[s] = sh.base[s];
      if (s < slots) a.counts[s] = sh.run[s];
    }
    if (tid == 0) {   // Switch's load-balance loss and the router z-loss
      const float n = static_cast<float>(a.n);
      float lb = 0.f;
      for (int e = 0; e < a.E; ++e)
        lb += (static_cast<float>(sh.top1[e]) / n) * (sh.psum[e] / n);
      a.aux[0] = static_cast<float>(a.E) * lb;
      a.aux[1] = sh.zsum / n;
      a.aux[2] = 0.f;
    }
  }
  __syncthreads();
  for (int s = tid; s < slots; s += kThreads) sh.run[s] = 0;
  __syncthreads();

  // pass 2: each assignment's rank and row; the x rows into the buffer
  for (int c0 = 0; c0 < a.n; c0 += kThreads) {
    const int tok = c0 + tid;
    const bool valid = tok < a.n;
    if (!one) {
      r = route_token(a, valid ? tok : c0);
      gates_of(a, r, tok, valid, gate, sg);
      ballots(sh, a, r, sg, slots);
    }
    __syncthreads();
    for (int s = tid; s < slots; s += kThreads) {
      int c = sh.run[s];
      for (int w = 0; w < kWarps; ++w) {
        sh.pre[w][s] = c;
        c += __popc(sh.wbal[w][s]);
      }
      sh.run[s] = c;
    }
    __syncthreads();
    const unsigned before = (1u << lane) - 1u;
#pragma unroll
    for (int j = 0; j < kMaxTopK; ++j) {
      if (j >= a.k) continue;
      const bool kept = valid && sg[j] > 0.f;
      for (int i = 0; i < a.tpe; ++i) {
        const int q = j * a.tpe + i, s = r.e[j] * a.tpe + i;
        int row = 0;
        if (kept)
          row = sh.base[s] + sh.pre[warp][s] +
                __popc(sh.wbal[warp][s] & before);
        sh.row[tid][q] = kept ? row : -1;
        if (first && valid) {
          const size_t o = static_cast<size_t>(tok) * K + q;
          a.rows[o] = row;
          a.weights[o] = kept ? sg[j] : 0.f;
        }
      }
      if (first && valid) {
        const size_t o = static_cast<size_t>(tok) * a.k + j;
        a.experts[o] = r.e[j];
        a.gate[o] = gate[j];
      }
    }
    if (first && valid)
      a.margin[tok] = a.E > a.k ? r.p[a.k - 1] - r.p[a.k]
                                : __int_as_float(0x7f800000);   // +inf
    __syncthreads();
    const int cn = a.n - c0 < kThreads ? a.n - c0 : kThreads;
    for (int lt = (static_cast<int>(blockIdx.x) - c0 % G + G) % G; lt < cn;
         lt += G) {
      const float* src = a.x + static_cast<size_t>(c0 + lt) * a.d;
      for (int q = 0; q < K; ++q) {
        const int row = sh.row[lt][q];
        if (row >= 0)
          copy_row(src, a.xbuf + static_cast<size_t>(row) * a.d, a.d, a.vec);
      }
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kCombineCols / 4)
moe_combine_kernel(const float* __restrict__ out,
                   const long long* __restrict__ rows,
                   const float* __restrict__ weights,
                   const float* __restrict__ shared, float* __restrict__ y,
                   int K, int d, int vec) {
  const size_t tok = blockIdx.x;
  const long long* rt = rows + tok * K;
  const float* wt = weights + tok * K;
  if (vec) {
    const int c = blockIdx.y * (kCombineCols / 4) + threadIdx.x;   // float4
    if (c >= d / 4) return;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int q = 0; q < K; ++q) {
      const float w = __ldg(wt + q);
      if (!(w > 0.f)) continue;   // not kept: selected away
      const float4 v = __ldg(reinterpret_cast<const float4*>(
                                 out + static_cast<size_t>(__ldg(rt + q)) * d) +
                             c);
      acc.x = __fadd_rn(acc.x, __fmul_rn(v.x, w));
      acc.y = __fadd_rn(acc.y, __fmul_rn(v.y, w));
      acc.z = __fadd_rn(acc.z, __fmul_rn(v.z, w));
      acc.w = __fadd_rn(acc.w, __fmul_rn(v.w, w));
    }
    if (shared != nullptr) {
      const float4 s =
          __ldg(reinterpret_cast<const float4*>(shared + tok * d) + c);
      acc.x = __fadd_rn(acc.x, s.x);
      acc.y = __fadd_rn(acc.y, s.y);
      acc.z = __fadd_rn(acc.z, s.z);
      acc.w = __fadd_rn(acc.w, s.w);
    }
    reinterpret_cast<float4*>(y + tok * d)[c] = acc;
  } else {
    for (int c = blockIdx.y * kCombineCols + threadIdx.x;
         c < d && c < (blockIdx.y + 1) * kCombineCols; c += blockDim.x) {
      float acc = 0.f;
      for (int q = 0; q < K; ++q) {
        const float w = __ldg(wt + q);
        if (!(w > 0.f)) continue;
        acc = __fadd_rn(acc, __fmul_rn(
                                 __ldg(out + static_cast<size_t>(__ldg(rt + q)) *
                                                 d + c),
                                 w));
      }
      if (shared != nullptr) acc = __fadd_rn(acc, __ldg(shared + tok * d + c));
      y[tok * d + c] = acc;
    }
  }
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

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// Blocks of moe_route's grid for n tokens (its grid depends on nothing
// else).
extern "C" int moe_route_grid(int n) {
  const int most = kRouteBlocksPerSm * sm_count();
  return n < most ? n : most;
}

// Routes n tokens (logits (n, E) f32; mask (n) uint8, nullptr for all
// real; x (n, d) f32, all contiguous) to their top_k of E experts, each
// expert over tpe consecutive slots, and lays the kept assignments out in
// the grouped crossbar kernel's buffer (slots padded to `tile` rows):
// experts (n, k) int64 and gate (n, k) f32 (renormalised when norm),
// margin (n) f32 (the k-th minus the (k+1)-th probability, +inf when
// E == k), aux (3) f32 (the load-balance loss, the router z-loss, 0
// dropped), rows and weights (n, k * tpe) (int64 buffer row and f32 gate
// times mask of each assignment; 0 and 0 where not kept), bases
// (E * tpe + 1) and counts (E * tpe) int32, and the kept x rows in xbuf
// (rows of d f32; only the rows of kept assignments are written). Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for
// arguments the kernel does not take). Allocates nothing, does not
// synchronise; runs on `stream`.
extern "C" int moe_route(const void* logits, const void* mask, const void* x,
                         void* experts, void* gate, void* margin, void* aux,
                         void* rows, void* weights, void* bases, void* counts,
                         void* xbuf, int n, int E, int k, int tpe, int norm,
                         int tile, int d, void* stream) {
  if (n <= 0 || E <= 0 || k <= 0 || k > kMaxTopK || k > E || tpe <= 0 ||
      E * tpe > kMaxSlots || k * tpe > kMaxAssign || tile <= 0 || d <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  RouteArgs a;
  a.logits = static_cast<const float*>(logits);
  a.mask = static_cast<const uint8_t*>(mask);
  a.x = static_cast<const float*>(x);
  a.experts = static_cast<long long*>(experts);
  a.gate = static_cast<float*>(gate);
  a.margin = static_cast<float*>(margin);
  a.aux = static_cast<float*>(aux);
  a.rows = static_cast<long long*>(rows);
  a.weights = static_cast<float*>(weights);
  a.bases = static_cast<int*>(bases);
  a.counts = static_cast<int*>(counts);
  a.xbuf = static_cast<float*>(xbuf);
  a.n = n;
  a.E = E;
  a.k = k;
  a.tpe = tpe;
  a.norm = norm != 0;
  a.tile = tile;
  a.d = d;
  a.vec = d % 4 == 0 && aligned16(x) && aligned16(xbuf);
  moe_route_kernel<<<moe_route_grid(n), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// y (n, d) f32 = sum over q < K of weights[t, q] * out[rows[t, q]] for
// each token t, over the assignments with a weight > 0 (in q order), plus
// shared[t] (nullptr: none): out (R, d) f32, rows (n, K) int64, weights
// (n, K) f32, shared (n, d) f32, all contiguous. Returns
// cudaGetLastError() after the launch. Allocates nothing, does not
// synchronise; runs on `stream`.
extern "C" int moe_combine(const void* out, const void* rows,
                           const void* weights, const void* shared, void* y,
                           int n, int K, int d, void* stream) {
  if (n <= 0 || K <= 0 || d <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int vec = d % 4 == 0 && aligned16(out) && aligned16(y) &&
                  (shared == nullptr || aligned16(shared));
  const dim3 grid(n, (d + kCombineCols - 1) / kCombineCols);
  moe_combine_kernel<<<grid, kCombineCols / 4, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(out), static_cast<const long long*>(rows),
      static_cast<const float*>(weights), static_cast<const float*>(shared),
      static_cast<float*>(y), K, d, vec);
  return static_cast<int>(cudaGetLastError());
}
