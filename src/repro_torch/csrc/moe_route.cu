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
// Bound: the bytes of the x copy at a mixed tick or a prompt (each kept
// token's row read once and written once a kept assignment); at a decode
// tick neither bytes nor operations (8 tokens move 0.3 MB, 0.1 us at
// 3.35 TB/s) but the chain of dependent steps of one launch. So each
// token is routed once, by a few lanes, in a few shuffle steps, and the
// grid spreads the bytes.
//
// moe_route: grid min(n x pieces, 2 x SMs) blocks of 256 threads, where a
//   copy unit is a (token, piece of kPiece floats) of x: set by the shapes,
//   so a CUDA graph replays it for any routing. Block b's copy units are
//   b, b + grid, ... (a ragged mask's live rows spread evenly).
//   - A token is routed by kLanes lanes (a lane holds experts lane, lane +
//     kLanes, ...; 4 tokens a warp at once): the max logit and the sum of
//     exp(l - max) by butterflies, then the k + 1 largest probabilities by
//     k + 1 arg-max butterflies over (probability, expert), ties to the
//     lower expert, as the plain version's order has them. Every sum is
//     taken in an order fixed by the shapes, so two calls give the same
//     bits.
//   - A routing item is kChunk tokens, one step of the block's warps: their
//     kept assignments set one bit each in their slot's mask (a token takes
//     a slot at most once), so an assignment's rank among the item's is a
//     popcount of the bits before its own.
//   - Up to kRouteAllMax tokens (a decode tick) every block routes them all
//     as one item and has every slot's count, each rank and, by a warp
//     scan over the slots, the padded bases at once; block 0 writes the
//     per-token outputs, the layout and the aux losses. (Block 0 routing
//     alone and the others waiting for it took twice as long:
//     benchmarks/torch_route_knobs.py.)
//   - Above it the items are dealt by an atomic ticket. Each item's block
//     writes its tokens' outputs, its slot counts, its probability and
//     z partial sums, and each assignment's slot and rank in the item to
//     the workspace, then draws a second ticket: the last item's block
//     scans the counts over the items in token order (each item's offset
//     in each slot), sets the padded bases and raises a flag, then writes
//     the counts and reduces the aux partials in a fixed order (lanes over
//     items, then a butterfly). A block waits for the flag only once it
//     has drawn a ticket past the last item, so it waits only on blocks
//     that are running: the grid need not be resident. An assignment's
//     row is its slot's base plus its item's offset in the slot plus its
//     rank in the item: the JAX package's cumsum rank over the whole batch
//     in (token, k, slot) order, pads claiming none.
//   - Each block's first kRing copy units are fetched into shared memory
//     (cp.async, 16 bytes a thread where vec) before it routes or waits;
//     then each unit goes from there to a row of each kept assignment,
//     the unit kRing on fetched in its place. A pad's unit is not read.
//     Buffer rows that hold no kept assignment are not written: the
//     grouped crossbar kernels read a slot's rows only up to its count (x
//     past it reads as 0) and no row past the last slot's. The last block
//     out resets the tickets and the flag for the next call.
// moe_combine: one block a (token, 1024 columns): y = sum over the token's
//   kept assignments, in order, of gate x its buffer row (a product, then
//   a sum, each rounded: the plain version's numbers), plus the shared
//   expert's output where the layer has one.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSlots = 128;          // slots: experts x tpe
constexpr int kMaxTopK = 8;             // experts a token takes
constexpr int kMaxAssign = 16;          // slots a token takes: top_k x tpe
constexpr int kLanes = 8;               // lanes that route a token
constexpr int kChunk = 32;              // tokens of a routing item
constexpr int kRouteAllMax = 32;        // up to this, every block routes all
constexpr int kRouteBlocksPerSm = 2;
constexpr int kPiece = 4 * kThreads;    // floats of a copy unit: 4 a thread
constexpr int kRing = 8;                // copy units in flight a block
constexpr int kPollNs = 32;             // a waiting block's pause between
                                        // polls of the flag
constexpr int kRowCap = 512;            // assignments' rows a block holds
// workspace ints before the counts: the item ticket, the done ticket, the
// exit count and the flag, each on a 128-byte line of its own
constexpr int kTicket = 0, kDone = 32, kExit = 64, kFlag = 96, kCtl = 128;
constexpr int kCombineCols = 1024;      // columns of a combine block
static_assert(kRouteAllMax <= kChunk, "one item holds a decode tick");
static_assert(kChunk <= 32, "a slot's mask of an item is 32 bits");
static_assert(kChunk * kMaxAssign <= kRowCap, "a decode tick's rows fit");

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
  float* wsf;            // workspace: each item's prob sums (E) and z
  int* wsi;              // tickets; top-1 counts (E); each item's slot
                         // counts, then offsets (slots); each assignment's
                         // slot and rank in its item (n * K)
  int n, E, k, tpe, norm, tile, d, vec;
  int slots, K, items, pieces, units;
};

struct Shared {
  unsigned hit[kMaxSlots];            // the item's tokens on each slot
  int slot[kChunk][kMaxAssign];       // each token's kept slots (-1: not)
  float selp[kChunk][kMaxTopK + 1];   // each token's k + 1 largest
  int sele[kChunk][kMaxTopK + 1];     // probabilities and their experts
  float wpsum[kWarps][kMaxSlots];     // each warp's probability sums
  float wz[kWarps];                   // each warp's lse^2 sum
  int top1[kMaxSlots];                // tokens whose first expert it is
  int tot[kMaxSlots];                 // each slot's kept assignments
  int base[kMaxSlots + 1];            // the slots' padded bases
  float red[kMaxSlots + 1];           // each expert's prob sum; z last
  int row[kRowCap];                   // a window's rows (-1: not kept)
  bool live[kRowCap + kRing];         // whose token is real: the window's
                                      // units and the kRing after them
  int item, last;
};

constexpr unsigned kFull = 0xffffffffu;

// A ticket: acq_rel at gpu scope. After a __syncthreads and a fence it
// publishes the block's stores (release) and, for the block that draws the
// last one, makes every other block's visible after the next
// __syncthreads (acquire).
__device__ __forceinline__ int draw_ticket(int* ticket) {
  int old;
  asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;\n"
               : "=r"(old)
               : "l"(ticket)
               : "memory");
  return old;
}

// A poll of the flag: a volatile asm, so that a loop of them stays a loop.
__device__ __forceinline__ int load_relaxed(const int* p) {
  int v;
  asm volatile("ld.relaxed.gpu.global.b32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void store_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;\n" ::"l"(p), "r"(v)
               : "memory");
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// Tokens tok0 .. tok0 + ntok - 1 (ntok <= kChunk) routed by the block's
// warps, kLanes lanes a token (PM experts a lane: E <= kLanes PM), 32 /
// kLanes tokens a warp at once (an item in one step): each kept
// assignment's bit in sh.hit and its slot in sh.slot (sh.hit and sh.top1
// zeroed before), the first experts' counts in sh.top1, each warp's
// probability and lse^2 sums (its tokens in order, then its token groups
// by a butterfly) in sh.wpsum and sh.wz, each token's k + 1 largest
// probabilities and experts in sh.selp / sh.sele. With `write`, the
// per-token outputs: experts, gate, margin and each assignment's weight.
template <int PM>
__device__ void route_tokens(const RouteArgs& a, Shared& sh, int tok0,
                             int ntok, bool write) {
  constexpr int W = kLanes, TPW = 32 / kLanes;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gl = lane % W, grp = lane / W;
  const float ninf = __int_as_float(0xff800000);
  const int top = a.k + 1 < a.E ? a.k + 1 : a.E;
  float acc[PM];
#pragma unroll
  for (int i = 0; i < PM; ++i) acc[i] = 0.f;
  float zacc = 0.f;
  for (int t0 = warp * TPW; t0 < ntok; t0 += kWarps * TPW) {
    const int tl = t0 + grp;
    const bool valid = tl < ntok;
    const int tok = tok0 + (valid ? tl : 0);
    const float* l = a.logits + static_cast<size_t>(tok) * a.E;
    float p[PM], q[PM];
    float mx = ninf;
#pragma unroll
    for (int i = 0; i < PM; ++i) {
      const int e = gl + W * i;
      p[i] = e < a.E ? __ldg(l + e) : ninf;
      mx = fmaxf(mx, p[i]);
    }
#pragma unroll
    for (int o = W / 2; o > 0; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < PM; ++i) {
      p[i] = gl + W * i < a.E ? expf(p[i] - mx) : 0.f;
      sum += p[i];
    }
#pragma unroll
    for (int o = 1; o < W; o <<= 1) sum += __shfl_xor_sync(kFull, sum, o);
#pragma unroll
    for (int i = 0; i < PM; ++i) {
      const bool in = gl + W * i < a.E;
      p[i] = in ? p[i] / sum : 0.f;
      q[i] = in ? p[i] : -1.f;   // taken ones become -2
    }
    // the k + 1 largest probabilities, ties to the lower expert, into
    // sh.selp / sh.sele, a round a step (rolled: unrolled, the rounds
    // would be most of the code that a launch fetches into a cold
    // instruction cache)
#pragma unroll 1
    for (int j = 0; j < top; ++j) {
      float bv = -1.f;
      int be = 0x7fffffff;
#pragma unroll
      for (int i = 0; i < PM; ++i)
        if (q[i] > bv) {
          bv = q[i];
          be = gl + W * i;
        }
#pragma unroll
      for (int o = W / 2; o > 0; o >>= 1) {
        const float ov = __shfl_xor_sync(kFull, bv, o);
        const int oe = __shfl_xor_sync(kFull, be, o);
        if (ov > bv || (ov == bv && oe < be)) {
          bv = ov;
          be = oe;
        }
      }
#pragma unroll
      for (int i = 0; i < PM; ++i)
        if (gl + W * i == be) q[i] = -2.f;
      if (valid && gl == 0) {
        sh.selp[tl][j] = bv;
        sh.sele[tl][j] = be;
      }
    }
    __syncwarp();
    if (valid) {
      const float* sp = sh.selp[tl];
      const int* se = sh.sele[tl];
      const float m = a.mask == nullptr || a.mask[tok] != 0 ? 1.f : 0.f;
      float s = 0.f;
      for (int j = 0; j < a.k; ++j) s += sp[j];
      const float den = fmaxf(s, 1e-9f);
      if (write) {
        for (int j = gl; j < a.k; j += W) {
          const size_t o = static_cast<size_t>(tok) * a.k + j;
          a.experts[o] = se[j];
          a.gate[o] = a.norm ? sp[j] / den : sp[j];
        }
        if (gl == 0)
          a.margin[tok] = a.E > a.k ? sp[a.k - 1] - sp[a.k]
                                    : __int_as_float(0x7f800000);   // +inf
      }
      for (int qa = gl; qa < a.K; qa += W) {
        const int j = qa / a.tpe;
        const float sg = (a.norm ? sp[j] / den : sp[j]) * m;
        const bool kept = sg > 0.f;
        const int sl = se[j] * a.tpe + qa % a.tpe;
        sh.slot[tl][qa] = kept ? sl : -1;
        if (kept) atomicOr(&sh.hit[sl], 1u << tl);
        if (write)
          a.weights[static_cast<size_t>(tok) * a.K + qa] = kept ? sg : 0.f;
      }
      if (gl == 0) atomicAdd(&sh.top1[se[0]], 1);   // integers: any order
#pragma unroll
      for (int i = 0; i < PM; ++i) acc[i] += p[i];
      const float lse = mx + logf(sum);
      if (gl == 0) zacc += lse * lse;
    }
  }
#pragma unroll
  for (int o = W; o < 32; o <<= 1)
#pragma unroll
    for (int i = 0; i < PM; ++i) acc[i] += __shfl_xor_sync(kFull, acc[i], o);
  zacc = warp_sum(zacc);
  if (grp == 0) {
#pragma unroll
    for (int i = 0; i < PM; ++i)
      if (gl + W * i < a.E) sh.wpsum[warp][gl + W * i] = acc[i];
  }
  if (lane == 0) sh.wz[warp] = zacc;
}

// The padded bases of the slots' counts in sh.tot, by one warp (4 slots a
// lane, then a scan over the lanes): sh.base[0 .. slots].
__device__ __forceinline__ void scan_bases(Shared& sh, int slots, int tile) {
  const int lane = threadIdx.x & 31;
  int pre[4], run = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = 4 * lane + i;
    pre[i] = run;
    if (s < slots) run += (sh.tot[s] + tile - 1) / tile * tile;
  }
  int inc = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(kFull, inc, o);
    if (lane >= o) inc += v;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (4 * lane + i < slots) sh.base[4 * lane + i] = inc - run + pre[i];
  if (lane == 31) sh.base[slots] = inc;
}

// Switch's load-balance loss and the router z-loss from the top-1 counts
// (`top1`), the experts' probability sums and the lse^2 sum (sh.red[E]),
// by one warp: aux[0..2].
__device__ __forceinline__ void write_aux(const RouteArgs& a, const Shared& sh,
                                          const int* top1) {
  const int lane = threadIdx.x & 31;
  const float n = static_cast<float>(a.n);
  float lb = 0.f;
  for (int e = lane; e < a.E; e += 32)
    lb += (static_cast<float>(top1[e]) / n) * (sh.red[e] / n);
  lb = warp_sum(lb);
  if (lane == 0) {
    a.aux[0] = static_cast<float>(a.E) * lb;
    a.aux[1] = sh.red[a.E] / n;
    a.aux[2] = 0.f;
  }
}

// The block's copy units are u = blockIdx.x + G i (i < their count),
// dealt round the grid so that a ragged mask's live rows spread evenly.
__device__ __forceinline__ int block_units(const RouteArgs& a) {
  const int G = static_cast<int>(gridDim.x), b = static_cast<int>(blockIdx.x);
  return b < a.units ? (a.units - b + G - 1) / G : 0;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_ring() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kRing - 1) : "memory");
}

// The copy ring in dynamic shared memory: kRing units of 4 floats a
// thread, each thread's own (it copies in and reads back only its own
// bytes, so the ring needs no barrier).
__device__ __forceinline__ float* ring_slot(int i) {
  extern __shared__ float4 ring[];
  return reinterpret_cast<float*>(ring + (i % kRing) * kThreads +
                                  threadIdx.x);
}

// Whether unit i of the block holds a real token (a pad's is not copied:
// no row holds it).
__device__ __forceinline__ bool unit_live(const RouteArgs& a, int i) {
  const int u = static_cast<int>(blockIdx.x) + static_cast<int>(gridDim.x) * i;
  return a.mask == nullptr || a.mask[u / a.pieces] != 0;
}

// Starts the copy of unit i of the block into its ring slot when `live`,
// and commits a group (an empty one else).
__device__ __forceinline__ void fetch_unit(const RouteArgs& a, int i,
                                           bool live) {
  const int tid = threadIdx.x;
  if (live) {
    const int u = static_cast<int>(blockIdx.x) +
                  static_cast<int>(gridDim.x) * i;
    const int tok = u / a.pieces;
    const int off = (u % a.pieces) * kPiece, cols = a.d - off;
    const float* src = a.x + static_cast<size_t>(tok) * a.d + off;
    float* dst = ring_slot(i);
    if (a.vec) {
      if (4 * tid < cols) cp_async16(dst, src + 4 * tid);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (tid + j * kThreads < cols)
          cp_async4(dst + j, src + tid + j * kThreads);
    }
  }
  cp_async_commit();
}

// The block's first kRing units (all of them, if fewer), fetched before
// the layout is known; their masks read at once, a thread each (one after
// another, each a round trip, they would hold the fetches back).
__device__ __forceinline__ void prefetch_units(const RouteArgs& a,
                                               Shared& sh) {
  const int nu = block_units(a), np = nu < kRing ? nu : kRing;
  if (static_cast<int>(threadIdx.x) < np)
    sh.live[threadIdx.x] = unit_live(a, threadIdx.x);
  __syncthreads();
#pragma unroll 1
  for (int i = 0; i < np; ++i) fetch_unit(a, i, sh.live[i]);
}

// The block's units into the buffer, a window of them at a time: their
// tokens' rows first (from the block's own layout in shared memory when
// `pack` is null, else from the workspace: each assignment's slot and
// rank in its item, the item's offset in the slot and the slot's base;
// the unit of a token's first piece then writes its rows out), then each
// unit's ring slot into a row of each kept assignment, the unit kRing on
// fetched in its place when the block has more than kRing units.
// prefetch_units ran before.
__device__ void copy_units(const RouteArgs& a, Shared& sh, const int* pack,
                           const int* off) {
  const int tid = threadIdx.x, G = static_cast<int>(gridDim.x);
  const int nu = block_units(a);
  const bool ring = nu > kRing;   // else every unit is in already
  if (!ring) asm volatile("cp.async.wait_all;\n" ::: "memory");
  const int win = kRowCap / a.K;
  for (int w0 = 0; w0 < nu; w0 += win) {
    const int ni = w0 + win < nu ? w0 + win : nu;
    for (int i = tid; i < (ni - w0) * a.K; i += kThreads) {
      const int u = static_cast<int>(blockIdx.x) + G * (w0 + i / a.K);
      const int tok = u / a.pieces, q = i % a.K;
      int row = -1;
      if (pack == nullptr) {
        const int s = sh.slot[tok][q];
        if (s >= 0) row = sh.base[s] + __popc(sh.hit[s] & ((1u << tok) - 1u));
      } else {
        const size_t o = static_cast<size_t>(tok) * a.K + q;
        const int pk = __ldcg(pack + o);
        if (pk >= 0) {
          const int s = pk & 255;
          row = __ldcg(a.bases + s) +
                __ldcg(off + static_cast<size_t>(tok / kChunk) * a.slots + s) +
                (pk >> 8);
        }
        if (u % a.pieces == 0) a.rows[o] = row >= 0 ? row : 0;
      }
      sh.row[i] = row;
    }
    if (ring)   // whose units this window's steps fetch: unit i + kRing
      for (int j = tid; j < ni - w0; j += kThreads) {
        const int f = w0 + kRing + j;
        sh.live[kRing + j] = f < nu && unit_live(a, f);
      }
    __syncthreads();
    for (int i = w0; i < ni; ++i) {
      if (ring) cp_async_wait_ring();   // unit i's group is in
      const int u = static_cast<int>(blockIdx.x) + G * i;
      const int off_u = (u % a.pieces) * kPiece, cols = a.d - off_u;
      const float* src = ring_slot(i);
      const int* r = sh.row + (i - w0) * a.K;
      for (int q = 0; q < a.K; ++q) {
        const int row = r[q];
        if (row < 0) continue;
        float* dst = a.xbuf + static_cast<size_t>(row) * a.d + off_u;
        if (a.vec) {
          if (4 * tid < cols)
            reinterpret_cast<float4*>(dst)[tid] =
                *reinterpret_cast<const float4*>(src);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (tid + j * kThreads < cols) dst[tid + j * kThreads] = src[j];
        }
      }
      if (ring) fetch_unit(a, i + kRing, sh.live[kRing + i - w0]);
    }
    __syncthreads();
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Up to kRouteAllMax tokens: every block routes them all; block 0 writes
// everything but the buffer; each block copies its units.
template <int PM>
__device__ void route_all(const RouteArgs& a, Shared& sh) {
  const int tid = threadIdx.x, warp = tid >> 5;
  const bool first = blockIdx.x == 0;
  prefetch_units(a, sh);   // the x copy's first units, under the routing
  for (int s = tid; s < a.slots; s += kThreads) {
    sh.hit[s] = 0u;
    sh.top1[s] = 0;
  }
  __syncthreads();
  route_tokens<PM>(a, sh, 0, a.n, first);
  __syncthreads();
  for (int s = tid; s < a.slots; s += kThreads) sh.tot[s] = __popc(sh.hit[s]);
  if (first) {
    for (int e = tid; e <= a.E; e += kThreads) {
      float t = 0.f;
      for (int w = 0; w < kWarps; ++w)
        t += e < a.E ? sh.wpsum[w][e] : sh.wz[w];
      sh.red[e] = t;
    }
  }
  __syncthreads();
  if (warp == 0) scan_bases(sh, a.slots, a.tile);
  if (first && warp == 1) write_aux(a, sh, sh.top1);
  __syncthreads();
  if (first) {
    for (int s = tid; s <= a.slots; s += kThreads) {
      a.bases[s] = sh.base[s];
      if (s < a.slots) a.counts[s] = sh.tot[s];
    }
  }
  if (first) {
    for (int i = tid; i < a.n * a.K; i += kThreads) {
      const int tl = i / a.K, s = sh.slot[tl][i % a.K];
      a.rows[i] =
          s >= 0 ? sh.base[s] + __popc(sh.hit[s] & ((1u << tl) - 1u)) : 0;
    }
  }
  copy_units(a, sh, nullptr, nullptr);
}

// The last item's block: each slot's offset in each item (the counts
// scanned over the items in token order, in place) and total, and the
// padded bases; then the flag; then the counts and the aux losses from the
// items' partials summed in a fixed order (lanes over items, then a
// butterfly).
__device__ void finish(const RouteArgs& a, Shared& sh, int* ctl, int* top1,
                       int* off, const float* part) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  constexpr int kS = kMaxSlots / kWarps;       // slots a warp
  constexpr int kP = kMaxSlots / kWarps + 1;   // sums a warp (z last)
  int carry[kS];
  float ps[kP];
#pragma unroll
  for (int i = 0; i < kS; ++i) carry[i] = 0;
#pragma unroll
  for (int i = 0; i < kP; ++i) ps[i] = 0.f;
  for (int c0 = 0; c0 < a.items; c0 += 32) {
    const int c = c0 + lane;
    const bool in = c < a.items;
    int v[kS];
    float w[kP];
#pragma unroll
    for (int i = 0; i < kS; ++i) {
      const int s = warp + kWarps * i;
      v[i] = in && s < a.slots
                 ? __ldcg(off + static_cast<size_t>(c) * a.slots + s)
                 : 0;
    }
#pragma unroll
    for (int i = 0; i < kP; ++i) {
      const int e = warp + kWarps * i;
      w[i] = in && e <= a.E
                 ? __ldcg(part + static_cast<size_t>(c) * (a.E + 1) + e)
                 : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kS; ++i) {
      const int s = warp + kWarps * i;
      if (s >= a.slots) continue;
      int inc = v[i];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int t = __shfl_up_sync(kFull, inc, o);
        if (lane >= o) inc += t;
      }
      if (in) off[static_cast<size_t>(c) * a.slots + s] = carry[i] + inc - v[i];
      carry[i] += __shfl_sync(kFull, inc, 31);
    }
#pragma unroll
    for (int i = 0; i < kP; ++i) ps[i] += w[i];
  }
#pragma unroll
  for (int i = 0; i < kS; ++i) {
    const int s = warp + kWarps * i;
    if (s < a.slots && lane == 0) sh.tot[s] = carry[i];
  }
  __syncthreads();
  if (warp == 0) scan_bases(sh, a.slots, a.tile);
  __syncthreads();
  for (int s = tid; s <= a.slots; s += kThreads) a.bases[s] = sh.base[s];
  if (tid == 0) ctl[kDone] = 0;   // ready for the next call
  __syncthreads();
  if (tid == 0) {   // the block's offsets and bases, then the flag
    __threadfence();
    store_release(ctl + kFlag, 1);
  }
  // after the flag: what no block reads
  for (int s = tid; s < a.slots; s += kThreads) a.counts[s] = sh.tot[s];
#pragma unroll
  for (int i = 0; i < kP; ++i) {
    const int e = warp + kWarps * i;
    const float t = warp_sum(ps[i]);
    if (e <= a.E && lane == 0) sh.red[e] = t;
  }
  __syncthreads();
  if (warp == 1) {
    for (int e = lane; e < a.E; e += 32) sh.top1[e] = __ldcg(top1 + e);
    __syncwarp();
    write_aux(a, sh, sh.top1);
    for (int e = lane; e < a.E; e += 32) top1[e] = 0;   // the next call's
  }
}

// Above kRouteAllMax tokens: items by ticket, the last one's block
// finishes the layout, every block waits for it past its last item, then
// writes its tokens' rows and copies its units.
template <int PM>
__device__ void route_items(const RouteArgs& a, Shared& sh) {
  const int tid = threadIdx.x;
  int* ctl = a.wsi;
  int* top1 = ctl + kCtl;
  int* off = top1 + a.E;
  int* pack = off + static_cast<size_t>(a.items) * a.slots;
  float* part = a.wsf;
  while (true) {
    if (tid == 0) sh.item = atomicAdd(ctl + kTicket, 1);
    for (int s = tid; s < a.slots; s += kThreads) {
      sh.hit[s] = 0u;
      sh.top1[s] = 0;
    }
    __syncthreads();
    const int c = sh.item;
    if (c >= a.items) break;
    const int tok0 = c * kChunk;
    const int ntok = a.n - tok0 < kChunk ? a.n - tok0 : kChunk;
    route_tokens<PM>(a, sh, tok0, ntok, true);
    __syncthreads();
    for (int s = tid; s < a.slots; s += kThreads)
      off[static_cast<size_t>(c) * a.slots + s] = __popc(sh.hit[s]);
    for (int e = tid; e <= a.E; e += kThreads) {
      float t = 0.f;
      for (int w = 0; w < kWarps; ++w)
        t += e < a.E ? sh.wpsum[w][e] : sh.wz[w];
      part[static_cast<size_t>(c) * (a.E + 1) + e] = t;
      if (e < a.E && sh.top1[e] != 0) atomicAdd(top1 + e, sh.top1[e]);
    }
    for (int i = tid; i < ntok * a.K; i += kThreads) {
      const int tl = i / a.K, s = sh.slot[tl][i % a.K];
      pack[static_cast<size_t>(tok0) * a.K + i] =
          s >= 0 ? s | __popc(sh.hit[s] & ((1u << tl) - 1u)) << 8 : -1;
    }
    __syncthreads();
    if (tid == 0) {   // the block's stores and adds, then the ticket
      __threadfence();
      sh.last = draw_ticket(ctl + kDone) == a.items - 1;
    }
    __syncthreads();
    if (sh.last) finish(a, sh, ctl, top1, off, part);
    __syncthreads();
  }
  prefetch_units(a, sh);   // the x copy's first units, under the wait
  if (tid == 0) {   // relaxed polls, then one acquire fence
    while (load_relaxed(ctl + kFlag) == 0)
      if (kPollNs > 0) __nanosleep(kPollNs);
    asm volatile("fence.acq_rel.gpu;\n" ::: "memory");
  }
  __syncthreads();
  copy_units(a, sh, pack, off);
  if (tid == 0 &&
      atomicAdd(ctl + kExit, 1) == static_cast<int>(gridDim.x) - 1) {
    ctl[kTicket] = 0;   // every block has drawn its last ticket, seen the flag
    ctl[kExit] = 0;
    ctl[kFlag] = 0;
  }
}

template <int PM>
__global__ void __launch_bounds__(kThreads)
moe_route_kernel(const RouteArgs a) {
  __shared__ Shared sh;
  if (a.n <= kRouteAllMax)
    route_all<PM>(a, sh);
  else
    route_items<PM>(a, sh);
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

int route_items_of(int n) { return (n + kChunk - 1) / kChunk; }

constexpr int kRingBytes = kRing * kPiece * sizeof(float);

template <int PM>
cudaError_t launch_route(const RouteArgs& a, int grid, cudaStream_t stream) {
  static bool configured = false;  // one attribute call per instantiation
  if (!configured) {
    const cudaError_t err =
        cudaFuncSetAttribute(moe_route_kernel<PM>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kRingBytes);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  moe_route_kernel<PM><<<grid, kThreads, kRingBytes, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// Blocks of moe_route's grid for n tokens of width d (its grid depends on
// nothing else): a block a copy unit, at most 2 an SM.
extern "C" int moe_route_grid(int n, int d) {
  const long long units =
      static_cast<long long>(n) * ((d + kPiece - 1) / kPiece);
  const int most = kRouteBlocksPerSm * sm_count();
  return units < most ? static_cast<int>(units) : most;
}

// The workspace moe_route needs for n tokens over E experts, top_k, tpe
// slots an expert: returns its f32 partials and sets *tickets to its int32
// count (both 0 up to kRouteAllMax tokens, where it takes none). The
// tickets must be 0 before the first call; every call leaves them so.
extern "C" size_t moe_route_workspace(int n, int E, int k, int tpe,
                                      int* tickets) {
  *tickets = 0;
  if (n <= kRouteAllMax || E <= 0 || k <= 0 || tpe <= 0) return 0;
  const int items = route_items_of(n);
  *tickets = kCtl + E + items * E * tpe + n * k * tpe;
  return static_cast<size_t>(items) * (E + 1);
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
// (rows of d f32; only the rows of kept assignments are written).
// partials / tickets: the workspace (moe_route_workspace; n_partials and
// n_tickets its sizes). Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for arguments the kernel does not take or a
// workspace too small). Allocates nothing, does not synchronise; runs on
// `stream`.
extern "C" int moe_route(const void* logits, const void* mask, const void* x,
                         void* experts, void* gate, void* margin, void* aux,
                         void* rows, void* weights, void* bases, void* counts,
                         void* xbuf, void* partials, size_t n_partials,
                         void* tickets, int n_tickets, int n, int E, int k,
                         int tpe, int norm, int tile, int d, void* stream) {
  if (n <= 0 || E <= 0 || k <= 0 || k > kMaxTopK || k > E || tpe <= 0 ||
      E * tpe > kMaxSlots || k * tpe > kMaxAssign || tile <= 0 || d <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int need_t = 0;
  const size_t need_p = moe_route_workspace(n, E, k, tpe, &need_t);
  if (n_partials < need_p || n_tickets < need_t ||
      (need_t > 0 && (partials == nullptr || tickets == nullptr)))
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
  a.wsf = static_cast<float*>(partials);
  a.wsi = static_cast<int*>(tickets);
  a.n = n;
  a.E = E;
  a.k = k;
  a.tpe = tpe;
  a.norm = norm != 0;
  a.tile = tile;
  a.d = d;
  a.vec = d % 4 == 0 && aligned16(x) && aligned16(xbuf);
  a.slots = E * tpe;
  a.K = k * tpe;
  a.items = route_items_of(n);
  a.pieces = (d + kPiece - 1) / kPiece;
  a.units = n * a.pieces;
  const int grid = moe_route_grid(n, d);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      E <= kLanes       ? launch_route<1>(a, grid, s)
      : E <= 2 * kLanes ? launch_route<2>(a, grid, s)
      : E <= 4 * kLanes ? launch_route<4>(a, grid, s)
      : E <= 8 * kLanes ? launch_route<8>(a, grid, s)
                        : launch_route<16>(a, grid, s);
  return static_cast<int>(err);
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
