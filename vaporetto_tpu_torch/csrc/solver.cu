// FISTA gradient step of the linear-classifier trainer, for Hopper (sm_90a).
//
// Replaces the XLA loop bodies of the JAX package's solver
// (vaporetto_tpu/train/solver.py): _binary_ops (:158, the sparse X.w
// gather, the loss derivative, X^T r by segment_sum, the L2 term),
// _fista_power (:186, the power iteration's X^T X v), _fista_advance (:210,
// the prox, the momentum step and max |w_new - w|) and _fista_cs_advance
// (:305, the same for the smoothed Crammer-Singer objective over C
// classes). One FISTA iteration is two launches:
//   rows - a thread per example over a sliced layout (SELL-32: slices of
//          32 consecutive examples, each slice as wide as its longest
//          example, stored step-major so that step k of a warp reads the
//          k-th entry of its 32 examples as one coalesced load): the
//          margin(s) over the example's entries in order, then the loss
//          derivative dloss(y m) y (logistic, squared hinge, smoothed
//          hinge), or softmax((m + 1 - onehot) / mu) - onehot over C
//          classes; in power mode the plain margin X v;
//   cols - the feature-major sums of val * dl, then the update of each
//          feature: g = cost * sum (+ z for L2), w_new = prox(z - step g),
//          z_new = w_new + ((t - 1) / t_new)(w_new - w), and the largest
//          |w_new - w|; in power mode it writes X^T r instead. A feature
//          with at most SHORT entries (most of them) takes one thread,
//          which adds its entries in ascending example order: the short
//          features are sorted by entry count (stably) and cut into
//          slices of 32, stored step-major like rows' slices, so a warp's
//          threads share one trip count and read one line a step. A longer
//          feature is cut into segments of at most SEG entries, a warp
//          each (lanes strided, an xor butterfly), and the warp that
//          finishes a feature's last segment adds its segment sums in
//          segment order and applies the update. SHORT and SEG are the
//          host's (ops/solver.py), as are the layouts.
// A solve whose examples are split over several shards (a mesh, or
// several processes; train/solver.py) needs every shard's sums before any
// update, so its iteration is three launches a shard and a reduction:
//   rows        - as above, over the shard's examples;
//   cols<PART>  - the same sums in the same orders, each visited feature's
//                 (C of them for Crammer-Singer) stored into a dense
//                 n_dim C buffer (out) in place of the update: no point
//                 loaded, no delta, no state;
//   (the host adds the shards' buffers in a fixed order, the same on
//    every rank, into g)
//   update      - a pass over the live prefix of w, z and g (the
//                 features up to the largest id with an entry on some
//                 shard), four (feature, class) elements a thread at a
//                 time, strided over the grid: the same update() of g,
//                 then the delta and the stopping state exactly as cols
//                 ends an iteration, so every shard and rank runs the same
//                 iterations with no collective for the stop.
// Features with no entry keep w = z = 0 (their gradient is z, starting
// at 0), so cols does not visit them; slot 0 (padding) has no entry. The
// update of such a feature inside the prefix leaves it at +0 with a delta
// of 0, the same bits; past the prefix (the power-of-two padding of n_dim)
// nothing touches them. Padded
// examples (rows n..N-1, which the JAX package masks out) are in no slice:
// rows writes no dl for them and no feature's entries name them.
//
// Determinism. Every sum runs in an order fixed by the layout: a thread
// adds its example's entries (rows) or its short feature's entries (cols)
// in order, a segment's lanes add strided entries in order and combine by
// an xor butterfly (IEEE addition commutes, so every lane holds the same
// bits), and a feature's segment sums are added the same way whichever
// warp finishes last. There are no float atomics; the global max of
// |w_new - w| takes an atomicMax on the float's bits, exact in any order
// for non-negative values (a NaN, whose bits are larger than inf's, wins
// as jnp.max would return it). So two solves on the same input give the
// same bits, which the trainer's truncating quantization needs.
//
// The stopping test lives on the card. state = (it, active, delta bits,
// delta accumulator bits, block ticket): the last block of each cols
// launch stores delta, advances it and sets active to the JAX while_loop's
// cond (it < max_iter and (it < 8 or delta > eps step 100)); both kernels
// return at once while active is 0. The host launches a chunk of
// iterations and reads (it, delta) once, so the solve runs exactly the
// iterations the JAX loop runs, whatever the chunk. The momentum sequence
// t_k is data-independent: the host computes it in float32 (tseq).
//
// What bounds it on this card. The work is bytes: per iteration each live
// entry (id and value, 8 B) is streamed once by each kernel, dl is written
// and read, w and z of the visited features are read and written (about
// 1 GB for the boundary trainer's corpus, 0.3 ms at 3.35 TB/s); there is
// no arithmetic to speak of. What held the first version back was
// latency: a warp per example of ~31 entries gave each lane one entry, so
// a warp had one load per array in flight and then waited through three
// dependent round trips (row pointer, entry, gather of z) and a
// butterfly; a short feature's thread walked four dependent loads (its
// id, its column pointers, its entries, the gather of dl) with one load
// in flight, beside neighbours of other lengths. The design here removes
// the indirection and keeps loads in flight:
//   - the slices carry their own offsets (two neighbouring ints a warp),
//     and the entry arrays are (id, value) pairs read as one 8-byte load,
//     coalesced across the warp, evict-first (they are streamed once an
//     iteration; z and dl, gathered, stay in the L2);
//   - a thread loads UNROLL entries, then issues their UNROLL gathers,
//     then adds them in order: UNROLL independent gathers in flight a
//     thread, where the first version had one a lane (4 was 9% slower on
//     the segments, 16 no faster);
//   - a short feature's w and z are loaded with its slice's entries, not
//     after its sum; cols' warps for the short features are persistent
//     (a slice of mostly one-entry features is little work beside a
//     block's end: its barrier and two atomics), the widest slices first;
//     a warp per segment stays one block's warp (persistent segment warps
//     were slower);
//   - Crammer-Singer reads each entry once for a block of CLASS_BLOCK
//     classes, the classes' values adjacent in z and dl (x[id C + c]) and
//     its margins in registers; above CLASS_BLOCK classes it loops over
//     class blocks and keeps the margins in dl until the softmax.
// What is left: on the boundary trainer's corpus rows runs at 0.72 of
// its half of the byte bound and cols at 0.50 (PERF.md). The gathers (z
// in rows, dl in cols) fetch a 32-byte sector from the L2 for each 4-byte
// value, and the long features' segments (71% of the entries there)
// gather dl for examples far apart.
// Features keep their ids. Renumbering them (the short ones by count, so
// a slice's w and z are contiguous, with rows gathering z by the new id)
// made cols 8% and rows 3% faster on that corpus: not worth mapping w, z,
// the power step's vectors and the plain version's back to the caller's
// order. The short features of a slice, sorted stably by count, are
// mostly neighbours in id order already.

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

// Mirrored field for field by ops/solver.py (_Args): every field is 8 bytes
// wide (floats travel as doubles), so the layout has no padding. An
// "entry" is an int2 (id, value's float bits).
struct VtSolverArgs {
  const int32_t* row_slice;  // (n_row_slices + 1,) first step of slice s;
                             // its width is the next one's minus its own
  const int2* row_ent;       // (32 row_slice[-1],) step k of slice s, lane
                             // l at (row_slice[s] + k) 32 + l: example
                             // 32 s + l's k-th entry (feature, value);
                             // (0, 0) pads
  const int32_t* col_slice;  // (n_col_slices + 1,) the same for the short
                             // features, by entry count
  const int32_t* short_feat; // (32 n_col_slices,) thread t's feature, -1
                             // past the last
  const int2* col_ent;       // (32 col_slice[-1],) step k, thread t: its
                             // feature's k-th entry (example, value),
                             // examples ascending; (-1, 0) pads
  const int32_t* long_feat;  // (n_long,) features of more than SHORT
                             // entries, ascending
  const int32_t* long_ptr;   // (n_long + 1,) long feature L's entries
  const int32_t* long_seg;   // (n_long + 1,) long feature L's segments
  const int32_t* seg_long;   // (n_seg,) segment s's long feature
  const int2* long_ent;      // (long_ptr[-1],) (example, value), by
                             // feature, examples ascending
  const float* y;            // (N,) +1 / -1 (binary losses)
  const int32_t* labels;     // (N,) class ids (Crammer-Singer)
  const float* x;            // (n_dim * C,) the point rows reads (z or v)
  float* w;                  // (n_dim * C,) iterate, feature-major
  float* z;                  // (n_dim * C,) momentum point
  float* dl;                 // (N * C,) rows' output
  float* partial;            // (n_seg * C,) segment sums
  int32_t* long_cnt;         // (n_long,) segments finished, 0 between
                             // launches
  float* out;                // (n_dim,) power mode: X^T r
  int32_t* state;            // (8,) it, active, delta, delta acc, ticket
  const float* tseq;         // (max_iter + 1,) t_0 = 1, t_k+1 of t_k
  const float* g;            // (n_dim * C,) update: the sums of every
                             // shard, feature-major
  int64_t n, n_dim, C;       // n: the examples (rows n..N-1 are padding)
  int64_t n_row_slices, n_col_slices, n_seg;
  int64_t seg_len;           // SEG: segment q of long feature L holds
                             // entries long_ptr[L] + q SEG .. (at most SEG)
  int64_t seg_blocks;        // cols: blocks [0, seg_blocks) take a segment
                             // a warp, the others stride over the short
                             // features' slices, a warp a slice
  int64_t power;             // 1: rows writes X x, cols writes X^T dl
  int64_t part;              // 1: cols<PART> (writes its sums into out)
  int64_t loss;              // 0 logistic, 1 squared hinge, 2 smoothed
                             // hinge, 3 Crammer-Singer
  int64_t l1, max_iter;
  double cost, step, thr, mu;  // thr = eps * step * 100 (float32)
  int64_t n_prefix;          // update: the elements of w, z and g it
                             // visits, (largest feature id + 1) C
};

namespace {

using Args = VtSolverArgs;

constexpr int WARPS = 8;         // warps per block
constexpr int SLICE = 32;        // examples (short features) of a slice
constexpr int UNROLL = 8;        // entries a thread loads before it adds
constexpr int CLASS_BLOCK = 8;   // Crammer-Singer classes kept in registers
constexpr int CS_UNROLL = 2;     // the same, for CLASS_BLOCK classes
constexpr unsigned FULL = 0xffffffffu;
constexpr int CRAMMER_SINGER = 3;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// d loss / d m at m = y w.x (solver.py _losses)
__device__ __forceinline__ float dloss(int64_t kind, float m, float mu) {
  if (kind == 0) return -1.0f / (1.0f + expf(m));  // -sigmoid(-m)
  if (kind == 1) return -2.0f * fmaxf(0.0f, 1.0f - m);
  return -fminf(fmaxf((1.0f - m) / mu, 0.0f), 1.0f);
}

// g[i] += val * x[id * C + c0 + i] (i < nc) over the n entries ent[0],
// ent[step], ..., each class in entry order, skipping pads (id == pad).
// U entries are loaded (evict-first: each is read once an iteration),
// then their U * nc gathers issued, then added in order.
template <int NB, int U>
__device__ __forceinline__ void gather_sums(
    const float* __restrict__ x, const int2* __restrict__ ent, int n,
    int step, int C, int c0, int nc, int pad, float (&g)[NB]) {
  for (int k = 0; k < n; k += U) {
    int2 e[U];
#pragma unroll
    for (int u = 0; u < U; ++u)
      e[u] = k + u < n ? __ldcs(ent + static_cast<int64_t>(k + u) * step)
                       : make_int2(pad, 0);
    float v[U][NB];
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int i = 0; i < NB; ++i)
        v[u][i] = e[u].x != pad && i < nc
                      ? __ldg(x + static_cast<int64_t>(e[u].x) * C + c0 + i)
                      : 0.0f;
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (e[u].x != pad) {
        const float val = __int_as_float(e[u].y);
#pragma unroll
        for (int i = 0; i < NB; ++i)
          if (i < nc) g[i] += val * v[u][i];
      }
  }
}

__device__ __forceinline__ float cs_shift(int c, int lab) {
  return c == lab ? 0.0f : 1.0f;
}

// The Crammer-Singer derivative of one example from its margins: d[c] =
// softmax((m + 1 - onehot) / mu)_c - onehot_c, the maximum and the sum
// over c in order. m is the registers' copy when C <= CLASS_BLOCK, else
// the margins are read back from d.
__device__ void cs_softmax(float (&m)[CLASS_BLOCK], float* d, int C,
                           int lab, float mu) {
  float smax = -INFINITY, se = 0.0f;
  if (C <= CLASS_BLOCK) {
#pragma unroll
    for (int i = 0; i < CLASS_BLOCK; ++i)
      if (i < C) smax = fmaxf(smax, (m[i] + cs_shift(i, lab)) / mu);
#pragma unroll
    for (int i = 0; i < CLASS_BLOCK; ++i)
      if (i < C) {
        m[i] = expf((m[i] + cs_shift(i, lab)) / mu - smax);
        se += m[i];
      }
#pragma unroll
    for (int i = 0; i < CLASS_BLOCK; ++i)
      if (i < C) d[i] = m[i] / se - (i == lab ? 1.0f : 0.0f);
    return;
  }
  for (int c = 0; c < C; ++c)
    smax = fmaxf(smax, (d[c] + cs_shift(c, lab)) / mu);
  for (int c = 0; c < C; ++c) {
    const float e = expf((d[c] + cs_shift(c, lab)) / mu - smax);
    d[c] = e;
    se += e;
  }
  for (int c = 0; c < C; ++c) d[c] = d[c] / se - (c == lab ? 1.0f : 0.0f);
}

// A warp per slice of 32 examples, a thread per example.
template <bool CS>
__global__ void __launch_bounds__(WARPS * 32) rows_kernel(const Args a) {
  if (!a.power && !a.state[1]) return;
  const int lane = threadIdx.x & 31;
  const int64_t s =
      static_cast<int64_t>(blockIdx.x) * WARPS + (threadIdx.x >> 5);
  if (s >= a.n_row_slices) return;
  const int k0 = a.row_slice[s], width = a.row_slice[s + 1] - k0;
  const int2* ent = a.row_ent + static_cast<int64_t>(k0) * SLICE + lane;
  const int64_t r = s * SLICE + lane;
  const float mu = static_cast<float>(a.mu);
  if (!CS) {
    float m[1] = {0.0f};
    gather_sums<1, UNROLL>(a.x, ent, width, SLICE, 1, 0, 1, 0, m);
    if (r >= a.n) return;
    if (a.power) {
      a.dl[r] = m[0];
    } else {
      const float yr = a.y[r];
      a.dl[r] = dloss(a.loss, yr * m[0], mu) * yr;
    }
    return;
  }
  const int C = static_cast<int>(a.C);
  float* d = a.dl + r * C;
  float m[CLASS_BLOCK];
  for (int c0 = 0; c0 < C; c0 += CLASS_BLOCK) {
    const int nc = min(CLASS_BLOCK, C - c0);
#pragma unroll
    for (int i = 0; i < CLASS_BLOCK; ++i) m[i] = 0.0f;
    gather_sums<CLASS_BLOCK, CS_UNROLL>(a.x, ent, width, SLICE, C, c0, nc, 0,
                                        m);
    if (C > CLASS_BLOCK && r < a.n) {
#pragma unroll
      for (int i = 0; i < CLASS_BLOCK; ++i)
        if (i < nc) d[c0 + i] = m[i];
    }
  }
  if (r < a.n) cs_softmax(m, d, C, a.labels[r], mu);
}

// w and z of feature j, class c (FISTA; unread in power mode and by
// cols<PART>), loaded before the feature's sum is known.
struct Point {
  float z, w;
};

template <bool PART>
__device__ __forceinline__ Point point(const Args& a, int j, int c, int C) {
  if (PART || a.power || j < 0) return {0.0f, 0.0f};
  const int64_t k = static_cast<int64_t>(j) * C + c;
  return {a.z[k], a.w[k]};
}

// FISTA's step on one (feature, class) element from its sum g of val * dl
// and its point: the new point (w in .w, the momentum point in .z); dmax
// keeps the bits of the largest |w_new - w| (non-negative, so the bits
// order as the values). cols (through update()) and the update kernel
// both take it, so a split solve gives cols' bits.
__device__ __forceinline__ Point fista_point(float g, Point p, bool l1,
                                             float cost, float step,
                                             float beta, unsigned& dmax) {
  g = cost * g;
  if (!l1) g += p.z;
  float wn = p.z - step * g;
  if (l1)
    wn = (wn > 0.0f ? 1.0f : (wn < 0.0f ? -1.0f : 0.0f)) *
         fmaxf(fabsf(wn) - step, 0.0f);
  dmax = max(dmax, __float_as_uint(fabsf(wn - p.w)));
  return {wn + beta * (wn - p.w), wn};
}

// The update of feature j, class c, from its sum g of val * dl (or, in
// power mode and in cols<PART>, the sum itself stored into out) and its
// loaded point.
template <bool PART>
__device__ __forceinline__ void update(const Args& a, int j, int c, int C,
                                       float g, Point p, float cost,
                                       float step, float beta,
                                       unsigned& dmax) {
  const int64_t k = static_cast<int64_t>(j) * C + c;
  if (PART || a.power) {
    a.out[k] = g;
    return;
  }
  const Point n = fista_point(g, p, a.l1 != 0, cost, step, beta, dmax);
  a.w[k] = n.w;
  a.z[k] = n.z;
}

struct Step {
  float cost, step, beta;
};

// A warp per segment of a long feature: lanes add strided entries, the
// butterfly combines them; the warp that finishes the feature's last
// segment adds the segment sums in order and updates it.
template <int NB, bool PART>
__device__ void segment(const Args& a, int64_t s, int lane, int C,
                        const Step& t, unsigned& dmax) {
  const int L = a.seg_long[s];
  const int j = a.long_feat[L];
  const int s0 = a.long_seg[L], ns = a.long_seg[L + 1] - s0;
  const int64_t lo = a.long_ptr[L] + (s - s0) * a.seg_len;
  const int64_t end = a.long_ptr[L + 1];
  const int hi = static_cast<int>(lo + a.seg_len < end ? lo + a.seg_len
                                                       : end);
  // this lane's entries: lo + lane, lo + lane + 32, ... below hi
  const int mine = max(0, (hi - static_cast<int>(lo) - lane + 31) / 32);
  const int2* ent = a.long_ent + lo + lane;
  float g[NB];
  for (int c0 = 0; c0 < C; c0 += NB) {
    const int nc = min(NB, C - c0);
#pragma unroll
    for (int i = 0; i < NB; ++i) g[i] = 0.0f;
    gather_sums<NB, (NB == 1 ? UNROLL : CS_UNROLL)>(a.dl, ent, mine, 32, C,
                                                    c0, nc, -1, g);
#pragma unroll
    for (int i = 0; i < NB; ++i) g[i] = warp_sum(g[i]);
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      if (i >= nc) continue;
      if (ns > 1) {
        if (lane == 0) a.partial[s * C + c0 + i] = g[i];
      } else if (lane == ((c0 + i) & 31)) {
        update<PART>(a, j, c0 + i, C, g[i], point<PART>(a, j, c0 + i, C),
                     t.cost, t.step, t.beta, dmax);
      }
    }
  }
  if (ns == 1) return;
  __threadfence();
  __syncwarp();
  int done = 0;
  if (lane == 0) done = atomicAdd(&a.long_cnt[L], 1);
  if (__shfl_sync(FULL, done, 0) != ns - 1) return;
  // the feature's last segment: every segment sum is in L2
  __threadfence();
  if (lane == 0) a.long_cnt[L] = 0;
  for (int c = 0; c < C; ++c) {
    float h = 0.0f;
    for (int q = s0 + lane; q < s0 + ns; q += 32)
      h += __ldcg(&a.partial[static_cast<int64_t>(q) * C + c]);
    h = warp_sum(h);
    if (lane == (c & 31))
      update<PART>(a, j, c, C, h, point<PART>(a, j, c, C), t.cost, t.step,
                   t.beta, dmax);
  }
}

// A warp per slice of 32 short features, a thread per feature: its
// entries in ascending example order. Its w and z are loaded first, so
// they arrive with the entries, not after the sum.
template <int NB, bool PART>
__device__ void short_slice(const Args& a, int64_t q, int lane, int C,
                            const Step& t, unsigned& dmax) {
  const int j = a.short_feat[q * SLICE + lane];
  const int k0 = a.col_slice[q], width = a.col_slice[q + 1] - k0;
  const int2* ent = a.col_ent + static_cast<int64_t>(k0) * SLICE + lane;
  float g[NB];
  Point pt[NB];
  for (int c0 = 0; c0 < C; c0 += NB) {
    const int nc = min(NB, C - c0);
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      g[i] = 0.0f;
      pt[i] = point<PART>(a, i < nc ? j : -1, c0 + i, C);
    }
    gather_sums<NB, (NB == 1 ? UNROLL : CS_UNROLL)>(a.dl, ent, width, SLICE,
                                                    C, c0, nc, -1, g);
    if (j < 0) continue;
#pragma unroll
    for (int i = 0; i < NB; ++i)
      if (i < nc)
        update<PART>(a, j, c0 + i, C, g[i], pt[i], t.cost, t.step, t.beta,
                     dmax);
  }
}

// The end of an iteration's last launch (cols, or update in a sharded
// solve): the block's largest |w_new - w| into the state's accumulator;
// the last block to finish stores delta, advances it and sets active to
// the JAX loop's cond. Every thread of the block calls it.
__device__ __forceinline__ void finish_iteration(const Args& a,
                                                 unsigned dmax) {
  __shared__ unsigned block_delta[WARPS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  dmax = __reduce_max_sync(FULL, dmax);
  if (lane == 0) block_delta[warp] = dmax;
  __syncthreads();
  if (threadIdx.x != 0) return;
  for (int i = 1; i < WARPS; ++i) dmax = max(dmax, block_delta[i]);
  unsigned* st = reinterpret_cast<unsigned*>(a.state);
  atomicMax(&st[3], dmax);
  __threadfence();
  if (atomicAdd(&st[4], 1u) != gridDim.x - 1) return;
  // the last block: every block's max is in st[3]
  __threadfence();
  const unsigned d = atomicExch(&st[3], 0u);
  const int it = a.state[0] + 1;
  const float delta = __uint_as_float(d);
  a.state[0] = it;
  st[2] = d;
  a.state[1] =
      it < a.max_iter && (it < 8 || delta > static_cast<float>(a.thr));
  st[4] = 0u;
}

template <bool CS, bool PART>
__global__ void __launch_bounds__(WARPS * 32) cols_kernel(const Args a) {
  const bool fista = !a.power;
  if (fista && !a.state[1]) return;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int C = CS ? static_cast<int>(a.C) : 1;
  Step t{static_cast<float>(a.cost), static_cast<float>(a.step), 0.0f};
  if (fista) {
    const int it = a.state[0];
    t.beta = (a.tseq[it] - 1.0f) / a.tseq[it + 1];
  }
  constexpr int NB = CS ? CLASS_BLOCK : 1;
  unsigned dmax = 0;
  if (blockIdx.x < a.seg_blocks) {
    const int64_t s = static_cast<int64_t>(blockIdx.x) * WARPS + warp;
    if (s < a.n_seg) segment<NB, PART>(a, s, lane, C, t, dmax);
  } else {
    // persistent warps over the slices of short features, the widest (the
    // last) first: a slice is little work, a block's end costs atomics
    const int64_t stride =
        (static_cast<int64_t>(gridDim.x) - a.seg_blocks) * WARPS;
    for (int64_t u =
             (static_cast<int64_t>(blockIdx.x) - a.seg_blocks) * WARPS + warp;
         u < a.n_col_slices; u += stride)
      short_slice<NB, PART>(a, a.n_col_slices - 1 - u, lane, C, t, dmax);
  }
  if (!fista || PART) return;
  finish_iteration(a, dmax);
}

// A sharded solve's update, g the sums of every shard: fista_point on
// each element, as cols' update() (the order of the
// features does not matter: each is updated once, and the max is exact
// in any order), then the iteration's end, whose warp and block maxima
// take one atomicMax a block. Only the live prefix is visited, the first
// n_prefix = (largest feature id + 1) C elements (feature-major,
// k = j C + c): past it every shard's sums, w and z are 0 and stay so.
// A thread takes four elements at a time with 16-byte loads and stores
// (g streamed: it is read once; the host keeps w, z and g 16-byte
// aligned), then the last n_prefix % 4 one at a time; 32-bit indices (the
// host checks n_dim C < 2^31) and no division, since fista_point() needs
// no feature index.
__global__ void __launch_bounds__(WARPS * 32) update_kernel(const Args a) {
  if (!a.state[1]) return;
  const int it = a.state[0];
  const float beta = (a.tseq[it] - 1.0f) / a.tseq[it + 1];
  const float cost = static_cast<float>(a.cost);
  const float step = static_cast<float>(a.step);
  const bool l1 = a.l1 != 0;
  unsigned dmax = 0;
  const unsigned n = static_cast<unsigned>(a.n_prefix);
  const unsigned first = blockIdx.x * blockDim.x + threadIdx.x;
  const unsigned stride = gridDim.x * blockDim.x;
  const float4* g4 = reinterpret_cast<const float4*>(a.g);
  float4* w4 = reinterpret_cast<float4*>(a.w);
  float4* z4 = reinterpret_cast<float4*>(a.z);
  for (unsigned i = first; i < n / 4; i += stride) {
    const float4 g = __ldcs(g4 + i), z = z4[i], w = w4[i];
    const Point x = fista_point(g.x, Point{z.x, w.x}, l1, cost, step, beta,
                                dmax);
    const Point y = fista_point(g.y, Point{z.y, w.y}, l1, cost, step, beta,
                                dmax);
    const Point u = fista_point(g.z, Point{z.z, w.z}, l1, cost, step, beta,
                                dmax);
    const Point v = fista_point(g.w, Point{z.w, w.w}, l1, cost, step, beta,
                                dmax);
    w4[i] = make_float4(x.w, y.w, u.w, v.w);
    z4[i] = make_float4(x.z, y.z, u.z, v.z);
  }
  for (unsigned k = n / 4 * 4 + first; k < n; k += stride) {
    const Point x = fista_point(__ldcs(a.g + k), Point{a.z[k], a.w[k]}, l1,
                                cost, step, beta, dmax);
    a.w[k] = x.w;
    a.z[k] = x.z;
  }
  finish_iteration(a, dmax);
}

int launch(const void* kern, const Args* a, int blocks, void* stream,
           int device) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  void* params[] = {const_cast<Args*>(a)};
  e = cudaLaunchKernel(kern, dim3(blocks), dim3(WARPS * 32), params, 0,
                       static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

bool crammer_singer(const Args* a) {
  return !a->power && a->loss == CRAMMER_SINGER;
}

}  // namespace

extern "C" {

// Each launches one kernel on `stream` of `device` with `blocks` blocks of
// WARPS warps and returns cudaGetLastError() (0 = ok): rows takes a slice
// of examples a warp; cols takes a->seg_blocks blocks for the segments (a
// warp each) and strides the rest, any number, over the short features'
// slices.
int vt_solver_rows(const VtSolverArgs* a, int blocks, void* stream,
                   int device) {
  const void* k = crammer_singer(a)
                      ? reinterpret_cast<const void*>(rows_kernel<true>)
                      : reinterpret_cast<const void*>(rows_kernel<false>);
  return launch(k, a, blocks, stream, device);
}

int vt_solver_cols(const VtSolverArgs* a, int blocks, void* stream,
                   int device) {
  const bool cs = crammer_singer(a), part = a->part != 0;
  const void* k =
      cs ? (part ? reinterpret_cast<const void*>(cols_kernel<true, true>)
                 : reinterpret_cast<const void*>(cols_kernel<true, false>))
         : (part ? reinterpret_cast<const void*>(cols_kernel<false, true>)
                 : reinterpret_cast<const void*>(cols_kernel<false, false>));
  return launch(k, a, blocks, stream, device);
}

// update: any number of blocks (the grid strides over the live prefix,
// four elements a thread at a time).
int vt_solver_update(const VtSolverArgs* a, int blocks, void* stream,
                     int device) {
  return launch(reinterpret_cast<const void*>(update_kernel), a, blocks,
                stream, device);
}

int vt_solver_warps() { return WARPS; }

}  // extern "C"
