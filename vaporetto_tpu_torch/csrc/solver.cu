// FISTA gradient step of the linear-classifier trainer, for Hopper (sm_90a).
//
// Replaces the XLA loop bodies of the JAX package's solver
// (vaporetto_tpu/train/solver.py): _binary_ops (:158, the sparse X.w
// gather, the loss derivative, X^T r by segment_sum, the L2 term),
// _fista_power (:186, the power iteration's X^T X v), _fista_advance (:210,
// the prox, the momentum step and max |w_new - w|) and _fista_cs_advance
// (:305, the same for the smoothed Crammer-Singer objective over C
// classes). One FISTA iteration is two launches:
//   rows - a warp per example: its margin(s) over the example's live
//          entries (CSR, pads dropped), then the loss derivative
//          dloss(y m) y mask (logistic, squared hinge, smoothed hinge), or
//          (softmax((m + 1 - onehot) / mu) - onehot) mask over C classes;
//          in power mode the plain margin X v;
//   cols - the feature-major sums of val * dl (CSC), then the update of
//          each feature: g = cost * sum (+ z for L2), w_new = prox(z -
//          step g), z_new = w_new + ((t - 1) / t_new)(w_new - w), and the
//          largest |w_new - w|; in power mode it writes X^T r instead. A
//          feature with at most SHORT entries (most of them) takes one
//          thread, which adds its entries in order; a longer column is cut
//          into segments of at most SEG entries, a warp each, and the warp
//          that finishes a feature's last segment adds its segment sums
//          in segment order and applies the update. Both bounds are the
//          host's (ops/solver.py).
// Features with no entry keep w = z = 0 (their gradient is z, starting
// at 0), so they are not visited; slot 0 (padding) has no entry.
//
// Determinism. Every sum runs in an order fixed by the layout: a lane
// adds its strided entries in order, the warp combines lanes by an xor
// butterfly (IEEE addition commutes, so every lane holds the same bits),
// a feature's segment sums are added the same way whichever warp
// finishes last, and a short feature's thread adds its entries in order. There are no float atomics; the global max of
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
// What bounds it on this card: bytes. Per iteration each live entry is
// read once by each kernel (rows: its id, value and the gathered z; cols:
// its row id, value and the gathered dl), dl is written and read, and
// w and z of the visited features are read and written: a few hundred MB
// for the boundary trainer's corpus, at 3.35 TB/s a fraction of a ms. The
// gathers of z (rows) and dl (cols) are scattered but mostly L2 hits. The
// design spends nothing on arithmetic throughput: there is none to speak
// of (no tensor-core work: a product of a sparse matrix with a vector).
// Its balancing devices are the two kinds of column: a feature's column
// can hold every example (the bias) or one (most of the 11 M features of
// the boundary trainer's corpus hold a few). A warp per feature would
// leave most lanes idle on the short columns and the card waiting on the
// longest; so short columns take a thread each (neighbouring threads
// read neighbouring column ranges), long ones segments of at most SEG
// entries, and only multi-segment features pay the per-feature counter
// (col_cnt, reset by the warp that finishes it).

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

// Mirrored field for field by ops/solver.py (_Args): every field is 8 bytes
// wide (floats travel as doubles), so the layout has no padding.
struct VtSolverArgs {
  const int32_t* row_ptr;   // (N + 1,) CSR: the entries of example r
  const int32_t* col;       // (nnz,) feature ids, 1..n_dim-1
  const float* val;         // (nnz,)
  const int32_t* col_ptr;   // (n_dim + 1,) CSC: the entries of feature j
  const int32_t* short_col; // (n_short,) features of <= SHORT entries
  const int32_t* seg_col;   // (n_seg,) the feature of segment s
  const int32_t* col_seg;   // (n_dim + 1,) the segments of feature j
                            // (none for a short feature)
  const int32_t* crow;      // (nnz,) CSC: each entry's example, ascending
  const float* cval;        // (nnz,)
  const float* y;           // (N,) +1 / -1 (binary losses)
  const int32_t* labels;    // (N,) class ids (Crammer-Singer)
  const float* mask;        // (N,) 1 for real examples, 0 for padding
  const float* x;           // (n_dim * C,) the point rows reads (z or v)
  float* w;                 // (n_dim * C,) iterate, feature-major
  float* z;                 // (n_dim * C,) momentum point
  float* dl;                // (N * C,) rows' output
  float* partial;           // (n_seg * C,) segment sums
  int32_t* col_cnt;         // (n_dim,) segments finished, 0 between launches
  float* out;               // (n_dim,) power mode: X^T r
  int32_t* state;           // (8,) it, active, delta, delta acc, ticket
  const float* tseq;        // (max_iter + 1,) t_0 = 1, t_k+1 of t_k
  int64_t N, n_dim, C, n_seg, n_short;
  int64_t seg_len;          // SEG: segment q of feature j holds entries
                            // col_ptr[j] + q SEG .. (at most SEG of them)
  int64_t seg_blocks;       // cols: blocks [0, seg_blocks) take segments,
                            // the others a short feature a thread
  int64_t power;            // 1: rows writes X x, cols writes X^T dl
  int64_t loss;             // 0 logistic, 1 squared hinge, 2 smoothed
                            // hinge, 3 Crammer-Singer
  int64_t l1, max_iter;
  double cost, step, thr, mu;  // thr = eps * step * 100 (float32)
};

namespace {

using Args = VtSolverArgs;

constexpr int WARPS = 8;  // warps per block
constexpr unsigned FULL = 0xffffffffu;
constexpr int CRAMMER_SINGER = 3;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

// d loss / d m at m = y w.x (solver.py _losses)
__device__ __forceinline__ float dloss(int64_t kind, float m, float mu) {
  if (kind == 0) return -1.0f / (1.0f + expf(m));  // -sigmoid(-m)
  if (kind == 1) return -2.0f * fmaxf(0.0f, 1.0f - m);
  return -fminf(fmaxf((1.0f - m) / mu, 0.0f), 1.0f);
}

// sum over entries [lo, hi) of x[col * C + c] * val, in the fixed order
__device__ __forceinline__ float row_dot(const Args& a, int lo, int hi,
                                        int c, int C, int lane) {
  float s = 0.0f;
  for (int e = lo + lane; e < hi; e += 32)
    s += a.x[static_cast<int64_t>(a.col[e]) * C + c] * a.val[e];
  return warp_sum(s);
}

__global__ void __launch_bounds__(WARPS * 32) rows_kernel(const Args a) {
  if (!a.power && !a.state[1]) return;
  const int lane = threadIdx.x & 31;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * WARPS;
  const float mu = static_cast<float>(a.mu);
  const bool cs = !a.power && a.loss == CRAMMER_SINGER;
  const int C = cs ? static_cast<int>(a.C) : 1;
  for (int64_t r = static_cast<int64_t>(blockIdx.x) * WARPS +
                   (threadIdx.x >> 5);
       r < a.N; r += stride) {
    const int lo = a.row_ptr[r], hi = a.row_ptr[r + 1];
    if (!cs) {
      const float s = row_dot(a, lo, hi, 0, 1, lane);
      if (lane == 0) {
        if (a.power) {
          a.dl[r] = s;
        } else {
          const float yr = a.y[r];
          a.dl[r] = dloss(a.loss, yr * s, mu) * yr * a.mask[r];
        }
      }
      continue;
    }
    // Crammer-Singer: margin of class c kept by lane c % 32, which alone
    // reads it back
    float* d = a.dl + r * C;
    const int lab = a.labels[r];
    for (int c = 0; c < C; ++c) {
      const float s = row_dot(a, lo, hi, c, C, lane);
      if (lane == (c & 31)) d[c] = s;
    }
    float smax = -INFINITY;
    for (int c = lane; c < C; c += 32)
      smax = fmaxf(smax, (d[c] + (c == lab ? 0.0f : 1.0f)) / mu);
    smax = warp_max(smax);
    float se = 0.0f;
    for (int c = lane; c < C; c += 32)
      se += expf((d[c] + (c == lab ? 0.0f : 1.0f)) / mu - smax);
    se = warp_sum(se);
    const float mk = a.mask[r];
    for (int c = lane; c < C; c += 32) {
      const float p =
          expf((d[c] + (c == lab ? 0.0f : 1.0f)) / mu - smax) / se;
      d[c] = (p - (c == lab ? 1.0f : 0.0f)) * mk;
    }
  }
}

// The update of feature j, class c, from its sum g of val * dl (or, in
// power mode, the sum itself as X^T r); dmax keeps the bits of the
// largest |w_new - w| (non-negative, so the bits order as the values).
__device__ __forceinline__ void update(const Args& a, int j, int c, int C,
                                       float g, float cost, float step,
                                       float beta, unsigned& dmax) {
  const int64_t k = static_cast<int64_t>(j) * C + c;
  if (a.power) {
    a.out[k] = g;
    return;
  }
  const float zk = a.z[k], wk = a.w[k];
  g = cost * g;
  if (!a.l1) g += zk;
  float wn = zk - step * g;
  if (a.l1)
    wn = (wn > 0.0f ? 1.0f : (wn < 0.0f ? -1.0f : 0.0f)) *
         fmaxf(fabsf(wn) - step, 0.0f);
  a.w[k] = wn;
  a.z[k] = wn + beta * (wn - wk);
  dmax = max(dmax, __float_as_uint(fabsf(wn - wk)));
}

__global__ void __launch_bounds__(WARPS * 32) cols_kernel(const Args a) {
  const bool fista = !a.power;
  if (fista && !a.state[1]) return;
  __shared__ unsigned block_delta[WARPS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int C = static_cast<int>(a.C);
  const float cost = static_cast<float>(a.cost);
  const float step = static_cast<float>(a.step);
  float beta = 0.0f;
  if (fista) {
    const int it = a.state[0];
    beta = (a.tseq[it] - 1.0f) / a.tseq[it + 1];
  }
  unsigned dmax = 0;
  if (blockIdx.x < a.seg_blocks) {
    // long columns: a warp per segment
    const int64_t stride = a.seg_blocks * WARPS;
    for (int64_t s = static_cast<int64_t>(blockIdx.x) * WARPS + warp;
         s < a.n_seg; s += stride) {
      const int j = a.seg_col[s];
      const int s0 = a.col_seg[j], ns = a.col_seg[j + 1] - s0;
      const int64_t lo64 = a.col_ptr[j] + (s - s0) * a.seg_len;
      const int64_t end = a.col_ptr[j + 1];
      const int lo = static_cast<int>(lo64);
      const int hi = static_cast<int>(lo64 + a.seg_len < end
                                          ? lo64 + a.seg_len : end);
      if (ns > 1) {
        for (int c = 0; c < C; ++c) {
          float g = 0.0f;
          for (int e = lo + lane; e < hi; e += 32)
            g += a.cval[e] * a.dl[static_cast<int64_t>(a.crow[e]) * C + c];
          g = warp_sum(g);
          if (lane == (c & 31)) a.partial[s * C + c] = g;
        }
        __threadfence();
        __syncwarp();
        int done = 0;
        if (lane == 0) done = atomicAdd(&a.col_cnt[j], 1);
        if (__shfl_sync(FULL, done, 0) != ns - 1) continue;
        // the feature's last segment: every segment sum is in L2
        __threadfence();
        if (lane == 0) a.col_cnt[j] = 0;
      }
      for (int c = 0; c < C; ++c) {
        float g = 0.0f;
        if (ns == 1) {
          for (int e = lo + lane; e < hi; e += 32)
            g += a.cval[e] * a.dl[static_cast<int64_t>(a.crow[e]) * C + c];
        } else {
          for (int q = s0 + lane; q < s0 + ns; q += 32)
            g += __ldcg(&a.partial[static_cast<int64_t>(q) * C + c]);
        }
        g = warp_sum(g);
        if (lane == (c & 31)) update(a, j, c, C, g, cost, step, beta, dmax);
      }
    }
  } else {
    // short columns: a thread per feature, its entries in order
    const int64_t t =
        (static_cast<int64_t>(blockIdx.x) - a.seg_blocks) * blockDim.x +
        threadIdx.x;
    if (t < a.n_short) {
      const int j = a.short_col[t];
      const int lo = a.col_ptr[j], hi = a.col_ptr[j + 1];
      for (int c = 0; c < C; ++c) {
        float g = 0.0f;
        for (int e = lo; e < hi; ++e)
          g += a.cval[e] * a.dl[static_cast<int64_t>(a.crow[e]) * C + c];
        update(a, j, c, C, g, cost, step, beta, dmax);
      }
    }
  }
  if (!fista) return;
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

}  // namespace

extern "C" {

// Each launches one kernel on `stream` of `device` with `blocks` blocks of
// WARPS warps and returns cudaGetLastError() (0 = ok): rows strides over
// the examples; cols takes a->seg_blocks blocks for the segments (a
// stride over them) and the rest for the short features, a thread each.
int vt_solver_rows(const VtSolverArgs* a, int blocks, void* stream,
                   int device) {
  return launch(reinterpret_cast<const void*>(rows_kernel), a, blocks,
                stream, device);
}

int vt_solver_cols(const VtSolverArgs* a, int blocks, void* stream,
                   int device) {
  return launch(reinterpret_cast<const void*>(cols_kernel), a, blocks,
                stream, device);
}

int vt_solver_warps() { return WARPS; }

}  // extern "C"
