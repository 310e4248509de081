// Fused margin-form GLM loss and gradient for Hopper (sm_90a).
//
// Replaces the TPU kernel spark_agd_tpu/ops/pallas_kernels.py:
// fused_margin_loss_grad (body _margin_kernel).  For X (N, D), labels y,
// row mask m and weights w it returns
//
//     loss = sum_i m_i * per(x_i . w, y_i)
//     grad = sum_i m_i * mult(x_i . w, y_i) * x_i
//
// with (per, mult) the logistic, least-squares or hinge middle of
// spark_agd_tpu/ops/losses.py (dots_loss_and_mult).
//
// What bounds it on this card: reading X from device memory.  The two
// products do 4*N*D flops on N*D*itemsize bytes, one flop per byte in
// f32, far below the ~20 flop/byte where the H100's f32 rate would take
// over.  Two library products (X @ w, then X^T @ mult) read X twice.
//
// margin_plan picks one of seven modes by width; all but the grid mode
// write per-block (cluster mode: per-cluster) partials that
// reduce_partials (or reduce_partials_warp) sums in a fixed order, and the
// grid mode's blocks own disjoint columns; no mode uses float atomics, so
// two calls on the same inputs give the same bits.  X may be f32 or bf16
// (widened to f32 in registers); y, m, w and every accumulator are f32.
// Ragged row and column edges are masked here, so X needs no padding.
//
// Warp-rows mode (33 columns to kWarpRowsMaxWidth = 256, the hand-over to
// the tile; bf16 X of odd width only to 128).  What held these widths
// back in the tile: a 32-row tile of a few KB copied synchronously
// between three barriers, at most four blocks an SM, so little of X in
// flight and none while a block computes, and one thread a column in the
// gradient (192 of 256 idle at D = 64): about 3.3 ms at 10M rows
// whatever the width.  Here no tile
// and no barrier sit in the row loop.  Each lane of a warp owns C of the
// columns (C = 2, 4 or 8; adjacent pairs 2l, 2l + 1, 2l + 64, ... where
// rows are aligned to two elements, loaded together, else l, l + 32,
// ..., so that no width needs padding), with w and its gradient sums in
// registers for the block's whole row range.  A warp takes U = 32 / C
// consecutive rows at a time, each row's load coalesced across the
// lanes, all U rows in flight together.  The U dots are reduced and
// scattered across the lanes in log2(U) halving shuffle steps (and
// 5 - log2(U) plain ones), so that every lane holds one row's dot and
// the loss middle runs once for U rows, in parallel; each row's
// multiplier comes back by one shuffle.  The block reduces its registers
// once at the end.
//
// Tile mode (past the hand-over up to margin_tile_max_width, 264 f32 or
// 794 bf16 columns, and bf16 of odd width from 129, where the card timed
// it faster than the stream mode):
// every block walks a contiguous range of rows in tiles of `tile_rows`
// full rows (a contiguous chunk of X, copied with 16-byte loads).  One
// warp per row forms the dot with a shuffle reduction and applies the
// loss middle in f32; then every thread sums mult * x over the tile for
// the columns it owns, reading the tile again from shared memory, never
// from device memory.  X crosses the memory bus once per evaluation.
//
// Stream mode (past the tile, up to margin_max_width: 8,192 f32 or
// 16,384 bf16 columns): one 512-thread block an SM, w and the gradient
// sums in registers, rows streamed through a ring of shared-memory
// stages filled by bulk copies on mbarriers (details at margin_stream).
//
// Narrow mode (D <= kNarrowMaxWidth): a tile of a few hundred bytes
// between barriers leaves the card idle, so each thread owns whole rows
// instead, with the row, w and its D gradient sums in registers (D
// rounded up to a compile-time bucket and masked).  Neighbouring threads
// take neighbouring rows, so a warp's loads are contiguous.  Each block
// reduces its registers once at the end (a shuffle tree, then across
// warps in a fixed order), and a warp per column sums the blocks'
// partials.
//
// Cluster mode (past margin_max_width, up to margin_cluster_max_width):
// the TPU kernel reads X once at far wider rows, since its VMEM holds two
// 8-row blocks of a full-width row; one SM's shared memory does not (nor
// do one block's registers).  A thread block cluster of 2-16
// blocks on as many SMs holds a stage of full-width rows split by
// columns, each block w's slice, its rows' slices and its slice of the
// gradient; the blocks swap their partial dots through distributed
// shared memory, so X crosses the bus once (details at margin_cluster).
//
// Grid mode (past the cluster mode, up to margin_grid_max_width: about
// 2.16M columns on 132 SMs): the cluster mode's design with one block on
// every SM, launched cooperatively so that all are resident at once, the
// blocks' partial dots swapped through L2 instead of distributed shared
// memory; X crosses the bus once (details at margin_grid).
//
// Two-pass mode (past the grid mode's reach): pass 1 gives each row a
// warp that reads it from device memory (16-byte loads where rows are
// aligned; w stays in L2), applies the loss middle and writes m * mult to
// an (N,) scratch; pass 2 walks column chunks x row groups, one column a
// thread with eight rows' loads in flight, and reads X again.  Both grids
// are sized to what is resident at once.  X crosses the bus twice, as it
// does through the two library products that the TPU wrapper falls back
// to past its VMEM budget; this mode has no width limit.

#include <type_traits>

#include "cluster_common.cuh"
#include "margin_middle.cuh"
#include "tile_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;


// Shared-memory layout of one block: w and the gradient accumulator
// (D floats each), the tile's multipliers, one loss slot per warp, then
// the X tile, placed 16-byte aligned with 16 bytes of slack so that its
// byte offset modulo 16 can match the tile's address in device memory.
__host__ __device__ inline int64_t x_tile_offset(int64_t d, int tile_rows) {
  return round_up(4 * (2 * d + round_up(tile_rows, 4) + kWarps), 16);
}

__host__ __device__ inline int64_t smem_bytes(int64_t d, int tile_rows,
                                              int itemsize) {
  return x_tile_offset(d, tile_rows) + int64_t(tile_rows) * d * itemsize +
         kTileSlack;
}

constexpr int kMaxTileRows = 32;

// Most rows (at most kMaxTileRows) whose block fits in `budget` bytes.
int fit_rows(int64_t d, int itemsize, int64_t budget) {
  for (int rows = kMaxTileRows; rows >= 1; --rows)
    if (smem_bytes(d, rows, itemsize) <= budget) return rows;
  return 0;
}

// Rows of X one block keeps in shared memory: a multiple of the warps,
// small enough for three blocks an SM where that fits, else for one;
// 1..kWarps-1 rows for very wide X; 0 when not even one row fits (the
// counterpart of choose_block_rows in pallas_kernels.py returning 0).
int choose_tile_rows(int64_t d, int itemsize) {
  int rows = fit_rows(d, itemsize, kSmemSM / 3 - kSmemReserved);
  if (rows >= kWarps) return rows - rows % kWarps;
  rows = fit_rows(d, itemsize, kSmemBlock);
  return rows >= kWarps ? rows - rows % kWarps : rows;
}

template <typename T, int L>
__global__ void __launch_bounds__(kThreads)
    margin_partials(const T* __restrict__ X, const float* __restrict__ y,
                    const float* __restrict__ mask,
                    const float* __restrict__ w, int64_t n, int64_t d,
                    int tile_rows, float* __restrict__ partial_loss,
                    float* __restrict__ partial_grad) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* w_s = reinterpret_cast<float*>(smem);
  float* g_s = w_s + d;
  float* mult_s = g_s + d;
  float* warp_loss_s = mult_s + round_up(tile_rows, 4);
  unsigned char* x_base = smem + x_tile_offset(d, tile_rows);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  for (int64_t c = tid; c < d; c += kThreads) {
    w_s[c] = w[c];
    g_s[c] = 0.f;
  }
  const int64_t nblocks = gridDim.x;
  const int64_t rows_per_block = (n + nblocks - 1) / nblocks;
  const int64_t r_begin = min64(n, int64_t(blockIdx.x) * rows_per_block);
  const int64_t r_end = min64(n, r_begin + rows_per_block);
  Kahan loss_acc;
  __syncthreads();

  for (int64_t tile0 = r_begin; tile0 < r_end; tile0 += tile_rows) {
    const int rows = int(min64(tile_rows, r_end - tile0));
    const T* src = X + tile0 * d;
    copy_tile<kThreads>(src, int64_t(rows) * d * int64_t(sizeof(T)), x_base);
    const T* xs = reinterpret_cast<const T*>(
        x_base + (reinterpret_cast<uintptr_t>(src) & 15));
    __syncthreads();

    // first product and the loss middle: one warp per row
    for (int r = warp; r < rows; r += kWarps) {
      const T* row = xs + int64_t(r) * d;
      float acc = 0.f;
      for (int64_t c = lane; c < d; c += 32)
        acc = fmaf(to_f32(row[c]), w_s[c], acc);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (lane == 0) {
        const int64_t gr = tile0 + r;
        float per, mult;
        loss_middle<L>(acc, y[gr], &per, &mult);
        const float m = mask[gr];
        mult_s[r] = mult * m;
        loss_acc.add(per * m);
      }
    }
    __syncthreads();

    // second product off the same tile: each thread owns its columns
    for (int64_t c = tid; c < d; c += kThreads) {
      float s = 0.f;
      for (int r = 0; r < rows; ++r)
        s = fmaf(mult_s[r], to_f32(xs[int64_t(r) * d + c]), s);
      g_s[c] += s;
    }
    __syncthreads();
  }

  if (lane == 0) warp_loss_s[warp] = loss_acc.s;
  for (int64_t c = tid; c < d; c += kThreads)
    partial_grad[int64_t(blockIdx.x) * d + c] = g_s[c];
  __syncthreads();
  if (tid == 0) {
    Kahan k;
    for (int i = 0; i < kWarps; ++i) k.add(warp_loss_s[i]);
    partial_loss[blockIdx.x] = k.s;
  }
}

// Narrow mode.  Widths up to kNarrowMaxWidth go to one of the register
// buckets below (the row, w and the gradient sums each take DB
// registers).  The grid is as many blocks as are resident at once, each
// bucket's __launch_bounds__ holding its registers to that, so no block
// waits for a second wave; each thread walks rows tid, tid + stride, ...
// so that every thread walks many rows and a warp reads contiguous rows.
constexpr int kNarrowMaxWidth = 32;
constexpr int kNarrowThreads = 256;
constexpr int kNarrowWarps = kNarrowThreads / 32;

__host__ __device__ constexpr int narrow_blocks_per_sm(int bucket) {
  return bucket <= 16 ? 4 : 2;
}

int narrow_bucket(int64_t d) {
  return d <= 2 ? 2 : d <= 4 ? 4 : d <= 8 ? 8 : d <= 16 ? 16 : 32;
}

template <int Bytes>
struct VecOf;
template <>
struct VecOf<4> {
  using type = unsigned int;
};
template <>
struct VecOf<8> {
  using type = uint2;
};
template <>
struct VecOf<16> {
  using type = uint4;
};

// The DB elements of one row, widened to f32: as 4-, 8- or 16-byte
// vectors when the row is exactly DB wide and X is aligned to them
// (`vec`), else element by element, zero past column d.
template <typename T, int DB>
__device__ __forceinline__ void load_row(const T* __restrict__ row,
                                         int64_t d, bool vec,
                                         float (&x)[DB]) {
  if (vec) {
    constexpr int kBytes = DB * int(sizeof(T));
    constexpr int kVec = kBytes < 16 ? kBytes : 16;
    constexpr int kPer = kVec / int(sizeof(T));
    using V = typename VecOf<kVec>::type;
    const V* src = reinterpret_cast<const V*>(row);
#pragma unroll
    for (int i = 0; i < DB / kPer; ++i) {
      const V v = src[i];
      const T* e = reinterpret_cast<const T*>(&v);
#pragma unroll
      for (int j = 0; j < kPer; ++j) x[i * kPer + j] = to_f32(e[j]);
    }
  } else {
#pragma unroll
    for (int c = 0; c < DB; ++c) x[c] = c < d ? to_f32(row[c]) : 0.f;
  }
}

template <typename T, int L, int DB>
__global__ void __launch_bounds__(kNarrowThreads, narrow_blocks_per_sm(DB))
    margin_narrow(const T* __restrict__ X, const float* __restrict__ y,
                  const float* __restrict__ mask,
                  const float* __restrict__ w, int64_t n, int64_t d,
                  float* __restrict__ partial_loss,
                  float* __restrict__ partial_grad) {
  // rows whose loads are in flight together: more where rows are short
  constexpr int U = DB <= 4 ? 4 : (DB <= 8 ? 2 : 1);
  constexpr int kVecBytes = DB * int(sizeof(T)) < 16 ? DB * int(sizeof(T))
                                                     : 16;
  __shared__ float red_s[kNarrowWarps][DB + 1];
  float wr[DB], g[DB];
#pragma unroll
  for (int c = 0; c < DB; ++c) {
    wr[c] = c < d ? w[c] : 0.f;
    g[c] = 0.f;
  }
  const bool vec =
      d == DB && reinterpret_cast<uintptr_t>(X) % kVecBytes == 0;
  Kahan loss_acc;
  const int64_t stride = int64_t(gridDim.x) * kNarrowThreads;
  for (int64_t r0 = int64_t(blockIdx.x) * kNarrowThreads + threadIdx.x;
       r0 < n; r0 += U * stride) {
    float x[U][DB], yv[U], mv[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int64_t r = r0 + u * stride;
      if (r < n) {
        load_row<T, DB>(X + r * d, d, vec, x[u]);
        yv[u] = y[r];
        mv[u] = mask[r];
      } else {  // past the last row: contributes exactly 0
#pragma unroll
        for (int c = 0; c < DB; ++c) x[u][c] = 0.f;
        yv[u] = 0.f;
        mv[u] = 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float dot = 0.f;
#pragma unroll
      for (int c = 0; c < DB; ++c) dot = fmaf(x[u][c], wr[c], dot);
      float per, mult;
      loss_middle<L>(dot, yv[u], &per, &mult);
      loss_acc.add(per * mv[u]);
      const float mm = mult * mv[u];
#pragma unroll
      for (int c = 0; c < DB; ++c) g[c] = fmaf(mm, x[u][c], g[c]);
    }
  }

  // once per block: a shuffle tree in each warp, then the warps in order
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float ls = loss_acc.s;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    ls += __shfl_xor_sync(0xffffffffu, ls, off);
#pragma unroll
    for (int c = 0; c < DB; ++c)
      g[c] += __shfl_xor_sync(0xffffffffu, g[c], off);
  }
  if (lane == 0) {
#pragma unroll
    for (int c = 0; c < DB; ++c) red_s[warp][c] = g[c];
    red_s[warp][DB] = ls;
  }
  __syncthreads();
  const int c = threadIdx.x;
  if (c <= DB) {
    Kahan k;
    for (int i = 0; i < kNarrowWarps; ++i) k.add(red_s[i][c]);
    if (c == DB)
      partial_loss[blockIdx.x] = k.s;
    else if (c < d)
      partial_grad[int64_t(blockIdx.x) * d + c] = k.s;
  }
}

// Warp-rows mode.  Its widest X (C = 8) is the hand-over to the tile.
constexpr int64_t kWarpRowsMaxWidth = 256;
constexpr int64_t kWarpRowsBF16OddMaxWidth = 128;

// Whether the warp-rows mode takes X of width d with `itemsize`-byte
// elements, from the `--ab margin:` sweep of chip_smoke.py (PERF.md): f32
// from 33 columns to the hand-over; bf16 too at even widths, whose rows
// load as column pairs, but at odd widths only up to 128 columns (past
// that its 2-byte loads, eight a row, made it slower than the tile).
bool warp_rows_takes(int64_t d, int itemsize) {
  return d > kNarrowMaxWidth && d <= kWarpRowsMaxWidth &&
         (itemsize == 4 || d % 2 == 0 || d <= kWarpRowsBF16OddMaxWidth);
}

// Columns a lane owns (C) for X of width d; 32 * C >= d.
int warp_rows_cols(int64_t d) { return d <= 64 ? 2 : d <= 128 ? 4 : 8; }

// Blocks an SM, which __launch_bounds__ holds the registers to (85 a
// thread): the U rows' C columns (32 floats), their U dots, and w and the
// sums (2 C).  At four blocks (64 registers) the C = 8 build spills.
constexpr int kWarpRowsBlocksPerSM = 3;

// The column of the j-th value a lane holds: where X's rows are aligned
// to two elements (`pairs`), lane l owns the adjacent columns 2l + 64 i
// and 2l + 64 i + 1 and loads both at once (a 4-byte bf16 pair, an 8-byte
// f32 pair; bf16 loaded one element at a time was up to 3x slower,
// PERF.md); else lane l owns l + 32 j.
__device__ __forceinline__ int warp_rows_col(int j, int lane, bool pairs) {
  return pairs ? 64 * (j / 2) + 2 * lane + (j & 1) : lane + 32 * j;
}

template <typename T>
struct PairOf;
template <>
struct PairOf<float> {
  using type = float2;
  __device__ static float2 widen(float2 v) { return v; }
};
template <>
struct PairOf<__nv_bfloat16> {
  using type = __nv_bfloat162;
  __device__ static float2 widen(__nv_bfloat162 v) {
    return __bfloat1622float2(v);
  }
};

// Step I of the reduce-scatter of a warp's U dots: the lanes with bit
// (4 - I) set keep the upper half of the sums they carry, the others the
// lower half, each adding its partner's; after log2(U) steps lane l holds
// (a part of) the dot of row l / (32 / U).  Unrolled at compile time, so
// that p stays in registers.
template <int U, int I = 0>
__device__ __forceinline__ void reduce_scatter(float (&p)[U], int lane) {
  if constexpr ((U >> I) > 1) {
    constexpr int half = U >> (I + 1);
    constexpr int off = 16 >> I;
    const bool upper = (lane & off) != 0;
#pragma unroll
    for (int v = 0; v < half; ++v) {
      const float send = upper ? p[v] : p[v + half];
      const float keep = upper ? p[v + half] : p[v];
      p[v] = keep + __shfl_xor_sync(0xffffffffu, send, off);
    }
    reduce_scatter<U, I + 1>(p, lane);
  }
}

template <typename T, int L, int C>
__global__ void __launch_bounds__(kThreads, kWarpRowsBlocksPerSM)
    margin_warp_rows(const T* __restrict__ X, const float* __restrict__ y,
                     const float* __restrict__ mask,
                     const float* __restrict__ w, int64_t n, int d,
                     float* __restrict__ partial_loss,
                     float* __restrict__ partial_grad) {
  constexpr int U = 32 / C;  // rows a warp takes at a time
  constexpr int Q = U == 16 ? 4 : U == 8 ? 3 : 2;  // log2(U)
  using Pair = typename PairOf<T>::type;
  __shared__ float red_s[kWarps][32 * C + 1];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const bool pairs =
      d % 2 == 0 && reinterpret_cast<uintptr_t>(X) % (2 * sizeof(T)) == 0;
  float wr[C], g[C];
#pragma unroll
  for (int j = 0; j < C; ++j) {
    const int c = warp_rows_col(j, lane, pairs);
    wr[j] = c < d ? w[c] : 0.f;
    g[j] = 0.f;
  }
  const int64_t nblocks = gridDim.x;
  const int64_t rows_per_block = (n + nblocks - 1) / nblocks;
  const int64_t r_begin = min64(n, int64_t(blockIdx.x) * rows_per_block);
  const int64_t r_end = min64(n, r_begin + rows_per_block);
  // after the reduce-scatter this lane holds the dot of row `my_row` of
  // the warp's U rows: row u sits in lanes u * C ... u * C + C - 1, and
  // lane u * C (`lead`) counts its loss
  const int my_row = lane / C;
  const bool lead = lane % C == 0;
  Kahan loss_acc;
  for (int64_t r0 = r_begin + int64_t(warp) * U; r0 < r_end;
       r0 += int64_t(kWarps) * U) {
    float x[U][C];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int64_t r = r0 + u;
      const T* row = X + r * d;
      if (pairs) {
#pragma unroll
        for (int i = 0; i < C / 2; ++i) {
          const int c = 64 * i + 2 * lane;
          float2 v = make_float2(0.f, 0.f);
          if (r < r_end && c < d)
            v = PairOf<T>::widen(*reinterpret_cast<const Pair*>(row + c));
          x[u][2 * i] = v.x;
          x[u][2 * i + 1] = v.y;
        }
      } else {
#pragma unroll
        for (int j = 0; j < C; ++j) {
          const int c = lane + 32 * j;
          x[u][j] = r < r_end && c < d ? to_f32(row[c]) : 0.f;
        }
      }
    }
    const int64_t mr = r0 + my_row;
    const bool live = mr < r_end;
    const float yv = live ? y[mr] : 0.f;
    const float mv = live ? mask[mr] : 0.f;
    float p[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      p[u] = 0.f;
#pragma unroll
      for (int j = 0; j < C; ++j) p[u] = fmaf(x[u][j], wr[j], p[u]);
    }
    reduce_scatter<U>(p, lane);
    float dot = p[0];
#pragma unroll
    for (int off = 16 >> Q; off > 0; off >>= 1)
      dot += __shfl_xor_sync(0xffffffffu, dot, off);
    float per, mult;
    loss_middle<L>(dot, yv, &per, &mult);
    const float mm = live ? mult * mv : 0.f;
    if (live && lead) loss_acc.add(per * mv);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const float mu = __shfl_sync(0xffffffffu, mm, u * C);
#pragma unroll
      for (int j = 0; j < C; ++j) g[j] = fmaf(mu, x[u][j], g[j]);
    }
  }

  // once per block: the warps' sums in a fixed order
  float ls = loss_acc.s;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    ls += __shfl_xor_sync(0xffffffffu, ls, off);
#pragma unroll
  for (int j = 0; j < C; ++j)
    red_s[warp][warp_rows_col(j, lane, pairs)] = g[j];
  if (lane == 0) red_s[warp][32 * C] = ls;
  __syncthreads();
  for (int c = threadIdx.x; c <= 32 * C; c += kThreads) {
    if (c < d || c == 32 * C) {
      Kahan k;
      for (int i = 0; i < kWarps; ++i) k.add(red_s[i][c]);
      if (c == 32 * C)
        partial_loss[blockIdx.x] = k.s;
      else
        partial_grad[int64_t(blockIdx.x) * d + c] = k.s;
    }
  }
}

// Two-pass mode, pass 1: one warp per row (rows strided over the grid's
// warps) forms the dot from device memory, four loads in flight a lane;
// lane 0 applies the loss middle, writes m * mult for the row and adds
// m * per to the warp's loss.  One loss partial per block.
template <typename T, int L>
__global__ void __launch_bounds__(kThreads)
    margin_wide_dots(const T* __restrict__ X, const float* __restrict__ y,
                     const float* __restrict__ mask,
                     const float* __restrict__ w, int64_t n, int64_t d,
                     float* __restrict__ mult_out,
                     float* __restrict__ partial_loss) {
  __shared__ float warp_loss_s[kWarps];
  constexpr int kVec = 16 / int(sizeof(T));
  // every row starts 16-byte aligned
  const bool vec = d % kVec == 0 &&
                   reinterpret_cast<uintptr_t>(X) % 16 == 0;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  Kahan loss_acc;
  const int64_t warps_total = int64_t(gridDim.x) * kWarps;
  for (int64_t r = int64_t(blockIdx.x) * kWarps + warp; r < n;
       r += warps_total) {
    const T* row = X + r * d;
    float acc0 = 0.f, acc1 = 0.f, acc2 = 0.f, acc3 = 0.f;
    if (vec) {
      // 16-byte loads: kVec elements a lane, two vectors in flight
      const uint4* rv = reinterpret_cast<const uint4*>(row);
      const int64_t nv = d / kVec;
      int64_t v = lane;
      for (; v + 32 < nv; v += 64) {
        const uint4 a = rv[v], b = rv[v + 32];
        const T* ea = reinterpret_cast<const T*>(&a);
        const T* eb = reinterpret_cast<const T*>(&b);
        const float* wa = w + v * kVec;
        const float* wb = w + (v + 32) * kVec;
#pragma unroll
        for (int j = 0; j < kVec; j += 2) {
          acc0 = fmaf(to_f32(ea[j]), wa[j], acc0);
          acc1 = fmaf(to_f32(ea[j + 1]), wa[j + 1], acc1);
          acc2 = fmaf(to_f32(eb[j]), wb[j], acc2);
          acc3 = fmaf(to_f32(eb[j + 1]), wb[j + 1], acc3);
        }
      }
      for (; v < nv; v += 32) {
        const uint4 a = rv[v];
        const T* ea = reinterpret_cast<const T*>(&a);
        const float* wa = w + v * kVec;
#pragma unroll
        for (int j = 0; j < kVec; j += 2) {
          acc0 = fmaf(to_f32(ea[j]), wa[j], acc0);
          acc1 = fmaf(to_f32(ea[j + 1]), wa[j + 1], acc1);
        }
      }
    } else {
      int64_t c = lane;
      for (; c + 96 < d; c += 128) {
        acc0 = fmaf(to_f32(row[c]), w[c], acc0);
        acc1 = fmaf(to_f32(row[c + 32]), w[c + 32], acc1);
        acc2 = fmaf(to_f32(row[c + 64]), w[c + 64], acc2);
        acc3 = fmaf(to_f32(row[c + 96]), w[c + 96], acc3);
      }
      for (; c < d; c += 32) acc0 = fmaf(to_f32(row[c]), w[c], acc0);
    }
    float acc = (acc0 + acc1) + (acc2 + acc3);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) {
      float per, mult;
      loss_middle<L>(acc, y[r], &per, &mult);
      const float m = mask[r];
      mult_out[r] = mult * m;
      loss_acc.add(per * m);
    }
  }
  if (lane == 0) warp_loss_s[warp] = loss_acc.s;
  __syncthreads();
  if (threadIdx.x == 0) {
    Kahan k;
    for (int i = 0; i < kWarps; ++i) k.add(warp_loss_s[i]);
    partial_loss[blockIdx.x] = k.s;
  }
}

// Two-pass mode, pass 2: block (x, y) owns columns [256 x, 256 x + 256),
// one a thread, over row group y (gridDim.y groups of contiguous rows).
// A warp reads 32 neighbouring columns of a row; the multipliers come in
// chunks through shared memory.  Writes partial_grad[y, c].
constexpr int kWideMultChunk = 2048;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    margin_wide_grad(const T* __restrict__ X, const float* __restrict__ mult,
                     int64_t n, int64_t d,
                     float* __restrict__ partial_grad) {
  __shared__ float mult_s[kWideMultChunk];
  const int64_t c = int64_t(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t groups = gridDim.y;
  const int64_t rows_per_group = (n + groups - 1) / groups;
  const int64_t r_begin = min64(n, int64_t(blockIdx.y) * rows_per_group);
  const int64_t r_end = min64(n, r_begin + rows_per_group);
  float s[8] = {};
  for (int64_t r0 = r_begin; r0 < r_end; r0 += kWideMultChunk) {
    const int rows = int(min64(kWideMultChunk, r_end - r0));
    __syncthreads();  // the previous chunk's multipliers are consumed
    for (int i = threadIdx.x; i < rows; i += kThreads)
      mult_s[i] = mult[r0 + i];
    __syncthreads();
    if (c < d) {
      const T* col = X + r0 * d + c;
      int i = 0;
      for (; i + 7 < rows; i += 8) {
        float x[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) x[k] = to_f32(col[int64_t(i + k) * d]);
#pragma unroll
        for (int k = 0; k < 8; ++k) s[k] = fmaf(mult_s[i + k], x[k], s[k]);
      }
      for (; i < rows; ++i)
        s[0] = fmaf(mult_s[i], to_f32(col[int64_t(i) * d]), s[0]);
    }
  }
  if (c < d)
    partial_grad[int64_t(blockIdx.y) * d + c] =
        ((s[0] + s[1]) + (s[2] + s[3])) + ((s[4] + s[5]) + (s[6] + s[7]));
}

// Blocks of pass 1, and of pass 2 (column chunks x row groups): as many
// as are resident at once, so no block waits for a second wave; each
// pass-2 group at least kWideMultChunk rows where there are that many.
constexpr int kWideBlocksPerSM = 8;
constexpr int kWideGradBlocksPerSM = 8;

// Cluster mode: X past the tile, read once.  A thread block cluster of C
// blocks, one an SM, holds a stage of full-width rows split by columns:
// block (rank) q owns the column slice [q S, q S + S) (the last block the
// rest), with w's slice in shared memory and the slice's gradient sums in
// registers (kClusterThreads threads, column j + kClusterThreads i for
// thread j, up to J columns a thread) for the cluster's whole row range.
// Rows stream through a ring of kClusterStages stages of `rows` rows;
// each stage is filled with 1-D bulk copies (cp.async.bulk, completing on
// an mbarrier) where every row slice is 16-byte aligned, else with
// 16-byte cp.async copies of the chunks that cover it (copy_tile_async).
// Each block stores its partial dot of each row of a stage into every
// block's shared memory (distributed shared memory, st.async), in the
// sender's slot, counted on the receiver's mbarrier; each block waits for
// its C partials of the stage and adds them in rank order, so all of them
// form the same dot, and applies the loss middle itself; rank 0 alone
// counts the loss.  No cluster-wide barrier sits in the row loop: a
// barrier.cluster after each stage, with every block then reading its
// peers' partials (ld.shared::cluster), took 7.72 ms of device time at
// 100,000 x 40,000 f32 on an H100 80GB HBM3 against 5.43 for these
// one-way stores (PERF.md).  The slots
// and their mbarriers alternate by stage parity: a block stores its
// partials of stage s + 2 only after it has received every peer's of
// stage s + 1, which each peer sends after reading its slots of stage s.
// Each cluster writes one loss partial and its partial gradient, which
// reduce_partials sums in cluster order.
constexpr int kClusterThreads = 512;
constexpr int kClusterWarps = kClusterThreads / 32;
constexpr int kClusterStages = 2;
constexpr int kClusterMaxRows = 8;
// Columns a thread owns at most (the largest register bucket J), which
// bounds a slice at kClusterThreads * kClusterMaxCols columns.
constexpr int kClusterMaxCols = 32;

// f(std::integral_constant<int, J>{}) with J the register bucket of a
// slice: the columns a thread owns, rounded up to a multiple of
// kClusterBucketStep.  Each column of a bucket past the slice costs a
// guarded iteration in both loops: buckets of 8, 16 and 32 columns took
// 4.28 ms at 100,000 x 40,000 bf16 (20 columns a thread) on an H100
// 80GB HBM3, buckets of 4 3.22 (PERF.md).
constexpr int kClusterBucketStep = 4;

template <int J = kClusterBucketStep, typename F>
auto with_bucket(int64_t slice, F&& f) {
  if constexpr (J < kClusterMaxCols) {
    if ((slice + kClusterThreads - 1) / kClusterThreads > J)
      return with_bucket<J + kClusterBucketStep>(slice, f);
  }
  return f(std::integral_constant<int, J>{});
}

// Shared-memory layout of one block of the cluster mode: the stages'
// mbarriers and the two parities' partial-dot mbarriers, the warps'
// partial dots of a stage, the two parities' slots of the ranks' partial
// dots (a row's kClusterMaxSize slots, one a rank), the stage's
// multipliers, w's slice, then the ring (stages x rows, each row slice
// 16-byte aligned with 16 bytes of slack, so that its byte offset modulo
// 16 can match its address in device memory).
struct ClusterLayout {
  int64_t mbar, red, slot, mult, w, ring, row_stride, total;
};

__host__ __device__ inline ClusterLayout cluster_layout(int64_t slice,
                                                        int rows,
                                                        int itemsize) {
  ClusterLayout s;
  s.mbar = 0;
  s.red = 8 * (kClusterStages + 2);
  s.slot = s.red + 4 * kClusterMaxRows * kClusterWarps;
  s.mult = s.slot + 4 * 2 * kClusterMaxRows * kClusterMaxSize;
  s.w = round_up(s.mult + 4 * kClusterMaxRows, 16);
  s.ring = round_up(s.w + 4 * slice, 128);
  s.row_stride = round_up(slice * itemsize, 16) + kTileSlack;
  s.total = s.ring + int64_t(kClusterStages) * rows * s.row_stride;
  return s;
}

// Rows a stage holds for X of width d in clusters of c blocks (at most
// kClusterMaxRows), or 0 where not one row fits, or the slice is too wide
// for the register buckets or leaves the last block no columns.
int cluster_rows(int64_t d, int c, int itemsize) {
  const int64_t slice = cluster_slice(d, c);
  if (slice > int64_t(kClusterThreads) * kClusterMaxCols ||
      d - (c - 1) * slice < 1)
    return 0;
  for (int rows = kClusterMaxRows; rows >= 1; --rows)
    if (cluster_layout(slice, rows, itemsize).total <= kSmemBlock)
      return rows;
  return 0;
}

template <typename T, int L, int J>
__global__ void __launch_bounds__(kClusterThreads, 1)
    margin_cluster(const T* __restrict__ X, const float* __restrict__ y,
                   const float* __restrict__ mask,
                   const float* __restrict__ w, int64_t n, int64_t d,
                   int rows, int64_t slice, int bulk,
                   float* __restrict__ partial_loss,
                   float* __restrict__ partial_grad) {
  extern __shared__ __align__(128) unsigned char smem[];
  const ClusterLayout lay = cluster_layout(slice, rows, int(sizeof(T)));
  uint64_t* mbar = reinterpret_cast<uint64_t*>(smem + lay.mbar);
  float* red_s = reinterpret_cast<float*>(smem + lay.red);
  float* slot_s = reinterpret_cast<float*>(smem + lay.slot);
  float* mult_s = reinterpret_cast<float*>(smem + lay.mult);
  float* w_s = reinterpret_cast<float*>(smem + lay.w);
  unsigned char* ring = smem + lay.ring;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int rank = cluster_rank();
  const int blocks = cluster_blocks();
  const int64_t cid = cluster_id();
  const int64_t clusters = cluster_count();
  const int64_t c0 = int64_t(rank) * slice;
  // this block's columns (at most kClusterThreads * J)
  const int cols = int(rank == blocks - 1 ? d - c0 : slice);
  const int64_t rows_per_cluster = (n + clusters - 1) / clusters;
  const int64_t r_begin = min64(n, cid * rows_per_cluster);
  const int64_t r_end = min64(n, r_begin + rows_per_cluster);
  const int64_t stages = (r_end - r_begin + rows - 1) / rows;
  const T* x_end = X + n * d;

  for (int c = tid; c < cols; c += kClusterThreads) w_s[c] = w[c0 + c];
  uint64_t* dots_bar = mbar + kClusterStages;  // a parity's partials in
  if (tid == 0) {
    for (int b = 0; b < kClusterStages + 2; ++b) mbar_init(&mbar[b]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  cluster_sync();

  // Fill stage s's buffer: the row slices of its rows, each at its own
  // address modulo 16 (0 for bulk copies).
  auto issue = [&](int64_t s) {
    const int64_t row0 = r_begin + s * rows;
    const int here = int(min64(rows, r_end - row0));
    unsigned char* buf =
        ring + int64_t(s % kClusterStages) * rows * lay.row_stride;
    if (bulk) {
      if (tid == 0) {
        uint64_t* bar = &mbar[s % kClusterStages];
        const uint32_t bytes = uint32_t(cols) * uint32_t(sizeof(T));
        mbar_expect_bytes(bar, bytes * uint32_t(here));
        for (int r = 0; r < here; ++r)
          bulk_copy(buf + r * lay.row_stride, X + (row0 + r) * d + c0, bytes,
                    bar);
      }
    } else {
      for (int r = 0; r < here; ++r)
        copy_tile_async<kClusterThreads>(
            X + (row0 + r) * d + c0, int64_t(cols) * int64_t(sizeof(T)),
            buf + r * lay.row_stride, X, x_end);
    }
  };
  // row r of stage s in shared memory
  auto row_of = [&](int64_t s, int r) {
    const T* src = X + (r_begin + s * rows + r) * d + c0;
    return reinterpret_cast<const T*>(
        ring + (int64_t(s % kClusterStages) * rows + r) * lay.row_stride +
        (reinterpret_cast<uintptr_t>(src) & 15));
  };

  for (int s = 0; s < kClusterStages; ++s) {
    if (s < stages) issue(s);
    if (!bulk) cp_async_commit();
  }

  float g[J];
#pragma unroll
  for (int j = 0; j < J; ++j) g[j] = 0.f;
  Kahan loss_acc;
  for (int64_t s = 0; s < stages; ++s) {
    const int64_t row0 = r_begin + s * rows;
    const int here = int(min64(rows, r_end - row0));
    // the middle's inputs, loaded while the stage lands
    float yv = 0.f, mv = 0.f;
    if (tid < here) {
      yv = y[row0 + tid];
      mv = mask[row0 + tid];
    }
    if (bulk)
      mbar_wait(&mbar[s % kClusterStages],
                uint32_t((s / kClusterStages) & 1));
    else
      cp_async_wait<kClusterStages - 1>();
    __syncthreads();

    // this block's partial dots: each thread over its columns, a shuffle
    // tree, then the warps in order
    for (int r = 0; r < here; ++r) {
      const T* xr = row_of(s, r);
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int c = tid + j * kClusterThreads;
        if (c < cols) acc = fmaf(to_f32(xr[c]), w_s[c], acc);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (lane == 0) red_s[r * kClusterWarps + warp] = acc;
    }
    __syncthreads();
    // row r's partial from rank q lands in slot[r * kClusterMaxSize + q]
    float* slot = slot_s + (s & 1) * kClusterMaxRows * kClusterMaxSize;
    uint64_t* bar = &dots_bar[s & 1];
    if (tid == 0) mbar_expect_bytes(bar, uint32_t(blocks * here * 4));
    if (tid < here) {
      float p = 0.f;
      for (int i = 0; i < kClusterWarps; ++i)
        p += red_s[tid * kClusterWarps + i];
      for (int q = 0; q < blocks; ++q)
        send_peer(&slot[tid * kClusterMaxSize + rank], p, bar, q);
    }
    mbar_wait(bar, uint32_t((s >> 1) & 1));
    // the whole dot, the same in every block: the ranks' partials in order
    if (tid < here) {
      float dot = 0.f;
      for (int q = 0; q < blocks; ++q)
        dot += slot[tid * kClusterMaxSize + q];
      float per, mult;
      loss_middle<L>(dot, yv, &per, &mult);
      mult_s[tid] = mult * mv;
      if (rank == 0) loss_acc.add(per * mv);
    }
    __syncthreads();

    // the gradient over this block's columns from the resident rows
    for (int r = 0; r < here; ++r) {
      const T* xr = row_of(s, r);
      const float mr = mult_s[r];
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int c = tid + j * kClusterThreads;
        if (c < cols) g[j] = fmaf(mr, to_f32(xr[c]), g[j]);
      }
    }
    __syncthreads();  // the stage's buffer is free
    if (s + kClusterStages < stages) issue(s + kClusterStages);
    if (!bulk) cp_async_commit();
  }
  cluster_sync();

#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int c = tid + j * kClusterThreads;
    if (c < cols) partial_grad[cid * d + c0 + c] = g[j];
  }
  if (rank == 0) {
    if (tid < kClusterMaxRows) red_s[tid] = loss_acc.s;
    __syncthreads();
    if (tid == 0) {
      Kahan k;
      for (int i = 0; i < kClusterMaxRows; ++i) k.add(red_s[i]);
      partial_loss[cid] = k.s;
    }
  }
}

// Stream mode: the single-block counterpart of the cluster mode, past
// the tile's few hundred columns up to stream_max_width (8,192 f32 or
// 16,384 bf16 columns; single_block_mode).  What held these widths back
// in the tile: w and the gradient sums in shared memory beside the tile, a
// tile copied synchronously between three barriers, one warp a row for
// the dots, and past about 1,900 f32 columns one block an SM, so nothing
// in flight while it computed.  Here each of kStreamThreads threads owns
// the columns tid + kStreamThreads j (j < J, J the register bucket) with
// w and the gradient sums in registers for the block's whole row range,
// and rows stream through a ring of `stages` stages of R =
// stream_rows(J, itemsize) contiguous rows (one cp.async.bulk a stage
// of the 16-byte chunks that cover its rows, completing on the stage's
// mbarrier, whatever the rows' alignment: issue_stage).
// Every warp works on every row of a stage: each thread's partial dots
// of the R rows, reduced across the warp and scattered so that lane l
// holds row l / (32 / R)'s (reduce_scatter); after a barrier thread r
// adds the warps' partials of row r in warp order and applies the loss
// middle; after a second, every thread adds mult * x into its registers.
// Two barriers a stage and none a row; a stage's buffer is refilled once
// every thread has passed the next stage's first barrier.  The blocks'
// partials go through reduce_partials in block order.
constexpr int kStreamThreads = kClusterThreads;
constexpr int kStreamWarps = kStreamThreads / 32;
constexpr int kStreamMaxCols = 32;
// Bytes of X a stage holds at most.
constexpr int64_t kStreamStageBytes = 64 * 1024;
// The ring's stages (fewer where they do not fit), and the fewest taken.
constexpr int kStreamStages = 4;
constexpr int kStreamMinStages = 2;

// Rows of a stage for the register bucket J and `itemsize`-byte
// elements: a power of 2 (for reduce_scatter), at most 32, whose rows of
// kStreamThreads * J columns take at most kStreamStageBytes.
__host__ __device__ constexpr int stream_rows(int j, int itemsize) {
  int rows = 32;
  while (rows > 1 &&
         int64_t(rows) * kStreamThreads * j * itemsize > kStreamStageBytes)
    rows /= 2;
  return rows;
}

__host__ __device__ constexpr int log2_of(int v) {
  return v <= 1 ? 0 : 1 + log2_of(v / 2);
}

// f(std::integral_constant<int, J>{}) with J the register bucket of X of
// width d: 1, 2, then multiples of 4 up to kStreamMaxCols (each column of
// a bucket past d costs a guarded iteration, as in the cluster mode).
template <int J = 1, typename F>
auto with_stream_bucket(int64_t d, F&& f) {
  if constexpr (J < kStreamMaxCols) {
    if ((d + kStreamThreads - 1) / kStreamThreads > J)
      return with_stream_bucket<J < 4 ? 2 * J : J + 4>(d, f);
  }
  return f(std::integral_constant<int, J>{});
}

// Columns a thread owns at most: kStreamMaxCols in bf16, 16 in f32 (past
// that the cluster mode at 2 blocks took no longer, single_block_mode).
__host__ __device__ constexpr int stream_max_cols(int itemsize) {
  return itemsize == 4 ? 16 : kStreamMaxCols;
}

// The widest X the stream mode takes.
int64_t stream_max_width(int itemsize) {
  return int64_t(kStreamThreads) * stream_max_cols(itemsize);
}

// Rows of a stage for X of width d (0 where the mode does not take it).
int stream_bucket_rows(int64_t d, int itemsize) {
  if (d > stream_max_width(itemsize)) return 0;
  return with_stream_bucket(d, [&](auto j) {
    return stream_rows(decltype(j)::value, itemsize);
  });
}

// Shared-memory layout of one block of the stream mode: the stages'
// mbarriers, the warps' partial dots of a stage (kStreamWarps x 32
// rows), the stage's multipliers, then the ring (each stage R rows of X,
// contiguous, placed at their address modulo 16 with 16 bytes of slack
// for the chunks that cover them).
struct StreamLayout {
  int64_t mbar, red, mult, ring, stage, total;
};

__host__ __device__ inline StreamLayout stream_layout(int64_t d, int rows,
                                                      int stages,
                                                      int itemsize) {
  StreamLayout s;
  s.mbar = 0;
  s.red = 8 * kStreamStages;
  s.mult = s.red + 4 * 32 * kStreamWarps;
  s.ring = round_up(s.mult + 4 * 32, 128);
  s.stage = round_up(rows * d * itemsize, 16) + kTileSlack;
  s.total = s.ring + stages * s.stage;
  return s;
}

// The ring's stages for X of width d (at most kStreamStages), or 0 where
// the mode does not take d or kStreamMinStages stages do not fit.
int stream_stages(int64_t d, int itemsize) {
  const int rows = stream_bucket_rows(d, itemsize);
  if (rows < 1) return 0;
  for (int st = kStreamStages; st >= kStreamMinStages; --st)
    if (stream_layout(d, rows, st, itemsize).total <= kSmemBlock) return st;
  return 0;
}

template <typename T, int J>
__global__ void __launch_bounds__(kStreamThreads, 1)
    margin_stream(const T* __restrict__ X, const float* __restrict__ y,
                  const float* __restrict__ mask,
                  const float* __restrict__ w, int64_t n, int d, int stages,
                  int loss_kind, float* __restrict__ partial_loss,
                  float* __restrict__ partial_grad) {
  constexpr int R = stream_rows(J, int(sizeof(T)));
  constexpr int Q = log2_of(R);
  extern __shared__ __align__(128) unsigned char smem[];
  const StreamLayout lay = stream_layout(d, R, stages, int(sizeof(T)));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + lay.mbar);
  float* red_s = reinterpret_cast<float*>(smem + lay.red);
  float* mult_s = reinterpret_cast<float*>(smem + lay.mult);
  unsigned char* ring = smem + lay.ring;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int64_t nblocks = gridDim.x;
  const int64_t rows_per_block = (n + nblocks - 1) / nblocks;
  const int64_t r_begin = min64(n, int64_t(blockIdx.x) * rows_per_block);
  const int64_t r_end = min64(n, r_begin + rows_per_block);
  const int64_t nst = (r_end - r_begin + R - 1) / R;
  const T* x_end = X + n * d;

  float wr[J], g[J];
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int c = tid + j * kStreamThreads;
    wr[j] = c < d ? w[c] : 0.f;
    g[j] = 0.f;
  }
  if (tid == 0) {
    for (int b = 0; b < stages; ++b)
      mbar_init(&full[b]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Fill stage s's buffer with its rows, at their address modulo 16.
  auto issue = [&](int64_t s) {
    if (tid != 0) return;
    const int64_t row0 = r_begin + s * R;
    const int64_t row1 = min64(r_end, row0 + R);
    issue_stage(ring + (s % stages) * lay.stage, X + row0 * d, X + row1 * d,
                X, x_end, &full[s % stages]);
  };
  for (int64_t s = 0; s < stages && s < nst; ++s) issue(s);

  // the middle's inputs of row tid of stage s, loaded a stage ahead (at
  // 10M rows y and the mask come from device memory, not L2: loaded
  // where they are used, their latency stood in every stage)
  auto load_middle = [&](int64_t s, float* yv, float* mv) {
    const int64_t row = r_begin + s * R + tid;
    const bool live = tid < R && s < nst && row < r_end;
    *yv = live ? y[row] : 0.f;
    *mv = live ? mask[row] : 0.f;
  };
  float y_next, m_next;
  load_middle(0, &y_next, &m_next);

  Kahan loss_acc;
  for (int64_t s = 0; s < nst; ++s) {
    const int64_t row0 = r_begin + s * R;
    const int here = int(min64(R, r_end - row0));
    const float yv = y_next, mv = m_next;
    load_middle(s + 1, &y_next, &m_next);
    mbar_wait(&full[s % stages], uint32_t((s / stages) & 1));
    const T* xs = reinterpret_cast<const T*>(
        ring + (s % stages) * lay.stage +
        (reinterpret_cast<uintptr_t>(X + row0 * d) & 15));

    // each thread's partial dots of the stage's rows, over its columns
    float p[R];
#pragma unroll
    for (int u = 0; u < R; ++u) {
      p[u] = 0.f;
      if (u < here) {
#pragma unroll
        for (int j = 0; j < J; ++j) {
          const int c = tid + j * kStreamThreads;
          if (c < d) p[u] = fmaf(to_f32(xs[u * d + c]), wr[j], p[u]);
        }
      }
    }
    // the warp's sums, lane l holding row l / (32 / R)'s
    reduce_scatter<R>(p, lane);
    float dot = p[0];
#pragma unroll
    for (int off = 16 >> Q; off > 0; off >>= 1)
      dot += __shfl_xor_sync(0xffffffffu, dot, off);
    if (lane % (32 / R) == 0) red_s[warp * 32 + lane / (32 / R)] = dot;
    __syncthreads();
    // every thread is past the previous stage: refill its buffer
    if (s >= 1 && s - 1 + stages < nst) issue(s - 1 + stages);
    // the whole dot of row tid: the warps' partials in order
    if (tid < here) {
      float full_dot = 0.f;
      for (int i = 0; i < kStreamWarps; ++i) full_dot += red_s[i * 32 + tid];
      float per, mult;
      loss_middle_of(loss_kind, full_dot, yv, &per, &mult);
      mult_s[tid] = mult * mv;
      loss_acc.add(per * mv);
    }
    __syncthreads();

    // the gradient over this thread's columns from the resident rows
#pragma unroll
    for (int u = 0; u < R; ++u) {
      if (u < here) {
        const float mu = mult_s[u];
#pragma unroll
        for (int j = 0; j < J; ++j) {
          const int c = tid + j * kStreamThreads;
          if (c < d) g[j] = fmaf(mu, to_f32(xs[u * d + c]), g[j]);
        }
      }
    }
  }

#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int c = tid + j * kStreamThreads;
    if (c < d) partial_grad[int64_t(blockIdx.x) * d + c] = g[j];
  }
  // no thread reads red_s past the last stage's second barrier
  if (tid < R) red_s[tid] = loss_acc.s;
  __syncthreads();
  if (tid == 0) {
    Kahan k;
    for (int i = 0; i < R; ++i) k.add(red_s[i]);
    partial_loss[blockIdx.x] = k.s;
  }
}

// Grid mode: X past the cluster mode, read once.  What stops the cluster
// mode at 262,144 columns: a cluster holds at most 16 blocks of
// kClusterThreads threads x kClusterMaxCols register columns, and 16-block
// clusters leave SMs of the card idle; the two-pass mode past it read X
// twice and w from L2 once a row.  Here the grid is one kGridThreads-thread
// block on each SM (at most; fewer where X has fewer units of
// kSliceAlign columns), launched cooperatively so that every block is
// resident at once (the blocks wait on each other; a launch that the card
// refuses returns its error and nothing runs in its place).  Block b owns
// a column slice of every row: X's units of kSliceAlign columns are dealt
// in order, the first units % blocks blocks one more than the rest
// (grid_slice), so that every block has columns, every slice starts on a
// unit and the slices differ by at most a unit (a slice ceil(d / blocks)
// rounded up to the unit can leave the last blocks nothing: 262,145
// columns in 132 blocks).  Each thread keeps w and the gradient sums of
// the columns tid + kGridThreads j (j < J, the register bucket) in
// registers for all N rows.  Rows stream through a ring of S stages of
// `rows` rows: the last warp copies a stage, lane r row r's slice with one
// cp.async.bulk of the 16-byte chunks that cover it, completing on the
// stage's mbarrier, whatever the rows' alignment (issue_rows).
//
// A stage: its rows' partial dots over the block's slice (each thread's
// over its columns, reduce-scattered across the warp as in the stream
// mode, then the warps' in order) go through L2, each as one 64-bit word
// that carries its stage: block b stores its partial dot of row r of stage
// t, tagged t + 1, at parts[t % kGridSlots][r][b] (a relaxed store from a
// warp that gathers nothing: the value and its tag are one
// single-copy-atomic word, so no fence orders them); warp r of every block
// reads row r's word of every block (lane l the blocks l, l + 32, ...,
// relaxed loads past L1) until each carries the tag t + 1, then adds the
// values in a fixed order (lane l its blocks in turn, then a shuffle
// tree), so every block forms the same dot bit for bit and applies the
// loss middle itself; block 0 alone counts the loss; then every thread
// adds mult * x into its registers.  Three barriers a stage, no float
// atomics, no fence and no grid-wide barrier.  A block publishes stage
// t + A's partials (A = kGridAhead stages ahead, fewer where the ring is
// short) before it needs stage t's, and where A >= 2 it loads stage
// t + 1's words in iteration t, so the L2 round trip (about 2 µs while X
// streams) stays off the stage's path.  (This code at kGridAhead = 1
// timed as fast as at 2; the same loop rewritten for one stage ahead
// alone, without the early loads, 1.27x slower at 262,145 f32 columns,
// with 22 registers fewer: PERF.md.)  A first build, a flag word a block
// published with a release store after the partials and read after an
// acquire fence, ran no faster than the two-pass mode (PERF.md).
// The slots: a block stores stage t + A's partials in its iteration t,
// after it has read every block's stage t - 1 words, which every block
// stored in its iteration t - 1 - A, after it had read stage t - 2 - A's;
// so stages t - 1 - A ... t + A may be in use, and 2 A + 2 slots suffice
// (kGridSlots).  The words are zeroed on the call's stream before each
// launch (launch_grid), so no tag of an earlier call is read.  Each block
// writes its slice of the gradient, and block 0 the loss, straight to the
// outputs.
constexpr int kGridThreads = kClusterThreads;
constexpr int kGridWarps = kGridThreads / 32;
constexpr int kGridMaxRows = 8;
// The ring's stages at most and at least, and the stages a block
// publishes ahead of the one whose dots it needs (fewer where the ring has
// fewer than kGridAhead + 2 stages).
constexpr int kGridStages = 4;
constexpr int kGridMinStages = 3;
constexpr int kGridAhead = 2;
constexpr int kGridSlots = 2 * kGridAhead + 2;
// Columns a thread owns at most (the largest register bucket), and the
// most blocks a warp's lanes read (5 a lane; the H100 has 132 SMs).
constexpr int kGridMaxCols = kClusterMaxCols;
constexpr int kGridMaxBlocks = 160;
static_assert(kGridMaxRows <= kGridWarps - 2,
              "warp r < rows gathers row r; the last two warps store the "
              "partial dots and copy the rows");
static_assert((kGridMaxRows & (kGridMaxRows - 1)) == 0 && kGridMaxRows <= 32,
              "a stage's dots are reduce-scattered across a warp");
// A block that waits this long for its peers' words traps (the launch
// fails with an error) instead of hanging: with every block resident
// that does not happen.
constexpr uint64_t kGridWaitNs = 20'000'000'000ull;

// X's units of kSliceAlign columns.
__host__ __device__ inline int64_t grid_units(int64_t d) {
  return (d + kSliceAlign - 1) / kSliceAlign;
}

// Block b's slice of X of width d in `blocks` blocks: its first column and
// its columns.
__host__ __device__ inline void grid_slice(int64_t d, int blocks, int b,
                                           int64_t* c0, int* cols) {
  const int64_t units = grid_units(d);
  const int64_t q = units / blocks, r = units % blocks;
  const int64_t first = b * q + (b < r ? b : r);
  const int64_t end = (first + q + (b < r ? 1 : 0)) * kSliceAlign;
  *c0 = first * kSliceAlign;
  *cols = int((end < d ? end : d) - *c0);
}

// The widest slice, in columns.
__host__ __device__ inline int64_t grid_slice_max(int64_t d, int blocks) {
  const int64_t units = grid_units(d);
  return (units / blocks + (units % blocks ? 1 : 0)) * kSliceAlign;
}

// Shared-memory layout of one block of the grid mode: the stages'
// mbarriers, the warps' partial dots of a stage (row-major), the stage's
// multipliers, then the ring (stages x rows, each row slice at its
// address modulo 16 with 16 bytes of slack).
struct GridLayout {
  int64_t mbar, red, mult, ring, row_stride, total;
};

__host__ __device__ inline GridLayout grid_layout(int64_t slice, int rows,
                                                  int stages, int itemsize) {
  GridLayout s;
  s.mbar = 0;
  s.red = 8 * kGridStages;
  s.mult = s.red + 4 * kGridMaxRows * kGridWarps;
  s.ring = round_up(s.mult + 4 * kGridMaxRows, 128);
  s.row_stride = round_up(slice * itemsize, 16) + kTileSlack;
  s.total = s.ring + int64_t(stages) * rows * s.row_stride;
  return s;
}

// The ring's stages for X of width d in `blocks` blocks: kGridStages where
// that many stages of one row fit, else kGridMinStages; 0 where a slice
// is too wide for the register buckets or kGridMinStages rows do not fit.
int grid_stages(int64_t d, int blocks, int itemsize) {
  if (blocks < 1 || blocks > kGridMaxBlocks || grid_units(d) < blocks)
    return 0;
  const int64_t slice = grid_slice_max(d, blocks);
  if (slice > int64_t(kGridThreads) * kGridMaxCols) return 0;
  for (int stages = kGridStages; stages >= kGridMinStages; --stages)
    if (grid_layout(slice, 1, stages, itemsize).total <= kSmemBlock)
      return stages;
  return 0;
}

// Rows a stage holds for X of width d in `blocks` blocks (at most
// kGridMaxRows, in a ring of grid_stages stages), or 0 where the mode does
// not take the width.
int grid_rows(int64_t d, int blocks, int itemsize) {
  const int stages = grid_stages(d, blocks, itemsize);
  if (stages == 0) return 0;
  const int64_t slice = grid_slice_max(d, blocks);
  for (int rows = kGridMaxRows; rows >= 1; --rows)
    if (grid_layout(slice, rows, stages, itemsize).total <= kSmemBlock)
      return rows;
  return 0;
}

// Floats of the exchange scratch for `blocks` blocks and stages of `rows`
// rows: the slots' tagged words, two floats each.
int64_t grid_scratch_floats(int blocks, int rows) {
  return 2 * int64_t(kGridSlots) * rows * blocks;
}

__device__ __forceinline__ uint64_t ld_relaxed64(const uint64_t* p) {
  uint64_t v;
  asm volatile("ld.relaxed.gpu.global.b64 %0, [%1];\n"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_relaxed64(uint64_t* p, uint64_t v) {
  asm volatile("st.relaxed.gpu.global.b64 [%0], %1;\n" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// Fill `buf` (stride `stride` a row) with the `here` (at most 32) row
// slices of `cols` elements that start at `a` and lie `d` elements apart
// in X (whose elements lie in [lo_x, hi_x)), each at its address modulo 16
// past its row of buf, completing on `bar` (one arrival), with the lanes
// of one warp, lane r row r: a bulk copy of the 16-byte chunks that cover
// the slice and lie in X, and plain copies of the elements at X's ends
// that no such chunk holds, stored before the arrival that releases them.
// (One thread issuing a stage's 7 rows at 262,145 f32 columns kept the
// rest of the block at the next barrier for about 1 µs a stage.)
template <typename T>
__device__ __forceinline__ void issue_rows(unsigned char* buf,
                                           int64_t stride, const T* a,
                                           int cols, int64_t d, int here,
                                           const T* lo_x, const T* hi_x,
                                           uint64_t* bar, int lane) {
  // this lane's slice [ua, ue), the 16-byte boundary below it and the
  // chunks [lo, hi) that cover it within X (lo = hi = ue where none does)
  uintptr_t ua = 0, ue = 0, base = 0, lo = 0, hi = 0;
  if (lane < here) {
    ua = reinterpret_cast<uintptr_t>(a + lane * d);
    ue = ua + uintptr_t(cols) * sizeof(T);
    base = ua & ~uintptr_t(15);
    const uintptr_t lo_c =
        (reinterpret_cast<uintptr_t>(lo_x) + 15) & ~uintptr_t(15);
    const uintptr_t hi_c =
        reinterpret_cast<uintptr_t>(hi_x) & ~uintptr_t(15);
    const uintptr_t e16 = (ue + 15) & ~uintptr_t(15);
    lo = lo_c > base ? lo_c : base;
    hi = hi_c < e16 ? hi_c : e16;
    if (hi <= lo) lo = hi = ue;
    unsigned char* row = buf + lane * stride;
    for (uintptr_t q = ua; q < (lo < ue ? lo : ue); q += sizeof(T))
      *reinterpret_cast<T*>(row + (q - base)) =
          *reinterpret_cast<const T*>(q);
    for (uintptr_t q = hi > ua ? hi : ua; q < ue; q += sizeof(T))
      *reinterpret_cast<T*>(row + (q - base)) =
          *reinterpret_cast<const T*>(q);
  }
  const uint32_t bytes =
      __reduce_add_sync(0xffffffffu, uint32_t(hi - lo));
  // the lanes' plain stores, ordered before lane 0's arrival (whose
  // release covers them), and the arrival before the bulk copies
  __syncwarp();
  if (lane == 0) mbar_expect_bytes(bar, bytes);
  __syncwarp();
  if (hi > lo)
    bulk_copy(buf + lane * stride + (lo - base),
              reinterpret_cast<const void*>(lo), uint32_t(hi - lo), bar);
}

template <typename T, int J>
__global__ void __launch_bounds__(kGridThreads, 1)
    margin_grid(const T* __restrict__ X, const float* __restrict__ y,
                const float* __restrict__ mask, const float* __restrict__ w,
                int64_t n, int64_t d, int rows, int stages, int loss_kind,
                uint64_t* parts, float* __restrict__ loss_out,
                float* __restrict__ grad_out) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int blocks = gridDim.x;
  const int b = blockIdx.x;
  const GridLayout lay = grid_layout(grid_slice_max(d, blocks), rows, stages,
                                     int(sizeof(T)));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + lay.mbar);
  float* red_s = reinterpret_cast<float*>(smem + lay.red);
  float* mult_s = reinterpret_cast<float*>(smem + lay.mult);
  unsigned char* ring = smem + lay.ring;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  // the warp that copies the rows and the warp that stores the block's
  // partial dots: warps that gather no row
  const int issuer = kGridWarps - 1;
  const int storer = kGridWarps - 2;
  const int ahead = stages - 2 < kGridAhead ? stages - 2 : kGridAhead;
  int64_t c0;
  int cols;
  grid_slice(d, blocks, b, &c0, &cols);

  float wr[J], g[J];
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int c = tid + j * kGridThreads;
    wr[j] = c < cols ? w[c0 + c] : 0.f;
    g[j] = 0.f;
  }
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) mbar_init(&full[s]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // A stage's number, its buffer in the ring and its mbarrier's phase,
  // stepped one stage at a time: no division by the ring's length (a
  // 64-bit one by a run-time value costs hundreds of cycles).
  struct Pos {
    int s, buf;
    uint32_t phase;
  };
  auto next = [&](Pos& p) {
    ++p.s;
    if (++p.buf == stages) {
      p.buf = 0;
      p.phase ^= 1u;
    }
  };
  auto here_of = [&](int s) {
    return int(min64(rows, n - int64_t(s) * rows));
  };
  // the first element of stage s's row r in X
  auto src_of = [&](int s, int r) {
    return X + (int64_t(s) * rows + r) * d + c0;
  };
  // row r of the stage at p in shared memory
  auto row_of = [&](const Pos& p, int r) {
    return reinterpret_cast<const T*>(
        ring + int64_t(p.buf * rows + r) * lay.row_stride +
        (reinterpret_cast<uintptr_t>(src_of(p.s, r)) & 15));
  };
  // Fill the buffer of the stage at p with its row slices.
  auto issue = [&](const Pos& p) {
    if (warp == issuer)
      issue_rows(ring + int64_t(p.buf * rows) * lay.row_stride,
                 lay.row_stride, src_of(p.s, 0), cols, d, here_of(p.s), X,
                 X + n * d, &full[p.buf], lane);
  };
  // stage s's tagged words of row r
  auto words = [&](int s, int r) {
    return parts + int64_t((s % kGridSlots) * rows + r) * blocks;
  };

  // The partial dots of this block's slice of the stage at p, stored
  // tagged: each thread's over its columns for every row of the stage,
  // reduced across the warp and scattered so that lane u * (32 /
  // kGridMaxRows) holds row u's (reduce_scatter: log2(kGridMaxRows)
  // halving steps for all the rows at once, where a shuffle tree a row
  // took 0.13 µs a row at 262,145 f32), then the warps' in order.
  auto publish = [&](const Pos& p) {
    constexpr int R = kGridMaxRows;
    constexpr int Q = log2_of(R);
    const int here = here_of(p.s);
    mbar_wait(&full[p.buf], p.phase);
    float acc[R];
#pragma unroll
    for (int u = 0; u < R; ++u) {
      acc[u] = 0.f;
      if (u < here) {
        const T* xr = row_of(p, u);
#pragma unroll
        for (int j = 0; j < J; ++j) {
          const int c = tid + j * kGridThreads;
          if (c < cols) acc[u] = fmaf(to_f32(xr[c]), wr[j], acc[u]);
        }
      }
    }
    reduce_scatter<R>(acc, lane);
    float dot = acc[0];
#pragma unroll
    for (int off = 16 >> Q; off > 0; off >>= 1)
      dot += __shfl_xor_sync(0xffffffffu, dot, off);
    if (lane % (32 / R) == 0)
      red_s[(lane / (32 / R)) * kGridWarps + warp] = dot;
    __syncthreads();
    if (warp == storer && lane < here) {
      float sum = 0.f;
      for (int i = 0; i < kGridWarps; ++i)
        sum += red_s[lane * kGridWarps + i];
      st_relaxed64(words(p.s, lane) + b, (uint64_t(p.s + 1) << 32) |
                                             __float_as_uint(sum));
    }
  };

  // Stages below nst; the grid mode's X has fewer than 2^31 rows.
  const int nst = int((n + rows - 1) / rows);
  Pos fill{0, 0, 0};  // the next stage to copy
  for (int k = 0; k < stages && fill.s < nst; ++k) {
    issue(fill);
    next(fill);
  }
  Pos pub{0, 0, 0};  // the next stage to publish
  for (int k = 0; k < ahead && pub.s < nst; ++k) {
    publish(pub);
    next(pub);
    // The storer reads red_s past publish's barrier, and the next
    // publish writes it at once: this barrier keeps them apart (in the
    // loop, a stage's own two barriers do).
    __syncthreads();
  }

  // The middle's inputs of row `warp` of stage s and every block's word
  // of it, loaded by the warps that gather that stage.  Under a full
  // stream of X an L2 round trip took about 2 µs: loaded at the top of
  // the iteration that used them, the words held a stage of 7 rows at
  // 262,145 f32 for 1.2 µs past its dots.  So where the stages are
  // published two or more ahead, stage t + 1's are loaded in iteration t,
  // an iteration after its peers stored them.
  struct Inputs {
    float y, m;
    uint64_t v[kGridMaxBlocks / 32];
  };
  auto fetch = [&](int s, Inputs& in) {
    if (s < nst && warp < here_of(s)) {
      const int64_t row = int64_t(s) * rows + warp;
      in.y = y[row];
      in.m = mask[row];
      const uint64_t* mine = words(s, warp);
#pragma unroll
      for (int k = 0; k < kGridMaxBlocks / 32; ++k)
        if (lane + 32 * k < blocks)
          in.v[k] = ld_relaxed64(mine + lane + 32 * k);
    }
  };
  const bool early = ahead >= 2;
  Inputs next_in;
  if (early) fetch(0, next_in);

  Kahan loss_acc;  // block 0, lane 0 of warp r: row r of every stage
  for (Pos cur{0, 0, 0}; cur.s < nst; next(cur)) {
    const int t = cur.s;
    const int here = here_of(t);
    const bool gathers = warp < here;
    Inputs in;
    if (early) {
      in = next_in;
      fetch(t + 1, next_in);
    } else {
      fetch(t, in);
    }
    if (pub.s < nst) {
      publish(pub);
      next(pub);
    }

    // row `warp`'s whole dot: every block's partial, in a fixed order
    if (gathers) {
      const uint32_t want = uint32_t(t + 1);
      const uint64_t* mine = words(t, warp);
      uint64_t since = 0;
      for (;;) {
        bool ready = true;
#pragma unroll
        for (int k = 0; k < kGridMaxBlocks / 32; ++k)
          if (lane + 32 * k < blocks)
            ready &= uint32_t(in.v[k] >> 32) == want;
        if (__all_sync(0xffffffffu, ready)) break;
        if (since == 0) since = global_ns();
        if (global_ns() - since > kGridWaitNs) __trap();
#pragma unroll
        for (int k = 0; k < kGridMaxBlocks / 32; ++k)
          if (lane + 32 * k < blocks && uint32_t(in.v[k] >> 32) != want)
            in.v[k] = ld_relaxed64(mine + lane + 32 * k);
      }
      float dot = 0.f;
#pragma unroll
      for (int k = 0; k < kGridMaxBlocks / 32; ++k)
        if (lane + 32 * k < blocks) dot += __uint_as_float(uint32_t(in.v[k]));
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, off);
      if (lane == 0) {
        float per, mult;
        loss_middle_of(loss_kind, dot, in.y, &per, &mult);
        mult_s[warp] = mult * in.m;
        if (b == 0) loss_acc.add(per * in.m);
      }
    }
    __syncthreads();

    // the gradient over this block's columns from the resident rows
    for (int r = 0; r < here; ++r) {
      const T* xr = row_of(cur, r);
      const float mr = mult_s[r];
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int c = tid + j * kGridThreads;
        if (c < cols) g[j] = fmaf(mr, to_f32(xr[c]), g[j]);
      }
    }
    __syncthreads();  // stage t's buffer is free
    if (fill.s < nst) {
      issue(fill);
      next(fill);
    }
  }

#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int c = tid + j * kGridThreads;
    if (c < cols) grad_out[c0 + c] = g[j];
  }
  if (b == 0) {
    // no thread reads red_s past the last stage's barriers
    if (lane == 0 && warp < kGridMaxRows) red_s[warp] = loss_acc.s;
    __syncthreads();
    if (tid == 0) {
      Kahan k;
      for (int i = 0; i < kGridMaxRows; ++i) k.add(red_s[i]);
      loss_out[0] = k.s;
    }
  }
}

// Stage 2 of the narrow mode: a warp per gradient column (and one for
// the loss, warp d), each lane summing every 32nd partial, then a
// shuffle tree; a fixed order, as reduce_partials keeps, but 32 lanes
// wide where its one thread a column would walk every block's partial in
// turn.
__global__ void reduce_partials_warp(const float* __restrict__ partial_loss,
                                     const float* __restrict__ partial_grad,
                                     int nblocks, int64_t d,
                                     float* __restrict__ loss,
                                     float* __restrict__ grad) {
  const int64_t c = (int64_t(blockIdx.x) * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (c > d) return;  // whole warps leave together
  Kahan k;
  for (int b = lane; b < nblocks; b += 32)
    k.add(c < d ? partial_grad[int64_t(b) * d + c] : partial_loss[b]);
  float v = k.s;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  if (lane == 0) (c < d ? grad[c] : loss[0]) = v;
}

// Stage 2: fixed-order sums of the per-block partials, one thread per
// gradient column; thread 0 also sums the loss.
__global__ void reduce_partials(const float* __restrict__ partial_loss,
                                int nloss,
                                const float* __restrict__ partial_grad,
                                int ngrad, int64_t d,
                                float* __restrict__ loss,
                                float* __restrict__ grad) {
  const int64_t c = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (c < d) {
    Kahan k;
    for (int b = 0; b < ngrad; ++b) k.add(partial_grad[int64_t(b) * d + c]);
    grad[c] = k.s;
  }
  if (c == 0) {
    Kahan k;
    for (int b = 0; b < nloss; ++b) k.add(partial_loss[b]);
    loss[0] = k.s;
  }
}

template <typename T, int L>
cudaError_t launch_partials(const void* X, const float* y, const float* mask,
                            const float* w, int64_t n, int64_t d,
                            int tile_rows, int grid, float* partial_loss,
                            float* partial_grad, cudaStream_t stream) {
  const int64_t smem = smem_bytes(d, tile_rows, int(sizeof(T)));
  auto kern = margin_partials<T, L>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  kern<<<grid, kThreads, size_t(smem), stream>>>(
      static_cast<const T*>(X), y, mask, w, n, d, tile_rows, partial_loss,
      partial_grad);
  return cudaGetLastError();
}

enum Mode { kTile = 0, kNarrow = 1, kTwoPass = 2, kWarpRows = 3,
            kCluster = 4, kStream = 5, kGrid = 6 };

// A launch plan, as margin_plan fills it: the mode; the tile rows (tile
// mode), the register bucket (narrow mode), the columns a lane owns
// (warp-rows mode), the rows of a stage (cluster and grid modes), the
// stages of the ring (stream mode) or 0 (two-pass);
// the blocks of the (first) launch; the gradient partials (the grid,
// pass 2's row groups, or the clusters; 0 in the grid mode, which writes
// the outputs itself); the blocks of a cluster (cluster mode; 0
// otherwise).  One loss partial a block, or a cluster.
struct Plan {
  int mode, rows, grid, partials, cluster;
};

template <typename T, int L, int J>
cudaError_t cluster_attributes() {
  static std::atomic<unsigned long long> done{0};
  return smem_attributes(margin_cluster<T, L, J>, done, true);
}

// The clusters of c blocks, each with `smem` bytes, that the card keeps
// resident at once for margin_cluster<T, L, J>
// (cudaOccupancyMaxActiveClusters: the SMs of a GPC bound where clusters
// go, so it is not sms / c).
template <typename T, int L, int J>
cudaError_t cluster_occupancy(int c, int64_t smem, int* clusters) {
  const cudaError_t err = cluster_attributes<T, L, J>();
  if (err != cudaSuccess) return err;
  ClusterLaunch l(c, c, kClusterThreads, smem, nullptr);
  return cudaOccupancyMaxActiveClusters(clusters, margin_cluster<T, L, J>,
                                        &l.cfg);
}

template <typename T, int L, int J>
cudaError_t launch_cluster(const Plan& p, const T* X, const float* y,
                           const float* mask, const float* w, int64_t n,
                           int64_t d, float* partial_loss,
                           float* partial_grad, cudaStream_t stream) {
  const int64_t slice = cluster_slice(d, p.cluster);
  const int64_t smem = cluster_layout(slice, p.rows, int(sizeof(T))).total;
  cudaError_t err = cluster_attributes<T, L, J>();
  if (err != cudaSuccess) return err;
  // bulk copies where every row slice is 16-byte aligned (the slices
  // start at multiples of kSliceAlign columns)
  const int bulk = (d * int64_t(sizeof(T))) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(X) % 16 == 0;
  ClusterLaunch l(p.grid, p.cluster, kClusterThreads, smem, stream);
  err = cudaLaunchKernelEx(&l.cfg, margin_cluster<T, L, J>, X, y, mask, w,
                           n, d, p.rows, slice, bulk, partial_loss,
                           partial_grad);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename T, int J>
cudaError_t launch_stream(const Plan& p, const T* X, const float* y,
                          const float* mask, const float* w, int64_t n,
                          int64_t d, int loss_kind, float* partial_loss,
                          float* partial_grad, cudaStream_t stream) {
  static std::atomic<unsigned long long> done{0};
  const cudaError_t err = smem_attributes(margin_stream<T, J>, done, false);
  if (err != cudaSuccess) return err;
  const int64_t smem =
      stream_layout(d, stream_rows(J, int(sizeof(T))), p.rows,
                    int(sizeof(T)))
          .total;
  margin_stream<T, J><<<p.grid, kStreamThreads, size_t(smem), stream>>>(
      X, y, mask, w, n, int(d), p.rows, loss_kind, partial_loss,
      partial_grad);
  return cudaGetLastError();
}

template <typename T, int J>
cudaError_t grid_attributes() {
  static std::atomic<unsigned long long> done{0};
  return smem_attributes(margin_grid<T, J>, done, false);
}

// The shared memory of one block of the grid plan (d, blocks, rows).
int64_t grid_smem(int64_t d, int blocks, int rows, int itemsize) {
  return grid_layout(grid_slice_max(d, blocks), rows,
                     grid_stages(d, blocks, itemsize), itemsize)
      .total;
}

// The blocks of the grid plan (d, blocks, rows) that an SM keeps
// resident at once.
template <typename T>
cudaError_t grid_resident(int64_t d, int blocks, int rows, int* per_sm) {
  const int64_t smem = grid_smem(d, blocks, rows, int(sizeof(T)));
  return with_bucket(grid_slice_max(d, blocks), [&](auto j) {
    constexpr int J = decltype(j)::value;
    const cudaError_t err = grid_attributes<T, J>();
    if (err != cudaSuccess) return err;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        per_sm, margin_grid<T, J>, kGridThreads, size_t(smem));
  });
}

// Zero the tagged words of `scratch` on `stream`, then launch the grid
// plan's kernel cooperatively: every block resident at once, or the launch
// fails (cudaErrorCooperativeLaunchTooLarge) and its error is returned.
template <typename T>
cudaError_t launch_grid(const Plan& p, const T* X, const float* y,
                        const float* mask, const float* w, int64_t n,
                        int64_t d, int loss_kind, float* scratch, float* loss,
                        float* grad, cudaStream_t stream) {
  const int itemsize = int(sizeof(T));
  const int stages = grid_stages(d, p.grid, itemsize);
  const int64_t smem = grid_smem(d, p.grid, p.rows, itemsize);
  return with_bucket(grid_slice_max(d, p.grid), [&](auto j) {
    constexpr int J = decltype(j)::value;
    cudaError_t err = grid_attributes<T, J>();
    if (err != cudaSuccess) return err;
    const size_t words = size_t(grid_scratch_floats(p.grid, p.rows));
    err = cudaMemsetAsync(scratch, 0, sizeof(float) * words, stream);
    if (err != cudaSuccess) return err;
    cudaLaunchConfig_t cfg{};
    cfg.gridDim = dim3(unsigned(p.grid));
    cfg.blockDim = dim3(unsigned(kGridThreads));
    cfg.dynamicSmemBytes = size_t(smem);
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeCooperative;
    attr[0].val.cooperative = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, margin_grid<T, J>, X, y, mask, w, n, d,
                             p.rows, stages, loss_kind,
                             reinterpret_cast<uint64_t*>(scratch), loss,
                             grad);
    // a refused launch leaves its error for the next cudaGetLastError,
    // which would report it against the next kernel launched: clear it
    if (err != cudaSuccess) cudaGetLastError();
    return err != cudaSuccess ? err : cudaGetLastError();
  });
}

template <typename T, int L>
cudaError_t launch_mode(const Plan& p, const void* X, const float* y,
                        const float* mask, const float* w, int64_t n,
                        int64_t d, float* partial_loss, float* partial_grad,
                        float* mult, cudaStream_t stream) {
  if (p.mode == kCluster)
    return with_bucket(cluster_slice(d, p.cluster), [&](auto j) {
      return launch_cluster<T, L, decltype(j)::value>(
          p, static_cast<const T*>(X), y, mask, w, n, d, partial_loss,
          partial_grad, stream);
    });
  if (p.mode == kStream)
    return with_stream_bucket(d, [&](auto j) {
      constexpr int J = decltype(j)::value;
      if constexpr (J <= stream_max_cols(int(sizeof(T))))
        return launch_stream<T, J>(p, static_cast<const T*>(X), y, mask, w,
                                   n, d, L, partial_loss, partial_grad,
                                   stream);
      else
        return cudaError_t(cudaErrorInvalidValue);  // checked: not reached
    });
  if (p.mode == kTile)
    return launch_partials<T, L>(X, y, mask, w, n, d, p.rows, p.grid,
                                 partial_loss, partial_grad, stream);
  const T* Xt = static_cast<const T*>(X);
  if (p.mode == kNarrow) {
#define MARGIN_NARROW(DB)                                                \
  case DB:                                                               \
    margin_narrow<T, L, DB><<<p.grid, kNarrowThreads, 0, stream>>>(      \
        Xt, y, mask, w, n, d, partial_loss, partial_grad);               \
    break;
    switch (p.rows) {
      MARGIN_NARROW(2)
      MARGIN_NARROW(4)
      MARGIN_NARROW(8)
      MARGIN_NARROW(16)
      MARGIN_NARROW(32)
      default:
        return cudaErrorInvalidValue;
    }
#undef MARGIN_NARROW
    return cudaGetLastError();
  }
  if (p.mode == kWarpRows) {
#define MARGIN_WARP_ROWS(C)                                              \
  case C:                                                                \
    margin_warp_rows<T, L, C><<<p.grid, kThreads, 0, stream>>>(          \
        Xt, y, mask, w, n, int(d), partial_loss, partial_grad);          \
    break;
    switch (p.rows) {
      MARGIN_WARP_ROWS(2)
      MARGIN_WARP_ROWS(4)
      MARGIN_WARP_ROWS(8)
      default:
        return cudaErrorInvalidValue;
    }
#undef MARGIN_WARP_ROWS
    return cudaGetLastError();
  }
  margin_wide_dots<T, L><<<p.grid, kThreads, 0, stream>>>(
      Xt, y, mask, w, n, d, mult, partial_loss);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid2(unsigned((d + kThreads - 1) / kThreads),
                   unsigned(p.partials));
  margin_wide_grad<T><<<grid2, kThreads, 0, stream>>>(Xt, mult, n, d,
                                                     partial_grad);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_for_loss(int loss_kind, const Plan& p, const void* X,
                            const float* y, const float* mask,
                            const float* w, int64_t n, int64_t d,
                            float* partial_loss, float* partial_grad,
                            float* mult, cudaStream_t stream) {
  switch (loss_kind) {
    case kLogistic:
      return launch_mode<T, kLogistic>(p, X, y, mask, w, n, d, partial_loss,
                                       partial_grad, mult, stream);
    case kLeastSquares:
      return launch_mode<T, kLeastSquares>(p, X, y, mask, w, n, d,
                                           partial_loss, partial_grad, mult,
                                           stream);
    case kHinge:
      return launch_mode<T, kHinge>(p, X, y, mask, w, n, d, partial_loss,
                                    partial_grad, mult, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// The clusters of c blocks, with `rows` rows a stage of X of width d,
// that the card keeps resident at once (every loss's kernel takes the
// same threads and shared memory, one block an SM: the logistic one is
// asked).
template <typename T>
cudaError_t cluster_resident(int64_t d, int c, int rows, int* clusters) {
  const int64_t slice = cluster_slice(d, c);
  const int64_t smem = cluster_layout(slice, rows, int(sizeof(T))).total;
  return with_bucket(slice, [&](auto j) {
    return cluster_occupancy<T, kLogistic, decltype(j)::value>(c, smem,
                                                               clusters);
  });
}

// A stage of this many rows is preferred to a smaller cluster.
constexpr int kClusterMinRows = 2;

// The cluster mode's plan for X (n, d) in clusters of c blocks: as many
// clusters as are resident at once, at most one a stage of rows.  Sets
// p->mode to -1 where a stage of c blocks holds fewer than `least` rows,
// or the card keeps no such cluster resident.  A cluster past the
// portable size that the card refuses is skipped the same way; any
// other CUDA error is returned.
cudaError_t cluster_plan_of(int64_t n, int64_t d, int itemsize, int c,
                            int least, Plan* p) {
  p->mode = -1;
  const int rows = cluster_rows(d, c, itemsize);
  if (rows < least || rows < 1) return cudaSuccess;
  int resident = 0;
  const cudaError_t err =
      itemsize == 4 ? cluster_resident<float>(d, c, rows, &resident)
                    : cluster_resident<__nv_bfloat16>(d, c, rows, &resident);
  if (err != cudaSuccess) {
    if (c <= kPortableCluster) return err;
    cudaGetLastError();  // not schedulable here
    return cudaSuccess;
  }
  if (resident < 1) return cudaSuccess;
  int64_t clusters = (n + rows - 1) / rows;
  if (clusters > resident) clusters = resident;
  if (clusters < 1) clusters = 1;
  *p = Plan{kCluster, rows, int(clusters * c), int(clusters), c};
  return cudaSuccess;
}

// The cluster mode's plan for X (n, d): the smallest cluster the card
// schedules whose stages hold kClusterMinRows rows, else the smallest that
// holds one.  Sets p->mode to -1 where no cluster holds a row.
cudaError_t cluster_plan(int64_t n, int64_t d, int itemsize, Plan* p) {
  p->mode = -1;
  const int leasts[] = {kClusterMinRows, 1};
  for (int least : leasts)
    for (int c : kClusterSizes) {
      const cudaError_t err = cluster_plan_of(n, d, itemsize, c, least, p);
      if (err != cudaSuccess || p->mode == kCluster) return err;
    }
  return cudaSuccess;
}

// The grid mode's plan for X of width d: a block on each of the `sms`
// SMs (fewer where X has fewer units of kSliceAlign columns, at most
// kGridMaxBlocks), stages of grid_rows rows.  Sets p->mode to -1 where a
// slice is too wide for the register buckets or the ring, or the card
// cannot keep every block resident at once; returns the CUDA error of a
// device query if it fails.
cudaError_t grid_plan(int64_t d, int itemsize, int sms, Plan* p) {
  p->mode = -1;
  int64_t blocks = grid_units(d);
  if (blocks > sms) blocks = sms;
  if (blocks > kGridMaxBlocks) blocks = kGridMaxBlocks;
  const int rows = grid_rows(d, int(blocks), itemsize);
  if (rows < 1) return cudaSuccess;
  int per_sm = 0;
  const cudaError_t err =
      itemsize == 4
          ? grid_resident<float>(d, int(blocks), rows, &per_sm)
          : grid_resident<__nv_bfloat16>(d, int(blocks), rows, &per_sm);
  if (err != cudaSuccess) return err;
  if (int64_t(per_sm) * sms < blocks) return cudaSuccess;
  *p = Plan{kGrid, rows, int(blocks), 0, 0};
  return cudaSuccess;
}

// f32 X whose rows are not 16-byte aligned takes the grid mode from this
// width on, where the cluster mode still takes X (its unaligned rows go
// through 16-byte cp.async copies, the grid mode's through bulk copies of
// the chunks that cover them): the width at which a 16-block cluster's
// stage falls from two rows to one (cluster_rows).  chip_smoke.py --ab
// margin: --shapes grid timed the grid mode faster from there (190,001,
// 196,607 and 262,143 columns) and the cluster mode faster below it
// (131,071 to 180,001), and at every aligned or bf16 width up to its
// reach (PERF.md; an H100 80GB HBM3).
constexpr int64_t kGridUnalignedFrom = 184'321;

bool grid_before_cluster(int64_t d, int itemsize) {
  return itemsize == 4 && (d * itemsize) % 16 != 0 &&
         d >= kGridUnalignedFrom;
}

// The two-pass mode's plan for X (n, d): pass 1 as many blocks as are
// resident at once, at most a warp a row; pass 2's row groups filling the
// card with the column chunks, each at least kWideMultChunk rows.
Plan two_pass_plan(int64_t n, int64_t d, int sms) {
  int64_t blocks = (n + kWarps - 1) / kWarps;
  if (blocks > int64_t(sms) * kWideBlocksPerSM)
    blocks = int64_t(sms) * kWideBlocksPerSM;
  const int64_t chunks = (d + kThreads - 1) / kThreads;
  int64_t groups = int64_t(sms) * kWideGradBlocksPerSM / chunks;
  const int64_t most = (n + kWideMultChunk - 1) / kWideMultChunk;
  if (groups > most) groups = most;
  return Plan{kTwoPass, 0, int(blocks < 1 ? 1 : blocks),
              int(groups < 1 ? 1 : groups), 0};
}

// The tile mode's plan for X (n, d) (a few blocks an SM, as many as fit,
// at most one per tile); p->mode is -1 where not one row fits a tile.
void tile_plan(int64_t n, int64_t d, int itemsize, int sms, Plan* p) {
  p->mode = -1;
  const int rows = choose_tile_rows(d, itemsize);
  if (rows < 1) return;
  int64_t per_sm = kSmemSM / (smem_bytes(d, rows, itemsize) + kSmemReserved);
  per_sm = per_sm < 1 ? 1 : (per_sm > 4 ? 4 : per_sm);
  int64_t blocks = (n + rows - 1) / rows;
  if (blocks > sms * per_sm) blocks = sms * per_sm;
  *p = Plan{kTile, rows, int(blocks < 1 ? 1 : blocks), 0, 0};
  p->partials = p->grid;
}

// The stream mode's plan for X (n, d): a ring of stream_stages stages,
// one block an SM, at most one a stage of rows.  p->mode is -1 where the
// mode does not take the width.
void stream_plan(int64_t n, int64_t d, int itemsize, int sms, Plan* p) {
  p->mode = -1;
  const int st = stream_stages(d, itemsize);
  if (st < kStreamMinStages) return;
  const int rows = stream_bucket_rows(d, itemsize);
  int64_t blocks = (n + rows - 1) / rows;
  if (blocks > sms) blocks = sms;
  const int grid = int(blocks < 1 ? 1 : blocks);
  *p = Plan{kStream, st, grid, grid, 0};
}

// The mode that takes X of width d (past the warp-rows mode) in one
// block a row, or -1 where the cluster mode takes it, by the times of
// chip_smoke.py --ab margin: at 10M rows (PERF.md; an H100 80GB
// HBM3): the tile up to tile_max_width, where a stage of the stream mode
// holds 32 rows of one or two columns a thread and its per-row sums cost
// more than the tile's copy (f32: the tile won at 257 and 264 columns,
// the stream mode from 265; bf16: the tile won to 768 and at 794, the
// stream mode from 800, where the tile's blocks an SM fall from four to
// three); the stream mode up to stream_max_width; the cluster mode past
// that (at 2 blocks it matched the stream mode in f32 at 8,192 and
// 12,288 columns and beat it at 16,384; in bf16 the stream mode won at
// 16,384).
int64_t tile_max_width(int itemsize) { return itemsize == 4 ? 264 : 794; }

int single_block_mode(int64_t d, int itemsize) {
  if (d <= tile_max_width(itemsize)) return kTile;
  if (d <= stream_max_width(itemsize) &&
      stream_stages(d, itemsize) >= kStreamMinStages)
    return kStream;
  return -1;
}

void write_plan(const Plan& p, int* plan) {
  plan[0] = p.mode;
  plan[1] = p.rows;
  plan[2] = p.grid;
  plan[3] = p.partials;
  plan[4] = p.cluster;
}

}  // namespace

extern "C" {

// Launch plan for X (n, d) with `itemsize`-byte elements on the current
// device, of `sms` SMs (checked against the device), written to
// plan[0..4] = {mode, rows, grid, partials, cluster} (see Plan): narrow
// mode up to kNarrowMaxWidth columns; warp-rows mode up to the hand-over
// (warp_rows_takes); then the tile mode and the stream mode, each where
// the card timed it faster (single_block_mode); cluster mode past that
// while a cluster that the device schedules holds a row (cluster_plan),
// but for f32 rows that are not 16-byte aligned from kGridUnalignedFrom
// columns on; grid mode past that while a block on each SM holds a slice
// (grid_plan); two-pass mode past that.  Callers work a plan out once a
// shape.  Returns
// cudaErrorInvalidValue, and sets nothing, for arguments no mode takes or
// an `sms` that is not the device's, and the CUDA error of a device query
// if it fails.
int margin_plan(int64_t n, int64_t d, int itemsize, int sms, int* plan) {
  if (const cudaError_t err = check_plan_args(n, d, itemsize, sms);
      err != cudaSuccess)
    return int(err);
  Plan p{};
  if (d <= kNarrowMaxWidth) {
    p.rows = narrow_bucket(d);
    int64_t blocks = (n + kNarrowThreads - 1) / kNarrowThreads;
    if (blocks > int64_t(sms) * narrow_blocks_per_sm(p.rows))
      blocks = int64_t(sms) * narrow_blocks_per_sm(p.rows);
    p.mode = kNarrow;
    p.grid = p.partials = int(blocks < 1 ? 1 : blocks);
  } else if (warp_rows_takes(d, itemsize)) {
    p.rows = warp_rows_cols(d);
    const int64_t rows_a_block = int64_t(kWarps) * (32 / p.rows);
    int64_t blocks = (n + rows_a_block - 1) / rows_a_block;
    const int64_t most = int64_t(sms) * kWarpRowsBlocksPerSM;
    if (blocks > most) blocks = most;
    p.mode = kWarpRows;
    p.grid = p.partials = int(blocks < 1 ? 1 : blocks);
  } else {
    p.mode = -1;
    const int mode = single_block_mode(d, itemsize);
    if (mode == kTile)
      tile_plan(n, d, itemsize, sms, &p);
    else if (mode == kStream)
      stream_plan(n, d, itemsize, sms, &p);
    if (p.mode == -1 && grid_before_cluster(d, itemsize))
      if (const cudaError_t err = grid_plan(d, itemsize, sms, &p);
          err != cudaSuccess)
        return int(err);
    if (p.mode == -1)
      if (const cudaError_t err = cluster_plan(n, d, itemsize, &p);
          err != cudaSuccess)
        return int(err);
    if (p.mode == -1)
      if (const cudaError_t err = grid_plan(d, itemsize, sms, &p);
          err != cudaSuccess)
        return int(err);
    if (p.mode == -1) p = two_pass_plan(n, d, sms);
  }
  write_plan(p, plan);
  return 0;
}

// The plan of one mode, chosen by the caller, for X (n, d), written to
// plan[0..4] as margin_plan writes its own: `mode` is a mode code of
// margin_mode_name; the tile mode (kTile), the stream mode (kStream), the
// cluster mode (kCluster, in clusters of `cluster` blocks; the other
// modes ignore it), the grid mode (kGrid) and the two-pass mode
// (kTwoPass, every width) are taken.  For timing
// a mode at widths its plan does not give it (chip_smoke.py --ab
// margin:); the kernel checks a forced plan as any other.  Returns
// cudaErrorInvalidValue, and sets nothing, where the mode cannot take X
// of width d (or the card keeps no such cluster resident), and the CUDA
// error of a device query if it fails.
int margin_mode_plan(int64_t n, int64_t d, int itemsize, int sms, int mode,
                     int cluster, int* plan) {
  if (const cudaError_t err = check_plan_args(n, d, itemsize, sms);
      err != cudaSuccess)
    return int(err);
  Plan p{};
  p.mode = -1;
  if (mode == kTile) {
    tile_plan(n, d, itemsize, sms, &p);
  } else if (mode == kStream) {
    stream_plan(n, d, itemsize, sms, &p);
  } else if (mode == kCluster) {
    bool size_ok = false;
    for (int c : kClusterSizes) size_ok = size_ok || c == cluster;
    if (size_ok)
      if (const cudaError_t err =
              cluster_plan_of(n, d, itemsize, cluster, 1, &p);
          err != cudaSuccess)
        return int(err);
  } else if (mode == kGrid) {
    if (const cudaError_t err = grid_plan(d, itemsize, sms, &p);
        err != cudaSuccess)
      return int(err);
  } else if (mode == kTwoPass) {
    p = two_pass_plan(n, d, sms);
  }
  if (p.mode != mode) return int(cudaErrorInvalidValue);
  write_plan(p, plan);
  return 0;
}

// The name of a mode of margin_plan, or NULL past the last.
const char* margin_mode_name(int mode) {
  switch (mode) {
    case kTile:
      return "tile";
    case kNarrow:
      return "narrow";
    case kTwoPass:
      return "two_pass";
    case kWarpRows:
      return "warp_rows";
    case kCluster:
      return "cluster";
    case kStream:
      return "stream";
    case kGrid:
      return "grid";
    default:
      return nullptr;
  }
}

// The widest X (in columns) that takes the warp-rows mode: the hand-over
// to the tile.
int64_t margin_warp_rows_max_width() { return kWarpRowsMaxWidth; }

// Whether X of width d with `itemsize`-byte elements takes the warp-rows
// mode (1) or not (0).
int margin_warp_rows_takes(int64_t d, int itemsize) {
  return warp_rows_takes(d, itemsize) ? 1 : 0;
}

// The widest X (in columns) that the tile mode takes (single_block_mode);
// the stream mode takes the next column on.
int64_t margin_tile_max_width(int itemsize) {
  return tile_max_width(itemsize);
}

// The widest X (in columns) that one block a row takes (the stream or
// tile mode, single_block_mode).  Wider X takes the cluster mode, up to
// margin_cluster_max_width.
int64_t margin_max_width(int itemsize) {
  int64_t lo = 0, hi = kSmemBlock;  // lo is taken (vacuously), hi is not
  while (hi - lo > 1) {
    const int64_t mid = (lo + hi) / 2;
    (single_block_mode(mid, itemsize) != -1 ? lo : hi) = mid;
  }
  return lo;
}

// The widest X (in columns) that the cluster mode takes on the current
// device (f32 X whose rows are not 16-byte aligned only short of
// margin_grid_unaligned_from_width).  Wider X takes the grid mode, up to
// margin_grid_max_width.  Returns 0 where no cluster is scheduled, and
// minus the CUDA error code if the query fails.
int64_t margin_cluster_max_width(int itemsize) {
  if (itemsize != 4 && itemsize != 2) return -int64_t(cudaErrorInvalidValue);
  // lo is taken (or the tile's), hi is not: no slice is that wide
  int64_t lo = margin_max_width(itemsize);
  int64_t hi = int64_t(kClusterSizes[3]) * kClusterThreads * kClusterMaxCols
               + 1;
  const int64_t tile = lo;
  while (hi - lo > 1) {
    const int64_t mid = (lo + hi) / 2;
    Plan p{};
    const cudaError_t err = cluster_plan(1, mid, itemsize, &p);
    if (err != cudaSuccess) return -int64_t(err);
    (p.mode == kCluster ? lo : hi) = mid;
  }
  return lo == tile ? 0 : lo;
}

// The widest X (in columns) that the grid mode takes on the current
// device: the widest read once (about 132 x 16,384 columns on an H100).
// Wider X takes the two-pass mode.  Returns 0 where the grid mode takes
// no width past the cluster mode, and minus the CUDA error code if a
// query fails.
int64_t margin_grid_max_width(int itemsize) {
  if (itemsize != 4 && itemsize != 2) return -int64_t(cudaErrorInvalidValue);
  int dev = 0, sms = 0;
  if (const cudaError_t err = cudaGetDevice(&dev); err != cudaSuccess)
    return -int64_t(err);
  if (const cudaError_t err = cudaDeviceGetAttribute(
          &sms, cudaDevAttrMultiProcessorCount, dev);
      err != cudaSuccess)
    return -int64_t(err);
  // lo is taken (or the cluster mode's), hi is not: no slice is that wide
  int64_t lo = margin_cluster_max_width(itemsize);
  if (lo < 0) return lo;
  if (lo < margin_max_width(itemsize)) lo = margin_max_width(itemsize);
  int64_t hi = int64_t(sms) * kGridThreads * kGridMaxCols + 1;
  const int64_t before = lo;
  while (hi - lo > 1) {
    const int64_t mid = (lo + hi) / 2;
    Plan p{};
    const cudaError_t err = grid_plan(mid, itemsize, sms, &p);
    if (err != cudaSuccess) return -int64_t(err);
    (p.mode == kGrid ? lo : hi) = mid;
  }
  return lo == before ? 0 : lo;
}

// The narrowest X (in columns) of rows that are not 16-byte aligned that
// the plan gives the grid mode where the cluster mode would take it: f32
// only (0 for bf16: none).
int64_t margin_grid_unaligned_from_width(int itemsize) {
  return itemsize == 4 ? kGridUnalignedFrom : 0;
}

// Floats of the `mult` scratch that margin_loss_grad needs for the plan
// plan[0..4] and n rows: the two-pass mode's multipliers (n), the grid
// mode's tagged partial dots, else 0.
int64_t margin_scratch_floats(int64_t n, const int* plan) {
  if (plan[0] == kTwoPass) return n;
  if (plan[0] == kGrid && plan[1] >= 1 && plan[2] >= 1)
    return grid_scratch_floats(plan[2], plan[1]);
  return 0;
}

// Launch the plan's kernels and the final sum on `stream`.
// `partial_loss` holds plan[2] floats, `partial_grad` plan[3] * d floats
// and `mult` margin_scratch_floats (two-pass mode: n; grid mode: its
// exchange; it may be NULL otherwise) of scratch.  Returns the CUDA error
// code of the launches (0 on success): a cluster or cooperative (grid)
// launch that the card refuses returns its error, and nothing is
// launched in its place.  Synchronises nothing.
int margin_loss_grad(const void* X, int x_type, const void* y,
                     const void* mask, const void* w, int64_t n, int64_t d,
                     int loss_kind, const int* plan, void* partial_loss,
                     void* partial_grad, void* mult, void* loss, void* grad,
                     void* stream) {
  const Plan p{plan[0], plan[1], plan[2], plan[3], plan[4]};
  const int itemsize = x_type == kBF16 ? 2 : 4;
  const bool grid_ok =
      p.mode == kGrid && p.rows >= 1 && p.rows <= kGridMaxRows &&
      p.grid >= 1 && p.partials == 0 && p.cluster == 0 && mult != nullptr &&
      n < (int64_t(1) << 31) &&
      (x_type == kF32 || x_type == kBF16) && loss_kind >= kLogistic &&
      loss_kind <= kHinge && grid_rows(d, p.grid, itemsize) >= p.rows;
  const bool ok =
      n >= 0 && d >= 1 && (grid_ok || (p.grid >= 1 && p.partials >= 1 &&
      ((p.mode == kTile && p.rows >= 1 && p.partials == p.grid) ||
       (p.mode == kNarrow && d <= p.rows && p.partials == p.grid) ||
       (p.mode == kWarpRows && (p.rows == 2 || p.rows == 4 || p.rows == 8) &&
        d <= 32 * p.rows && p.partials == p.grid) ||
       (p.mode == kTwoPass && (mult != nullptr || n == 0)) ||
       (p.mode == kStream && p.partials == p.grid &&
        p.rows >= kStreamMinStages &&
        stream_stages(d, itemsize) == p.rows) ||
       (p.mode == kCluster && p.rows >= 1 && p.rows <= kClusterMaxRows &&
        (p.cluster == 2 || p.cluster == 4 || p.cluster == 8 ||
         p.cluster == 16) &&
        p.grid == p.partials * p.cluster &&
        cluster_rows(d, p.cluster, itemsize) >= p.rows))));
  if (!ok) return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* yf = static_cast<const float*>(y);
  const float* mf = static_cast<const float*>(mask);
  const float* wf = static_cast<const float*>(w);
  float* pl = static_cast<float*>(partial_loss);
  float* pg = static_cast<float*>(partial_grad);
  float* mu = static_cast<float*>(mult);
  if (p.mode == kGrid)  // the blocks write the outputs themselves
    return int(
        x_type == kF32
            ? launch_grid<float>(p, static_cast<const float*>(X), yf, mf, wf,
                                 n, d, loss_kind, mu,
                                 static_cast<float*>(loss),
                                 static_cast<float*>(grad), s)
            : launch_grid<__nv_bfloat16>(
                  p, static_cast<const __nv_bfloat16*>(X), yf, mf, wf, n, d,
                  loss_kind, mu, static_cast<float*>(loss),
                  static_cast<float*>(grad), s));
  cudaError_t err;
  if (x_type == kF32)
    err = launch_for_loss<float>(loss_kind, p, X, yf, mf, wf, n, d, pl, pg,
                                 mu, s);
  else if (x_type == kBF16)
    err = launch_for_loss<__nv_bfloat16>(loss_kind, p, X, yf, mf, wf, n, d,
                                         pl, pg, mu, s);
  else
    err = cudaErrorInvalidValue;
  if (err != cudaSuccess) return int(err);
  const int threads = 256;
  if (p.mode == kNarrow || p.mode == kWarpRows) {
    const int blocks = int(((d + 1) * 32 + threads - 1) / threads);
    reduce_partials_warp<<<blocks, threads, 0, s>>>(
        pl, pg, p.grid, d, static_cast<float*>(loss),
        static_cast<float*>(grad));
  } else {
    // a loss partial a block, but a cluster's in the cluster mode
    const int nloss = p.mode == kCluster ? p.partials : p.grid;
    const int blocks = int((d + threads - 1) / threads);
    reduce_partials<<<blocks, threads, 0, s>>>(pl, nloss, pg, p.partials, d,
                                               static_cast<float*>(loss),
                                               static_cast<float*>(grad));
  }
  return int(cudaGetLastError());
}

const char* margin_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
