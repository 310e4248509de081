// K lanes of the fused margin-form GLM loss and gradient for Hopper
// (sm_90a): the lanes of a regularization path, X read once for all.
//
// Replaces the TPU kernel spark_agd_tpu/ops/pallas_kernels.py:
// fused_margin_loss_grad (body _margin_kernel) under jax.vmap, as
// api.sweep runs it over the strengths of a path: Pallas batches the
// kernel by adding a lane axis to its grid, one pass of X per lane.  For
// X (N, D), labels y, one row mask m and the K rows w_k of W (K, D) it
// returns, for every lane k,
//
//     loss[k] = sum_i m_i * per(x_i . w_k, y_i)
//     grad[k] = sum_i m_i * mult(x_i . w_k, y_i) * x_i
//
// with (per, mult) the middles of margin_middle.cuh.
//
// What bounds it on this card: reading X, N*D*itemsize bytes, while the
// 4*N*D*K flops take less time at the f32 rate (up to K = 20 for f32 X,
// K = 10 for bf16), and far less on the tensor cores.  Launched once per
// lane, the solo kernel (margin_loss_grad.cu) would read X K times; the
// two library products (X @ W^T, then M^T @ X) read it twice.
//
// lanes_plan picks one of four modes by width and lanes: the tensor-core
// mode (lanes_mma) and the tile mode (lanes_tile) while one block's
// shared memory holds the lanes' W beside a row tile, the cluster mode
// (lanes_cluster) from where lanes_mma's block stops fitting up to the
// reach of its largest cluster (most_blocks: 2-16 blocks by lanes and
// type; none for 16 lanes of bf16), and the two-pass mode past that:
// each hand-over where `--ab lanes:` of chip_smoke.py timed the next mode
// faster (cluster_from, most_blocks).  K is compiled in buckets (1, 2, 4,
// 8, 16 lanes; the lanes past K read zero weights and are not written),
// so one launch takes up to kMaxLanes lanes and the wrapper runs more in
// chunks.  Every mode writes per-block (cluster mode: per-cluster)
// partials that lanes_reduce sums in block order (the two-pass mode's
// loss partials come from its middle's blocks), with no float atomics,
// so two calls on the same inputs give the same bits.  X may be f32 or
// bf16 (widened to f32 in registers); y, m, W and every accumulator are
// f32.  Ragged rows and columns are masked here, so X needs no padding.
//
// Tensor-core mode (from 8 lanes at every width it takes, 4 lanes past
// 512 columns: where the `--ab lanes:` sweep found it faster than the
// tile mode).  What held the tile mode back at 10M x 1000, K = 8: W, the
// gradient partial and its compensation in shared memory (96 KB) left
// room for one 256-thread block an SM; its 3.2e11 flops ran on the CUDA
// cores with a shared-memory operand every 2 FMAs; and the K x D partial
// was folded into shared memory after every 16-row tile.  Here both
// products run on the tensor cores (mma.sync m16n8k8, TF32 operands
// split in halves for f32 accuracy, W in three parts, tf32_mma.cuh):
// the dots of a 16-row tile as X_tile W^T (the lanes as one or two n8
// tiles), the gradient as X_tile^T M (16 columns of D an m16 tile, the
// rows as two k8 steps).  Each of 16 warps owns fixed m-tiles of the
// gradient for the block's whole row range, their sums and Kahan
// compensations in registers, so nothing is folded into shared memory
// and 512 threads share the SM; the next tile loads (cp.async) while the
// block works on this one.  Past the registers (more than 8 m16 x n8
// tiles a warp) or shared memory, the lanes keep the tile mode.
//
// Tile mode (one read of X, while the lanes' W, gradient partial and its
// compensation, three KB x D f32 arrays, fit in shared memory beside two tiles
// of at least one row: choose_tile_rows): every block walks a contiguous
// range of rows in tiles, the next tile copied with cp.async while the block
// computes on the current one.  The K dots: a warp takes a group of R rows,
// each lane summing every 32nd column of the R rows against every lane's
// weights (R*KB sums in registers, each weight read from shared memory once for
// R rows), then a shuffle tree; lane (r, k) of the warp applies lane k's middle
// to row r and writes m * mult to the tile's (rows x KB) multipliers.  The
// gradient: each thread owns kCols columns at a time and sums mult[r][k] *
// x[r][c] over the tile into kCols x KB registers (each row's KB multipliers
// read as broadcast vectors once for kCols columns), then adds them to the
// block's partial in shared memory with a compensated (Kahan) sum: a block
// walks some 75,000 rows at 10M rows, and near an optimum the gradient is a
// small difference of large partial sums, which plain f32 adds of each tile
// would blur.
//
// Cluster mode (from cluster_from to lanes_max_width): what held these
// widths back was one block a row.  lanes_tile past lanes_mma's reach
// holds 1-2 rows a tile beside the lanes' K x D arrays, one 256-thread
// block an SM; the two-pass mode reads X twice, and W from L2 for every
// row.  Here a thread block cluster of 2-16 blocks holds each 16-row tile
// split by columns, each block lanes_mma's design over its slice, the
// partial dots swapped through distributed shared memory, so X is read
// once (details at lanes_cluster).
//
// Two-pass mode (past lanes_max_width): X read twice, as the TPU
// wrapper's two library products do past its VMEM budget, both products
// on the tensor cores.  W (K x D f32: 0.9 MB at K = 16 and 14,337
// columns, past L1) read from L2 for every row would move some 16 times
// the bytes of X; so pass 1 forms the dots of a 128-row tile as X_tile
// W^T with W's columns staged beside X's, and W leaves L2 once a tile;
// the middle is a pass over the (N, 8 NT) dots; pass 2 forms X^T M on
// the tensor cores over (256 columns, row group) blocks.  This mode has
// no width limit (details at lanes_tp_dots).

#include <atomic>
#include <type_traits>

#include "cluster_common.cuh"
#include "margin_middle.cuh"
#include "tf32_mma.cuh"
#include "tile_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxLanes = 16;
constexpr int kCols = 4;
constexpr int kMaxTileRows = 32;

// Rows of a warp's group in the dot product: R * KB sums in registers,
// and R * KB <= 32, one lane of the middle each.  Two rows from 8 lanes
// up, so that the 16-row tiles that fit at D = 1000 keep all 8 warps
// busy.
__host__ __device__ constexpr int group_rows(int kb) {
  return kb >= 8 ? 2 : 4;
}

int bucket_of(int k) {
  return k < 1 ? 0 : k <= 1 ? 1 : k <= 2 ? 2 : k <= 4 ? 4 : k <= 8 ? 8
         : k <= kMaxLanes ? kMaxLanes : 0;
}

// Shared-memory layout of a tile-mode block (byte offsets): W at 0, the
// gradient partial and its Kahan compensation (KB x D f32 each), the
// tile's multipliers (rows x KB f32, 16-byte aligned for KB >= 4), one
// loss slot a thread, then two X tile buffers, each 16-byte aligned with
// 16 bytes of slack so that a tile's byte offset modulo 16 can match its
// address in device memory.
struct Layout {
  int64_t g, comp, mult, loss, x, x_buf, total;
  __host__ __device__ Layout(int64_t d, int kb, int rows, int itemsize) {
    g = 4 * int64_t(kb) * d;
    comp = 2 * g;
    mult = 3 * g;
    loss = mult + 4 * int64_t(rows) * kb;
    x = round_up(loss + 4 * kThreads, 16);
    x_buf = round_up(int64_t(rows) * d * itemsize + kTileSlack, 16);
    total = x + 2 * x_buf;
  }
};

// Most rows (at most kMaxTileRows, down to a multiple of the row group
// where there are that many) whose block fits shared memory; 0 when not
// even one row does.
int choose_tile_rows(int64_t d, int kb, int itemsize) {
  int rows = 0;
  for (int r = kMaxTileRows; r >= 1 && rows == 0; --r)
    if (Layout(d, kb, r, itemsize).total <= kSmemBlock) rows = r;
  const int g = group_rows(kb);
  return rows >= g ? rows - rows % g : rows;
}

// The KB floats at p (16-byte aligned when KB % 4 == 0).
template <int KB>
__device__ __forceinline__ void load_lanes(const float* p, float (&v)[KB]) {
  if constexpr (KB % 4 == 0) {
#pragma unroll
    for (int i = 0; i < KB / 4; ++i) {
      const float4 q = reinterpret_cast<const float4*>(p)[i];
      v[4 * i] = q.x;
      v[4 * i + 1] = q.y;
      v[4 * i + 2] = q.z;
      v[4 * i + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < KB; ++i) v[i] = p[i];
  }
}

template <typename T, int L, int KB>
__global__ void __launch_bounds__(kThreads)
    lanes_tile(const T* __restrict__ X, const float* __restrict__ y,
               const float* __restrict__ mask, const float* __restrict__ W,
               int64_t n, int64_t d, int k, int tile_rows,
               float* __restrict__ partial_loss,
               float* __restrict__ partial_grad) {
  constexpr int R = group_rows(KB);
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout lay(d, KB, tile_rows, int(sizeof(T)));
  float* w_s = reinterpret_cast<float*>(smem);
  float* g_s = reinterpret_cast<float*>(smem + lay.g);
  float* comp_s = reinterpret_cast<float*>(smem + lay.comp);
  float* mult_s = reinterpret_cast<float*>(smem + lay.mult);
  float* loss_s = reinterpret_cast<float*>(smem + lay.loss);
  unsigned char* x_buf0 = smem + lay.x;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int64_t nblocks = gridDim.x;
  const int64_t rows_per_block = (n + nblocks - 1) / nblocks;
  const int64_t r_begin = min64(n, int64_t(blockIdx.x) * rows_per_block);
  const int64_t r_end = min64(n, r_begin + rows_per_block);
  // start copying the tile at row tile0 into buffer b
  auto load = [&](int64_t tile0, int b) {
    const int rows = int(min64(tile_rows, r_end - tile0));
    copy_tile_async<kThreads>(X + tile0 * d,
                              int64_t(rows) * d * int64_t(sizeof(T)),
                              x_buf0 + b * lay.x_buf, X, X + n * d);
  };
  if (r_begin < r_end) load(r_begin, 0);
  cp_async_commit();

  for (int64_t i = tid; i < int64_t(KB) * d; i += kThreads) {
    w_s[i] = i < int64_t(k) * d ? W[i] : 0.f;
    g_s[i] = comp_s[i] = 0.f;
  }
  // this lane's place in the middle: row mid_r of its warp's group, lane
  // mid_k of W
  const int mid_r = lane / KB;
  const int mid_k = lane % KB;
  Kahan loss_acc;

  int buf = 0;
  for (int64_t tile0 = r_begin; tile0 < r_end;
       tile0 += tile_rows, buf ^= 1) {
    const int rows = int(min64(tile_rows, r_end - tile0));
    // this tile has landed for every thread, and every thread is done
    // with the last one (its buffer and the multipliers)
    cp_async_wait<0>();
    __syncthreads();
    if (tile0 + tile_rows < r_end) load(tile0 + tile_rows, buf ^ 1);
    cp_async_commit();
    const T* xs = reinterpret_cast<const T*>(
        x_buf0 + buf * lay.x_buf +
        (reinterpret_cast<uintptr_t>(X + tile0 * d) & 15));

    // the K dots of each row: a warp a group of R rows
    for (int r0 = warp * R; r0 < rows; r0 += kWarps * R) {
      float acc[R][KB];
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int kk = 0; kk < KB; ++kk) acc[r][kk] = 0.f;
      for (int64_t c = lane; c < d; c += 32) {
        float xv[R];
#pragma unroll
        for (int r = 0; r < R; ++r)
          xv[r] = r0 + r < rows ? to_f32(xs[int64_t(r0 + r) * d + c]) : 0.f;
#pragma unroll
        for (int kk = 0; kk < KB; ++kk) {
          const float wv = w_s[int64_t(kk) * d + c];
#pragma unroll
          for (int r = 0; r < R; ++r) acc[r][kk] = fmaf(xv[r], wv, acc[r][kk]);
        }
      }
      float dot = 0.f;
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int kk = 0; kk < KB; ++kk) {
          float v = acc[r][kk];
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            v += __shfl_xor_sync(0xffffffffu, v, off);
          if (r * KB + kk == lane) dot = v;
        }
      const int row = r0 + mid_r;
      if (lane < R * KB && row < rows) {
        float mm = 0.f;
        if (mid_k < k) {
          const int64_t gr = tile0 + row;
          float per, mult;
          loss_middle<L>(dot, y[gr], &per, &mult);
          const float m = mask[gr];
          mm = mult * m;
          loss_acc.add(per * m);
        }
        mult_s[row * KB + mid_k] = mm;
      }
    }
    __syncthreads();

    // the gradient off the same tile: kCols columns a thread at a time
    for (int64_t c0 = tid; c0 < d; c0 += int64_t(kCols) * kThreads) {
      float s[kCols][KB];
#pragma unroll
      for (int j = 0; j < kCols; ++j)
#pragma unroll
        for (int kk = 0; kk < KB; ++kk) s[j][kk] = 0.f;
      for (int r = 0; r < rows; ++r) {
        float mv[KB];
        load_lanes<KB>(mult_s + r * KB, mv);
        const T* xr = xs + int64_t(r) * d;
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          const int64_t c = c0 + int64_t(j) * kThreads;
          const float xv = c < d ? to_f32(xr[c]) : 0.f;
#pragma unroll
          for (int kk = 0; kk < KB; ++kk) s[j][kk] = fmaf(mv[kk], xv, s[j][kk]);
        }
      }
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int64_t c = c0 + int64_t(j) * kThreads;
        if (c < d) {
#pragma unroll
          for (int kk = 0; kk < KB; ++kk) {
            const int64_t i = int64_t(kk) * d + c;
            const float v = s[j][kk] - comp_s[i];
            const float t = g_s[i] + v;
            comp_s[i] = (t - g_s[i]) - v;
            g_s[i] = t;
          }
        }
      }
    }
  }

  loss_s[tid] = loss_acc.s;
  __syncthreads();
  const int64_t kd = int64_t(k) * d;
  for (int64_t i = tid; i < kd; i += kThreads)
    partial_grad[int64_t(blockIdx.x) * kd + i] = g_s[i];
  if (tid < k) {
    Kahan sum;
    for (int w = 0; w < kWarps; ++w)
      for (int l = tid; l < R * KB; l += KB) sum.add(loss_s[w * 32 + l]);
    partial_loss[int64_t(blockIdx.x) * k + tid] = sum.s;
  }
}

// ---- tensor-core mode -------------------------------------------------
//
// One block of kMmaWarps warps an SM walks a contiguous range of rows in
// 16-row tiles (one m16 tile), cp.async double-buffered.  A tile's K
// dots are Z (16 x 8 NT) = X_tile W^T: A = X, B = W^T in NT n8 tiles of
// lanes, D stepped 8 columns at a time, warp w taking the steps w, w +
// kMmaWarps, ...; each warp writes its partial Z to shared memory.  One
// thread a (row, lane) sums the warps' partials in warp order and applies
// the lane's middle, writing m * mult to the tile's M (16 x 8 NT).  The
// gradient G^T (D x 8 NT) += X_tile^T M: A = X^T (16 columns of D an m16
// tile, the tile's rows as two k8 steps), B = M.  Warp w owns the
// m-tiles w, w + kMmaWarps, ... (MT of them) for the block's whole row
// range, their sums and Kahan compensations in registers, and folds each
// tile's product into them with a compensated add.
constexpr int kMmaThreads = 512;
constexpr int kMmaWarps = kMmaThreads / 32;
constexpr int kMmaRows = 16;
// The m16 x n8 gradient tiles a warp may own (MT * NT, each 4 sums and 4
// compensations a thread): past that the lanes keep the tile mode.
constexpr int kMmaMaxTiles = 8;

// Row stride, in floats, of W staged in shared memory: the columns padded
// to a multiple of 8, then to s % 32 == 4, so that the lanes of a B
// fragment load (lane g of W, column t) hit distinct banks.
__host__ __device__ inline int64_t mma_w_stride(int64_t d) {
  const int64_t s = round_up(d, 8);
  return s + ((4 - s % 32) % 32 + 32) % 32;
}

// Row stride, in floats, of the partial dots and the multipliers: 8 for
// one n8 tile of lanes, 24 for two, so that fragment stores and loads hit
// distinct banks.
__host__ __device__ constexpr int mma_lane_stride(int nt) {
  return nt == 1 ? 8 : 24;
}

// The m16 tiles of D a warp owns, rounded up to 1, 2, 4 or 8; 0 past 8.
__host__ __device__ inline int mma_tiles(int64_t d) {
  const int64_t per_warp = ((d + 15) / 16 + kMmaWarps - 1) / kMmaWarps;
  return per_warp <= 1 ? 1 : per_warp <= 2 ? 2 : per_warp <= 4 ? 4
         : per_warp <= 8 ? 8 : 0;
}

// Shared-memory layout of a tensor-core block (byte offsets): W at 0 (8
// NT x mma_w_stride floats, zero past lane k and column d), the warps'
// partial dots (kMmaWarps x 16 x stride), the tile's multipliers (16 x
// stride), then two X tile buffers as in tile mode.
struct MmaLayout {
  int64_t zp, mult, x, x_buf, total;
  __host__ __device__ MmaLayout(int64_t d, int nt, int itemsize) {
    const int ls = mma_lane_stride(nt);
    zp = 4 * 8 * nt * mma_w_stride(d);
    mult = zp + 4 * kMmaWarps * kMmaRows * ls;
    x = round_up(mult + 4 * kMmaRows * ls, 16);
    x_buf = round_up(int64_t(kMmaRows) * d * itemsize + kTileSlack, 16);
    total = x + 2 * x_buf;
  }
};

template <typename T, int L, int NT, int MT>
__global__ void __launch_bounds__(kMmaThreads, 1)
    lanes_mma(const T* __restrict__ X, const float* __restrict__ y,
              const float* __restrict__ mask, const float* __restrict__ W,
              int64_t n, int d, int k, float* __restrict__ partial_loss,
              float* __restrict__ partial_grad) {
  constexpr bool kXLo = sizeof(T) == 4;  // f32 X has a lo half
  constexpr int LS = mma_lane_stride(NT);
  constexpr int KB = 8 * NT;             // lanes computed, k of them live
  extern __shared__ __align__(16) unsigned char smem[];
  const MmaLayout lay(d, NT, int(sizeof(T)));
  float* w_s = reinterpret_cast<float*>(smem);
  float* zp_s = reinterpret_cast<float*>(smem + lay.zp);
  float* m_s = reinterpret_cast<float*>(smem + lay.mult);
  unsigned char* x_buf0 = smem + lay.x;
  const int ws = int(mma_w_stride(d));
  const int ksteps = (d + 7) / 8;    // 8-column steps of the dots
  const int mtiles = (d + 15) / 16;  // 16-column m-tiles of the gradient

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int64_t nblocks = gridDim.x;
  const int64_t rows_per_block = (n + nblocks - 1) / nblocks;
  const int64_t r_begin = min64(n, int64_t(blockIdx.x) * rows_per_block);
  const int64_t r_end = min64(n, r_begin + rows_per_block);
  // start copying the tile at row tile0 into buffer b
  auto load = [&](int64_t tile0, int b) {
    const int rows = int(min64(kMmaRows, r_end - tile0));
    copy_tile_async<kMmaThreads>(X + tile0 * d,
                                 int64_t(rows) * d * int64_t(sizeof(T)),
                                 x_buf0 + b * lay.x_buf, X, X + n * d);
  };
  if (r_begin < r_end) load(r_begin, 0);
  cp_async_commit();

  for (int i = tid; i < KB * ws; i += kMmaThreads) {
    const int kk = i / ws, c = i % ws;
    w_s[i] = kk < k && c < d ? W[int64_t(kk) * d + c] : 0.f;
  }
  float acc[MT][NT][4], comp[MT][NT][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[m][nt][i] = comp[m][nt][i] = 0.f;
  // this thread's place in the middle: row mr of the tile, lane mk
  const bool mid = tid < kMmaRows * KB;
  const int mr = tid / KB, mk = tid % KB;
  Kahan loss_acc;

  int buf = 0;
  for (int64_t tile0 = r_begin; tile0 < r_end;
       tile0 += kMmaRows, buf ^= 1) {
    const int rows = int(min64(kMmaRows, r_end - tile0));
    const bool live = mid && mr < rows && mk < k;
    const float yv = live ? y[tile0 + mr] : 0.f;
    const float mv = live ? mask[tile0 + mr] : 0.f;
    // this tile has landed for every thread, and every thread is done
    // with the last one (its buffer, the partial dots, the multipliers)
    cp_async_wait<0>();
    __syncthreads();
    if (tile0 + kMmaRows < r_end) load(tile0 + kMmaRows, buf ^ 1);
    cp_async_commit();
    const T* xs = reinterpret_cast<const T*>(
        x_buf0 + buf * lay.x_buf +
        (reinterpret_cast<uintptr_t>(X + tile0 * d) & 15));

    // the dots: warp w sums the 8-column steps w, w + kMmaWarps, ...;
    // rows past the tile and columns past d read as zeros
    {
      float big[NT][4], small[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) big[nt][i] = small[nt][i] = 0.f;
      for (int s = warp; s < ksteps; s += kMmaWarps) {
        uint32_t ah[4], al[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = g + 8 * (i & 1);
          const int c = s * 8 + t + 4 * (i >> 1);
          split_x<T>(r < rows && c < d ? to_f32(xs[r * d + c]) : 0.f, ah[i],
                     al[i]);
        }
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          uint32_t bh[2], bl[2], bl2[2];
#pragma unroll
          for (int h = 0; h < 2; ++h)
            split_w(w_s[(nt * 8 + g) * ws + s * 8 + t + 4 * h], bh[h], bl[h],
                    bl2[h]);
          mma3<kXLo>(big[nt], small[nt], ah, al, bh, bl);
          mma_tf32(small[nt], ah, bl2);  // x_hi w_lo2
        }
      }
      float* zp = zp_s + warp * kMmaRows * LS;
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          *reinterpret_cast<float2*>(zp + (g + 8 * h) * LS + nt * 8 + 2 * t) =
              make_float2(big[nt][2 * h] + small[nt][2 * h],
                          big[nt][2 * h + 1] + small[nt][2 * h + 1]);
    }
    __syncthreads();

    // the middle: thread (row mr, lane mk); dead rows and lanes get 0
    if (mid) {
      float mm = 0.f;
      if (live) {
        float z = 0.f;
#pragma unroll
        for (int w = 0; w < kMmaWarps; ++w)
          z += zp_s[(w * kMmaRows + mr) * LS + mk];
        float per, mult;
        loss_middle<L>(z, yv, &per, &mult);
        mm = mult * mv;
        loss_acc.add(per * mv);
      }
      m_s[mr * LS + mk] = mm;
    }
    __syncthreads();

    // the gradient: M's fragments (the tile's two k8 steps of rows),
    // split once; then warp w's m-tiles of D
    {
      uint32_t mh[2][NT][2], ml[2][NT][2];
#pragma unroll
      for (int ks = 0; ks < 2; ++ks)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            split_tf32(m_s[(ks * 8 + t + 4 * h) * LS + nt * 8 + g],
                       mh[ks][nt][h], ml[ks][nt][h]);
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const int mt = warp + kMmaWarps * m;
        if (mt < mtiles) {
          float big[NT][4], small[NT][4];
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int i = 0; i < 4; ++i) big[nt][i] = small[nt][i] = 0.f;
#pragma unroll
          for (int ks = 0; ks < 2; ++ks) {
            uint32_t ah[4], al[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int c = mt * 16 + g + 8 * (i & 1);
              const int r = ks * 8 + t + 4 * (i >> 1);
              split_x<T>(r < rows && c < d ? to_f32(xs[r * d + c]) : 0.f,
                         ah[i], al[i]);
            }
#pragma unroll
            for (int nt = 0; nt < NT; ++nt)
              mma3<kXLo>(big[nt], small[nt], ah, al, mh[ks][nt],
                         ml[ks][nt]);
          }
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const float v = (big[nt][i] + small[nt][i]) - comp[m][nt][i];
              const float s = acc[m][nt][i] + v;
              comp[m][nt][i] = (s - acc[m][nt][i]) - v;
              acc[m][nt][i] = s;
            }
        }
      }
    }
  }

  // the block's partials: the gradient from the registers, the loss of
  // each lane summed over the middle's rows in order
  const int64_t kd = int64_t(k) * d;
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    const int mt = warp + kMmaWarps * m;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = mt * 16 + g + 8 * (i >> 1);
        const int kk = nt * 8 + 2 * t + (i & 1);
        if (mt < mtiles && c < d && kk < k)
          partial_grad[int64_t(blockIdx.x) * kd + int64_t(kk) * d + c] =
              acc[m][nt][i];
      }
  }
  __syncthreads();  // every thread is done with the partial dots
  if (mid) zp_s[tid] = loss_acc.s;
  __syncthreads();
  if (tid < k) {
    Kahan sum;
    for (int r = 0; r < kMmaRows; ++r) sum.add(zp_s[r * KB + tid]);
    partial_loss[int64_t(blockIdx.x) * k + tid] = sum.s;
  }
}

// ---- cluster mode -----------------------------------------------------
//
// Past what one block's shared memory holds (lanes_mma's W and two
// 16-row tiles, lanes_tile's three K x D arrays beside a row), a thread
// block cluster of C = 2-16 blocks of kMmaThreads threads, one an SM,
// holds each 16-row tile of the cluster's contiguous row range split by
// columns: block (rank) q owns the column slice [q S, q S + S) (S =
// cluster_slice(d, C), a multiple of kSliceAlign; the last block the
// rest), with W's slice in shared memory (8 NT x mma_w_stride(S) floats,
// zero past lane k and the slice) and a ring of `stages` 16-row stages of
// row slices, each row slice placed at its address modulo 16 and filled
// by one cp.async.bulk of the 16-byte chunks that cover it, issued by a
// warp of its own, all of a stage completing on the stage's mbarrier
// (issue_stage: rows aligned or not; the elements at X's ends that fill
// no chunk copied plainly).
// Each block forms its partial Z (16 x 8 NT) = X_slice W_slice^T on the
// tensor cores, as lanes_mma does (warp w the 8-column steps w, w +
// kMmaWarps, ... of the slice; the warps' partials added in warp order),
// and stores the live entries (rows of the tile, lanes below k) into
// every block's shared memory (distributed shared memory, st.async), in
// its own rank's slot, counted on the receiver's mbarrier; the slots and
// their mbarriers alternate by tile parity, as in the margin kernel's
// cluster mode (a block stores tile s + 2's partials only after it has
// received every peer's of tile s + 1, which each peer sends after
// reading its slots of tile s).  Each block adds the C partials in rank
// order, so every block holds the same dots, and applies the middle
// itself (loss_middle_of, chosen at run time: one instantiation serves
// the three losses); rank 0 alone counts the loss.  The gradient of the
// block's slice, G^T (S x 8 NT) += X_slice^T M, runs as in lanes_mma:
// each warp owns fixed m16 tiles of the slice for the cluster's whole
// row range, their sums and Kahan compensations in registers.  X crosses
// the bus once.  Each cluster writes one loss partial and its gradient
// partial, which lanes_reduce sums in cluster order.  The cluster's size
// and the grid come from cudaOccupancyMaxActiveClusters (lanes_plan).
constexpr int kLanesClusterMaxStages = 4;
constexpr int kLanesClusterMinStages = 2;

// Shared-memory layout of one block of the cluster mode (byte offsets):
// the stages' mbarriers (kLanesClusterMaxStages) and the two parities'
// partial-dot mbarriers at 0, the warps' partial dots (kMmaWarps x 16 x
// mma_lane_stride), the two parities' slots of the ranks' partial dots
// (c ranks x 16 rows x 8 NT lanes each), the tile's multipliers, W's
// slice, then the ring (stages x 16 row slices, each 16-byte aligned with
// 16 bytes of slack, so that its byte offset modulo 16 can match its
// address in device memory; for f32 a row's stride is S + 4 floats, so
// that the lanes of an A fragment load hit distinct banks).
struct LanesClusterLayout {
  int64_t zp, slot, mult, w, ring, row_stride, stage, total;
};

__host__ __device__ inline LanesClusterLayout lanes_cluster_layout(
    int64_t slice, int nt, int c, int stages, int itemsize) {
  const int ls = mma_lane_stride(nt);
  LanesClusterLayout s;
  s.zp = 8 * (kLanesClusterMaxStages + 2);
  s.slot = s.zp + 4 * kMmaWarps * kMmaRows * ls;
  s.mult = s.slot + 4 * 2 * int64_t(c) * kMmaRows * 8 * nt;
  s.w = round_up(s.mult + 4 * kMmaRows * ls, 16);
  s.ring = round_up(s.w + 4 * 8 * nt * mma_w_stride(slice), 128);
  s.row_stride = round_up(slice * itemsize, 16) + kTileSlack;
  s.stage = kMmaRows * s.row_stride;
  s.total = s.ring + stages * s.stage;
  return s;
}

// The ring's stages for kb lanes over X of width d in clusters of c
// blocks (as many as fit, at most kLanesClusterMaxStages), or 0 where
// kLanesClusterMinStages do not fit, the slice's m16 tiles are past the
// registers (kMmaMaxTiles), or the last block would own no column.
int lanes_cluster_stages(int64_t d, int kb, int c, int itemsize) {
  const int64_t slice = cluster_slice(d, c);
  const int nt = kb <= 8 ? 1 : 2;
  const int mt = mma_tiles(slice);
  if (d - (c - 1) * slice < 1 || mt < 1 || mt * nt > kMmaMaxTiles) return 0;
  for (int st = kLanesClusterMaxStages; st >= kLanesClusterMinStages; --st)
    if (lanes_cluster_layout(slice, nt, c, st, itemsize).total <= kSmemBlock)
      return st;
  return 0;
}

template <typename T, int NT, int MT>
__global__ void __launch_bounds__(kMmaThreads, 1)
    lanes_cluster(const T* __restrict__ X, const float* __restrict__ y,
                  const float* __restrict__ mask, const float* __restrict__ W,
                  int64_t n, int64_t d, int k, int loss_kind, int stages,
                  int slice, float* __restrict__ partial_loss,
                  float* __restrict__ partial_grad) {
  constexpr bool kXLo = sizeof(T) == 4;  // f32 X has a lo half
  constexpr int LS = mma_lane_stride(NT);
  constexpr int KB = 8 * NT;             // lanes computed, k of them live
  extern __shared__ __align__(128) unsigned char smem[];
  const int rank = cluster_rank();
  const int blocks = cluster_blocks();
  const int64_t cid = cluster_id();
  const int64_t clusters = cluster_count();
  const LanesClusterLayout lay =
      lanes_cluster_layout(slice, NT, blocks, stages, int(sizeof(T)));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* dots_bar = full + kLanesClusterMaxStages;  // a parity's slots
  float* zp_s = reinterpret_cast<float*>(smem + lay.zp);
  float* slot_s = reinterpret_cast<float*>(smem + lay.slot);
  float* m_s = reinterpret_cast<float*>(smem + lay.mult);
  float* w_s = reinterpret_cast<float*>(smem + lay.w);
  unsigned char* ring = smem + lay.ring;
  // 32-bit offsets in the ring, and the slice's first column: fewer
  // registers held across the row loop (the 8-tile build spilled more)
  const int row_stride = int(lay.row_stride), stage_bytes = int(lay.stage);
  const int ws = int(mma_w_stride(slice));
  const int c0 = rank * slice;
  // this block's columns (at most slice)
  const int cols = int(rank == blocks - 1 ? d - c0 : slice);
  const int ksteps = (cols + 7) / 8;    // 8-column steps of the dots
  const int mtiles = (cols + 15) / 16;  // 16-column m-tiles of the gradient

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int64_t rows_per_cluster = (n + clusters - 1) / clusters;
  const int64_t r_begin = min64(n, cid * rows_per_cluster);
  const int64_t r_end = min64(n, r_begin + rows_per_cluster);
  const int tiles = int((r_end - r_begin + kMmaRows - 1) / kMmaRows);

  for (int i = tid; i < KB * ws; i += kMmaThreads) {
    const int kk = i / ws, c = i % ws;
    w_s[i] = kk < k && c < cols ? W[int64_t(kk) * d + c0 + c] : 0.f;
  }
  static_assert(kMmaWarps == kMmaRows, "a warp issues a row of a stage");
  if (tid == 0) {
    for (int b = 0; b < kLanesClusterMaxStages; ++b)
      mbar_init(&full[b], kMmaRows);
    for (int b = 0; b < 2; ++b) mbar_init(&dots_bar[b]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  cluster_sync();

  // Fill tile s's stage: row r's slice by lane 0 of warp r, one bulk copy
  // of the 16-byte chunks that cover it (the elements at X's ends that
  // fill no chunk copied plainly first), its bytes expected on the
  // stage's mbarrier with the warp's arrival (kMmaRows arrivals a phase; a
  // row past the tile arrives with none).  One thread issuing a stage's
  // 16 copies in turn took 1.6-1.7x as long a tile (PERF.md).
  auto issue = [&](int s) {
    if (lane != 0) return;
    const int64_t row = r_begin + int64_t(s) * kMmaRows + warp;
    unsigned char* dst = ring + (s % stages) * stage_bytes + warp * row_stride;
    uint64_t* bar = &full[s % stages];
    if (row < r_end) {
      const T* a = X + row * d + c0;
      issue_stage(dst, a, a + cols, X, X + n * d, bar);
    } else {
      mbar_expect_bytes(bar, 0);
    }
  };
  for (int s = 0; s < stages && s < tiles; ++s) issue(s);

  float acc[MT][NT][4], comp[MT][NT][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[m][nt][i] = comp[m][nt][i] = 0.f;
  // this thread's place in the middle: row mr of the tile, lane mk
  const bool mid = tid < kMmaRows * KB;
  const int mr = tid / KB, mk = tid % KB;
  Kahan loss_acc;

  for (int s = 0; s < tiles; ++s) {
    const int64_t row0 = r_begin + int64_t(s) * kMmaRows;
    const int rows = int(min64(kMmaRows, r_end - row0));
    const bool live = mid && mr < rows && mk < k;
    const float yv = live ? y[row0 + mr] : 0.f;
    const float mv = live ? mask[row0 + mr] : 0.f;
    mbar_wait(&full[s % stages], uint32_t((s / stages) & 1));
    // every thread is done with the last tile (its stage, the partial
    // dots, the multipliers): refill its stage
    __syncthreads();
    if (s >= 1 && s - 1 + stages < tiles) issue(s - 1 + stages);
    const T* xs = reinterpret_cast<const T*>(ring + (s % stages) * stage_bytes);
    // where row r of the tile starts in xs (r below rows): its slice sits
    // at its address modulo 16
    auto row_at = [&](int r) {
      return int((r * row_stride +
                  (reinterpret_cast<uintptr_t>(X + (row0 + r) * d + c0) &
                   15)) /
                 int64_t(sizeof(T)));
    };

    // the block's partial dots: warp w sums the 8-column steps w, w +
    // kMmaWarps, ...; rows past the tile and columns past the slice read
    // as zeros
    {
      const int xa[2] = {row_at(g < rows ? g : 0),
                         row_at(g + 8 < rows ? g + 8 : 0)};
      const bool ra[2] = {g < rows, g + 8 < rows};
      float big[NT][4], small[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) big[nt][i] = small[nt][i] = 0.f;
      for (int st = warp; st < ksteps; st += kMmaWarps) {
        uint32_t ah[4], al[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int c = st * 8 + t + 4 * (i >> 1);
          split_x<T>(ra[i & 1] && c < cols ? to_f32(xs[xa[i & 1] + c]) : 0.f,
                     ah[i], al[i]);
        }
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          uint32_t bh[2], bl[2], bl2[2];
#pragma unroll
          for (int h = 0; h < 2; ++h)
            split_w(w_s[(nt * 8 + g) * ws + st * 8 + t + 4 * h], bh[h], bl[h],
                    bl2[h]);
          mma3<kXLo>(big[nt], small[nt], ah, al, bh, bl);
          mma_tf32(small[nt], ah, bl2);  // x_hi w_lo2
        }
      }
      float* zp = zp_s + warp * kMmaRows * LS;
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          *reinterpret_cast<float2*>(zp + (g + 8 * h) * LS + nt * 8 + 2 * t) =
              make_float2(big[nt][2 * h] + small[nt][2 * h],
                          big[nt][2 * h + 1] + small[nt][2 * h + 1]);
    }
    __syncthreads();

    // the block's partial of (row mr, lane mk), the warps' in order, into
    // slot (rank, mr, mk) of every block of the cluster
    float* slot = slot_s + (s & 1) * blocks * kMmaRows * KB;
    uint64_t* bar = &dots_bar[s & 1];
    if (tid == 0) mbar_expect_bytes(bar, uint32_t(blocks * rows * k * 4));
    if (live) {
      float p = 0.f;
#pragma unroll
      for (int w = 0; w < kMmaWarps; ++w)
        p += zp_s[(w * kMmaRows + mr) * LS + mk];
      for (int q = 0; q < blocks; ++q)
        send_peer(&slot[(rank * kMmaRows + mr) * KB + mk], p, bar, q);
    }
    mbar_wait(bar, uint32_t((s >> 1) & 1));
    // the middle: the whole dot, the same in every block (the ranks'
    // partials in order); dead rows and lanes get 0
    if (mid) {
      float mm = 0.f;
      if (live) {
        float z = 0.f;
        for (int q = 0; q < blocks; ++q)
          z += slot[(q * kMmaRows + mr) * KB + mk];
        float per, mult;
        loss_middle_of(loss_kind, z, yv, &per, &mult);
        mm = mult * mv;
        if (rank == 0) loss_acc.add(per * mv);
      }
      m_s[mr * LS + mk] = mm;
    }
    __syncthreads();

    // the gradient of the slice: M's fragments (the tile's two k8 steps
    // of rows), split at each m-tile (fewer registers held across the
    // m-tiles than the halves); then warp w's m-tiles
    {
      float mf[2][NT][2];
#pragma unroll
      for (int ks = 0; ks < 2; ++ks)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            mf[ks][nt][h] = m_s[(ks * 8 + t + 4 * h) * LS + nt * 8 + g];
      // this thread's rows of the A fragments: t, t + 4, t + 8, t + 12
      int xr[4];
      bool rr[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        rr[j] = t + 4 * j < rows;
        xr[j] = row_at(rr[j] ? t + 4 * j : 0);
      }
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const int mt = warp + kMmaWarps * m;
        if (mt < mtiles) {
          float big[NT][4], small[NT][4];
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int i = 0; i < 4; ++i) big[nt][i] = small[nt][i] = 0.f;
#pragma unroll
          for (int ks = 0; ks < 2; ++ks) {
            uint32_t ah[4], al[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int c = mt * 16 + g + 8 * (i & 1);
              const int j = 2 * ks + (i >> 1);
              split_x<T>(rr[j] && c < cols ? to_f32(xs[xr[j] + c]) : 0.f,
                         ah[i], al[i]);
            }
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) {
              uint32_t mh[2], ml[2];
#pragma unroll
              for (int h = 0; h < 2; ++h)
                split_tf32(mf[ks][nt][h], mh[h], ml[h]);
              mma3<kXLo>(big[nt], small[nt], ah, al, mh, ml);
            }
          }
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const float v = (big[nt][i] + small[nt][i]) - comp[m][nt][i];
              const float sum = acc[m][nt][i] + v;
              comp[m][nt][i] = (sum - acc[m][nt][i]) - v;
              acc[m][nt][i] = sum;
            }
        }
      }
    }
  }

  // the cluster's partials: each block its slice of the gradient from the
  // registers; rank 0 the loss of each lane, summed over the middle's
  // rows in order
  const int64_t kd = int64_t(k) * d;
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    const int mt = warp + kMmaWarps * m;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = mt * 16 + g + 8 * (i >> 1);
        const int kk = nt * 8 + 2 * t + (i & 1);
        if (mt < mtiles && c < cols && kk < k)
          partial_grad[cid * kd + int64_t(kk) * d + c0 + c] = acc[m][nt][i];
      }
  }
  if (rank == 0) {
    __syncthreads();  // every thread is done with the partial dots
    if (mid) zp_s[tid] = loss_acc.s;
    __syncthreads();
    if (tid < k) {
      Kahan sum;
      for (int r = 0; r < kMmaRows; ++r) sum.add(zp_s[r * KB + tid]);
      partial_loss[cid * k + tid] = sum.s;
    }
  }
  cluster_sync();
}

// ---- two-pass mode ----------------------------------------------------
//
// X read twice, both products on the tensor cores with the fragments and
// splits of lanes_mma (tf32_mma.cuh), in three launches and the final
// sums:
//   - pass 1 (lanes_tp_dots): block (row tile, D split) forms the partial
//     dots Z (128 rows x 8 NT lanes) = X_tile W^T over its columns: warp
//     w owns rows 16 w .. 16 w + 15 (an m16 tile) and every lane; D runs
//     in stages of 256 bytes of each row (64 f32 or 128 bf16 columns)
//     through a two-stage ring that carries X's stage and W's (the k
//     lanes' same columns), so W leaves L2 once a tile and not once a row.
//     Tiles of 256 rows by 128 bytes took 15-20% longer in pass 1 on the
//     H100, and a third stage at one block an SM 30% longer (PERF.md):
//     a stage's bulk copies are as many as its rows.
//     Each stage's sum (hi*hi from zero at each k8 step, added with a
//     rounded f32 add; the small terms in the compensation) is added to
//     the sum over stages with compensation.  The block writes its partial
//     Z into the (splits, N, LS) scratch (LS = mma_lane_stride: 8 floats a
//     row, 24 for two n8 tiles, so that pass 2's B loads hit distinct
//     banks).  Where the row tiles leave the card's waves short (10,000
//     rows are 79 tiles for 264 resident blocks), D is split across
//     blocks: the fewest splits whose blocks fill their waves
//     (two_pass_plan);
//   - the middle (lanes_tp_middle): a thread an element (row, lane) of
//     the dots: the splits' partials added in split order, the lane's
//     middle applied, m * mult written over the first split's dot (the
//     (N, LS) multipliers, 0 past lane k), m * per added to the thread's
//     loss; each block's loss of each lane summed in a fixed tree;
//   - pass 2 (lanes_tp_grad): block (256 columns of D, row group) forms
//     G^T (256 x 8 NT) = X^T M over the group's rows: warp w owns
//     columns 32 w .. 32 w + 31 (two m16 tiles of A = X^T, read down the
//     staged rows) and every lane (B = M), in stages of 32 f32 or 64 bf16
//     rows through a two-stage ring, the stages added with compensation,
//     into its group's gradient partial; the row groups are as many as
//     fill the card's waves at every width (two_pass_plan).
// A stage's rows arrive by one bulk copy each (cp.async.bulk of the
// 16-byte chunks that cover the row's columns, issue_stage), each row at
// its address modulo 16, so rows of any width (14,337 f32 columns: no row
// but every fourth is aligned) need no padding; a thread a row issues
// them, and the stage completes on its mbarrier.  The first build copied
// the 16-byte chunks with cp.async, about 9 a thread a stage, and took
// 1.3-1.5x as long (PERF.md).  Columns past the last
// stage of D are masked at the fragment loads (pass 1) or land only in
// G^T's rows past d, which are not written (pass 2); rows past the tile
// give dots that are not written (pass 1) and are zeroed in both
// operands (pass 2); lanes past k give dots that the middle does not
// read.  No float atomics: two calls give the same bits.
constexpr int kTPThreads = kThreads;
// pass 1: m16 tiles of rows a warp, so rows a block; bytes of each row a
// stage (so its columns a stage: tp_step); the ring's stages; blocks an
// SM (their registers capped to fit)
constexpr int kTP1MTiles = 1;
constexpr int kTP1Rows = 16 * kTP1MTiles * kWarps;
constexpr int kTP1RowBytes = 256;
constexpr int kTP1Stages = 2;
constexpr int kTP1MinBlocks = 2;
// pass 2: m16 tiles of columns a warp, so columns a block; a stage's
// bytes of X (so its rows: tp_rows); blocks an SM
constexpr int kTP2MTiles = 2;
constexpr int kTP2Cols = 16 * kTP2MTiles * kWarps;
constexpr int kTP2StageBytes = 32 * 1024;
constexpr int kTP2MinBlocks = 2;
// D splits of pass 1: at most kTPMaxSplits, each at least kTPMinSplitStages
// stages; pass 2's row groups: at least kTPWaves waves of blocks, their
// partials at most kTPPartialBytes; the middle: at most kTPMiddlePerSM
// blocks an SM (its loss partials)
constexpr int kTPMaxSplits = 32;
constexpr int kTPMinSplitStages = 16;
constexpr int kTPWaves = 4;
constexpr int64_t kTPPartialBytes = int64_t(256) << 20;
constexpr int kTPMiddlePerSM = 4;

// Pass 1's columns a stage and pass 2's rows a stage, for X of `itemsize`.
__host__ __device__ constexpr int tp_step(int itemsize) {
  return kTP1RowBytes / itemsize;
}
__host__ __device__ constexpr int tp_rows(int itemsize) {
  return kTP2StageBytes / (kTP2Cols * itemsize);
}

// A row stride in shared memory: `bytes` rounded up to 16, then to s %
// 128 == rem, so that the lanes of a fragment load hit distinct banks
// (32 banks of 4 bytes).  Fragments across a row (pass 1's A = X and B =
// W^T: lane (g, t) reads row g, column t) take rem 16, a word stride of 4
// mod 32; fragments down the columns (pass 2's A = X^T and B = M: lane
// (g, t) reads row t, column g) take rem 32, 8 mod 32.
__host__ __device__ constexpr int tp_stride(int bytes, int rem) {
  return (bytes + 15) / 16 * 16 +
         ((rem - (bytes + 15) / 16 * 16 % 128) % 128 + 128) % 128;
}

// Pass 1's shared memory (byte offsets): kTP1Stages stages, each the X
// stage (kTP1Rows rows of kTP1RowBytes, each at its address modulo 16)
// then W's (8 NT lanes of the same columns, in f32); then the stages'
// mbarriers.
struct TP1Layout {
  int xs, ws, x, stage, bar, total;
  __host__ __device__ constexpr TP1Layout(int itemsize, int nt)
      : xs(tp_stride(kTP1RowBytes + 16, 16)),
        ws(tp_stride(tp_step(itemsize) * 4 + 16, 16)),
        x(kTP1Rows * xs),
        stage(x + 8 * nt * ws),
        bar(kTP1Stages * stage),
        total(bar + 8 * kTP1Stages) {}
};

// Pass 2's shared memory (byte offsets): two stages, each the X stage
// (tp_rows rows of 256 columns, each at its address modulo 16) then M's
// (the same rows of the multipliers, as the scratch holds them:
// mma_lane_stride floats a row); then the stages' mbarriers.
struct TP2Layout {
  int xs, ms, x, stage, bar, total;
  __host__ __device__ constexpr TP2Layout(int itemsize, int nt)
      : xs(tp_stride(kTP2Cols * itemsize + 16, 32)),
        ms(4 * mma_lane_stride(nt)),
        x(tp_rows(itemsize) * xs),
        stage(x + tp_rows(itemsize) * ms),
        bar(2 * stage),
        total(bar + 16) {}
};

// Where element c of a staged row starts: the row's byte address modulo
// 16, in elements.
template <typename T>
__device__ __forceinline__ int tp_offset(const T* base, int64_t elem) {
  return int(((reinterpret_cast<uintptr_t>(base) +
               uintptr_t(elem) * sizeof(T)) & 15) / sizeof(T));
}

// The stage's sum (`big`, the small terms in `ncomp`) into the sum over
// stages with compensation: ncomp is the negated Kahan correction, so the
// stage's sum plus ncomp is what the next compensated add takes.
template <int MT, int NT>
__device__ __forceinline__ void tp_add_stage(float (&sum)[MT][NT][4],
                                             float (&ncomp)[MT][NT][4],
                                             const float (&big)[MT][NT][4]) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float v = big[mt][nt][i] + ncomp[mt][nt][i];
        const float s = sum[mt][nt][i] + v;
        ncomp[mt][nt][i] = v - (s - sum[mt][nt][i]);
        sum[mt][nt][i] = s;
      }
}

// Pass 1: block (x, y) forms the partial dots of rows [256 x, 256 x +
// 256) over the columns [y split_cols, (y + 1) split_cols) of D (a
// multiple of the stage) and writes them to zp[(y n + row) LS + lane]
// (rows below n, all 8 NT lanes; LS = mma_lane_stride).  Stage s: row r
// of the tile by thread r, lane kk of W by thread kk, one bulk copy each
// (issue_stage), an arrival each on the stage's mbarrier (with no bytes
// past the tile and past lane k).  A fragments: a0 (row g, column t), a1
// (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4) of the warp's m-tile; B:
// b0 (column t, lane g), b1 (t + 4, g); C: c0 (row g, lane 2t), c1 (g,
// 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1).
template <typename T, int NT>
__global__ void __launch_bounds__(kTPThreads, kTP1MinBlocks)
    lanes_tp_dots(const T* __restrict__ X, const float* __restrict__ W,
                  int64_t n, int64_t d, int k, int64_t split_cols,
                  float* __restrict__ zp) {
  constexpr bool kXLo = sizeof(T) == 4;  // f32 X has a lo half
  constexpr int MT = kTP1MTiles;
  constexpr int STEP = tp_step(int(sizeof(T)));
  constexpr int LS = mma_lane_stride(NT);
  constexpr TP1Layout lay(int(sizeof(T)), NT);
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + lay.bar);
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int64_t row0 = int64_t(blockIdx.x) * kTP1Rows;
  const int rows = int(min64(kTP1Rows, n - row0));
  const int64_t dbeg = int64_t(blockIdx.y) * split_cols;
  const int64_t dend = min64(d, dbeg + split_cols);
  const int nst = int((dend - dbeg + STEP - 1) / STEP);
  const T* xt = X + row0 * d;
  // where this lane's rows (m-tile mt, half h) and lanes (n8 tile nt)
  // start in a stage, in elements: the same in every stage, whose first
  // column lies a multiple of 16 bytes on
  int xo[MT][2], wo[NT];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = warp * 16 * MT + mt * 16 + g + 8 * h;
      xo[mt][h] = r * (lay.xs / int(sizeof(T))) + tp_offset(xt, r * d);
    }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
    wo[nt] = (nt * 8 + g) * (lay.ws / 4) + tp_offset(W, (nt * 8 + g) * d);
  static_assert(kTP1Rows <= kTPThreads, "a thread a row");
  if (tid == 0) {
    for (int b = 0; b < kTP1Stages; ++b)
      mbar_init(&full[b], kTP1Rows + 8 * NT);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  auto issue = [&](int s) {
    unsigned char* st = smem + (s % kTP1Stages) * lay.stage;
    uint64_t* bar = &full[s % kTP1Stages];
    const int64_t c0 = dbeg + int64_t(s) * STEP;
    const int64_t c1 = min64(dend, c0 + STEP);
    if (tid < rows) {
      const T* a = xt + tid * d;
      issue_stage(st + tid * lay.xs, a + c0, a + c1, X, X + n * d, bar);
    } else if (tid < kTP1Rows) {
      mbar_expect_bytes(bar, 0);
    }
    if (tid < k) {
      const float* a = W + tid * d;
      issue_stage(st + lay.x + tid * lay.ws, a + c0, a + c1, W,
                  W + int64_t(k) * d, bar);
    } else if (tid < 8 * NT) {
      mbar_expect_bytes(bar, 0);
    }
  };
#pragma unroll
  for (int s = 0; s < kTP1Stages - 1; ++s)
    if (s < nst) issue(s);
  float sum[MT][NT][4], ncomp[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) sum[mt][nt][i] = ncomp[mt][nt][i] = 0.f;

  for (int s = 0; s < nst; ++s) {
    mbar_wait(&full[s % kTP1Stages], uint32_t((s / kTP1Stages) & 1));
    // every thread is done with stage s - 1, whose buffer takes stage s +
    // kTP1Stages - 1
    __syncthreads();
    if (s + kTP1Stages - 1 < nst) issue(s + kTP1Stages - 1);
    const unsigned char* st = smem + (s % kTP1Stages) * lay.stage;
    const T* xs = reinterpret_cast<const T*>(st);
    const float* ws = reinterpret_cast<const float*>(st + lay.x);
    // the stage's live columns: fewer only in the last stage of D, whose
    // columns past them are masked to zero in both operands
    const int live = int(min64(STEP, dend - dbeg - int64_t(s) * STEP));
    float big[MT][NT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) big[mt][nt][i] = 0.f;
    auto dots = [&](auto tail) {
      constexpr bool kTail = decltype(tail)::value;
#pragma unroll 4
      for (int j = 0; j < STEP / 8; ++j) {
        uint32_t ah[MT][4], al[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int c = j * 8 + t + 4 * (i >> 1);
            const float v = to_f32(xs[xo[mt][i & 1] + c]);
            split_x<T>(!kTail || c < live ? v : 0.f, ah[mt][i], al[mt][i]);
          }
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          uint32_t bh[2], bl[2], bl2[2];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int c = j * 8 + t + 4 * h;
            const float v = ws[wo[nt] + c];
            split_w(!kTail || c < live ? v : 0.f, bh[h], bl[h], bl2[h]);
          }
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma3<kXLo>(big[mt][nt], ncomp[mt][nt], ah[mt], al[mt], bh, bl);
            mma_tf32(ncomp[mt][nt], ah[mt], bl2);  // x_hi w_lo2
          }
        }
      }
    };
    if (live == STEP)
      dots(std::false_type{});
    else
      dots(std::true_type{});
    tp_add_stage(sum, ncomp, big);
  }

  float* out = zp + (int64_t(blockIdx.y) * n + row0) * LS;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = warp * 16 * MT + mt * 16 + g + 8 * h;
      if (r >= rows) continue;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        *reinterpret_cast<float2*>(out + r * LS + nt * 8 + 2 * t) =
            make_float2(sum[mt][nt][2 * h] + ncomp[mt][nt][2 * h],
                        sum[mt][nt][2 * h + 1] + ncomp[mt][nt][2 * h + 1]);
    }
}

// The middle: element (row, lane) of the dots (lane below ms = 8 NT), a
// thread each in a grid-stride loop over row ms + lane (the stride a
// multiple of ms, so that a thread keeps its lane): the `splits`
// partials at zp + (s n + row) ls + lane added in split order, lane's
// middle applied, m * mult written over the first split's dot (0 past
// lane k), m * per added to the thread's loss.  Each block's loss of each
// lane, summed in a fixed tree, goes to partial_loss[block k + lane].
__global__ void __launch_bounds__(kTPThreads)
    lanes_tp_middle(const float* __restrict__ y,
                    const float* __restrict__ mask, int64_t n, int k, int ms,
                    int ls, int splits, int loss_kind, float* __restrict__ zp,
                    float* __restrict__ partial_loss) {
  __shared__ float loss_s[kTPThreads];
  const int lane = threadIdx.x % ms;
  Kahan acc;
  for (int64_t e = int64_t(blockIdx.x) * kTPThreads + threadIdx.x;
       e < n * ms; e += int64_t(gridDim.x) * kTPThreads) {
    const int64_t r = e / ms;
    float* p = zp + r * ls + lane;
    float mm = 0.f;
    if (lane < k) {
      float z = 0.f;
      for (int s = 0; s < splits; ++s) z += p[s * n * ls];
      float per, mult;
      loss_middle_of(loss_kind, z, y[r], &per, &mult);
      const float m = mask[r];
      mm = mult * m;
      acc.add(per * m);
    }
    *p = mm;
  }
  loss_s[threadIdx.x] = acc.s;
  __syncthreads();
  for (int w = kTPThreads / 2; w >= ms; w >>= 1) {
    if (threadIdx.x < w) loss_s[threadIdx.x] += loss_s[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x < k)
    partial_loss[int64_t(blockIdx.x) * k + threadIdx.x] = loss_s[threadIdx.x];
}

// Pass 2: block (x, y) forms G^T = X^T M for the columns [256 x, 256 x +
// 256) of D over the rows [y rows_per_group, ...) (a multiple of the
// stage), M the (n, LS) multipliers (LS = mma_lane_stride, lanes past 8
// NT unread), and writes partial_grad[(y k + kk) d + c] (c below d, kk
// below k).  Stage s: row r by thread r (one bulk copy, issue_stage; a
// row past the group zeroed by its thread), M's rows by thread R (one
// bulk copy; rows past the group zeroed), an arrival each on the stage's
// mbarrier.  A = X^T: a0 (column g, row t), a1 (g + 8, t), a2 (g, t + 4),
// a3 (g + 8, t + 4) of the warp's m-tile; B = M: b0 (row t, lane g), b1
// (t + 4, g); C: c0 (column g, lane 2t), c1 (g, 2t + 1), c2 (g + 8, 2t),
// c3 (g + 8, 2t + 1).
template <typename T, int NT>
__global__ void __launch_bounds__(kTPThreads, kTP2MinBlocks)
    lanes_tp_grad(const T* __restrict__ X, const float* __restrict__ mult,
                  int64_t n, int64_t d, int k, int64_t rows_per_group,
                  float* __restrict__ partial_grad) {
  constexpr bool kXLo = sizeof(T) == 4;
  constexpr int MT = kTP2MTiles;
  constexpr int LS = mma_lane_stride(NT);
  constexpr int R = tp_rows(int(sizeof(T)));
  constexpr TP2Layout lay(int(sizeof(T)), NT);
  static_assert(R < kTPThreads, "a thread a row and one for M");
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + lay.bar);
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int64_t d0 = int64_t(blockIdx.x) * kTP2Cols;
  const int64_t c1 = min64(d, d0 + kTP2Cols);
  const int64_t r_begin = min64(n, int64_t(blockIdx.y) * rows_per_group);
  const int64_t r_end = min64(n, r_begin + rows_per_group);
  const int nst = int((r_end - r_begin + R - 1) / R);
  // a row's bytes modulo 16, for the staged rows' offsets
  const uint32_t row_bytes = uint32_t((d * int64_t(sizeof(T))) & 15);
  if (tid == 0) {
    for (int b = 0; b < 2; ++b) mbar_init(&full[b], R + 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  auto issue = [&](int s) {
    unsigned char* st = smem + (s & 1) * lay.stage;
    uint64_t* bar = &full[s & 1];
    const int64_t r0 = r_begin + int64_t(s) * R;
    const int rows = int(min64(R, r_end - r0));
    if (tid < rows) {
      const T* a = X + (r0 + tid) * d;
      issue_stage(st + tid * lay.xs, a + d0, a + c1, X, X + n * d, bar);
    } else if (tid < R) {  // rows past the group read as zeros
      uint4* z = reinterpret_cast<uint4*>(st + tid * lay.xs);
      for (int i = 0; i < lay.xs / 16; ++i) z[i] = make_uint4(0u, 0u, 0u, 0u);
      mbar_expect_bytes(bar, 0);
    } else if (tid == R) {
      float* m = reinterpret_cast<float*>(st + lay.x);
      for (int i = rows * LS; i < R * LS; ++i) m[i] = 0.f;
      issue_stage(st + lay.x, mult + r0 * LS, mult + (r0 + rows) * LS, mult,
                  mult + n * LS, bar);
    }
  };
  if (nst > 0) issue(0);
  float sum[MT][NT][4], ncomp[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) sum[mt][nt][i] = ncomp[mt][nt][i] = 0.f;

  for (int s = 0; s < nst; ++s) {
    mbar_wait(&full[s & 1], uint32_t((s >> 1) & 1));
    __syncthreads();
    if (s + 1 < nst) issue(s + 1);
    const unsigned char* st = smem + (s & 1) * lay.stage;
    const T* xs = reinterpret_cast<const T*>(st);
    const float* ms = reinterpret_cast<const float*>(st + lay.x);
    // the stage's first row at column d0, modulo 16 bytes
    const uint32_t base = uint32_t(
        (reinterpret_cast<uintptr_t>(X + d0) +
         uintptr_t(r_begin + int64_t(s) * R) * uintptr_t(d) * sizeof(T)) &
        15);
    float big[MT][NT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) big[mt][nt][i] = 0.f;
#pragma unroll 2
    for (int j = 0; j < R / 8; ++j) {
      // this lane's rows j 8 + t and j 8 + t + 4, each at its address
      // modulo 16 (a zeroed row past the group reads zeros wherever)
      int xr[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = j * 8 + t + 4 * h;
        xr[h] = r * (lay.xs / int(sizeof(T))) +
                int(((base + uint32_t(r) * row_bytes) & 15) / sizeof(T));
      }
      uint32_t ah[MT][4], al[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          split_x<T>(to_f32(xs[xr[i >> 1] + warp * 16 * MT + mt * 16 + g +
                               8 * (i & 1)]),
                     ah[mt][i], al[mt][i]);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        uint32_t bh[2], bl[2];
#pragma unroll
        for (int h = 0; h < 2; ++h)
          split_tf32(ms[(j * 8 + t + 4 * h) * LS + nt * 8 + g], bh[h], bl[h]);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          mma3<kXLo>(big[mt][nt], ncomp[mt][nt], ah[mt], al[mt], bh, bl);
      }
    }
    tp_add_stage(sum, ncomp, big);
  }

  float* pg = partial_grad + int64_t(blockIdx.y) * k * d;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int64_t c = d0 + warp * 16 * MT + mt * 16 + g + 8 * (i >> 1);
        const int kk = nt * 8 + 2 * t + (i & 1);
        if (c < d && kk < k)
          pg[int64_t(kk) * d + c] = sum[mt][nt][i] + ncomp[mt][nt][i];
      }
}

// Stage 2: fixed-order sums of the partials.  Thread i < k*d sums
// gradient entry i over the ngrad gradient partials; thread k*d + kk sums
// lane kk's loss over the nloss loss partials.
__global__ void lanes_reduce(const float* __restrict__ partial_loss,
                             int nloss, const float* __restrict__ partial_grad,
                             int ngrad, int64_t kd, int k,
                             float* __restrict__ loss,
                             float* __restrict__ grad) {
  const int64_t i = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < kd) {
    Kahan sum;
    for (int b = 0; b < ngrad; ++b) sum.add(partial_grad[int64_t(b) * kd + i]);
    grad[i] = sum.s;
  } else if (i < kd + k) {
    const int kk = int(i - kd);
    Kahan sum;
    for (int b = 0; b < nloss; ++b) sum.add(partial_loss[int64_t(b) * k + kk]);
    loss[kk] = sum.s;
  }
}

enum Mode {
  kLanesTile = 0,
  kLanesTwoPass = 1,
  kLanesMma = 2,
  kLanesCluster = 3
};

// A launch plan, as lanes_plan fills it: the mode; the lane bucket; the
// tile rows (tile and tensor-core modes), the ring's stages (cluster
// mode) or pass 1's D splits (two-pass mode); the blocks of the launch
// (two-pass mode: of the middle); the gradient partials (the grid, pass
// 2's row groups, or the clusters); the blocks of a cluster (cluster
// mode, else 0).  One loss partial a block (two-pass mode: a block of the
// middle), or a cluster.
struct Plan {
  int mode, kb, rows, grid, partials, cluster;
};

template <typename T, int L, int NT, int MT>
cudaError_t launch_mma_tiles(const Plan& p, const T* X, const float* y,
                             const float* mask, const float* W, int64_t n,
                             int64_t d, int k, float* partial_loss,
                             float* partial_grad, cudaStream_t stream) {
  if constexpr (NT * MT > kMmaMaxTiles) {
    return cudaErrorInvalidValue;
  } else {
    const int64_t smem = MmaLayout(d, NT, int(sizeof(T))).total;
    auto kern = lanes_mma<T, L, NT, MT>;
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return err;
    kern<<<p.grid, kMmaThreads, size_t(smem), stream>>>(
        X, y, mask, W, n, int(d), k, partial_loss, partial_grad);
    return cudaGetLastError();
  }
}

template <typename T, int L, int NT>
cudaError_t launch_mma(const Plan& p, const T* X, const float* y,
                       const float* mask, const float* W, int64_t n,
                       int64_t d, int k, float* pl, float* pg,
                       cudaStream_t s) {
  switch (mma_tiles(d)) {
    case 1:
      return launch_mma_tiles<T, L, NT, 1>(p, X, y, mask, W, n, d, k, pl, pg,
                                           s);
    case 2:
      return launch_mma_tiles<T, L, NT, 2>(p, X, y, mask, W, n, d, k, pl, pg,
                                           s);
    case 4:
      return launch_mma_tiles<T, L, NT, 4>(p, X, y, mask, W, n, d, k, pl, pg,
                                           s);
    case 8:
      return launch_mma_tiles<T, L, NT, 8>(p, X, y, mask, W, n, d, k, pl, pg,
                                           s);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T, int L, int KB>
cudaError_t launch_kb(const Plan& p, const T* X, const float* y,
                      const float* mask, const float* W, int64_t n, int64_t d,
                      int k, float* partial_loss, float* partial_grad,
                      cudaStream_t stream) {
  if (p.mode == kLanesMma)
    return launch_mma<T, L, (KB <= 8 ? 1 : 2)>(p, X, y, mask, W, n, d, k,
                                               partial_loss, partial_grad,
                                               stream);
  const int64_t smem = Layout(d, KB, p.rows, int(sizeof(T))).total;
  auto kern = lanes_tile<T, L, KB>;
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  kern<<<p.grid, kThreads, size_t(smem), stream>>>(
      X, y, mask, W, n, d, k, p.rows, partial_loss, partial_grad);
  return cudaGetLastError();
}

template <typename T, int L>
cudaError_t launch_loss(const Plan& p, const T* X, const float* y,
                        const float* mask, const float* W, int64_t n,
                        int64_t d, int k, float* pl, float* pg,
                        cudaStream_t s) {
  switch (p.kb) {
    case 1:
      return launch_kb<T, L, 1>(p, X, y, mask, W, n, d, k, pl, pg, s);
    case 2:
      return launch_kb<T, L, 2>(p, X, y, mask, W, n, d, k, pl, pg, s);
    case 4:
      return launch_kb<T, L, 4>(p, X, y, mask, W, n, d, k, pl, pg, s);
    case 8:
      return launch_kb<T, L, 8>(p, X, y, mask, W, n, d, k, pl, pg, s);
    case kMaxLanes:
      return launch_kb<T, L, kMaxLanes>(p, X, y, mask, W, n, d, k, pl, pg,
                                        s);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_type(int loss_kind, const Plan& p, const void* X,
                        const float* y, const float* mask, const float* W,
                        int64_t n, int64_t d, int k, float* pl, float* pg,
                        cudaStream_t s) {
  const T* Xt = static_cast<const T*>(X);
  switch (loss_kind) {
    case kLogistic:
      return launch_loss<T, kLogistic>(p, Xt, y, mask, W, n, d, k, pl, pg,
                                       s);
    case kLeastSquares:
      return launch_loss<T, kLeastSquares>(p, Xt, y, mask, W, n, d, k, pl,
                                           pg, s);
    case kHinge:
      return launch_loss<T, kHinge>(p, Xt, y, mask, W, n, d, k, pl, pg, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// The columns of each of pass 1's `splits` D splits (a multiple of its
// stage; the last split takes the rest).
int64_t tp_split_cols(int64_t d, int64_t splits, int itemsize) {
  return round_up((d + splits - 1) / splits, tp_step(itemsize));
}

// Pass 2's rows a group for `groups` groups over n rows (a multiple of
// its stage).
int64_t tp_rows_per_group(int64_t n, int64_t groups, int itemsize) {
  return round_up((n + groups - 1) / groups, tp_rows(itemsize));
}

template <typename K>
cudaError_t set_smem(K kern, int64_t bytes) {
  return cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
}

// The two-pass mode's three launches (see lanes_tp_dots): pass 1 on
// (row tiles, p.rows D splits), the middle on p.grid blocks, pass 2 on
// (256-column blocks, p.partials row groups).  `zp` holds p.rows x n x
// mma_lane_stride(NT) floats.
template <typename T, int NT>
cudaError_t launch_two_pass(const Plan& p, int loss_kind, const T* X,
                            const float* y, const float* mask,
                            const float* W, int64_t n, int64_t d, int k,
                            float* pl, float* pg, float* zp,
                            cudaStream_t s) {
  constexpr int itemsize = int(sizeof(T));
  constexpr TP1Layout l1(itemsize, NT);
  constexpr TP2Layout l2(itemsize, NT);
  cudaError_t err = set_smem(lanes_tp_dots<T, NT>, l1.total);
  if (err != cudaSuccess) return err;
  err = set_smem(lanes_tp_grad<T, NT>, l2.total);
  if (err != cudaSuccess) return err;
  const int64_t tiles = (n + kTP1Rows - 1) / kTP1Rows;
  if (tiles > 0) {
    lanes_tp_dots<T, NT>
        <<<dim3(unsigned(tiles), unsigned(p.rows)), kTPThreads, l1.total, s>>>(
            X, W, n, d, k, tp_split_cols(d, p.rows, itemsize), zp);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  lanes_tp_middle<<<p.grid, kTPThreads, 0, s>>>(
      y, mask, n, k, 8 * NT, mma_lane_stride(NT), p.rows, loss_kind, zp, pl);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid2(unsigned((d + kTP2Cols - 1) / kTP2Cols),
                   unsigned(p.partials));
  lanes_tp_grad<T, NT><<<grid2, kTPThreads, l2.total, s>>>(
      X, zp, n, d, k, tp_rows_per_group(n, p.partials, itemsize), pg);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_two_pass_for(const Plan& p, int loss_kind, const void* X,
                                const float* y, const float* mask,
                                const float* W, int64_t n, int64_t d, int k,
                                float* pl, float* pg, float* zp,
                                cudaStream_t s) {
  const T* Xt = static_cast<const T*>(X);
  return p.kb <= 8 ? launch_two_pass<T, 1>(p, loss_kind, Xt, y, mask, W, n,
                                           d, k, pl, pg, zp, s)
                   : launch_two_pass<T, 2>(p, loss_kind, Xt, y, mask, W, n,
                                           d, k, pl, pg, zp, s);
}

// The cluster mode's kernels take X's type as a template argument and
// the loss at run time.
template <typename T>
using ClusterKernel = void (*)(const T*, const float*, const float*,
                               const float*, int64_t, int64_t, int, int, int,
                               int, float*, float*);

// The cluster-mode kernel of NT n8 tiles of lanes and MT m16 tiles a
// warp, its attributes set on the current device (once).
template <typename T, int NT, int MT>
cudaError_t cluster_kernel_of(ClusterKernel<T>* kern) {
  static std::atomic<unsigned long long> done{0};
  *kern = lanes_cluster<T, NT, MT>;
  return smem_attributes(lanes_cluster<T, NT, MT>, done, true);
}

// The cluster-mode kernel for kb lanes over slices of `slice` columns.
template <typename T>
cudaError_t cluster_kernel(int64_t slice, int kb, ClusterKernel<T>* kern) {
  switch ((kb <= 8 ? 100 : 200) + mma_tiles(slice)) {
    case 101:
      return cluster_kernel_of<T, 1, 1>(kern);
    case 102:
      return cluster_kernel_of<T, 1, 2>(kern);
    case 104:
      return cluster_kernel_of<T, 1, 4>(kern);
    case 108:
      return cluster_kernel_of<T, 1, 8>(kern);
    case 201:
      return cluster_kernel_of<T, 2, 1>(kern);
    case 202:
      return cluster_kernel_of<T, 2, 2>(kern);
    case 204:
      return cluster_kernel_of<T, 2, 4>(kern);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_cluster(const Plan& p, const void* X, const float* y,
                           const float* mask, const float* W, int64_t n,
                           int64_t d, int k, int loss_kind, float* pl,
                           float* pg, cudaStream_t stream) {
  const int64_t slice = cluster_slice(d, p.cluster);
  ClusterKernel<T> kern = nullptr;
  cudaError_t err = cluster_kernel<T>(slice, p.kb, &kern);
  if (err != cudaSuccess) return err;
  const int64_t smem = lanes_cluster_layout(slice, p.kb <= 8 ? 1 : 2,
                                            p.cluster, p.rows,
                                            int(sizeof(T)))
                           .total;
  ClusterLaunch l(p.grid, p.cluster, kMmaThreads, smem, stream);
  err = cudaLaunchKernelEx(&l.cfg, kern, static_cast<const T*>(X), y, mask,
                           W, n, d, k, loss_kind, p.rows, int(slice), pl, pg);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// Whether lanes_mma's block holds kb lanes over X of width d: its
// accumulators within the register budget (kMmaMaxTiles) and its block
// within shared memory.
bool mma_fits(int64_t d, int kb, int itemsize) {
  const int nt = kb <= 8 ? 1 : 2;
  const int mt = mma_tiles(d);
  return mt >= 1 && mt * nt <= kMmaMaxTiles &&
         MmaLayout(d, nt, itemsize).total <= kSmemBlock;
}

// The widest X (in columns) for which fits(d) holds, searched up to
// `most` (fits holds from 1 column on, and not past its widest).
template <typename F>
int64_t widest(int64_t most, F&& fits) {
  int64_t lo = 0, hi = most + 1;  // lo fits (vacuously), hi does not
  while (hi - lo > 1) {
    const int64_t mid = (lo + hi) / 2;
    (fits(mid) ? lo : hi) = mid;
  }
  return lo;
}

// The widest X whose kb lanes lanes_mma's block holds.
int64_t mma_max_width(int kb, int itemsize) {
  return widest(kSmemBlock,
                [&](int64_t d) { return mma_fits(d, kb, itemsize); });
}

// Where the tensor-core mode was faster than the tile mode in the
// `--ab lanes:` sweep of chip_smoke.py (PERF.md: 10M rows of f32 X at D
// = 64, 256, 512, 1000): from 8 lanes at every width, 4 lanes past 512
// columns.  At 1 or 2 lanes an n8 tile is mostly padding and the tile
// mode's K sums a row are few.
bool mma_faster(int64_t d, int kb, int /*itemsize*/) {
  return kb >= 8 || (kb == 4 && d > 512);
}

// Whether the plan gives kb lanes over X of width d to the tensor-core
// mode: its block fits, and it was timed faster there than the tile mode.
bool mma_takes(int64_t d, int kb, int itemsize) {
  return mma_fits(d, kb, itemsize) && mma_faster(d, kb, itemsize);
}

// The narrowest X that the plan gives to the cluster mode, where
// chip_smoke.py --ab lanes: timed it faster than one block a row (PERF.md;
// an H100 80GB HBM3).  From 4 lanes up, where lanes_mma's block stops
// fitting (lanes_tile past it holds 1-8 rows a tile), but for bf16 X at
// 4 and 8 lanes from kBf16ClusterFrom: its lanes_mma block did more work
// a tile for the same bytes, and lost from 1,536 columns (it won at
// 1,280).  At 1 and 2 lanes, where lanes_tile is the single-block mode,
// from where its row tile falls below 12 rows (16 for bf16 at 2 lanes):
// tiles of 12 rows tied with the cluster mode, and of 8 lost by 15-30%.
constexpr int64_t kBf16ClusterFrom = 1409;

int64_t cluster_from(int kb, int itemsize) {
  if (kb > 2)
    return itemsize == 2 && kb <= 8 ? kBf16ClusterFrom
                                    : mma_max_width(kb, itemsize) + 1;
  const int rows = itemsize == 2 && kb == 2 ? 16 : 12;
  return widest(kSmemBlock, [&](int64_t d) {
           return choose_tile_rows(d, kb, itemsize) >= rows;
         }) + 1;
}

// The clusters of c blocks, each with `smem` bytes, that the card keeps
// resident at once for the cluster-mode kernel of kb lanes over slices of
// `slice` columns (cudaOccupancyMaxActiveClusters: the SMs of a GPC bound
// where clusters go, so it is not sms / c).
template <typename T>
cudaError_t cluster_resident(int64_t slice, int kb, int c, int64_t smem,
                             int* clusters) {
  ClusterKernel<T> kern = nullptr;
  const cudaError_t err = cluster_kernel<T>(slice, kb, &kern);
  if (err != cudaSuccess) return err;
  ClusterLaunch l(c, c, kMmaThreads, smem, nullptr);
  return cudaOccupancyMaxActiveClusters(clusters, kern, &l.cfg);
}

// The cluster mode's plan for kb lanes over X (n, d) in clusters of c
// blocks: as many clusters as are resident at once, at most one a 16-row
// tile.  Sets p->mode to -1 where the slices do not fit
// (lanes_cluster_stages) or the card keeps no such cluster resident; a
// cluster past the portable size that the card refuses is skipped the
// same way; any other CUDA error is returned.
cudaError_t cluster_plan_of(int64_t n, int64_t d, int kb, int itemsize, int c,
                            Plan* p) {
  p->mode = -1;
  const int stages = lanes_cluster_stages(d, kb, c, itemsize);
  if (stages < kLanesClusterMinStages) return cudaSuccess;
  const int64_t slice = cluster_slice(d, c);
  const int64_t smem =
      lanes_cluster_layout(slice, kb <= 8 ? 1 : 2, c, stages, itemsize)
          .total;
  int resident = 0;
  const cudaError_t err =
      itemsize == 4
          ? cluster_resident<float>(slice, kb, c, smem, &resident)
          : cluster_resident<__nv_bfloat16>(slice, kb, c, smem, &resident);
  if (err != cudaSuccess) {
    if (c <= kPortableCluster) return err;
    cudaGetLastError();  // not schedulable here
    return cudaSuccess;
  }
  if (resident < 1) return cudaSuccess;
  int64_t clusters = (n + kMmaRows - 1) / kMmaRows;
  if (clusters > resident) clusters = resident;
  if (clusters < 1) clusters = 1;
  *p = Plan{kLanesCluster, kb, stages, int(clusters * c), int(clusters), c};
  return cudaSuccess;
}

// The largest cluster the plan gives a width, past which it gives the
// two-pass mode, where `--ab lanes:` of chip_smoke.py timed that faster
// than the next cluster size (PERF.md, an H100 80GB HBM3; 100,003 rows):
// f32 X, 1 lane 8 blocks (the earlier CUDA-core two-pass design against
// 16 blocks at 12,000 columns), 16 lanes 2 (2,049
// columns 0.79-0.81 ms against 1.00-1.01 in 4-block clusters; 2,048
// 0.70-0.78 against 0.64 in 2-block ones), else 16 (within 5% of
// 16-block clusters either way at 8 lanes, slower at 1-4 at their
// reach); bf16 X, 16 lanes none (1,025-3,072 columns 10-43% under every
// cluster size), else 2 (8 lanes: 4,096 0.69-0.71 against 0.64-0.65,
// 4,097 0.71-0.75 against 0.94-0.96; 1-4 lanes: 8,192 1.20-1.28 against
// 4-block clusters' 1.31-1.40).
int most_blocks(int kb, int itemsize) {
  if (itemsize == 2) return kb == kMaxLanes ? 0 : 2;
  return kb == kMaxLanes ? 2 : kb == 1 ? 8 : kClusterMaxSize;
}

// The cluster mode's plan: the smallest cluster the card schedules that
// takes the width (the fewest tiles a cluster), up to most_blocks;
// p->mode is -1 where none does.
cudaError_t cluster_plan(int64_t n, int64_t d, int kb, int itemsize,
                         Plan* p) {
  p->mode = -1;
  for (int c : kClusterSizes) {
    if (c > most_blocks(kb, itemsize)) break;
    const cudaError_t err = cluster_plan_of(n, d, kb, itemsize, c, p);
    if (err != cudaSuccess || p->mode == kLanesCluster) return err;
  }
  return cudaSuccess;
}

// The tensor-core mode's plan: one block an SM, at most one per 16-row
// tile; p->mode is -1 where its block does not fit.
void mma_plan(int64_t n, int64_t d, int kb, int itemsize, int sms, Plan* p) {
  p->mode = -1;
  if (!mma_fits(d, kb, itemsize)) return;
  int64_t blocks = (n + kMmaRows - 1) / kMmaRows;
  if (blocks > sms) blocks = sms;
  const int grid = int(blocks < 1 ? 1 : blocks);
  *p = Plan{kLanesMma, kb, kMmaRows, grid, grid, 0};
}

// The tile mode's plan: a few blocks an SM where they fit, at most one per
// tile; p->mode is -1 where not one row fits beside the lanes' W and
// partial.
void tile_plan(int64_t n, int64_t d, int kb, int itemsize, int sms,
               Plan* p) {
  p->mode = -1;
  const int rows = choose_tile_rows(d, kb, itemsize);
  if (rows < 1) return;
  int64_t per_sm =
      kSmemSM / (Layout(d, kb, rows, itemsize).total + kSmemReserved);
  per_sm = per_sm < 1 ? 1 : (per_sm > 4 ? 4 : per_sm);
  int64_t blocks = (n + rows - 1) / rows;
  if (blocks > sms * per_sm) blocks = sms * per_sm;
  const int grid = int(blocks < 1 ? 1 : blocks);
  *p = Plan{kLanesTile, kb, rows, grid, grid, 0};
}

// The share of its waves that `blocks` blocks fill, `slots` resident at
// once.
double wave_fill(int64_t blocks, int64_t slots) {
  return double(blocks) / double((blocks + slots - 1) / slots * slots);
}

// The smallest count c in [lo, hi] for which per * c blocks fill 90% of
// their waves, else the one that fills the most.
int64_t fill_waves(int64_t per, int64_t lo, int64_t hi, int64_t slots) {
  int64_t best = lo;
  for (int64_t c = lo; c <= hi; ++c) {
    const double f = wave_fill(per * c, slots);
    if (f >= 0.9) return c;
    if (f > wave_fill(per * best, slots)) best = c;
  }
  return best;
}

// The two-pass mode's plan (every width): rows = pass 1's D splits, the
// fewest whose (row tile, split) blocks fill the card's waves (two blocks
// an SM), each split at least kTPMinSplitStages stages; grid = the
// middle's blocks (one loss partial each); partials = pass 2's row
// groups, the fewest from kTPWaves waves of (256 columns, row group)
// blocks that fill theirs, at most one a stage of rows and
// kTPPartialBytes of gradient partials.
void two_pass_plan(int64_t n, int64_t d, int kb, int itemsize, int sms,
                   Plan* p) {
  const int64_t slots = int64_t(sms) * kTP1MinBlocks;
  const int64_t tiles = (n + kTP1Rows - 1) / kTP1Rows;
  const int64_t stages = (d + tp_step(itemsize) - 1) / tp_step(itemsize);
  int64_t most = stages / kTPMinSplitStages;
  most = most < 1 ? 1 : (most > kTPMaxSplits ? kTPMaxSplits : most);
  int64_t splits = tiles < 1 ? 1 : fill_waves(tiles, 1, most, slots);
  splits = (d + tp_split_cols(d, splits, itemsize) - 1) /
           tp_split_cols(d, splits, itemsize);
  const int64_t ms = kb <= 8 ? 8 : 16;
  int64_t middle = (n * ms + kTPThreads - 1) / kTPThreads;
  if (middle > int64_t(sms) * kTPMiddlePerSM)
    middle = int64_t(sms) * kTPMiddlePerSM;
  const int64_t slots2 = int64_t(sms) * kTP2MinBlocks;
  const int64_t cols = (d + kTP2Cols - 1) / kTP2Cols;
  const int64_t lo = (slots2 * kTPWaves + cols - 1) / cols;
  int64_t groups = fill_waves(cols, lo, 2 * lo, slots2);
  const int64_t most_rows = (n + tp_rows(itemsize) - 1) / tp_rows(itemsize);
  const int64_t most_bytes = kTPPartialBytes / (4 * d * kb);
  if (groups > most_rows) groups = most_rows;
  if (groups > most_bytes) groups = most_bytes;
  if (groups > 65535) groups = 65535;
  if (groups < 1) groups = 1;
  // the groups that hold rows
  const int64_t per_group = tp_rows_per_group(n, groups, itemsize);
  if (per_group > 0) groups = (n + per_group - 1) / per_group;
  *p = Plan{kLanesTwoPass, kb, int(splits), int(middle < 1 ? 1 : middle),
            int(groups), 0};
}

void write_plan(const Plan& p, int* plan) {
  plan[0] = p.mode;
  plan[1] = p.kb;
  plan[2] = p.rows;
  plan[3] = p.grid;
  plan[4] = p.partials;
  plan[5] = p.cluster;
}

}  // namespace

extern "C" {

// Launch plan for k lanes over X (n, d) with `itemsize`-byte elements on
// the current device, of `sms` SMs (checked against the device), written
// to plan[0..5] = {mode, kb, rows, grid, partials, cluster} (see Plan):
// below cluster_from the tensor-core mode where mma_takes, else the tile
// mode; from there the cluster mode while a cluster that the device
// schedules takes the width (cluster_plan: up to most_blocks), and the
// two-pass mode past it.  Returns cudaErrorInvalidValue, and sets
// nothing, for arguments no mode takes (k outside 1..kMaxLanes) or an
// `sms` that is not the device's, and the CUDA error of a device query
// if it fails.
int lanes_plan(int64_t n, int64_t d, int k, int itemsize, int sms,
               int* plan) {
  const int kb = bucket_of(k);
  if (kb == 0) return int(cudaErrorInvalidValue);
  if (const cudaError_t err = check_plan_args(n, d, itemsize, sms);
      err != cudaSuccess)
    return int(err);
  Plan p{};
  p.mode = -1;
  if (d < cluster_from(kb, itemsize)) {
    if (mma_takes(d, kb, itemsize))
      mma_plan(n, d, kb, itemsize, sms, &p);
    else
      tile_plan(n, d, kb, itemsize, sms, &p);
  } else if (const cudaError_t err = cluster_plan(n, d, kb, itemsize, &p);
             err != cudaSuccess) {
    return int(err);
  }
  if (p.mode == -1) two_pass_plan(n, d, kb, itemsize, sms, &p);
  write_plan(p, plan);
  return 0;
}

// The plan of one mode, chosen by the caller, for k lanes over X (n, d),
// written to plan[0..5] as lanes_plan writes its own: `mode` is a mode
// code of lanes_mode_name; the cluster mode takes clusters of `cluster`
// blocks (the other modes ignore it), the tensor-core mode any width its
// block holds.  For timing a mode at widths its plan does not give it
// (chip_smoke.py --ab lanes:); the kernel checks a forced plan as any
// other.  Returns cudaErrorInvalidValue, and sets nothing, where the mode
// cannot take X of width d (or the card keeps no such cluster resident),
// and the CUDA error of a device query if it fails.
int lanes_mode_plan(int64_t n, int64_t d, int k, int itemsize, int sms,
                    int mode, int cluster, int* plan) {
  const int kb = bucket_of(k);
  if (kb == 0) return int(cudaErrorInvalidValue);
  if (const cudaError_t err = check_plan_args(n, d, itemsize, sms);
      err != cudaSuccess)
    return int(err);
  Plan p{};
  p.mode = -1;
  if (mode == kLanesTile) {
    tile_plan(n, d, kb, itemsize, sms, &p);
  } else if (mode == kLanesMma) {
    mma_plan(n, d, kb, itemsize, sms, &p);
  } else if (mode == kLanesTwoPass) {
    two_pass_plan(n, d, kb, itemsize, sms, &p);
  } else if (mode == kLanesCluster) {
    bool size_ok = false;
    for (int c : kClusterSizes) size_ok = size_ok || c == cluster;
    if (size_ok)
      if (const cudaError_t err =
              cluster_plan_of(n, d, kb, itemsize, cluster, &p);
          err != cudaSuccess)
        return int(err);
  }
  if (p.mode != mode) return int(cudaErrorInvalidValue);
  write_plan(p, plan);
  return 0;
}

// The name of a mode of lanes_plan, or NULL past the last.
const char* lanes_mode_name(int mode) {
  switch (mode) {
    case kLanesTile:
      return "lanes_tile";
    case kLanesTwoPass:
      return "lanes_two_pass";
    case kLanesMma:
      return "lanes_mma";
    case kLanesCluster:
      return "lanes_cluster";
    default:
      return nullptr;
  }
}

// The most lanes one launch takes.
int lanes_max_lanes() { return kMaxLanes; }

// The widest X (in columns) that lanes_mma's block holds for k lanes
// (whether or not the plan gives it that width: mma_faster); 0 for k
// outside 1..kMaxLanes.
int64_t lanes_mma_max_width(int k, int itemsize) {
  const int kb = bucket_of(k);
  return kb == 0 ? 0 : mma_max_width(kb, itemsize);
}

// The narrowest X (in columns) that the plan gives to the cluster mode
// for k lanes (cluster_from); 0 for k outside 1..kMaxLanes.
int64_t lanes_cluster_min_width(int k, int itemsize) {
  const int kb = bucket_of(k);
  return kb == 0 ? 0 : cluster_from(kb, itemsize);
}

// The widest X (in columns) read once for k lanes on the current device:
// the reach of the cluster mode that the plan gives (cluster_plan, its
// clusters up to most_blocks; where it gives none, lanes_mma's or the
// tile's last width).  Wider X takes the two-pass mode.  Returns 0 for k
// outside 1..kMaxLanes, and minus the CUDA error code if a query fails.
int64_t lanes_max_width(int k, int itemsize) {
  const int kb = bucket_of(k);
  if (kb == 0) return 0;
  if (itemsize != 4 && itemsize != 2) return -int64_t(cudaErrorInvalidValue);
  const int64_t from = cluster_from(kb, itemsize);
  cudaError_t err = cudaSuccess;
  const int64_t reach = widest(
      int64_t(kClusterMaxSize) * kMmaWarps * 16 * kMmaMaxTiles,
      [&](int64_t d) {
        if (d < from || err != cudaSuccess) return true;
        Plan p{};
        err = cluster_plan(1, d, kb, itemsize, &p);
        return p.mode == kLanesCluster;
      });
  return err != cudaSuccess ? -int64_t(err) : reach;
}

// Launch the plan's kernels and the final sums on `stream` for the k
// rows of W (k, d).  `partial_loss` holds plan[3] * k floats,
// `partial_grad` plan[4] * k * d floats and `mult` plan[2] * n * (8, or
// 24 past 8 lanes) floats (two-pass mode only, its dots and multipliers;
// it may be NULL otherwise) of scratch; `loss` gets
// k floats and `grad` k * d.  Returns the CUDA error code of the
// launches (0 on success): a cluster launch that the card refuses
// returns its error, and nothing is launched in its place.  Synchronises
// nothing.
int margin_lanes_loss_grad(const void* X, int x_type, const void* y,
                           const void* mask, const void* W, int64_t n,
                           int64_t d, int loss_kind, int k, const int* plan,
                           void* partial_loss, void* partial_grad,
                           void* mult, void* loss, void* grad,
                           void* stream) {
  const Plan p{plan[0], plan[1], plan[2], plan[3], plan[4], plan[5]};
  const int itemsize = x_type == kBF16 ? 2 : 4;
  const bool ok =
      n >= 0 && d >= 1 && k >= 1 && bucket_of(k) == p.kb && p.grid >= 1 &&
      p.partials >= 1 && loss_kind >= kLogistic && loss_kind <= kHinge &&
      ((p.mode == kLanesTile && p.rows >= 1 && p.partials == p.grid) ||
       (p.mode == kLanesMma && p.rows == kMmaRows && p.partials == p.grid &&
        mma_fits(d, p.kb, itemsize)) ||
       (p.mode == kLanesTwoPass && p.rows >= 1 && p.rows <= 65535 &&
        p.partials <= 65535 && (mult != nullptr || n == 0)) ||
       (p.mode == kLanesCluster &&
        (p.cluster == 2 || p.cluster == 4 || p.cluster == 8 ||
         p.cluster == 16) &&
        p.grid == p.partials * p.cluster &&
        p.rows == lanes_cluster_stages(d, p.kb, p.cluster, itemsize)));
  if (!ok) return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* yf = static_cast<const float*>(y);
  const float* mf = static_cast<const float*>(mask);
  const float* wf = static_cast<const float*>(W);
  float* pl = static_cast<float*>(partial_loss);
  float* pg = static_cast<float*>(partial_grad);
  float* mu = static_cast<float*>(mult);
  cudaError_t err;
  if (x_type != kF32 && x_type != kBF16)
    err = cudaErrorInvalidValue;
  else if (p.mode == kLanesCluster)
    err = x_type == kF32
              ? launch_cluster<float>(p, X, yf, mf, wf, n, d, k, loss_kind,
                                      pl, pg, s)
              : launch_cluster<__nv_bfloat16>(p, X, yf, mf, wf, n, d, k,
                                              loss_kind, pl, pg, s);
  else if (p.mode == kLanesTwoPass)
    err = x_type == kF32
              ? launch_two_pass_for<float>(p, loss_kind, X, yf, mf, wf, n, d,
                                           k, pl, pg, mu, s)
              : launch_two_pass_for<__nv_bfloat16>(p, loss_kind, X, yf, mf,
                                                   wf, n, d, k, pl, pg, mu,
                                                   s);
  else if (x_type == kF32)
    err = launch_type<float>(loss_kind, p, X, yf, mf, wf, n, d, k, pl, pg,
                             s);
  else
    err = launch_type<__nv_bfloat16>(loss_kind, p, X, yf, mf, wf, n, d, k,
                                     pl, pg, s);
  if (err != cudaSuccess) return int(err);
  // a loss partial a block (of the middle, in the two-pass mode), but a
  // cluster's in the cluster mode
  const int nloss = p.mode == kLanesCluster ? p.partials : p.grid;
  const int64_t kd = int64_t(k) * d;
  const int threads = 256;
  const int blocks = int((kd + k + threads - 1) / threads);
  lanes_reduce<<<blocks, threads, 0, s>>>(pl, nloss, pg, p.partials, kd, k,
                                          static_cast<float*>(loss),
                                          static_cast<float*>(grad));
  return int(cudaGetLastError());
}

const char* lanes_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
