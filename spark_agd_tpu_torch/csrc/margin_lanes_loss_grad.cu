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
// reach of a 16-block cluster, and the two-pass mode past that: each
// hand-over where `--ab lanes:` of chip_smoke.py timed the next mode
// faster (cluster_from).  K is compiled in buckets (1, 2, 4, 8, 16
// lanes; the lanes past K read zero weights and are not written), so one
// launch takes up to kMaxLanes lanes and the wrapper runs more in chunks.
// Every mode writes per-block (cluster mode: per-cluster) partials that
// lanes_reduce sums in block order, with no float atomics, so two calls
// on the same inputs give the same bits.  X may be f32 or bf16 (widened
// to f32 in registers); y, m, W and every accumulator are f32.  Ragged
// rows and columns are masked here, so X needs no padding.
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
// Two-pass mode (past lanes_max_width): pass 1 gives each row a warp
// that reads it from device memory (W from L1/L2) and writes the K
// multipliers to an (N, K) scratch; pass 2 walks column chunks x row
// groups, one column and its KB sums a thread (plain sums over each
// chunk of rows, compensated across chunks), and reads X again, as the
// TPU wrapper's two library products do past its VMEM budget.  This mode
// has no width limit.

#include <atomic>

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

// Two-pass mode, pass 1: a warp per row (rows strided over the grid's
// warps) forms the row's K dots from device memory; lane kk applies lane
// kk's middle, writes m * mult to mult_out[r * k + kk] and adds m * per to
// its loss.  One loss partial a lane per block.
template <typename T, int L, int KB>
__global__ void __launch_bounds__(kThreads)
    lanes_wide_dots(const T* __restrict__ X, const float* __restrict__ y,
                    const float* __restrict__ mask,
                    const float* __restrict__ W, int64_t n, int64_t d, int k,
                    float* __restrict__ mult_out,
                    float* __restrict__ partial_loss) {
  __shared__ float loss_s[kThreads];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  Kahan loss_acc;
  const int64_t warps_total = int64_t(gridDim.x) * kWarps;
  for (int64_t r = int64_t(blockIdx.x) * kWarps + warp; r < n;
       r += warps_total) {
    const T* row = X + r * d;
    float acc[KB];
#pragma unroll
    for (int kk = 0; kk < KB; ++kk) acc[kk] = 0.f;
    for (int64_t c = lane; c < d; c += 32) {
      const float xv = to_f32(row[c]);
#pragma unroll
      for (int kk = 0; kk < KB; ++kk)
        if (kk < k) acc[kk] = fmaf(xv, __ldg(W + int64_t(kk) * d + c), acc[kk]);
    }
    float dot = 0.f;
#pragma unroll
    for (int kk = 0; kk < KB; ++kk) {
      float v = acc[kk];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, off);
      if (kk == lane) dot = v;
    }
    if (lane < k) {
      float per, mult;
      loss_middle<L>(dot, y[r], &per, &mult);
      const float m = mask[r];
      mult_out[r * k + lane] = mult * m;
      loss_acc.add(per * m);
    }
  }
  loss_s[threadIdx.x] = loss_acc.s;
  __syncthreads();
  if (threadIdx.x < k) {
    Kahan sum;
    for (int w = 0; w < kWarps; ++w) sum.add(loss_s[w * 32 + threadIdx.x]);
    partial_loss[int64_t(blockIdx.x) * k + threadIdx.x] = sum.s;
  }
}

// Two-pass mode, pass 2: block (x, y) owns columns [256 x, 256 x + 256),
// one a thread, over row group y; the multipliers come through shared
// memory kWideChunk rows at a time, four rows' loads in flight, summed
// plainly within a chunk and compensated across chunks.  Writes
// partial_grad[(y * k + kk) * d + c].
constexpr int kWideChunk = 256;
constexpr int kWideBlocksPerSM = 8;

template <typename T, int KB>
__global__ void __launch_bounds__(kThreads)
    lanes_wide_grad(const T* __restrict__ X, const float* __restrict__ mult,
                    int64_t n, int64_t d, int k,
                    float* __restrict__ partial_grad) {
  __shared__ __align__(16) float mult_s[kWideChunk * KB];
  const int64_t c = int64_t(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t groups = gridDim.y;
  const int64_t rows_per_group = (n + groups - 1) / groups;
  const int64_t r_begin = min64(n, int64_t(blockIdx.y) * rows_per_group);
  const int64_t r_end = min64(n, r_begin + rows_per_group);
  Kahan sum[KB];
  for (int64_t r0 = r_begin; r0 < r_end; r0 += kWideChunk) {
    const int rows = int(min64(kWideChunk, r_end - r0));
    __syncthreads();  // the last chunk's multipliers are consumed
    for (int i = threadIdx.x; i < rows * KB; i += kThreads) {
      const int kk = i % KB;
      mult_s[i] = kk < k ? mult[(r0 + i / KB) * k + kk] : 0.f;
    }
    __syncthreads();
    if (c < d) {
      float s[KB];
#pragma unroll
      for (int kk = 0; kk < KB; ++kk) s[kk] = 0.f;
      const T* col = X + r0 * d + c;
      int i = 0;
      for (; i + 3 < rows; i += 4) {
        float xv[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) xv[u] = to_f32(col[int64_t(i + u) * d]);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          float mv[KB];
          load_lanes<KB>(mult_s + (i + u) * KB, mv);
#pragma unroll
          for (int kk = 0; kk < KB; ++kk) s[kk] = fmaf(mv[kk], xv[u], s[kk]);
        }
      }
      for (; i < rows; ++i) {
        const float xv = to_f32(col[int64_t(i) * d]);
        float mv[KB];
        load_lanes<KB>(mult_s + i * KB, mv);
#pragma unroll
        for (int kk = 0; kk < KB; ++kk) s[kk] = fmaf(mv[kk], xv, s[kk]);
      }
#pragma unroll
      for (int kk = 0; kk < KB; ++kk) sum[kk].add(s[kk]);
    }
  }
  if (c < d) {
#pragma unroll
    for (int kk = 0; kk < KB; ++kk)
      if (kk < k)
        partial_grad[(int64_t(blockIdx.y) * k + kk) * d + c] = sum[kk].s;
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
// mode) or 0 (two-pass mode); the blocks of the (first) launch; the
// gradient partials (the grid, pass 2's row groups, or the clusters); the
// blocks of a cluster (cluster mode, else 0).  One loss partial a block,
// or a cluster.
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
                      float* mult, cudaStream_t stream) {
  if (p.mode == kLanesMma)
    return launch_mma<T, L, (KB <= 8 ? 1 : 2)>(p, X, y, mask, W, n, d, k,
                                               partial_loss, partial_grad,
                                               stream);
  if (p.mode == kLanesTile) {
    const int64_t smem = Layout(d, KB, p.rows, int(sizeof(T))).total;
    auto kern = lanes_tile<T, L, KB>;
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return err;
    kern<<<p.grid, kThreads, size_t(smem), stream>>>(
        X, y, mask, W, n, d, k, p.rows, partial_loss, partial_grad);
    return cudaGetLastError();
  }
  lanes_wide_dots<T, L, KB><<<p.grid, kThreads, 0, stream>>>(
      X, y, mask, W, n, d, k, mult, partial_loss);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid2(unsigned((d + kThreads - 1) / kThreads),
                   unsigned(p.partials));
  lanes_wide_grad<T, KB><<<grid2, kThreads, 0, stream>>>(X, mult, n, d, k,
                                                        partial_grad);
  return cudaGetLastError();
}

template <typename T, int L>
cudaError_t launch_loss(const Plan& p, const T* X, const float* y,
                        const float* mask, const float* W, int64_t n,
                        int64_t d, int k, float* pl, float* pg, float* mu,
                        cudaStream_t s) {
  switch (p.kb) {
    case 1:
      return launch_kb<T, L, 1>(p, X, y, mask, W, n, d, k, pl, pg, mu, s);
    case 2:
      return launch_kb<T, L, 2>(p, X, y, mask, W, n, d, k, pl, pg, mu, s);
    case 4:
      return launch_kb<T, L, 4>(p, X, y, mask, W, n, d, k, pl, pg, mu, s);
    case 8:
      return launch_kb<T, L, 8>(p, X, y, mask, W, n, d, k, pl, pg, mu, s);
    case kMaxLanes:
      return launch_kb<T, L, kMaxLanes>(p, X, y, mask, W, n, d, k, pl, pg,
                                        mu, s);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_type(int loss_kind, const Plan& p, const void* X,
                        const float* y, const float* mask, const float* W,
                        int64_t n, int64_t d, int k, float* pl, float* pg,
                        float* mu, cudaStream_t s) {
  const T* Xt = static_cast<const T*>(X);
  switch (loss_kind) {
    case kLogistic:
      return launch_loss<T, kLogistic>(p, Xt, y, mask, W, n, d, k, pl, pg,
                                       mu, s);
    case kLeastSquares:
      return launch_loss<T, kLeastSquares>(p, Xt, y, mask, W, n, d, k, pl,
                                           pg, mu, s);
    case kHinge:
      return launch_loss<T, kHinge>(p, Xt, y, mask, W, n, d, k, pl, pg, mu,
                                    s);
    default:
      return cudaErrorInvalidValue;
  }
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

// The largest cluster the plan gives a width: 8 blocks for one lane of
// f32 X, where the two-pass mode (whose passes for one lane are light)
// was timed faster than 16 blocks (12,000 columns; PERF.md), else 16.
int most_blocks(int kb, int itemsize) {
  return kb == 1 && itemsize == 4 ? 8 : kClusterMaxSize;
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

// The two-pass mode's plan (every width).
void two_pass_plan(int64_t n, int64_t d, int kb, int sms, Plan* p) {
  int64_t blocks = (n + kWarps - 1) / kWarps;
  if (blocks > int64_t(sms) * kWideBlocksPerSM)
    blocks = int64_t(sms) * kWideBlocksPerSM;
  const int64_t chunks = (d + kThreads - 1) / kThreads;
  int64_t groups = int64_t(sms) * kWideBlocksPerSM / chunks;
  const int64_t most = (n + kWideChunk - 1) / kWideChunk;
  if (groups > most) groups = most;
  *p = Plan{kLanesTwoPass, kb, 0, int(blocks < 1 ? 1 : blocks),
            int(groups < 1 ? 1 : groups), 0};
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
// schedules takes the width (cluster_plan), and the two-pass mode past
// it.  Returns cudaErrorInvalidValue, and sets nothing, for arguments no
// mode takes (k outside 1..kMaxLanes) or an `sms` that is not the
// device's, and the CUDA error of a device query if it fails.
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
  if (p.mode == -1) two_pass_plan(n, d, kb, sms, &p);
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
    two_pass_plan(n, d, kb, sms, &p);
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
// the reach of the cluster mode that the plan gives (cluster_plan).
// Wider X takes the two-pass mode.  Returns 0 for k outside 1..kMaxLanes,
// and minus the CUDA error code if a query fails.
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
// `partial_grad` plan[4] * k * d floats and `mult` n * k floats
// (two-pass mode only; it may be NULL otherwise) of scratch; `loss` gets
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
       (p.mode == kLanesTwoPass && (mult != nullptr || n == 0)) ||
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
  else if (x_type == kF32)
    err = launch_type<float>(loss_kind, p, X, yf, mf, wf, n, d, k, pl, pg,
                             mu, s);
  else
    err = launch_type<__nv_bfloat16>(loss_kind, p, X, yf, mf, wf, n, d, k,
                                     pl, pg, mu, s);
  if (err != cudaSuccess) return int(err);
  // a loss partial a block, but a cluster's in the cluster mode
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
