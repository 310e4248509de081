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
// What bounds it on this card: reading X once from device memory.  The
// two products do 4*N*D flops on N*D*itemsize bytes, one flop per byte
// in f32, far below the ~20 flop/byte where the H100's f32 rate would
// take over.  Two library products (X @ w, then X^T @ mult) read X
// twice; this kernel keeps each row tile in shared memory between the
// two products, so X crosses the memory bus once per evaluation.
//
// Design.  Stage 1: every block walks a contiguous range of rows in
// tiles of `tile_rows` full rows (a contiguous chunk of X, copied with
// 16-byte loads).  One warp per row forms the dot with a shuffle
// reduction and applies the loss middle in f32; then every thread sums
// mult * x over the tile for the columns it owns, reading the tile again
// from shared memory, never from device memory.  Each block writes its
// own partial loss and partial gradient.  Stage 2 sums the partials in
// block order.  No float atomics anywhere: two calls on the same inputs
// give the same bits.  X may be f32 or bf16 (widened to f32 in
// registers); y, m, w and every accumulator are f32.  Ragged row and
// column edges are masked here, so X needs no padding.

#include "tile_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

enum LossKind { kLogistic = 0, kLeastSquares = 1, kHinge = 2 };
enum XType { kF32 = 0, kBF16 = 1 };

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

// The per-row middle, the same formulas as losses.py:152-179.
template <int L>
__device__ __forceinline__ void loss_middle(float dot, float y, float* per,
                                            float* mult) {
  if (L == kLogistic) {
    // softplus(m) - (1 - y) m with m = -dot, in the exact form
    // log1p(exp(-|m|)) + max(m, 0) (no threshold switch)
    float m = -dot;
    float sp = log1pf(expf(-fabsf(m))) + fmaxf(m, 0.f);
    *per = sp - (1.f - y) * m;
    *mult = 1.f / (1.f + expf(-dot)) - y;
  } else if (L == kLeastSquares) {
    float diff = dot - y;
    *per = diff * diff;
    *mult = 2.f * diff;
  } else {
    float s = 2.f * y - 1.f;
    float margin = 1.f - s * dot;
    bool active = margin > 0.f;
    *per = active ? margin : 0.f;
    *mult = active ? -s : 0.f;
  }
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

// Stage 2: fixed-order sums of the per-block partials, one thread per
// gradient column; thread 0 also sums the loss.
__global__ void reduce_partials(const float* __restrict__ partial_loss,
                                const float* __restrict__ partial_grad,
                                int nblocks, int64_t d,
                                float* __restrict__ loss,
                                float* __restrict__ grad) {
  const int64_t c = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (c < d) {
    Kahan k;
    for (int b = 0; b < nblocks; ++b) k.add(partial_grad[int64_t(b) * d + c]);
    grad[c] = k.s;
  }
  if (c == 0) {
    Kahan k;
    for (int b = 0; b < nblocks; ++b) k.add(partial_loss[b]);
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

template <typename T>
cudaError_t launch_for_loss(int loss_kind, const void* X, const float* y,
                            const float* mask, const float* w, int64_t n,
                            int64_t d, int tile_rows, int grid,
                            float* partial_loss, float* partial_grad,
                            cudaStream_t stream) {
  switch (loss_kind) {
    case kLogistic:
      return launch_partials<T, kLogistic>(X, y, mask, w, n, d, tile_rows,
                                           grid, partial_loss, partial_grad,
                                           stream);
    case kLeastSquares:
      return launch_partials<T, kLeastSquares>(X, y, mask, w, n, d,
                                               tile_rows, grid, partial_loss,
                                               partial_grad, stream);
    case kHinge:
      return launch_partials<T, kHinge>(X, y, mask, w, n, d, tile_rows, grid,
                                        partial_loss, partial_grad, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Launch shape for X (n, d) with `itemsize`-byte elements on a card of
// `sms` SMs: the tile rows and the grid (a few blocks an SM, as many as
// fit, at most one per tile).  Returns cudaErrorInvalidValue, and sets
// nothing, when not even one row of X fits in shared memory.
int margin_plan(int64_t n, int64_t d, int itemsize, int sms, int* tile_rows,
                int* grid) {
  if (n < 0 || d < 1 || sms < 1 || (itemsize != 4 && itemsize != 2))
    return int(cudaErrorInvalidValue);
  const int rows = choose_tile_rows(d, itemsize);
  if (rows < 1) return int(cudaErrorInvalidValue);
  int64_t per_sm = kSmemSM / (smem_bytes(d, rows, itemsize) + kSmemReserved);
  per_sm = per_sm < 1 ? 1 : (per_sm > 4 ? 4 : per_sm);
  int64_t blocks = (n + rows - 1) / rows;
  if (blocks > sms * per_sm) blocks = sms * per_sm;
  *tile_rows = rows;
  *grid = int(blocks < 1 ? 1 : blocks);
  return 0;
}

// The widest X (in columns) whose rows fit the kernel's tile.
int64_t margin_max_width(int itemsize) {
  int64_t lo = 0, hi = kSmemBlock;  // lo fits (vacuously), hi does not
  while (hi - lo > 1) {
    const int64_t mid = (lo + hi) / 2;
    (choose_tile_rows(mid, itemsize) >= 1 ? lo : hi) = mid;
  }
  return lo;
}

// Launch both stages on `stream`.  `partial_loss` holds `grid` floats and
// `partial_grad` grid * d floats of scratch.  Returns the CUDA error code
// of the launches (0 on success); synchronises nothing.
int margin_loss_grad(const void* X, int x_type, const void* y,
                     const void* mask, const void* w, int64_t n, int64_t d,
                     int loss_kind, int tile_rows, int grid,
                     void* partial_loss, void* partial_grad, void* loss,
                     void* grad, void* stream) {
  if (n < 0 || d < 1 || tile_rows < 1 || grid < 1)
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* yf = static_cast<const float*>(y);
  const float* mf = static_cast<const float*>(mask);
  const float* wf = static_cast<const float*>(w);
  float* pl = static_cast<float*>(partial_loss);
  float* pg = static_cast<float*>(partial_grad);
  cudaError_t err;
  if (x_type == kF32)
    err = launch_for_loss<float>(loss_kind, X, yf, mf, wf, n, d, tile_rows,
                                 grid, pl, pg, s);
  else if (x_type == kBF16)
    err = launch_for_loss<__nv_bfloat16>(loss_kind, X, yf, mf, wf, n, d,
                                         tile_rows, grid, pl, pg, s);
  else
    err = cudaErrorInvalidValue;
  if (err != cudaSuccess) return int(err);
  const int threads = 256;
  const int blocks = int((d + threads - 1) / threads);
  reduce_partials<<<blocks, threads, 0, s>>>(pl, pg, grid, d,
                                             static_cast<float*>(loss),
                                             static_cast<float*>(grad));
  return int(cudaGetLastError());
}

const char* margin_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
