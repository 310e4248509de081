// Fused multinomial softmax loss and gradient for Hopper (sm_90a).
//
// Replaces the TPU kernel spark_agd_tpu/ops/pallas_kernels.py:
// fused_softmax_loss_grad (body _softmax_kernel).  For X (N, D), integral
// labels y (as f32), row mask m and weights W (D, K) it returns
//
//     loss = sum_i m_i * (lse_i - z_i[y_i]),   z_i = x_i . W
//     grad = sum_i x_i^T (softmax(z_i) - onehot(y_i)) m_i     (D, K)
//
// with lse_i = max_k z_ik + log(sum_k exp(z_ik - max_k z_ik)), in f32.
//
// What bounds it on this card: reading X once.  At the main path's shape
// (8.1M x 785 f32, K = 10) that is 25.43 GB / 3.35 TB/s = 7.6 ms, while
// the 4*N*D*K f32 flops of the two products take 254 GFLOP / 67 TFLOP/s
// = 3.8 ms on the CUDA cores: bytes bind.  Two library products
// (X @ W, then X^T @ resid) read X twice; this kernel keeps each row tile
// in shared memory between them, so X crosses the memory bus once per
// evaluation, and loads the next tile (cp.async) while it works on the
// current one.  It stays well above the bound; the hypothesis, not yet
// profiled, is instruction issue: W and the gradient accumulator fill a
// quarter of shared memory, so one block of eight warps runs on each SM,
// likely too few to hide the shared-memory latency of the two products
// (PERF.md has the measurements).
//
// Design.  Stage 1: every block walks a contiguous range of rows in tiles
// of `tile_rows` full rows copied to shared memory (tile_common.cuh), two
// buffers deep.  W is staged once per block, transposed to (KB, D) so
// that lanes on neighbouring columns read neighbouring banks; the
// gradient accumulator is (K, D) in shared memory.  Per tile:
//   - logits: each warp takes groups of R rows, its lanes strided over D,
//     holding R x KB dot partials in registers; a halving shuffle
//     reduction and a per-warp scratch row give lane r row r's logits;
//   - lane r of the warp then finishes row r of the group: row max, lse,
//     the picked logit selected by class == y (never logit * onehot),
//     loss += (lse - picked) * m with compensated adds, and
//     resid = (softmax - onehot) * m into shared memory;
//   - gradient: each thread owns CB columns and accumulates
//     x[r, d] * resid[r, k] for all classes in registers over the tile,
//     reading the tile again from shared memory, never from device
//     memory, then adds them to its own columns of the accumulator.
// Each block writes its partial loss and partial gradient.  Stage 2 sums
// the partials in block order.  No float atomics anywhere: two calls on
// the same inputs give the same bits.  X may be f32 or bf16 (widened to
// f32 in registers); y, m, W and every accumulator are f32.  Ragged rows,
// columns and classes are masked here, so nothing is padded in memory.
//
// Classes: the kernel is compiled for class buckets KB (kBuckets); a call
// with K classes runs the smallest bucket KB >= K, the classes K..KB-1
// masked out.  K is at most kMaxClasses, and less where W, the
// accumulator and one row of X do not fit a block's shared memory
// (softmax_max_classes).

#include "tile_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxClasses = 32;
constexpr int kMaxTileRows = 64;
// 10 is MNIST's class count (the main path); powers of two cover the rest
// of 1-32.
constexpr int kBuckets[] = {1, 2, 4, 8, 10, 16, 32};

enum XType { kF32 = 0, kBF16 = 1 };

// The smallest class bucket that holds k classes; 0 when none does.
int bucket_of(int k) {
  for (int b : kBuckets)
    if (k >= 1 && k <= b) return b;
  return 0;
}

// Rows a warp's logit pass holds at once (their logits fill about one
// 32-float group), and columns a thread's gradient pass holds at once
// (about 48 f32 accumulators).
__host__ __device__ constexpr int group_rows(int kb) {
  return 32 / kb < 2 ? 2 : (32 / kb > 8 ? 8 : 32 / kb);
}
__host__ __device__ constexpr int thread_cols(int kb) {
  return 48 / kb < 1 ? 1 : (48 / kb > 4 ? 4 : 48 / kb);
}
// Row stride of the residual tile: a multiple of 4 floats, for 16-byte
// loads.
__host__ __device__ constexpr int resid_stride(int kb) {
  return (kb + 3) / 4 * 4;
}
// A warp's group logits (group_rows x KB partial dots per lane), padded
// to a multiple of 32 for the halving reduction.
__host__ __device__ constexpr int group_width(int kb) {
  return (group_rows(kb) * kb + 31) / 32 * 32;
}

// Shared-memory layout of one block: the residual tile (tile_rows x
// resid_stride floats) first, so that it is 16-byte aligned; one loss
// slot per warp; one group's logits per warp; W transposed (KB x D); the
// gradient accumulator (K x D); then two X tile buffers (the next tile
// loads while the block works on the current one), each 16-byte aligned
// with 16 bytes of slack so that its byte offset modulo 16 can match the
// tile's address in device memory.
__host__ __device__ inline int64_t x_tile_offset(int64_t d, int k, int kb,
                                                 int tile_rows) {
  return round_up(
      4 * (int64_t(tile_rows) * resid_stride(kb) + kWarps +
           kWarps * group_width(kb) + kb * d + k * d),
      16);
}

__host__ __device__ inline int64_t tile_buffer_bytes(int64_t d,
                                                     int tile_rows,
                                                     int itemsize) {
  return round_up(int64_t(tile_rows) * d * itemsize + kTileSlack, 16);
}

__host__ __device__ inline int64_t smem_bytes(int64_t d, int k, int kb,
                                              int tile_rows, int itemsize) {
  return x_tile_offset(d, k, kb, tile_rows) +
         2 * tile_buffer_bytes(d, tile_rows, itemsize);
}

// Most rows (at most kMaxTileRows) whose block fits in `budget` bytes.
int fit_rows(int64_t d, int k, int kb, int itemsize, int64_t budget) {
  for (int rows = kMaxTileRows; rows >= 1; --rows)
    if (smem_bytes(d, k, kb, rows, itemsize) <= budget) return rows;
  return 0;
}

// Rows of X one block keeps in shared memory: a multiple of one logit
// pass of all warps (kWarps * R rows), small enough for two blocks an SM
// where that fits, else for one; when not even one pass fits, whole row
// groups (a multiple of R), else any rows; 0 when not even one row fits.
int choose_tile_rows(int64_t d, int k, int itemsize) {
  const int kb = bucket_of(k);
  if (kb == 0) return 0;
  const int r = group_rows(kb);
  const int unit = kWarps * r;
  const int64_t budgets[] = {kSmemSM / 2 - kSmemReserved, kSmemBlock};
  for (int64_t budget : budgets) {
    const int rows = fit_rows(d, k, kb, itemsize, budget);
    if (rows >= unit) return rows - rows % unit;
  }
  const int rows = fit_rows(d, k, kb, itemsize, kSmemBlock);
  return rows >= r ? rows - rows % r : rows;
}

// Sums v[0..N) over the warp by recursive halving: at lane offset O each
// lane keeps one half of its entries and adds its partner's copy of that
// half, N/2 + N/4 + ... + N/32 shuffles in all instead of 5N.  Afterwards
// lane l holds the sums of entries l*(N/32) .. l*(N/32) + N/32 - 1 in
// v[0..N/32).  The order of the sums is fixed.
template <int N, int O>
__device__ __forceinline__ void warp_sum_halving(float* v, int lane) {
  if constexpr (O > 0) {
    constexpr int H = N / 2;
    const bool upper = (lane & O) != 0;
#pragma unroll
    for (int i = 0; i < H; ++i) {
      const float send = upper ? v[i] : v[H + i];
      const float keep = upper ? v[H + i] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, O);
    }
    warp_sum_halving<H, O / 2>(v, lane);
  }
}

template <typename T, int KB>
__global__ void __launch_bounds__(kThreads, 1)
    softmax_partials(const T* __restrict__ X, const float* __restrict__ y,
                     const float* __restrict__ mask,
                     const float* __restrict__ W, int64_t n, int d, int k,
                     int tile_rows, float* __restrict__ partial_loss,
                     float* __restrict__ partial_grad) {
  constexpr int R = group_rows(KB);
  constexpr int CB = thread_cols(KB);
  constexpr int RS = resid_stride(KB);
  constexpr int V = group_width(KB);
  constexpr int P = V / 32;
  extern __shared__ __align__(16) unsigned char smem[];
  float* resid_s = reinterpret_cast<float*>(smem);  // [tile_rows][RS]
  float* warp_loss_s = resid_s + int64_t(tile_rows) * RS;
  float* group_s = warp_loss_s + kWarps;  // [kWarps][V]
  float* wt_s = group_s + kWarps * V;     // [KB][d]
  float* g_s = wt_s + KB * d;             // [k][d]
  unsigned char* x_buf0 = smem + x_tile_offset(d, k, KB, tile_rows);
  const int64_t x_buf_bytes =
      tile_buffer_bytes(d, tile_rows, int(sizeof(T)));

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int64_t nblocks = gridDim.x;
  const int64_t rows_per_block = (n + nblocks - 1) / nblocks;
  const int64_t r_begin = min64(n, int64_t(blockIdx.x) * rows_per_block);
  const int64_t r_end = min64(n, r_begin + rows_per_block);
  // start loading tile `tile0` into buffer `b`
  auto load = [&](int64_t tile0, int b) {
    const int rows = int(min64(tile_rows, r_end - tile0));
    copy_tile_async<kThreads>(X + tile0 * d,
                              int64_t(rows) * d * int64_t(sizeof(T)),
                              x_buf0 + b * x_buf_bytes, X, X + n * d);
  };
  if (r_begin < r_end) load(r_begin, 0);
  cp_async_commit();

  for (int64_t i = tid; i < KB * d; i += kThreads) {
    const int64_t kk = i / d, c = i % d;
    wt_s[i] = kk < k ? W[c * k + kk] : 0.f;
  }
  for (int64_t i = tid; i < k * d; i += kThreads) g_s[i] = 0.f;
  Kahan loss_acc;

  int buf = 0;
  for (int64_t tile0 = r_begin; tile0 < r_end;
       tile0 += tile_rows, buf ^= 1) {
    const int rows = int(min64(tile_rows, r_end - tile0));
    // the next tile loads while this one is worked on; a group is
    // committed every time, empty at the end, so that waiting for all but
    // the newest group means this tile has landed
    if (tile0 + tile_rows < r_end) load(tile0 + tile_rows, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const T* xs = reinterpret_cast<const T*>(
        x_buf0 + buf * x_buf_bytes +
        (reinterpret_cast<uintptr_t>(X + tile0 * d) & 15));

    // logits and the softmax middle: warp `warp` takes row groups
    // warp, warp + kWarps, ...; rows past the tile's end read its last
    // row and are discarded
    const int groups = (rows + R - 1) / R;
    float* group = group_s + warp * V;
    for (int g = warp; g < groups; g += kWarps) {
      const int r0 = g * R;
      // lane r's label and mask, loaded ahead of the logit loop
      const bool owner = lane < R && r0 + lane < rows;
      const int64_t gr = tile0 + r0 + lane;
      const float yv = owner ? y[gr] : 0.f;
      const float m = owner ? mask[gr] : 0.f;
      const T* xr[R];
#pragma unroll
      for (int r = 0; r < R; ++r)
        xr[r] = xs + (r0 + r < rows ? r0 + r : rows - 1) * d;
      float acc[V];  // acc[r * KB + kk]: row r0 + r, class kk
#pragma unroll
      for (int i = 0; i < V; ++i) acc[i] = 0.f;
#pragma unroll 4
      for (int c = lane; c < d; c += 32) {
        float wv[KB];
#pragma unroll
        for (int kk = 0; kk < KB; ++kk) wv[kk] = wt_s[kk * d + c];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float xv = to_f32(xr[r][c]);
#pragma unroll
          for (int kk = 0; kk < KB; ++kk)
            acc[r * KB + kk] = fmaf(xv, wv[kk], acc[r * KB + kk]);
        }
      }
      warp_sum_halving<V, 16>(acc, lane);
#pragma unroll
      for (int j = 0; j < P; ++j) group[lane * P + j] = acc[j];
      __syncwarp();

      // lane r finishes row r0 + r of the group
      if (owner) {
        const float* z = group + lane * KB;
        float zmax = -INFINITY;
#pragma unroll
        for (int kk = 0; kk < KB; ++kk)
          if (kk < k) zmax = fmaxf(zmax, z[kk]);
        float ez[KB];
        float sez = 0.f;
#pragma unroll
        for (int kk = 0; kk < KB; ++kk) {
          ez[kk] = kk < k ? expf(z[kk] - zmax) : 0.f;
          sez += ez[kk];
        }
        const float lse = zmax + logf(sez);
        // select-then-sum: the picked logit is the one whose class index
        // equals the label (pallas_kernels.py:391-395)
        float picked = 0.f;
#pragma unroll
        for (int kk = 0; kk < KB; ++kk)
          if (kk < k && float(kk) == yv) picked += z[kk];
        loss_acc.add((lse - picked) * m);
        float* res = resid_s + (r0 + lane) * RS;
#pragma unroll
        for (int kk = 0; kk < KB; ++kk)
          res[kk] = kk < k
              ? (ez[kk] / sez - (float(kk) == yv ? 1.f : 0.f)) * m
              : 0.f;
#pragma unroll
        for (int kk = KB; kk < RS; ++kk) res[kk] = 0.f;
      }
      __syncwarp();
    }
    __syncthreads();

    // gradient off the same tile: thread tid owns columns
    // c0 + i * kThreads, i < CB, of each chunk c0
    for (int c0 = tid; c0 < d; c0 += CB * kThreads) {
      int cl[CB];  // column to load (clamped), the result discarded
#pragma unroll
      for (int i = 0; i < CB; ++i) {
        const int c = c0 + i * kThreads;
        cl[i] = c < d ? c : d - 1;
      }
      float acc[CB][KB];
#pragma unroll
      for (int i = 0; i < CB; ++i)
#pragma unroll
        for (int kk = 0; kk < KB; ++kk) acc[i][kk] = 0.f;
#pragma unroll 4
      for (int r = 0; r < rows; ++r) {
        float rv[RS];
        const float4* rp = reinterpret_cast<const float4*>(resid_s + r * RS);
#pragma unroll
        for (int q = 0; q < RS / 4; ++q) {
          const float4 v = rp[q];
          rv[4 * q] = v.x;
          rv[4 * q + 1] = v.y;
          rv[4 * q + 2] = v.z;
          rv[4 * q + 3] = v.w;
        }
        const T* xrow = xs + r * d;
#pragma unroll
        for (int i = 0; i < CB; ++i) {
          const float xv = to_f32(xrow[cl[i]]);
#pragma unroll
          for (int kk = 0; kk < KB; ++kk)
            acc[i][kk] = fmaf(xv, rv[kk], acc[i][kk]);
        }
      }
#pragma unroll
      for (int i = 0; i < CB; ++i) {
        const int c = c0 + i * kThreads;
        if (c >= d) continue;
#pragma unroll
        for (int kk = 0; kk < KB; ++kk)
          if (kk < k) g_s[kk * d + c] += acc[i][kk];
      }
    }
    __syncthreads();
  }

  // block loss: the threads' sums in a fixed order
  float ls = loss_acc.s;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    ls += __shfl_xor_sync(0xffffffffu, ls, off);
  if (lane == 0) warp_loss_s[warp] = ls;
  float* pg = partial_grad + int64_t(blockIdx.x) * k * d;
  for (int64_t i = tid; i < k * d; i += kThreads) pg[i] = g_s[i];
  __syncthreads();
  if (tid == 0) {
    Kahan s;
    for (int i = 0; i < kWarps; ++i) s.add(warp_loss_s[i]);
    partial_loss[blockIdx.x] = s.s;
  }
}

// Stage 2: fixed-order sums of the per-block partials, one thread per
// gradient entry (partials are (K, D); the gradient is (D, K)); thread 0
// also sums the loss.
__global__ void reduce_partials(const float* __restrict__ partial_loss,
                                const float* __restrict__ partial_grad,
                                int nblocks, int64_t d, int k,
                                float* __restrict__ loss,
                                float* __restrict__ grad) {
  const int64_t e = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t size = d * k;
  if (e < size) {
    Kahan s;
    for (int b = 0; b < nblocks; ++b)
      s.add(partial_grad[int64_t(b) * size + e]);
    const int64_t kk = e / d, c = e % d;
    grad[c * k + kk] = s.s;
  }
  if (e == 0) {
    Kahan s;
    for (int b = 0; b < nblocks; ++b) s.add(partial_loss[b]);
    loss[0] = s.s;
  }
}

template <typename T, int KB>
cudaError_t launch_partials(const void* X, const float* y, const float* mask,
                            const float* W, int64_t n, int64_t d, int k,
                            int tile_rows, int grid, float* partial_loss,
                            float* partial_grad, cudaStream_t stream) {
  const int64_t smem = smem_bytes(d, k, KB, tile_rows, int(sizeof(T)));
  auto kern = softmax_partials<T, KB>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  kern<<<grid, kThreads, size_t(smem), stream>>>(
      static_cast<const T*>(X), y, mask, W, n, int(d), k, tile_rows,
      partial_loss, partial_grad);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_for_bucket(int kb, const void* X, const float* y,
                              const float* mask, const float* W, int64_t n,
                              int64_t d, int k, int tile_rows, int grid,
                              float* pl, float* pg, cudaStream_t s) {
#define SOFTMAX_BUCKET(B)                                              \
  case B:                                                              \
    return launch_partials<T, B>(X, y, mask, W, n, d, k, tile_rows, grid, \
                                 pl, pg, s);
  switch (kb) {
    SOFTMAX_BUCKET(1)
    SOFTMAX_BUCKET(2)
    SOFTMAX_BUCKET(4)
    SOFTMAX_BUCKET(8)
    SOFTMAX_BUCKET(10)
    SOFTMAX_BUCKET(16)
    SOFTMAX_BUCKET(32)
    default:
      return cudaErrorInvalidValue;
  }
#undef SOFTMAX_BUCKET
}

}  // namespace

extern "C" {

// Launch shape for X (n, d) with `itemsize`-byte elements and k classes on
// a card of `sms` SMs: the tile rows and the grid (a few blocks an SM, as
// many as fit, at most one per tile).  Returns cudaErrorInvalidValue, and
// sets nothing, when the kernel cannot take this width and class count.
int softmax_plan(int64_t n, int64_t d, int k, int itemsize, int sms,
                 int* tile_rows, int* grid) {
  if (n < 0 || d < 1 || sms < 1 || k < 1 || k > kMaxClasses ||
      (itemsize != 4 && itemsize != 2))
    return int(cudaErrorInvalidValue);
  const int rows = choose_tile_rows(d, k, itemsize);
  if (rows < 1) return int(cudaErrorInvalidValue);
  int64_t per_sm = kSmemSM / (smem_bytes(d, k, bucket_of(k), rows, itemsize) +
                              kSmemReserved);
  per_sm = per_sm < 1 ? 1 : (per_sm > 4 ? 4 : per_sm);
  int64_t blocks = (n + rows - 1) / rows;
  if (blocks > sms * per_sm) blocks = sms * per_sm;
  *tile_rows = rows;
  *grid = int(blocks < 1 ? 1 : blocks);
  return 0;
}

// The most classes the kernel takes for X of width d (0 when not even
// one class fits).
int softmax_max_classes(int64_t d, int itemsize) {
  if (d < 1 || (itemsize != 4 && itemsize != 2)) return 0;
  for (int k = kMaxClasses; k >= 1; --k)
    if (choose_tile_rows(d, k, itemsize) >= 1) return k;
  return 0;
}

// Launch both stages on `stream`.  `partial_loss` holds `grid` floats and
// `partial_grad` grid * k * d floats of scratch.  Returns the CUDA error
// code of the launches (0 on success); synchronises nothing.
int softmax_loss_grad(const void* X, int x_type, const void* y,
                      const void* mask, const void* W, int64_t n, int64_t d,
                      int k, int tile_rows, int grid, void* partial_loss,
                      void* partial_grad, void* loss, void* grad,
                      void* stream) {
  const int kb = bucket_of(k);
  if (n < 0 || d < 1 || d > kSmemBlock || kb == 0 || tile_rows < 1 ||
      grid < 1)
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* yf = static_cast<const float*>(y);
  const float* mf = static_cast<const float*>(mask);
  const float* wf = static_cast<const float*>(W);
  float* pl = static_cast<float*>(partial_loss);
  float* pg = static_cast<float*>(partial_grad);
  cudaError_t err;
  if (x_type == kF32)
    err = launch_for_bucket<float>(kb, X, yf, mf, wf, n, d, k, tile_rows,
                                   grid, pl, pg, s);
  else if (x_type == kBF16)
    err = launch_for_bucket<__nv_bfloat16>(kb, X, yf, mf, wf, n, d, k,
                                           tile_rows, grid, pl, pg, s);
  else
    err = cudaErrorInvalidValue;
  if (err != cudaSuccess) return int(err);
  const int threads = 256;
  const int blocks = int((d * k + threads - 1) / threads);
  reduce_partials<<<blocks, threads, 0, s>>>(pl, pg, grid, d, k,
                                             static_cast<float*>(loss),
                                             static_cast<float*>(grad));
  return int(cudaGetLastError());
}

const char* softmax_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
