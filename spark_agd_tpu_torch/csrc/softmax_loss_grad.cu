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
// (8.1M x 785 f32, K = 10) that is 25.43 GB / 3.35 TB/s = 7.6 ms.  Both
// products run on the tensor cores in TF32 passes (three for the
// gradient, four for the logits) with K padded to the 16-class fragment:
// 7 * 2 * N * D * 16 = 1.42 TFLOP, 2.9 ms at the data sheet's 495
// TFLOP/s dense TF32, so bytes bind.  Two library
// products (X @ W, then X^T @ resid) read X twice; this kernel keeps each
// row tile in shared memory between them, so X crosses the memory bus
// once per evaluation, and loads the next tile (cp.async) while it works
// on the current one.  On the card it is no faster than the CUDA-core
// kernel it replaced and well above the byte bound: each product's loop
// is latency-bound, and splitting X costs about as many instructions as
// the FMAs that the tensor cores take over (PERF.md).  The two-pass mode
// (below) moves 2 N D itemsize + 2 N K 4 bytes (X twice, the residuals
// written and read) and does 4 N D K flops on the CUDA cores (67 TFLOP/s
// f32): at CIFAR-100's shape (50,000 x 3,072, K = 100) the flops bind.
//
// Tensor cores at f32 accuracy.  Every product is
// mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 in three passes,
// a_hi b_hi + a_hi b_lo + a_lo b_hi, hi and lo rounded to TF32 to
// nearest, ties away from zero, as cvt.rna.tf32.f32 rounds (split_tf32);
// the dropped lo*lo term is about 2^-22 relative.  A bf16 X is exact in
// TF32: its lo is zero and that pass is skipped.  hi + lo keeps 22 of
// f32's 24 bits.  For X and the residuals that error differs from row to
// row and averages out; W's is the same for every row, and over 8.1M rows
// it put the gradient at up to 0.99 of its f64 tolerance (PERF.md).  So
// the logit product has a fourth pass, x_hi w_lo2, with W split exactly:
// hi, lo its remainder cut to TF32, lo2 what is left (at most 2 bits,
// exact in TF32; split_w).  The tensor cores add a product's terms to C
// with truncation after aligning them to the largest, which against a
// large running C shaves every row's logits the same way; so hi*hi starts
// from zero at each k-step and is added to its sum with a rounded f32
// add, and the small terms run on in a second accumulator (mma3).  Fragments (PTX ISA, m16n8k8 .tf32; lane = 4g + t):
//   A (16 x 8, row): a0 (g, t), a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4)
//   B (8 x 8, col):  b0 (k = t, n = g), b1 (k = t+4, n = g)
//   C (16 x 8):      c0 (g, 2t), c1 (g, 2t+1), c2 (g+8, 2t), c3 (g+8, 2t+1)
//
// Design.  Stage 1: one block of 16 warps an SM walks a contiguous range
// of rows in tiles of at most 16 rows (one m-tile), copied to shared
// memory (tile_common.cuh) two buffers deep, each to its own address
// modulo 16 so that nothing is padded.  D is cut into 8-column steps, and
// warp w owns the steps w, w + 16, ... of both products.  Per tile:
//   - logits Z (rows x classes) = X_tile W: A = X, B = W (classes in n8
//     tiles), contraction over the warp's steps of D; each warp writes its
//     partial logits to shared memory.  W is staged once per block,
//     transposed (classes x D), as (hi, w - hi) pairs when shared
//     memory has room for them and a 16-row tile (one 8-byte load per B
//     element; 0.5 ms faster at the main shape than splitting at each
//     use, PERF.md), else raw and split at each use (wide K);
//   - the middle: one thread per (row, class), KB threads a row: the sum
//     of the warps' partials in warp order, then row max, sum of
//     exponentials and the picked logit (select-then-sum: the logit whose
//     class index equals the label) by xor-shuffles within the row's
//     lanes; loss += (lse - picked) * m with compensated adds;
//     resid = (softmax - onehot) * m into shared memory;
//   - gradient G^T (classes x D) += R^T (classes x rows) X_tile: A = R^T
//     (16 classes an m-tile, split once per tile into registers), B = X
//     (the warp's steps of D as n8 tiles), contraction over the tile's
//     rows in k8 steps; each n-tile's sums are added to the block's
//     (K, D) accumulator in shared memory once per tile.
// Ragged rows, columns and classes are masked where the fragments are
// loaded (zeros), so a short tile, a width that is not a multiple of 8
// and K below its bucket need no padding in memory.  Each block writes
// its partial loss and partial gradient; stage 2 sums the partials in
// block order.  No float atomics anywhere: two calls on the same inputs
// give the same bits.
//
// Classes: the one-read kernel is compiled for class buckets KB in {8,
// 16, 32} (one, two or four n8 tiles); a call with K classes runs the
// smallest bucket KB >= K, the classes K..KB-1 masked out.  It takes at
// most kMaxClasses classes, and fewer where W, the accumulator and one row
// of X do not fit a block's shared memory (choose_plan).
//
// Two-pass mode (everywhere else: K > 32, or a layout past shared memory;
// softmax_plan picks it, as the Pallas wrapper computes through the jnp
// loss past its VMEM budget).  Rows run in chunks of at most
// kTPResidBytes of residuals, (rows x K) f32, so the scratch stays bounded
// (the jnp path holds all N x K logits).  Per chunk:
//   - pass 1 (softmax_tp_logits): a block walks 32-row tiles; for each
//     chunk of KC classes it forms the logits X_tile W[:, chunk] with X
//     and W staged in shared memory 32 columns at a time (CUDA-core FMAs,
//     2 rows x KC/16 classes a thread), keeps each row's max and sum of
//     exponentials online across the chunks and parks the logits in the
//     residual scratch; then it rewrites them as (softmax - onehot) * m.
//     The loss takes the label's logit by select-then-sum, as above, with
//     compensated adds; each block writes its partial loss;
//   - pass 2 (softmax_tp_grad): block (D chunk of 64, class chunk of KC,
//     row group) sums X^T resid over its rows, 32 rows a step through
//     shared memory, the steps' sums added with compensation, into its own
//     (D, K) partial (chunks after the first add to it, in stream order).
// A last kernel sums the partials in a fixed order.  X is read twice (and
// W once per row tile), the residuals written and read twice; no float
// atomics, so two calls give the same bits.  Ragged rows, columns and
// classes are masked at load.

#include "tile_common.cuh"

namespace {

// kThreads / KB >= kMaxTileRows: the middle gives every (row, class) of
// a tile a thread.
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxClasses = 32;
// One 16-row m-tile of the logit product, two 8-row k-steps of the
// gradient product.
constexpr int kMaxTileRows = 16;
constexpr int kMaxKSteps = kMaxTileRows / 8;
constexpr int kBuckets[] = {8, 16, 32};

enum XType { kF32 = 0, kBF16 = 1 };

// The smallest class bucket that holds k classes; 0 when none does.
int bucket_of(int k) {
  for (int b : kBuckets)
    if (k >= 1 && k <= b) return b;
  return 0;
}

// Row stride, in floats, of the partial-logit and residual tiles: at
// least 16 classes plus 8, so that the lanes of one fragment load or
// store hit distinct banks.
__host__ __device__ constexpr int class_stride(int kb) {
  return (kb > 16 ? kb : 16) + 8;
}

// The smallest s >= v with s % m == r.
__host__ __device__ inline int64_t stride_at(int64_t v, int64_t m,
                                             int64_t r) {
  return v + ((r - v % m) % m + m) % m;
}

// Strides of the staged W and the gradient accumulator (columns padded to
// a multiple of 8, then to a stride whose fragment loads are free of bank
// conflicts): W split into (hi, lo) float2 pairs at s % 16 == 4, raw W at
// s % 32 == 4, the accumulator (float2 read-modify-writes) at s % 32 == 8.
__host__ __device__ inline int64_t w_stride(int64_t d, bool split) {
  return stride_at(round_up(d, 8), split ? 16 : 32, 4);
}
__host__ __device__ inline int64_t g_stride(int64_t d) {
  return stride_at(round_up(d, 8), 32, 8);
}

// Shared-memory layout of one block, byte offsets: the residual tile
// (rows padded to 8 x class_stride); the warps' partial logits (kWarps x
// rows x class_stride); one loss slot per warp; the staged W (k x
// w_stride, float2 pairs or floats); the gradient accumulator (k x
// g_stride); then two X tile buffers (the next tile loads while the block
// works on the current one), each 16-byte aligned with 16 bytes of slack
// so that its byte offset modulo 16 can match the tile's address in
// device memory.
struct Layout {
  int64_t zp, loss, w, g, x, x_buf, total;
  __host__ __device__ Layout(int64_t d, int k, int kb, int rows,
                             int itemsize, bool split) {
    const int64_t cs = class_stride(kb);
    zp = 4 * round_up(rows, 8) * cs;
    loss = zp + 4 * kWarps * int64_t(rows) * cs;
    w = round_up(loss + 4 * kWarps, 16);
    g = w + int64_t(k) * w_stride(d, split) * (split ? 8 : 4);
    x = round_up(g + 4 * int64_t(k) * g_stride(d), 16);
    x_buf = round_up(int64_t(rows) * d * itemsize + kTileSlack, 16);
    total = x + 2 * x_buf;
  }
};

// Most rows (at most kMaxTileRows) whose block fits shared memory.
int fit_rows(int64_t d, int k, int kb, int itemsize, bool split) {
  for (int rows = kMaxTileRows; rows >= 1; --rows)
    if (Layout(d, k, kb, rows, itemsize, split).total <= kSmemBlock)
      return rows;
  return 0;
}

// Tile rows and W staging for X of width d with k classes: a whole
// 16-row m-tile with W split once where that fits a block's shared
// memory; else raw W and as many rows as fit.  Returns false when not
// even one row fits.
bool choose_plan(int64_t d, int k, int itemsize, int* rows_out,
                 bool* split_out) {
  const int kb = bucket_of(k);
  if (kb == 0) return false;
  for (int pass = 0; pass < 2; ++pass) {
    const bool split = pass == 0;
    const int rows = fit_rows(d, k, kb, itemsize, split);
    if (rows == kMaxTileRows || (!split && rows >= 1)) {
      *rows_out = rows;
      *split_out = split;
      return true;
    }
  }
  return false;
}

// ---- tensor-core pieces -------------------------------------------------

// cvt.rna.tf32.f32 (nearest, ties away from zero) as the two integer
// operations it compiles to for a finite v, without its test for inf and
// NaN: an inf or NaN in X still makes lo, and so the result, NaN.
__device__ __forceinline__ uint32_t to_tf32(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}

// v = hi + lo + (about 2^-22 v), both TF32.  lo is handed to the tensor
// cores unmasked: they ignore the low 13 bits of a .tf32 operand, so
// adding half its last place is already round-to-nearest (ties away).
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi,
                                           uint32_t& lo) {
  hi = to_tf32(v);
  lo = __float_as_uint(v - __uint_as_float(hi)) + 0x1000u;
}

// c += a b for one m16n8k8 TF32 fragment triple.
__device__ __forceinline__ void mma_tf32(float (&c)[4],
                                         const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// w - hi (exact in f32, up to 13 bits) as lo, cut to TF32, and lo2, the
// rest: hi + lo + lo2 == w exactly, and lo2 is exact in TF32.
__device__ __forceinline__ void split_w(float rest, uint32_t& lo,
                                        uint32_t& lo2) {
  lo = __float_as_uint(rest) & 0xffffe000u;
  lo2 = __float_as_uint(rest - __uint_as_float(lo));
}

// An element of X (widened to f32) as (hi, lo) TF32 halves; a bf16 value
// is exact in TF32 (lo = 0, and its pass is skipped).
template <typename T>
__device__ __forceinline__ void split_x(float v, uint32_t& hi, uint32_t& lo) {
  if constexpr (sizeof(T) == 4) {
    split_tf32(v, hi, lo);
  } else {
    hi = __float_as_uint(v);
    lo = 0u;
  }
}

// The three passes of one fragment product: hi*hi into `big`, the two
// small terms into `small`; `kXLo` says whether the X operand has a lo
// half (f32) or not (bf16).  The tensor cores add a product's terms to C
// with truncation after aligning them to the largest, so a running C
// would shave every hi*hi term toward zero, by the same sign on every
// row: hi*hi starts from zero at each call and its result is added to
// `big` with a rounded f32 add.  The small terms (2^-11 of it) run on in
// `small`.
template <bool kXisA, bool kXLo>
__device__ __forceinline__ void mma3(float (&big)[4], float (&small)[4],
                                     const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4],
                                     const uint32_t (&bh)[2],
                                     const uint32_t (&bl)[2]) {
  float hh[4] = {0.f, 0.f, 0.f, 0.f};
  mma_tf32(hh, ah, bh);
#pragma unroll
  for (int i = 0; i < 4; ++i) big[i] += hh[i];
  if (kXisA ? true : kXLo) mma_tf32(small, ah, bl);
  if (kXisA ? kXLo : true) mma_tf32(small, al, bh);
}

template <typename T, int KB, bool kSplitW>
__global__ void __launch_bounds__(kThreads, 1)
    softmax_partials(const T* __restrict__ X, const float* __restrict__ y,
                     const float* __restrict__ mask,
                     const float* __restrict__ W, int64_t n, int d, int k,
                     int tile_rows, float* __restrict__ partial_loss,
                     float* __restrict__ partial_grad) {
  constexpr int NT = KB / 8;                // logit n-tiles (classes)
  constexpr int MG = (KB + 15) / 16;        // gradient m-tiles (classes)
  constexpr int CS = class_stride(KB);
  constexpr bool kXLo = sizeof(T) == 4;     // f32 X has a lo half
  const Layout lay(d, k, KB, tile_rows, int(sizeof(T)), kSplitW);
  extern __shared__ __align__(16) unsigned char smem[];
  float* resid_s = reinterpret_cast<float*>(smem);  // [rows8][CS]
  float* zp_s = reinterpret_cast<float*>(smem + lay.zp);
  float* warp_loss_s = reinterpret_cast<float*>(smem + lay.loss);
  float* g_s = reinterpret_cast<float*>(smem + lay.g);  // [k][GS]
  unsigned char* x_buf0 = smem + lay.x;
  const int WS = int(w_stride(d, kSplitW));
  const int GS = int(g_stride(d));
  const int ksteps = (d + 7) / 8;  // 8-column steps (and n-tiles) of D

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int64_t nblocks = gridDim.x;
  const int64_t rows_per_block = (n + nblocks - 1) / nblocks;
  const int64_t r_begin = min64(n, int64_t(blockIdx.x) * rows_per_block);
  const int64_t r_end = min64(n, r_begin + rows_per_block);
  // start loading tile `tile0` into buffer `b`
  auto load = [&](int64_t tile0, int b) {
    const int rows = int(min64(tile_rows, r_end - tile0));
    copy_tile_async<kThreads>(X + tile0 * d,
                              int64_t(rows) * d * int64_t(sizeof(T)),
                              x_buf0 + b * lay.x_buf, X, X + n * d);
  };
  if (r_begin < r_end) load(r_begin, 0);
  cp_async_commit();

  // W transposed to (k, WS), zero past column d: as (hi, w - hi) pairs,
  // or raw
  const int dpad = ksteps * 8;
  for (int64_t i = tid; i < int64_t(k) * dpad; i += kThreads) {
    const int kk = int(i / dpad), c = int(i % dpad);
    const float v = c < d ? W[int64_t(c) * k + kk] : 0.f;
    if constexpr (kSplitW) {
      const float hi = __uint_as_float(to_tf32(v));
      reinterpret_cast<float2*>(smem + lay.w)[kk * WS + c] =
          make_float2(hi, v - hi);
    } else {
      reinterpret_cast<float*>(smem + lay.w)[kk * WS + c] = v;
    }
  }
  for (int64_t i = tid; i < int64_t(k) * GS; i += kThreads) g_s[i] = 0.f;
  Kahan loss_acc;

  // B fragment of W for k-step `s` and n-tile `nt`, as (hi, lo, lo2)
  auto w_frag = [&](int s, int nt, uint32_t (&bh)[2], uint32_t (&bl)[2],
                    uint32_t (&bl2)[2]) {
    const int cls = nt * 8 + g;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = s * 8 + t + 4 * h;
      float2 v;  // (hi, w - hi)
      if constexpr (kSplitW) {
        v = cls < k
            ? reinterpret_cast<const float2*>(smem + lay.w)[cls * WS + c]
            : make_float2(0.f, 0.f);
      } else {
        const float w = cls < k
            ? reinterpret_cast<const float*>(smem + lay.w)[cls * WS + c]
            : 0.f;
        v.x = __uint_as_float(to_tf32(w));
        v.y = w - v.x;
      }
      bh[h] = __float_as_uint(v.x);
      split_w(v.y, bl[h], bl2[h]);
    }
  };

  int buf = 0;
  for (int64_t tile0 = r_begin; tile0 < r_end;
       tile0 += tile_rows, buf ^= 1) {
    const int rows = int(min64(tile_rows, r_end - tile0));
    const int rows8 = (rows + 7) / 8 * 8;
    // the label and mask of this thread's row in the middle, loaded ahead
    const int mr = tid / KB;  // the middle's row
    const float yv = mr < rows ? y[tile0 + mr] : -1.f;
    const float mv = mr < rows ? mask[tile0 + mr] : 0.f;
    // this tile has landed for every thread, and every thread is done
    // with the last tile, so its buffer takes the next one
    cp_async_wait<0>();
    __syncthreads();
    if (tile0 + tile_rows < r_end) load(tile0 + tile_rows, buf ^ 1);
    cp_async_commit();
    const T* xs = reinterpret_cast<const T*>(
        x_buf0 + buf * lay.x_buf +
        (reinterpret_cast<uintptr_t>(X + tile0 * d) & 15));

    // logits: warp `warp` sums the k-steps warp, warp + kWarps, ...;
    // rows and columns past the tile read as zeros
    {
      float big[NT][4], small[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) big[nt][i] = small[nt][i] = 0.f;
#pragma unroll 4
      for (int s = warp; s < ksteps; s += kWarps) {
        uint32_t bh[NT][2], bl[NT][2], bl2[NT][2];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          w_frag(s, nt, bh[nt], bl[nt], bl2[nt]);
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
          mma3<true, kXLo>(big[nt], small[nt], ah, al, bh[nt], bl[nt]);
          mma_tf32(small[nt], ah, bl2[nt]);  // x_hi w_lo2
        }
      }
      float* zp = zp_s + warp * rows * CS;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = g + 8 * h;
        if (r >= rows) continue;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          *reinterpret_cast<float2*>(zp + r * CS + nt * 8 + 2 * t) =
              make_float2(big[nt][2 * h] + small[nt][2 * h],
                          big[nt][2 * h + 1] + small[nt][2 * h + 1]);
      }
    }
    __syncthreads();

    // the middle: thread (row mr, class c), KB lanes a row; rows from
    // `rows` to `rows8` get zero residuals, and warps past them idle
    if (mr < rows8) {
      const int c = tid % KB;
      const bool live = mr < rows && c < k;
      float z = 0.f;
      if (live)
#pragma unroll
        for (int w = 0; w < kWarps; ++w) z += zp_s[(w * rows + mr) * CS + c];
      float zmax = live ? z : -INFINITY;
#pragma unroll
      for (int off = KB / 2; off > 0; off >>= 1)
        zmax = fmaxf(zmax, __shfl_xor_sync(0xffffffffu, zmax, off));
      const float ez = live ? expf(z - zmax) : 0.f;
      float sez = ez;
      // select-then-sum: the picked logit is the one whose class index
      // equals the label (pallas_kernels.py:391-395)
      float picked = live && float(c) == yv ? z : 0.f;
#pragma unroll
      for (int off = KB / 2; off > 0; off >>= 1) {
        sez += __shfl_xor_sync(0xffffffffu, sez, off);
        picked += __shfl_xor_sync(0xffffffffu, picked, off);
      }
      if (live && c == 0) loss_acc.add((zmax + logf(sez) - picked) * mv);
      resid_s[mr * CS + c] =
          live ? (ez / sez - (float(c) == yv ? 1.f : 0.f)) * mv : 0.f;
    }
    __syncthreads();

    // gradient: R^T (classes x rows) as A, split once per tile; warp
    // `warp` takes the n-tiles warp, warp + kWarps, ... of D
    {
      const int kst = rows8 / 8;
      uint32_t rh[kMaxKSteps][MG][4], rl[kMaxKSteps][MG][4];
#pragma unroll
      for (int ks = 0; ks < kMaxKSteps; ++ks) {
        if (ks >= kst) break;
#pragma unroll
        for (int mg = 0; mg < MG; ++mg)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int cls = mg * 16 + g + 8 * (i & 1);
            const int r = ks * 8 + t + 4 * (i >> 1);
            split_tf32(cls < KB ? resid_s[r * CS + cls] : 0.f, rh[ks][mg][i],
                       rl[ks][mg][i]);
          }
      }
#pragma unroll 4
      for (int j = warp; j < ksteps; j += kWarps) {
        const int col = j * 8 + g;
        float big[MG][4], small[MG][4];
#pragma unroll
        for (int mg = 0; mg < MG; ++mg)
#pragma unroll
          for (int i = 0; i < 4; ++i) big[mg][i] = small[mg][i] = 0.f;
#pragma unroll
        for (int ks = 0; ks < kMaxKSteps; ++ks) {
          if (ks >= kst) break;
          uint32_t bh[2], bl[2];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = ks * 8 + t + 4 * h;
            split_x<T>(r < rows && col < d ? to_f32(xs[r * d + col]) : 0.f,
                       bh[h], bl[h]);
          }
#pragma unroll
          for (int mg = 0; mg < MG; ++mg)
            mma3<false, kXLo>(big[mg], small[mg], rh[ks][mg], rl[ks][mg], bh,
                              bl);
        }
#pragma unroll
        for (int mg = 0; mg < MG; ++mg)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int cls = mg * 16 + g + 8 * h;
            if (cls >= k) continue;
            float2* gp =
                reinterpret_cast<float2*>(g_s + cls * GS + j * 8 + 2 * t);
            float2 v = *gp;
            v.x += big[mg][2 * h] + small[mg][2 * h];
            v.y += big[mg][2 * h + 1] + small[mg][2 * h + 1];
            *gp = v;
          }
      }
    }
  }
  __syncthreads();

  // block loss: the threads' sums in a fixed order
  float ls = loss_acc.s;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    ls += __shfl_xor_sync(0xffffffffu, ls, off);
  if (lane == 0) warp_loss_s[warp] = ls;
  float* pg = partial_grad + int64_t(blockIdx.x) * k * d;
  for (int64_t i = tid; i < int64_t(k) * d; i += kThreads)
    pg[i] = g_s[(i / d) * GS + i % d];
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

template <typename T, int KB, bool kSplitW>
cudaError_t launch_partials(const void* X, const float* y, const float* mask,
                            const float* W, int64_t n, int64_t d, int k,
                            int tile_rows, int grid, float* partial_loss,
                            float* partial_grad, cudaStream_t stream) {
  const int64_t smem =
      Layout(d, k, KB, tile_rows, int(sizeof(T)), kSplitW).total;
  if (smem > kSmemBlock) return cudaErrorInvalidValue;
  auto kern = softmax_partials<T, KB, kSplitW>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  kern<<<grid, kThreads, size_t(smem), stream>>>(
      static_cast<const T*>(X), y, mask, W, n, int(d), k, tile_rows,
      partial_loss, partial_grad);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_for_bucket(int kb, bool split, const void* X,
                              const float* y, const float* mask,
                              const float* W, int64_t n, int64_t d, int k,
                              int tile_rows, int grid, float* pl, float* pg,
                              cudaStream_t s) {
#define SOFTMAX_BUCKET(B)                                                   \
  case B:                                                                   \
    return split ? launch_partials<T, B, true>(X, y, mask, W, n, d, k,      \
                                               tile_rows, grid, pl, pg, s)  \
                 : launch_partials<T, B, false>(X, y, mask, W, n, d, k,     \
                                                tile_rows, grid, pl, pg, s);
  switch (kb) {
    SOFTMAX_BUCKET(8)
    SOFTMAX_BUCKET(16)
    SOFTMAX_BUCKET(32)
    default:
      return cudaErrorInvalidValue;
  }
#undef SOFTMAX_BUCKET
}

// ---- two-pass mode ----------------------------------------------------

constexpr int kTPThreads = 256;
constexpr int kTPRows = 32;      // pass 1: rows of a tile
constexpr int kTPCols = 32;      // pass 1: columns of X staged at a time
constexpr int kTPGradCols = 64;  // pass 2: columns of D a block owns
constexpr int kTPGradRows = 32;  // pass 2: rows staged at a time
constexpr int kTPBlocksPerSM = 4;
// the residual scratch of one chunk of rows, and the pass-2 partials
constexpr int64_t kTPResidBytes = int64_t(64) << 20;
constexpr int64_t kTPPartialBytes = int64_t(256) << 20;

// Class chunk of the two-pass mode: 16 classes up to 16, else 64.
__host__ __device__ constexpr int tp_class_chunk(int k) {
  return k <= 16 ? 16 : 64;
}

// Pass 1 on `n` rows (a chunk): logits, online max and sum of
// exponentials, the residuals into resid (n x k) and the loss.  Thread
// (rg, cg) = (tid / 16, tid % 16) forms rows rg and rg + 16 of the tile
// at classes cg + 16 j; thread (sr, sl) = (tid / 8, tid % 8) keeps row
// sr's running max and sum over classes sl + 8 q, shuffling within its 8
// lanes.  Every class chunk starts at a multiple of 8, so the thread that
// parks a logit is the one that reads it back.
template <typename T, int KC>
__global__ void __launch_bounds__(kTPThreads)
    softmax_tp_logits(const T* __restrict__ X, const float* __restrict__ y,
                      const float* __restrict__ mask,
                      const float* __restrict__ W, int64_t n, int64_t d,
                      int k, float* __restrict__ resid,
                      float* __restrict__ partial_loss) {
  constexpr int CJ = KC / 16;
  __shared__ float xs[kTPRows][kTPCols + 1];
  __shared__ float ws[kTPCols][KC];
  __shared__ float zs[kTPRows][KC + 1];
  __shared__ float row_loss_s[kTPRows];
  const int tid = threadIdx.x;
  const int rg = tid / 16, cg = tid % 16;
  const int sr = tid / 8, sl = tid % 8;
  Kahan loss_acc;  // row sr's losses, in lane sl == 0
  const int64_t tiles = (n + kTPRows - 1) / kTPRows;
  for (int64_t tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int64_t row0 = tile * kTPRows;
    const int64_t r = row0 + sr;
    const bool live = r < n;
    const float yv = live ? y[r] : -1.f;
    float run_max = -INFINITY, run_sum = 0.f, picked = 0.f;
    for (int kc0 = 0; kc0 < k; kc0 += KC) {
      float acc[2][CJ];
#pragma unroll
      for (int j = 0; j < CJ; ++j) acc[0][j] = acc[1][j] = 0.f;
      for (int64_t d0 = 0; d0 < d; d0 += kTPCols) {
        for (int e = tid; e < kTPRows * kTPCols; e += kTPThreads) {
          const int rr = e / kTPCols, cc = e % kTPCols;
          const int64_t gr = row0 + rr, gc = d0 + cc;
          xs[rr][cc] = gr < n && gc < d ? to_f32(X[gr * d + gc]) : 0.f;
        }
        for (int e = tid; e < kTPCols * KC; e += kTPThreads) {
          const int cc = e / KC, kk = e % KC;
          const int64_t gc = d0 + cc;
          ws[cc][kk] = gc < d && kc0 + kk < k
                           ? W[gc * k + kc0 + kk] : 0.f;
        }
        __syncthreads();
#pragma unroll 8
        for (int c = 0; c < kTPCols; ++c) {
          const float a0 = xs[rg][c], a1 = xs[rg + 16][c];
#pragma unroll
          for (int j = 0; j < CJ; ++j) {
            const float b = ws[c][cg + 16 * j];
            acc[0][j] = fmaf(a0, b, acc[0][j]);
            acc[1][j] = fmaf(a1, b, acc[1][j]);
          }
        }
        __syncthreads();
      }
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        zs[rg][cg + 16 * j] = acc[0][j];
        zs[rg + 16][cg + 16 * j] = acc[1][j];
      }
      __syncthreads();
      float cmax = -INFINITY;
      for (int c = sl; c < KC && kc0 + c < k; c += 8)
        cmax = fmaxf(cmax, zs[sr][c]);
#pragma unroll
      for (int off = 4; off > 0; off >>= 1)
        cmax = fmaxf(cmax, __shfl_xor_sync(0xffffffffu, cmax, off));
      const float new_max = fmaxf(run_max, cmax);
      float s = 0.f;
      for (int c = sl; c < KC && kc0 + c < k; c += 8) {
        const float z = zs[sr][c];
        s += expf(z - new_max);
        // select-then-sum: the logit whose class index equals the label
        if (float(kc0 + c) == yv) picked = z;
        if (live) resid[r * k + kc0 + c] = z;
      }
#pragma unroll
      for (int off = 4; off > 0; off >>= 1)
        s += __shfl_xor_sync(0xffffffffu, s, off);
      run_sum = (run_max == -INFINITY ? 0.f
                                      : run_sum * expf(run_max - new_max)) +
                s;
      run_max = new_max;
      __syncthreads();  // zs takes the next chunk's logits
    }
#pragma unroll
    for (int off = 4; off > 0; off >>= 1)
      picked += __shfl_xor_sync(0xffffffffu, picked, off);
    const float lse = run_max + logf(run_sum);
    const float mv = live ? mask[r] : 0.f;
    if (live && sl == 0) loss_acc.add((lse - picked) * mv);
    if (live)
      for (int64_t c = sl; c < k; c += 8) {
        const float z = resid[r * k + c];
        resid[r * k + c] =
            (expf(z - lse) - (float(c) == yv ? 1.f : 0.f)) * mv;
      }
  }
  if (sl == 0) row_loss_s[sr] = loss_acc.s;
  __syncthreads();
  if (tid == 0) {
    Kahan s;
    for (int i = 0; i < kTPRows; ++i) s.add(row_loss_s[i]);
    partial_loss[blockIdx.x] = s.s;
  }
}

// Pass 2 on `n` rows (a chunk): block (x, y, z) sums X^T resid over row
// group z for columns 64 x .. 64 x + 63 and classes KC y .. KC y + KC - 1;
// thread (dg, kg) = (tid / 16, tid % 16) owns columns dg + 16 i and classes
// kg + 16 j.  Writes (or, with `accumulate`, adds to) partial_grad[z] in
// the gradient's (D, K) layout.
template <typename T, int KC>
__global__ void __launch_bounds__(kTPThreads)
    softmax_tp_grad(const T* __restrict__ X, const float* __restrict__ resid,
                    int64_t n, int64_t d, int k, int64_t rows_per_group,
                    int accumulate, float* __restrict__ partial_grad) {
  constexpr int CJ = KC / 16;
  constexpr int DI = kTPGradCols / 16;
  __shared__ float xs[kTPGradRows][kTPGradCols];
  __shared__ float rs[kTPGradRows][KC];
  const int tid = threadIdx.x;
  const int dg = tid / 16, kg = tid % 16;
  const int64_t d0 = int64_t(blockIdx.x) * kTPGradCols;
  const int k0 = int(blockIdx.y) * KC;
  const int64_t r_begin = min64(n, int64_t(blockIdx.z) * rows_per_group);
  const int64_t r_end = min64(n, r_begin + rows_per_group);
  Kahan sums[DI][CJ];
  for (int64_t r0 = r_begin; r0 < r_end; r0 += kTPGradRows) {
    for (int e = tid; e < kTPGradRows * kTPGradCols; e += kTPThreads) {
      const int rr = e / kTPGradCols, cc = e % kTPGradCols;
      const int64_t gr = r0 + rr, gc = d0 + cc;
      xs[rr][cc] = gr < r_end && gc < d ? to_f32(X[gr * d + gc]) : 0.f;
    }
    for (int e = tid; e < kTPGradRows * KC; e += kTPThreads) {
      const int rr = e / KC, kk = e % KC;
      const int64_t gr = r0 + rr;
      rs[rr][kk] = gr < r_end && k0 + kk < k ? resid[gr * k + k0 + kk] : 0.f;
    }
    __syncthreads();
    float acc[DI][CJ];
#pragma unroll
    for (int i = 0; i < DI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) acc[i][j] = 0.f;
#pragma unroll 4
    for (int rr = 0; rr < kTPGradRows; ++rr) {
      float a[DI], b[CJ];
#pragma unroll
      for (int i = 0; i < DI; ++i) a[i] = xs[rr][dg + 16 * i];
#pragma unroll
      for (int j = 0; j < CJ; ++j) b[j] = rs[rr][kg + 16 * j];
#pragma unroll
      for (int i = 0; i < DI; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < DI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) sums[i][j].add(acc[i][j]);
    __syncthreads();  // xs and rs take the next step's rows
  }
  float* pg = partial_grad + int64_t(blockIdx.z) * d * k;
#pragma unroll
  for (int i = 0; i < DI; ++i)
#pragma unroll
    for (int j = 0; j < CJ; ++j) {
      const int64_t c = d0 + dg + 16 * i;
      const int kk = k0 + kg + 16 * j;
      if (c >= d || kk >= k) continue;
      float* p = pg + c * k + kk;
      *p = accumulate ? *p + sums[i][j].s : sums[i][j].s;
    }
}

// The two-pass mode's last stage: each gradient entry the fixed-order
// compensated sum of its `ngrad` partials ((D, K) each); thread 0 also
// sums the `nloss` loss partials.
__global__ void reduce_partials_dk(const float* __restrict__ partial_loss,
                                   int64_t nloss,
                                   const float* __restrict__ partial_grad,
                                   int ngrad, int64_t size,
                                   float* __restrict__ loss,
                                   float* __restrict__ grad) {
  const int64_t e = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e < size) {
    Kahan s;
    for (int b = 0; b < ngrad; ++b) s.add(partial_grad[int64_t(b) * size + e]);
    grad[e] = s.s;
  }
  if (e == 0) {
    Kahan s;
    for (int64_t b = 0; b < nloss; ++b) s.add(partial_loss[b]);
    loss[0] = s.s;
  }
}

enum Mode { kOneRead = 0, kTwoPass = 1 };

// A launch plan, as softmax_plan fills it: the mode; the tile rows
// (one-read) or the class chunk (two-pass); the blocks of the (pass-1)
// launch; the gradient partials (the grid, or pass 2's row groups); the
// rows of a chunk (two-pass: the residual scratch holds chunk x k floats;
// 0 one-read); the loss partials (the grid, or the grid times the
// chunks).
struct Plan {
  int mode, rows, grid, partials, chunk, nloss;
};

int64_t tp_chunks(int64_t n, int chunk) {
  return chunk < 1 ? 0 : (n + chunk - 1) / chunk;
}

template <typename T, int KC>
cudaError_t launch_two_pass(const Plan& p, const T* X, const float* y,
                            const float* mask, const float* W, int64_t n,
                            int64_t d, int k, float* pl, float* pg,
                            float* resid, cudaStream_t s) {
  const dim3 grid2(unsigned((d + kTPGradCols - 1) / kTPGradCols),
                   unsigned((k + KC - 1) / KC), unsigned(p.partials));
  int64_t c = 0;
  for (int64_t r0 = 0; r0 < n; r0 += p.chunk, ++c) {
    const int64_t rows = n - r0 < p.chunk ? n - r0 : int64_t(p.chunk);
    softmax_tp_logits<T, KC><<<p.grid, kTPThreads, 0, s>>>(
        X + r0 * d, y + r0, mask + r0, W, rows, d, k, resid,
        pl + c * p.grid);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const int64_t groups = p.partials;
    const int64_t per_group =
        round_up((rows + groups - 1) / groups, kTPGradRows);
    softmax_tp_grad<T, KC><<<grid2, kTPThreads, 0, s>>>(
        X + r0 * d, resid, rows, d, k, per_group, c > 0 ? 1 : 0, pg);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

template <typename T>
cudaError_t launch_two_pass_for(const Plan& p, const void* X,
                                const float* y, const float* mask,
                                const float* W, int64_t n, int64_t d, int k,
                                float* pl, float* pg, float* resid,
                                cudaStream_t s) {
  const T* Xt = static_cast<const T*>(X);
  if (p.rows == 16)
    return launch_two_pass<T, 16>(p, Xt, y, mask, W, n, d, k, pl, pg, resid,
                                  s);
  if (p.rows == 64)
    return launch_two_pass<T, 64>(p, Xt, y, mask, W, n, d, k, pl, pg, resid,
                                  s);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Launch plan for X (n, d) with `itemsize`-byte elements and k classes on
// a card of `sms` SMs, written to plan[0..5] (see Plan): the one-read
// kernel wherever choose_plan fits it (one block an SM, at most one per
// tile), else, or with `force_two_pass`, the two-pass mode (rows in
// chunks of at most kTPResidBytes of residuals; pass 1 on as many blocks
// as are resident, pass 2's row groups enough to fill the card, their
// partials at most kTPPartialBytes).  Returns cudaErrorInvalidValue, and
// sets nothing, for arguments no mode takes.
int softmax_plan(int64_t n, int64_t d, int k, int itemsize, int sms,
                 int force_two_pass, int* plan) {
  if (n < 0 || d < 1 || sms < 1 || k < 1 ||
      (itemsize != 4 && itemsize != 2))
    return int(cudaErrorInvalidValue);
  Plan p;
  int rows;
  bool split;
  if (!force_two_pass && k <= kMaxClasses &&
      choose_plan(d, k, itemsize, &rows, &split)) {
    int64_t blocks = (n + rows - 1) / rows;
    if (blocks > sms) blocks = sms;
    p.mode = kOneRead;
    p.rows = rows;
    p.grid = p.partials = p.nloss = int(blocks < 1 ? 1 : blocks);
    p.chunk = 0;
  } else {
    const int kc = tp_class_chunk(k);
    int64_t chunk = kTPResidBytes / (4 * int64_t(k)) / kTPRows * kTPRows;
    if (chunk < kTPRows) chunk = kTPRows;
    if (chunk > n) chunk = n < 1 ? 1 : n;
    int64_t blocks = (chunk + kTPRows - 1) / kTPRows;
    if (blocks > int64_t(sms) * kTPBlocksPerSM)
      blocks = int64_t(sms) * kTPBlocksPerSM;
    const int64_t tiles = (d + kTPGradCols - 1) / kTPGradCols *
                          ((k + kc - 1) / kc);
    int64_t groups = (int64_t(sms) * kTPBlocksPerSM + tiles - 1) / tiles;
    const int64_t most_rows = (chunk + kTPGradRows - 1) / kTPGradRows;
    const int64_t most_bytes = kTPPartialBytes / (4 * d * int64_t(k));
    if (groups > most_rows) groups = most_rows;
    if (groups > most_bytes) groups = most_bytes;
    if (groups > 65535) groups = 65535;
    p.mode = kTwoPass;
    p.rows = kc;
    p.grid = int(blocks);
    p.partials = int(groups < 1 ? 1 : groups);
    p.chunk = int(chunk);
    const int64_t nloss = tp_chunks(n, p.chunk) * p.grid;
    if (nloss > (int64_t(1) << 30)) return int(cudaErrorInvalidValue);
    p.nloss = int(nloss < 1 ? 1 : nloss);
  }
  plan[0] = p.mode;
  plan[1] = p.rows;
  plan[2] = p.grid;
  plan[3] = p.partials;
  plan[4] = p.chunk;
  plan[5] = p.nloss;
  return 0;
}

// The name of a mode of softmax_plan, or NULL past the last.
const char* softmax_mode_name(int mode) {
  switch (mode) {
    case kOneRead:
      return "one_read";
    case kTwoPass:
      return "two_pass";
    default:
      return nullptr;
  }
}

// The widest X (in columns) that the one-read kernel takes with k
// classes (0 when it takes none): wider X, or more classes, takes the
// two-pass mode.
int64_t softmax_one_read_max_width(int k, int itemsize) {
  if (k < 1 || k > kMaxClasses || (itemsize != 4 && itemsize != 2))
    return 0;
  int rows;
  bool split;
  int64_t lo = 0, hi = kSmemBlock;  // lo fits (vacuously), hi does not
  while (hi - lo > 1) {
    const int64_t mid = (lo + hi) / 2;
    (choose_plan(mid, k, itemsize, &rows, &split) ? lo : hi) = mid;
  }
  return lo;
}

// Launch the plan's kernels and the final sum on `stream`.
// `partial_loss` holds plan[5] floats, `partial_grad` plan[3] * d * k
// floats and `resid` plan[4] * k floats (two-pass mode only; it may be
// NULL otherwise) of scratch.  Returns the CUDA error code of the
// launches (0 on success); synchronises nothing.
int softmax_loss_grad(const void* X, int x_type, const void* y,
                      const void* mask, const void* W, int64_t n, int64_t d,
                      int k, const int* plan, void* partial_loss,
                      void* partial_grad, void* resid, void* loss,
                      void* grad, void* stream) {
  const Plan p{plan[0], plan[1], plan[2], plan[3], plan[4], plan[5]};
  const int itemsize = x_type == kBF16 ? 2 : 4;
  int plan_rows;
  bool split = false;
  const bool ok =
      n >= 0 && d >= 1 && k >= 1 && p.grid >= 1 && p.partials >= 1 &&
      (x_type == kF32 || x_type == kBF16) &&
      ((p.mode == kOneRead && d <= kSmemBlock && bucket_of(k) != 0 &&
        p.rows >= 1 && p.rows <= kMaxTileRows && p.partials == p.grid &&
        p.nloss == p.grid &&
        choose_plan(d, k, itemsize, &plan_rows, &split)) ||
       (p.mode == kTwoPass && p.rows == tp_class_chunk(k) && p.chunk >= 1 &&
        (resid != nullptr || n == 0) &&
        p.nloss >= tp_chunks(n, p.chunk) * p.grid));
  if (!ok) return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* yf = static_cast<const float*>(y);
  const float* mf = static_cast<const float*>(mask);
  const float* wf = static_cast<const float*>(W);
  float* pl = static_cast<float*>(partial_loss);
  float* pg = static_cast<float*>(partial_grad);
  const int threads = 256;
  if (p.mode == kOneRead) {
    const cudaError_t err =
        x_type == kF32
            ? launch_for_bucket<float>(bucket_of(k), split, X, yf, mf, wf,
                                       n, d, k, p.rows, p.grid, pl, pg, s)
            : launch_for_bucket<__nv_bfloat16>(bucket_of(k), split, X, yf,
                                               mf, wf, n, d, k, p.rows,
                                               p.grid, pl, pg, s);
    if (err != cudaSuccess) return int(err);
    const int blocks = int((d * k + threads - 1) / threads);
    reduce_partials<<<blocks, threads, 0, s>>>(pl, pg, p.grid, d, k,
                                               static_cast<float*>(loss),
                                               static_cast<float*>(grad));
    return int(cudaGetLastError());
  }
  float* rf = static_cast<float*>(resid);
  const cudaError_t err =
      x_type == kF32
          ? launch_two_pass_for<float>(p, X, yf, mf, wf, n, d, k, pl, pg, rf,
                                       s)
          : launch_two_pass_for<__nv_bfloat16>(p, X, yf, mf, wf, n, d, k,
                                               pl, pg, rf, s);
  if (err != cudaSuccess) return int(err);
  const int64_t chunks = tp_chunks(n, p.chunk);
  const int64_t size = d * int64_t(k);
  reduce_partials_dk<<<unsigned((size + threads - 1) / threads), threads, 0,
                       s>>>(pl, chunks * p.grid, pg,
                            chunks > 0 ? p.partials : 0, size,
                            static_cast<float*>(loss),
                            static_cast<float*>(grad));
  return int(cudaGetLastError());
}

const char* softmax_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
