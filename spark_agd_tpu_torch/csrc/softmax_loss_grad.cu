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
// (below) is bound, counting each input byte once (X, y, the mask and W
// read once, the gradient written once, at 3.35 TB/s) against the two
// products in three TF32 passes (3 x 4 N D K flops at 495 TFLOP/s), by
// the operations wherever K is large: at CIFAR-100's shape (50,000 x
// 3,072, K = 100) 0.372 ms against 0.183 for the bytes, at LIBSVM aloi's
// (108,000 x 128, K = 1,000) 0.335 ms.  Its own design moves X twice and
// the (N, K) residuals out and back, 2 N D itemsize + 2 N K 4 bytes
// (config 4's shape forced to it: 15.4 ms).
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
// loss past its VMEM budget).  Both products run on the tensor cores with
// the fragments and splits above (the logits in four passes, W in three
// parts; the gradient in three), in 256-thread blocks of 8 warps, two
// blocks an SM; a class tile is 16, 32, 64 or 128 classes
// (tp_class_tile), padded only to the n8 fragment (100 classes: 13 live
// n8 tiles).  Rows run in chunks of at most kTPResidBytes of residuals,
// (rows x K) f32, so the scratch stays bounded (the jnp path holds all
// N x K logits).  Per chunk:
//   - pass 1 (softmax_tp_logits): a block takes a tile of 64-256 rows
//     (32 rows a warp beside the class tile's warps) and, for each class
//     tile, forms the logits X_tile W[:, tile]: A = X, B = W, contraction
//     over D in 64-column stages (32 for f32 X in class tiles of 16-32
//     classes, so that two blocks fit an SM) through a 2-buffer cp.async
//     ring (X's stage and W's, row-major, W's rows being D); where the
//     classes take several tiles and the block's whole row tile fits
//     beside the W stages (aloi: 64 x 128 f32, 33 KB), it stays resident,
//     so X is read once at any class count.  Row tiles of 64 rows or
//     more read W from L2 half as often as 32-row tiles, or less.  The
//     middle works on the fragments' rows: each row's max and sum of
//     exponentials online across the class tiles (the warps' shares met
//     in shared memory in a fixed order), the label's logit by
//     select-then-sum; the logits of every class tile but the last are
//     parked in the residual scratch, and after the last the lane that
//     parked them rewrites them as (softmax - onehot) * m;
//   - pass 2 (softmax_tp_grad): block (64-256 columns of D, the class
//     tile, a row group) sums X^T resid over its rows: A = X^T (columns
//     of D as m16 tiles, read down the staged rows), B = the residuals,
//     contraction over the rows in stages of as many rows through the
//     same kind of ring; into its own (D, K) partial (chunks after the
//     first add to it, in stream order).
// Staged rows are padded so that every fragment load hits 32 distinct
// banks (tp_stride); a row whose 16-byte chunks are not aligned (785 f32
// columns, odd bf16 widths, K not a multiple of 4) takes 4-byte cp.async
// copies (f32) or plain loads (bf16).  In both products each k8 step's
// hi*hi starts from zero and is added to its sum with a rounded f32 add,
// the small terms in their own accumulator (mma3); pass 2 adds its
// stages' sums with compensation, the small terms riding in the
// compensation.  A last kernel sums the gradient partials in block order
// and, in its last block, the loss partials (a strided compensated share
// a thread, then a fixed tree).  No float atomics, so two calls give the
// same bits.  Ragged rows, columns and classes are masked at load.
//
// What bounds the two-pass mode (PERF.md): on an H100 80GB HBM3 at
// 700 W, mma.sync m16n8k8 TF32 alone peaks near 320 TFLOP/s
// (`chip_smoke.py --ab mma:probe=probes/mma_rate.cu`; wgmma's 495 needs
// both TF32 operands K-major in shared memory, which X^T and the
// residuals are not).  At that rate CIFAR-100's products take 0.70 ms;
// the mode takes 2.13 ms of device time there, a third of the rate.  In
// the code (cuobjdump -sass, not a measured rate) each mma.sync comes
// with the 3xTF32 scheme's splits, fragment loads and f32 adds.

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
constexpr int kTPWarps = kTPThreads / 32;
// Two blocks an SM: their registers are capped at 128 a thread, which
// spills a few bytes, but on the H100 16 warps an SM hide the loops'
// latency far better than one block of 8 at 166-215 registers (PERF.md).
// Every non-resident layout fits twice in an SM's shared memory (tp_step).
constexpr int kTPMinBlocks = 2;
// m16 tiles a warp: pass 1's rows, pass 2's columns of D
constexpr int kTPMTiles = 2;
// cp.async ring: kTPStages buffers, one in flight while the block works
// on the other
constexpr int kTPStages = 2;
// pass 1: at most this many blocks an SM (the rest walk more row tiles);
// pass 2: its row groups aim at this many blocks an SM
constexpr int kTPMaxBlocksPerSM = 16;
constexpr int kTPWaves = 4;
// the residual scratch of one chunk of rows, and the pass-2 partials
constexpr int64_t kTPResidBytes = int64_t(64) << 20;
constexpr int64_t kTPPartialBytes = int64_t(256) << 20;

// Class tile of the two-pass mode (pass 1's classes a sweep over D, pass
// 2's classes a block): 16, 32, 64 or 128 classes, the smallest that
// holds k; 128-class tiles past 128.
__host__ __device__ constexpr int tp_class_tile(int k) {
  return k <= 16 ? 16 : k <= 32 ? 32 : k <= 64 ? 64 : 128;
}

// Warps across a class tile of kt classes (each takes kt / 8 / warps
// n8 tiles, interleaved); the other kTPWarps / warps lie across rows
// (pass 1) or columns of D (pass 2), kTPMTiles m16 tiles a warp.
__host__ __device__ constexpr int tp_class_warps(int kt) {
  return kt <= 32 ? 1 : kt / 32;
}

// Rows of a pass-1 block, and columns of D of a pass-2 block: 64-256.
__host__ __device__ constexpr int tp_block_span(int kt) {
  return 16 * kTPMTiles * (kTPWarps / tp_class_warps(kt));
}

// A stage, pass 1's columns of D and pass 2's rows: 64 (eight k8 steps),
// or 32 for f32 X in class tiles of 16 or 32 classes, whose 256-row and
// 256-column blocks would take 156-163 KB of 64-wide stages, one block
// an SM; 32-wide, they take 78-87 KB and two fit.
__host__ __device__ constexpr int tp_step(int itemsize, int kt) {
  return itemsize == 4 && kt <= 32 ? 32 : 64;
}

// A row stride in shared memory: `bytes` rounded up to 16, then to
// s % mod == rem, so that the lanes of one fragment load hit distinct
// banks.  A fragments of a row-major tile (pass 1's X: lane (g, t) reads
// row g, column t) take s % 32 == 16 (a word stride of 4 mod 8, f32 or
// bf16); fragments read down a tile's columns (pass 1's W, pass 2's X^T
// and residuals: lane (g, t) reads row t, column g) take s % 128 == 32.
__host__ __device__ inline int64_t tp_stride(int64_t bytes, int64_t mod,
                                             int64_t rem) {
  return stride_at(round_up(bytes, 16), mod, rem);
}

// Pass 1's shared memory, byte offsets: the X stages (or, resident, the
// block's whole row tile, columns padded to the stage), the W stages
// (a stage's rows of D x kt classes each), then the cross-warp reductions
// (row max, row sum: class warps x rows each), each row's picked logit
// and one loss slot a warp.
struct TP1Layout {
  int64_t xs, ws, x_stage, w_stage, w, red, total;
  __host__ __device__ TP1Layout(int64_t d, int kt, int itemsize,
                                bool resident) {
    const int64_t bm = tp_block_span(kt), step = tp_step(itemsize, kt);
    xs = tp_stride((resident ? round_up(d, step) : step) * itemsize,
                   32, 16);
    ws = tp_stride(int64_t(kt) * 4, 128, 32);
    x_stage = bm * xs;
    w_stage = step * ws;
    w = x_stage * (resident ? 1 : kTPStages);
    red = w + w_stage * kTPStages;
    total = red + 4 * ((2 * tp_class_warps(kt) + 1) * bm + kTPWarps);
  }
};

// Pass 2's shared memory: kTPStages stages of (a stage's rows of X's
// block columns, the same rows of the residuals' class tile).
struct TP2Layout {
  int64_t xs, rs, r, stage, total;
  __host__ __device__ TP2Layout(int kt, int itemsize) {
    const int64_t step = tp_step(itemsize, kt);
    xs = tp_stride(int64_t(tp_block_span(kt)) * itemsize, 128, 32);
    rs = tp_stride(int64_t(kt) * 4, 128, 32);
    r = step * xs;
    stage = r + step * rs;
    total = stage * kTPStages;
  }
};

// 4-byte cp.async (cached at all levels), for rows whose chunks are not
// 16-byte aligned.
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

// Stage rows [row0, row0 + rows) x columns [col0, col0 + cols) of the
// row-major (nrows, ncols) array `src` into shared memory at `dst` (row
// stride `stride` bytes), with kTPThreads threads: a 16-byte cp.async
// per chunk that lies inside the array and is aligned, 4-byte ones (f32)
// or plain loads (bf16) for one that is not, zeros past the array.
// cols * sizeof(T) is a multiple of 16.
template <typename T>
__device__ __forceinline__ void tp_stage(unsigned char* dst, int64_t stride,
                                         const T* __restrict__ src,
                                         int64_t nrows, int64_t ncols,
                                         int64_t row0, int rows,
                                         int64_t col0, int cols) {
  constexpr int E = 16 / int(sizeof(T));  // elements a chunk
  const int cpr = cols / E;
  for (int i = threadIdx.x; i < rows * cpr; i += kTPThreads) {
    const int r = i / cpr, q = i % cpr;
    const int64_t gr = row0 + r, gc = col0 + int64_t(q) * E;
    unsigned char* p = dst + r * stride + q * 16;
    if (gr >= nrows || gc >= ncols) {
      *reinterpret_cast<uint4*>(p) = make_uint4(0u, 0u, 0u, 0u);
      continue;
    }
    const T* s = src + gr * ncols + gc;
    if (gc + E <= ncols && (reinterpret_cast<uintptr_t>(s) & 15) == 0) {
      cp_async16(p, s);
      continue;
    }
#pragma unroll
    for (int e = 0; e < E; ++e) {
      if constexpr (sizeof(T) == 4) {
        if (gc + e < ncols)
          cp_async4(p + 4 * e, s + e);
        else
          reinterpret_cast<uint32_t*>(p)[e] = 0u;
      } else {
        reinterpret_cast<uint16_t*>(p)[e] =
            gc + e < ncols ? reinterpret_cast<const uint16_t*>(s)[e]
                           : uint16_t(0);
      }
    }
  }
}

// An element of a staged tile, widened to f32.
template <typename T>
__device__ __forceinline__ float tp_at(const unsigned char* base,
                                       int64_t stride, int r, int c) {
  return to_f32(*reinterpret_cast<const T*>(base + r * stride +
                                            c * int(sizeof(T))));
}

// Pass 1 on `n` rows (a chunk): block tiles of BM rows (a grid-stride
// loop); for each class tile of KT classes the logits X_tile W[:, tile]
// on the tensor cores, D in tp_step-column stages through a cp.async
// ring (X's stage too, unless the block's whole row tile is resident);
// then each row's max and sum of exponentials, updated online across the
// class tiles, and the label's logit (select-then-sum).  The logits of
// every class tile but the last are parked in `resid` (n x k); after the
// last, the lane that parked them rewrites them as (softmax - onehot) *
// m, and writes the last tile's from its registers.  Warp (wm, wn) =
// (warp % WGM, warp / WGM) owns rows wm * 16 MT .. + 16 MT - 1 (MT
// m-tiles) and the n8 tiles wn, wn + WGN, ... of the class tile.  Each
// block writes its partial loss.
template <typename T, int KT, bool kResident>
__global__ void __launch_bounds__(kTPThreads, kTPMinBlocks)
    softmax_tp_logits(const T* __restrict__ X, const float* __restrict__ y,
                      const float* __restrict__ mask,
                      const float* __restrict__ W, int64_t n, int64_t d,
                      int k, float* __restrict__ resid,
                      float* __restrict__ partial_loss) {
  constexpr int WGN = tp_class_warps(KT);
  constexpr int WGM = kTPWarps / WGN;
  constexpr int NTW = KT / 8 / WGN;  // n8 tiles a warp
  constexpr int MT = kTPMTiles;
  constexpr int BM = tp_block_span(KT);
  constexpr bool kXLo = sizeof(T) == 4;
  constexpr int STEP = tp_step(int(sizeof(T)), KT);
  const TP1Layout lay(d, KT, int(sizeof(T)), kResident);
  extern __shared__ __align__(16) unsigned char smem[];
  float* red_max = reinterpret_cast<float*>(smem + lay.red);  // [WGN][BM]
  float* red_sum = red_max + WGN * BM;
  float* pick = red_sum + WGN * BM;  // [BM]: the label's logit
  float* warp_loss = pick + BM;

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = warp % WGM, wn = warp / WGM;
  const int dsteps = int((d + STEP - 1) / STEP);
  const int ctiles = (k + KT - 1) / KT;
  const int nstages = ctiles * dsteps;
  const int64_t tiles = (n + BM - 1) / BM;
  const int wsf = int(lay.ws / 4);  // W stage row stride, floats
  Kahan loss_acc;  // the losses of this lane's rows (wn == 0, t == 0)
  // this lane's row of m-tile mt, half h (rows g and g + 8)
  auto row_of = [&](int mt, int h) {
    return wm * 16 * MT + mt * 16 + g + 8 * h;
  };
  // this lane's class of n8 tile nt, column e of its pair, in class tile c0
  auto class_of = [&](int c0, int nt, int e) {
    return c0 + (wn + WGN * nt) * 8 + 2 * t + e;
  };

  for (int64_t tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int64_t row0 = tile * BM;
    // this lane's rows' labels (-1 past n) and running max and sum of
    // exponentials
    auto label = [&](int mt, int h) {
      const int64_t r = row0 + row_of(mt, h);
      return r < n ? y[r] : -1.f;
    };
    float run_max[MT][2], run_sum[MT][2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        run_max[mt][h] = -INFINITY;
        run_sum[mt][h] = 0.f;
      }
    auto load = [&](int s) {
      const int buf = s % kTPStages, ct = s / dsteps, ds = s % dsteps;
      if constexpr (!kResident)
        tp_stage<T>(smem + buf * lay.x_stage, lay.xs, X, n, d, row0, BM,
                    int64_t(ds) * STEP, STEP);
      tp_stage<float>(smem + lay.w + buf * lay.w_stage, lay.ws, W, d, k,
                      int64_t(ds) * STEP, STEP, int64_t(ct) * KT, KT);
    };
    // every warp is done with the last tile's buffers and reductions
    __syncthreads();
    for (int i = tid; i < BM; i += kTPThreads) pick[i] = 0.f;
    if constexpr (kResident)
      tp_stage<T>(smem, lay.xs, X, n, d, row0, BM, 0, dsteps * STEP);
#pragma unroll
    for (int s = 0; s < kTPStages - 1; ++s) {
      if (s < nstages) load(s);
      cp_async_commit();
    }
    float big[MT][NTW][4], small[MT][NTW][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NTW; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) big[mt][nt][i] = small[mt][nt][i] = 0.f;

    for (int s = 0; s < nstages; ++s) {
      // stage s has landed for every thread, and every thread is done
      // with stage s - 1, whose buffer takes stage s + kTPStages - 1
      cp_async_wait<kTPStages - 2>();
      __syncthreads();
      if (s + kTPStages - 1 < nstages) load(s + kTPStages - 1);
      cp_async_commit();
      const int buf = s % kTPStages, ct = s / dsteps, ds = s % dsteps;
      const int kc0 = ct * KT;
      const unsigned char* xb =
          kResident ? smem + ds * STEP * int(sizeof(T))
                    : smem + buf * lay.x_stage;
      const float* wb =
          reinterpret_cast<const float*>(smem + lay.w + buf * lay.w_stage);
#pragma unroll
      for (int j = 0; j < STEP / 8; ++j) {
        uint32_t ah[MT][4], al[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            split_x<T>(tp_at<T>(xb, lay.xs, row_of(mt, i & 1),
                                j * 8 + t + 4 * (i >> 1)),
                       ah[mt][i], al[mt][i]);
        // an n8 tile past k is skipped: that puts its mma.sync under a
        // predicate and a WARPSYNC, but saves its four passes (3 of 16
        // tiles at K = 100; pass 2 runs every tile, PERF.md)
#pragma unroll
        for (int nt = 0; nt < NTW; ++nt) {
          if (class_of(kc0, nt, 0) - 2 * t >= k) continue;  // warp-uniform
          uint32_t bh[2], bl[2], bl2[2];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float w =
                wb[(j * 8 + t + 4 * h) * wsf + (wn + WGN * nt) * 8 + g];
            bh[h] = to_tf32(w);
            split_w(w - __uint_as_float(bh[h]), bl[h], bl2[h]);
          }
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma3<true, kXLo>(big[mt][nt], small[mt][nt], ah[mt], al[mt], bh,
                             bl);
            mma_tf32(small[mt][nt], ah[mt], bl2);  // x_hi w_lo2
          }
        }
      }
      if (ds != dsteps - 1) continue;

      // ---- the middle, at the end of class tile ct: z = big + small ----
      const bool last = ct == ctiles - 1;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NTW; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            big[mt][nt][i] += small[mt][nt][i];
            small[mt][nt][i] = 0.f;
          }
      float new_max[MT][2];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float mx = -INFINITY;
#pragma unroll
          for (int nt = 0; nt < NTW; ++nt)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              if (class_of(kc0, nt, e) < k)
                mx = fmaxf(mx, big[mt][nt][2 * h + e]);
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
          if (t == 0) red_max[wn * BM + row_of(mt, h)] = mx;
        }
      __syncthreads();
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = row_of(mt, h);
          float mx = red_max[row];
#pragma unroll
          for (int w = 1; w < WGN; ++w) mx = fmaxf(mx, red_max[w * BM + row]);
          new_max[mt][h] = fmaxf(run_max[mt][h], mx);
          const float yv = label(mt, h);
          float sez = 0.f;
#pragma unroll
          for (int nt = 0; nt < NTW; ++nt)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int cls = class_of(kc0, nt, e);
              const float z = big[mt][nt][2 * h + e];
              if (cls < k) sez += expf(z - new_max[mt][h]);
              // select-then-sum: the logit whose class index is the label
              // (one lane of the block holds it)
              if (cls < k && float(cls) == yv) pick[row] = z;
            }
          sez += __shfl_xor_sync(0xffffffffu, sez, 1);
          sez += __shfl_xor_sync(0xffffffffu, sez, 2);
          if (t == 0) red_sum[wn * BM + row] = sez;
        }
      __syncthreads();
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = row_of(mt, h);
          float sez = 0.f;
#pragma unroll
          for (int w = 0; w < WGN; ++w) sez += red_sum[w * BM + row];
          run_sum[mt][h] =
              (run_max[mt][h] == -INFINITY
                   ? 0.f
                   : run_sum[mt][h] * expf(run_max[mt][h] - new_max[mt][h])) +
              sez;
          run_max[mt][h] = new_max[mt][h];
        }
      if (!last) {  // park this class tile's logits
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int64_t r = row0 + row_of(mt, h);
#pragma unroll
            for (int nt = 0; nt < NTW; ++nt)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int cls = class_of(kc0, nt, e);
                if (r < n && cls < k)
                  resid[r * k + cls] = big[mt][nt][2 * h + e];
                big[mt][nt][2 * h + e] = 0.f;
              }
          }
        continue;
      }
      // the last class tile (pick[] was written before the last barrier):
      // the loss and every residual of the rows
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = row_of(mt, h);
          const int64_t r = row0 + row;
          if (r >= n) continue;
          const float lse = run_max[mt][h] + logf(run_sum[mt][h]);
          const float m = mask[r], yv = y[r];
          if (wn == 0 && t == 0) loss_acc.add((lse - pick[row]) * m);
#pragma unroll
          for (int nt = 0; nt < NTW; ++nt)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int cls = class_of(kc0, nt, e);
              if (cls < k)
                resid[r * k + cls] =
                    (expf(big[mt][nt][2 * h + e] - lse) -
                     (float(cls) == yv ? 1.f : 0.f)) * m;
            }
          for (int c0 = 0; c0 < kc0; c0 += KT)
#pragma unroll
            for (int nt = 0; nt < NTW; ++nt)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int cls = class_of(c0, nt, e);
                float* p = resid + r * k + cls;
                *p = (expf(*p - lse) - (float(cls) == yv ? 1.f : 0.f)) * m;
              }
        }
    }
  }
  // block loss: the lanes' sums in a fixed order
  float ls = loss_acc.s;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    ls += __shfl_xor_sync(0xffffffffu, ls, off);
  if (lane == 0) warp_loss[warp] = ls;
  __syncthreads();
  if (tid == 0) {
    Kahan s;
    for (int i = 0; i < kTPWarps; ++i) s.add(warp_loss[i]);
    partial_loss[blockIdx.x] = s.s;
  }
}

// Pass 2 on `n` rows (a chunk): block (x, y, z) sums X^T resid over row
// group z for the BD columns of D from BD x and the KT classes from KT y,
// on the tensor cores: A = X^T (columns of D as m16 tiles), B = the
// residuals (classes as n8 tiles), contraction over the rows in tp_step-
// row stages through a cp.async ring.  Each k8 step's hi*hi starts from
// zero and is added to the stage's sum with a rounded f32 add; the small
// terms run on in the compensation of the sum over stages (ncomp, the
// negated Kahan correction: the stage's sum plus ncomp is what the next
// compensated add takes).  Warp (wm, wn) owns the columns wm * 16 MT ..
// + 16 MT - 1 and the n8 tiles wn, wn + WGN, ....  Writes (or, with
// `accumulate`, adds to) partial_grad[z] in the gradient's (D, K) layout.
template <typename T, int KT>
__global__ void __launch_bounds__(kTPThreads, kTPMinBlocks)
    softmax_tp_grad(const T* __restrict__ X, const float* __restrict__ resid,
                    int64_t n, int64_t d, int k, int64_t rows_per_group,
                    int accumulate, float* __restrict__ partial_grad) {
  constexpr int WGN = tp_class_warps(KT);
  constexpr int WGM = kTPWarps / WGN;
  constexpr int NTW = KT / 8 / WGN;
  constexpr int MT = kTPMTiles;
  constexpr int BD = tp_block_span(KT);
  constexpr bool kXLo = sizeof(T) == 4;
  constexpr int STEP = tp_step(int(sizeof(T)), KT);
  const TP2Layout lay(KT, int(sizeof(T)));
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = warp % WGM, wn = warp / WGM;
  const int64_t d0 = int64_t(blockIdx.x) * BD;
  const int kc0 = int(blockIdx.y) * KT;
  const int64_t r_begin = min64(n, int64_t(blockIdx.z) * rows_per_group);
  const int64_t r_end = min64(n, r_begin + rows_per_group);
  const int nst = int((r_end - r_begin + STEP - 1) / STEP);
  const int rsf = int(lay.rs / 4);  // residual stage row stride, floats

  auto load = [&](int s) {
    unsigned char* b = smem + (s % kTPStages) * lay.stage;
    const int64_t r0 = r_begin + int64_t(s) * STEP;
    tp_stage<T>(b, lay.xs, X, r_end, d, r0, STEP, d0, BD);
    tp_stage<float>(b + lay.r, lay.rs, resid, r_end, k, r0, STEP, kc0,
                    KT);
  };
#pragma unroll
  for (int s = 0; s < kTPStages - 1; ++s) {
    if (s < nst) load(s);
    cp_async_commit();
  }
  float sum[MT][NTW][4], ncomp[MT][NTW][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NTW; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) sum[mt][nt][i] = ncomp[mt][nt][i] = 0.f;

  for (int s = 0; s < nst; ++s) {
    cp_async_wait<kTPStages - 2>();
    __syncthreads();
    if (s + kTPStages - 1 < nst) load(s + kTPStages - 1);
    cp_async_commit();
    const unsigned char* xb = smem + (s % kTPStages) * lay.stage;
    const float* rb = reinterpret_cast<const float*>(xb + lay.r);
    float big[MT][NTW][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NTW; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) big[mt][nt][i] = 0.f;
    // not unrolled: the whole stage at once spills 664 bytes at the
    // register cap, one step at a time 104, and runs faster on the H100
    // (PERF.md)
#pragma unroll 1
    for (int j = 0; j < STEP / 8; ++j) {
      // A = X^T: a0 (col g, row t), a1 (g + 8, t), a2 (g, t + 4),
      // a3 (g + 8, t + 4) of the warp's m-tile
      uint32_t ah[MT][4], al[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          split_x<T>(tp_at<T>(xb, lay.xs, j * 8 + t + 4 * (i >> 1),
                              wm * 16 * MT + mt * 16 + g + 8 * (i & 1)),
                     ah[mt][i], al[mt][i]);
      // every tile runs, those past k or d on the zeros staged there
#pragma unroll
      for (int nt = 0; nt < NTW; ++nt) {
        const int ntg = wn + WGN * nt;
        uint32_t bh[2], bl[2];
#pragma unroll
        for (int h = 0; h < 2; ++h)
          split_tf32(rb[(j * 8 + t + 4 * h) * rsf + ntg * 8 + g], bh[h],
                     bl[h]);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          mma3<true, kXLo>(big[mt][nt], ncomp[mt][nt], ah[mt], al[mt], bh,
                           bl);
      }
    }
    // the stage's sum into the sum over stages, with compensation
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NTW; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float v = big[mt][nt][i] + ncomp[mt][nt][i];
          const float s2 = sum[mt][nt][i] + v;
          ncomp[mt][nt][i] = v - (s2 - sum[mt][nt][i]);
          sum[mt][nt][i] = s2;
        }
  }
  float* pg = partial_grad + int64_t(blockIdx.z) * d * k;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NTW; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int64_t c = d0 + wm * 16 * MT + mt * 16 + g + 8 * (i >> 1);
        const int kk = kc0 + (wn + WGN * nt) * 8 + 2 * t + (i & 1);
        if (c >= d || kk >= k) continue;
        float* p = pg + c * k + kk;
        // the small terms still in ncomp belong to the sum
        const float v = sum[mt][nt][i] + ncomp[mt][nt][i];
        *p = accumulate ? *p + v : v;
      }
}

// The two-pass mode's last stage: each gradient entry the fixed-order
// compensated sum of its `ngrad` partials ((D, K) each), a thread an
// entry; the grid's last block sums the `nloss` loss partials, each
// thread a strided share with compensation, then a fixed tree.
constexpr int kReduceThreads = 256;
__global__ void __launch_bounds__(kReduceThreads)
    reduce_partials_dk(const float* __restrict__ partial_loss, int64_t nloss,
                       const float* __restrict__ partial_grad, int ngrad,
                       int64_t size, float* __restrict__ loss,
                       float* __restrict__ grad) {
  if (blockIdx.x == gridDim.x - 1) {
    __shared__ float part[kReduceThreads];
    Kahan s;
    for (int64_t b = threadIdx.x; b < nloss; b += kReduceThreads)
      s.add(partial_loss[b]);
    part[threadIdx.x] = s.s;
    __syncthreads();
    for (int w = kReduceThreads / 2; w > 0; w >>= 1) {
      if (threadIdx.x < w) part[threadIdx.x] += part[threadIdx.x + w];
      __syncthreads();
    }
    if (threadIdx.x == 0) loss[0] = part[0];
    return;
  }
  const int64_t e = int64_t(blockIdx.x) * kReduceThreads + threadIdx.x;
  if (e < size) {
    Kahan s;
    for (int b = 0; b < ngrad; ++b) s.add(partial_grad[int64_t(b) * size + e]);
    grad[e] = s.s;
  }
}

enum Mode { kOneRead = 0, kTwoPass = 1 };

// A launch plan, as softmax_plan fills it: the mode; the tile rows
// (one-read) or the class tile (two-pass); the blocks of the (pass-1)
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

template <typename K>
cudaError_t set_smem(K kern, int64_t bytes) {
  if (bytes > kSmemBlock) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
}

// Pass 1 keeps a block's whole row tile of X in shared memory where the
// classes take more than one tile and the tile fits beside the W stages,
// so that X is read once in pass 1 at any class count.
bool tp_resident(int64_t d, int k, int itemsize) {
  const int kt = tp_class_tile(k);
  return k > kt && TP1Layout(d, kt, itemsize, true).total <= kSmemBlock;
}

template <typename T, int KT>
cudaError_t launch_two_pass(const Plan& p, const T* X, const float* y,
                            const float* mask, const float* W, int64_t n,
                            int64_t d, int k, float* pl, float* pg,
                            float* resid, cudaStream_t s) {
  const bool resident = tp_resident(d, k, int(sizeof(T)));
  auto logits = resident ? softmax_tp_logits<T, KT, true>
                         : softmax_tp_logits<T, KT, false>;
  const int64_t smem1 = TP1Layout(d, KT, int(sizeof(T)), resident).total;
  const int64_t smem2 = TP2Layout(KT, int(sizeof(T))).total;
  cudaError_t err = set_smem(logits, smem1);
  if (err != cudaSuccess) return err;
  err = set_smem(softmax_tp_grad<T, KT>, smem2);
  if (err != cudaSuccess) return err;
  const int bd = tp_block_span(KT);
  const dim3 grid2(unsigned((d + bd - 1) / bd), unsigned((k + KT - 1) / KT),
                   unsigned(p.partials));
  int64_t c = 0;
  for (int64_t r0 = 0; r0 < n; r0 += p.chunk, ++c) {
    const int64_t rows = n - r0 < p.chunk ? n - r0 : int64_t(p.chunk);
    logits<<<p.grid, kTPThreads, size_t(smem1), s>>>(
        X + r0 * d, y + r0, mask + r0, W, rows, d, k, resid,
        pl + c * p.grid);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const int64_t groups = p.partials;
    const int64_t per_group =
        round_up((rows + groups - 1) / groups, tp_step(int(sizeof(T)), KT));
    softmax_tp_grad<T, KT><<<grid2, kTPThreads, size_t(smem2), s>>>(
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
#define TP_TILE(KT)                                                        \
  case KT:                                                                 \
    return launch_two_pass<T, KT>(p, Xt, y, mask, W, n, d, k, pl, pg,      \
                                  resid, s);
  switch (p.rows) {
    TP_TILE(16)
    TP_TILE(32)
    TP_TILE(64)
    TP_TILE(128)
    default:
      return cudaErrorInvalidValue;
  }
#undef TP_TILE
}

}  // namespace

extern "C" {

// Launch plan for X (n, d) with `itemsize`-byte elements and k classes on
// a card of `sms` SMs, written to plan[0..5] (see Plan): the one-read
// kernel wherever choose_plan fits it (one block an SM, at most one per
// tile), else, or with `force_two_pass`, the two-pass mode (the class
// tile by k; rows in chunks of at most kTPResidBytes of residuals; pass 1
// a block a row tile, at most kTPMaxBlocksPerSM an SM; pass 2's row
// groups enough for kTPWaves blocks an SM, their partials at most
// kTPPartialBytes).  Returns cudaErrorInvalidValue, and sets nothing, for
// arguments no mode takes.
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
    const int kt = tp_class_tile(k);
    const int span = tp_block_span(kt);
    int64_t chunk = kTPResidBytes / (4 * int64_t(k)) / span * span;
    if (chunk < span) chunk = span;
    if (chunk > n) chunk = n < 1 ? 1 : n;
    int64_t blocks = (chunk + span - 1) / span;
    if (blocks > int64_t(sms) * kTPMaxBlocksPerSM)
      blocks = int64_t(sms) * kTPMaxBlocksPerSM;
    const int64_t tiles = (d + span - 1) / span * ((k + kt - 1) / kt);
    int64_t groups = (int64_t(sms) * kTPWaves + tiles - 1) / tiles;
    const int step = tp_step(itemsize, kt);
    const int64_t most_rows = (chunk + step - 1) / step;
    const int64_t most_bytes = kTPPartialBytes / (4 * d * int64_t(k));
    if (groups > most_rows) groups = most_rows;
    if (groups > most_bytes) groups = most_bytes;
    if (groups > 65535) groups = 65535;
    p.mode = kTwoPass;
    p.rows = kt;
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
       (p.mode == kTwoPass && p.rows == tp_class_tile(k) && p.chunk >= 1 &&
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
  reduce_partials_dk<<<unsigned((size + kReduceThreads - 1) / kReduceThreads +
                                1),
                       kReduceThreads, 0, s>>>(
      pl, chunks * p.grid, pg, chunks > 0 ? p.partials : 0, size,
      static_cast<float*>(loss), static_cast<float*>(grad));
  return int(cudaGetLastError());
}

const char* softmax_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
