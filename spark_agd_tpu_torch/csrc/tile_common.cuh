// Pieces shared by the port's row-tile kernels (margin_loss_grad.cu,
// softmax_loss_grad.cu): Hopper's shared-memory limits, compensated f32
// sums, bf16 widening and the copy of a contiguous chunk of X into shared
// memory.  Each kernel source is its own library, so everything here has
// internal linkage.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Hopper's shared memory: 227 KB for one block, 228 KB on an SM, of
// which the runtime keeps 1 KB per resident block.
constexpr int64_t kSmemBlock = 232448;
constexpr int64_t kSmemSM = 233472;
constexpr int64_t kSmemReserved = 1024;

__host__ __device__ inline int64_t round_up(int64_t v, int64_t m) {
  return (v + m - 1) / m * m;
}

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) {
  return a < b ? a : b;
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Compensated summation, so that sums over many rows stay near the
// exact value while accumulating in f32.
struct Kahan {
  float s = 0.f;
  float c = 0.f;
  __device__ void add(float v) {
    float yv = v - c;
    float t = s + yv;
    c = (t - s) - yv;
    s = t;
  }
};

// Asynchronous 16-byte copies from device to shared memory (cp.async,
// sm_80 and later), committed in groups; cp_async_wait<N> returns once at
// most N of this thread's groups are still in flight.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Copy `nbytes` contiguous bytes starting at `src` into shared memory at
// `dst_base + (src % 16)`, with `kThreads` threads: the middle with
// 16-byte loads, the unaligned head and tail element by element.
template <int kThreads, typename T>
__device__ __forceinline__ void copy_tile(const T* __restrict__ src,
                                          int64_t nbytes,
                                          unsigned char* dst_base) {
  const uintptr_t addr = reinterpret_cast<uintptr_t>(src);
  const uintptr_t floor16 = addr & ~uintptr_t(15);
  const uintptr_t a_begin = (addr + 15) & ~uintptr_t(15);
  const uintptr_t a_end = (addr + nbytes) & ~uintptr_t(15);
  T* dst = reinterpret_cast<T*>(dst_base + (addr - floor16));
  const int64_t n_elem = nbytes / int64_t(sizeof(T));
  if (a_begin >= a_end) {
    for (int64_t i = threadIdx.x; i < n_elem; i += kThreads) dst[i] = src[i];
    return;
  }
  const int64_t head = int64_t(a_begin - addr) / int64_t(sizeof(T));
  const int64_t tail0 = int64_t(a_end - addr) / int64_t(sizeof(T));
  if (threadIdx.x < head) dst[threadIdx.x] = src[threadIdx.x];
  for (int64_t i = tail0 + threadIdx.x; i < n_elem; i += kThreads)
    dst[i] = src[i];
  const uint4* gv = reinterpret_cast<const uint4*>(a_begin);
  uint4* sv = reinterpret_cast<uint4*>(dst_base + (a_begin - floor16));
  const int64_t nvec = int64_t(a_end - a_begin) / 16;
  constexpr int kUnroll = 4;
  for (int64_t i = threadIdx.x; i < nvec; i += kUnroll * kThreads) {
    uint4 v[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const int64_t j = i + int64_t(k) * kThreads;
      if (j < nvec) v[k] = gv[j];
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const int64_t j = i + int64_t(k) * kThreads;
      if (j < nvec) sv[j] = v[k];
    }
  }
}

// The same placement as copy_tile (the bytes at `src` land at
// `dst_base + (src % 16)`), as cp.async copies of the 16-byte chunks that
// cover them: a chunk may take a few bytes of the neighbouring rows, so
// that no thread waits on a load here.  Only a chunk that reaches outside
// [lo, hi), the whole array, is copied element by element.  The caller
// commits the group and waits for it, then synchronises the block, before
// reading the tile.
template <int kThreads, typename T>
__device__ __forceinline__ void copy_tile_async(const T* src, int64_t nbytes,
                                                unsigned char* dst_base,
                                                const T* lo, const T* hi) {
  const uintptr_t addr = reinterpret_cast<uintptr_t>(src);
  const uintptr_t floor16 = addr & ~uintptr_t(15);
  const int64_t nchunks = int64_t(((addr + nbytes + 15) & ~uintptr_t(15)) -
                                  floor16) / 16;
  const uintptr_t ulo = reinterpret_cast<uintptr_t>(lo);
  const uintptr_t uhi = reinterpret_cast<uintptr_t>(hi);
  for (int64_t j = threadIdx.x; j < nchunks; j += kThreads) {
    const uintptr_t g = floor16 + 16 * uintptr_t(j);
    if (g >= ulo && g + 16 <= uhi) {
      cp_async16(dst_base + 16 * j, reinterpret_cast<const void*>(g));
    } else {
      const uintptr_t b = g > addr ? g : addr;
      const uintptr_t e = g + 16 < addr + nbytes ? g + 16 : addr + nbytes;
      for (uintptr_t p = b; p < e; p += sizeof(T))
        *reinterpret_cast<T*>(dst_base + (p - floor16)) =
            *reinterpret_cast<const T*>(p);
    }
  }
}

// Row tiles of X are copied to their own address modulo 16, so a tile
// region needs 16 bytes of slack beyond rows * d * itemsize.
constexpr int64_t kTileSlack = 16;

}  // namespace
