// Pieces shared by the port's kernels that stream rows through shared
// memory on mbarriers and swap partial dots across a thread block
// cluster (margin_loss_grad.cu: its cluster and stream modes;
// margin_lanes_loss_grad.cu: its cluster mode): the cluster's special
// registers and barrier, stores into a peer block's shared memory,
// mbarriers, bulk copies of X's rows, the launch of a kernel in clusters,
// and the check of a plan query's arguments against the device.  Each
// kernel source is its own library, so everything here has internal
// linkage.

#pragma once

#include <atomic>

#include <cuda_runtime.h>
#include <stdint.h>

#include "tile_common.cuh"

namespace {

// A cluster's columns are cut into slices of a multiple of this many
// columns (64 or 128 bytes), so that every slice starts where its row
// does, modulo 16 bytes.
constexpr int kSliceAlign = 32;
constexpr int kClusterSizes[] = {2, 4, 8, 16};
constexpr int kClusterMaxSize = 16;
constexpr int kPortableCluster = 8;

// The columns of each block of a cluster of c blocks over X of width d
// (the last block takes the rest).
__host__ __device__ inline int64_t cluster_slice(int64_t d, int c) {
  return round_up((d + c - 1) / c, kSliceAlign);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ int cluster_rank() {
  int r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ int cluster_blocks() {
  int r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ int cluster_id() {
  int r;
  asm volatile("mov.u32 %0, %%clusterid.x;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ int cluster_count() {
  int r;
  asm volatile("mov.u32 %0, %%nclusterid.x;\n" : "=r"(r));
  return r;
}

// Every thread of every block of the cluster waits for all of them (at
// the start, so that no block stores into a peer not yet running; at the
// end, so that none leaves while a peer may still store into it).
__device__ __forceinline__ void cluster_sync() {
  __syncwarp();
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Store v at `p` (an address in this block's shared memory) in block
// `rank`'s shared memory, counted as 4 bytes on that block's copy of the
// mbarrier `bar`.
__device__ __forceinline__ void send_peer(float* p, float v, uint64_t* bar,
                                          int rank) {
  uint32_t to, to_bar;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(to)
               : "r"(smem_addr(p)), "r"(rank));
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(to_bar)
               : "r"(smem_addr(bar)), "r"(rank));
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.f32 [%0], %1, "
      "[%2];\n" ::"r"(to),
      "f"(v), "r"(to_bar)
      : "memory");
}

// Initialise the mbarrier `bar` for `count` arrivals a phase.
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count = 1) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_bytes(uint64_t* bar,
                                                  uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// Wait for the completion of the barrier's phase of parity `parity`.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// A 1-D bulk copy (TMA, no tensor map) of `bytes` (a multiple of 16) from
// 16-byte aligned device memory into this block's shared memory,
// completing on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Fill `buf` with the elements [a, e) of X (whose elements lie in [lo_x,
// hi_x)), each at its address modulo 16 past buf, completing on `bar`
// (one arrival): one bulk copy of the 16-byte chunks that cover [a, e)
// and lie in X, and plain copies by this thread of the elements left
// over at X's ends (those of a chunk that X does not fill), stored
// before the arrival that releases them.  A chunk that straddles two
// stages is read by both.
template <typename T>
__device__ __forceinline__ void issue_stage(unsigned char* buf,
                                            const T* a, const T* e,
                                            const T* lo_x, const T* hi_x,
                                            uint64_t* bar) {
  const uintptr_t ua = reinterpret_cast<uintptr_t>(a);
  const uintptr_t ue = reinterpret_cast<uintptr_t>(e);
  const uintptr_t base = ua & ~uintptr_t(15);
  uintptr_t lo = (reinterpret_cast<uintptr_t>(lo_x) + 15) & ~uintptr_t(15);
  uintptr_t hi = reinterpret_cast<uintptr_t>(hi_x) & ~uintptr_t(15);
  lo = lo > base ? lo : base;
  const uintptr_t e16 = (ue + 15) & ~uintptr_t(15);
  hi = hi < e16 ? hi : e16;
  if (hi <= lo) lo = hi = ue;  // no whole chunk: every element plainly
  auto plain = [&](uintptr_t from, uintptr_t to) {
    for (uintptr_t q = from; q < to; q += sizeof(T))
      *reinterpret_cast<T*>(buf + (q - base)) =
          *reinterpret_cast<const T*>(q);
  };
  plain(ua, lo < ue ? lo : ue);
  plain(hi > ua ? hi : ua, ue);
  mbar_expect_bytes(bar, uint32_t(hi - lo));
  if (hi > lo)
    bulk_copy(buf + (lo - base), reinterpret_cast<const void*>(lo),
              uint32_t(hi - lo), bar);
}

// The launch configuration of a kernel in clusters: `blocks` blocks of
// `threads` threads in clusters of `c`, with `smem` bytes of shared
// memory each.
struct ClusterLaunch {
  cudaLaunchConfig_t cfg{};
  cudaLaunchAttribute attr[1];
  ClusterLaunch(int blocks, int c, int threads, int64_t smem,
                cudaStream_t stream) {
    cfg.gridDim = dim3(unsigned(blocks));
    cfg.blockDim = dim3(unsigned(threads));
    cfg.dynamicSmemBytes = size_t(smem);
    cfg.stream = stream;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = unsigned(c);
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
};

// Let `kern` take a block's whole shared memory (and, with `clusters`,
// clusters past the portable size), once a device: function attributes
// belong to the kernel on the current device, and `done` holds a bit a
// device.  Where the card refuses the non-portable size, clusters of that
// size stay refused and the cluster plans skip them.
template <typename K>
cudaError_t smem_attributes(K kern, std::atomic<unsigned long long>& done,
                            bool clusters) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0;
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(kSmemBlock));
  if (err != cudaSuccess) return err;
  if (clusters && cudaFuncSetAttribute(
                      kern, cudaFuncAttributeNonPortableClusterSizeAllowed,
                      1) != cudaSuccess)
    cudaGetLastError();
  done.fetch_or(bit, std::memory_order_release);
  return cudaSuccess;
}

// The arguments every plan query checks: a shape and element size a mode
// takes, and `sms` the current device's SM count.
cudaError_t check_plan_args(int64_t n, int64_t d, int itemsize, int sms) {
  if (n < 0 || d < 1 || sms < 1 || (itemsize != 4 && itemsize != 2))
    return cudaErrorInvalidValue;
  int dev = 0, dev_sms = 0;
  if (const cudaError_t err = cudaGetDevice(&dev); err != cudaSuccess)
    return err;
  if (const cudaError_t err = cudaDeviceGetAttribute(
          &dev_sms, cudaDevAttrMultiProcessorCount, dev);
      err != cudaSuccess)
    return err;
  return dev_sms == sms ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace
