// Throughput probe of mma.sync.aligned.m16n8k8 in TF32 on the card, for
// `chip_smoke.py --ab mma:NAME=probes/mma_rate.cu`; not part of the
// package and not a kernel of any path.  Each warp issues
// `iters` rounds of U products into U accumulators from the same A and B
// fragments: with enough independent accumulators a round is bound by
// the tensor pipe's rate for this instruction, with one by the latency of
// a dependent chain.  The softmax kernel's two-pass mode
// (softmax_loss_grad.cu) is built from this instruction, so its rate
// bounds that mode's products.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <int U>
__global__ void mma_rate(int iters, float* __restrict__ out) {
  uint32_t a[4], b[2];
  // small operands (2^-10 and near), so the sums stay finite
#pragma unroll
  for (int i = 0; i < 4; ++i)
    a[i] = __float_as_uint(0x1p-10f * (1.f + 0.001f * (threadIdx.x + i)));
#pragma unroll
  for (int i = 0; i < 2; ++i)
    b[i] = __float_as_uint(0x1p-10f * (1.f + 0.002f * (threadIdx.x + i)));
  float c[U][4];
#pragma unroll
  for (int u = 0; u < U; ++u)
#pragma unroll
    for (int i = 0; i < 4; ++i) c[u][i] = 0.f;
  for (int it = 0; it < iters; ++it)
#pragma unroll
    for (int u = 0; u < U; ++u) mma_tf32(c[u], a, b);
  float s = 0.f;
#pragma unroll
  for (int u = 0; u < U; ++u)
#pragma unroll
    for (int i = 0; i < 4; ++i) s += c[u][i];
  out[int64_t(blockIdx.x) * blockDim.x + threadIdx.x] = s;
}

}  // namespace

extern "C" {

// Launch the probe with `chains` (1, 2, 4 or 8) accumulators a warp on
// `blocks` blocks of `threads` threads; `out` holds blocks * threads
// floats.  Returns the launch's CUDA error code.
int mma_rate_launch(int chains, int blocks, int threads, int iters,
                    void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  switch (chains) {
    case 1: mma_rate<1><<<blocks, threads, 0, s>>>(iters, o); break;
    case 2: mma_rate<2><<<blocks, threads, 0, s>>>(iters, o); break;
    case 4: mma_rate<4><<<blocks, threads, 0, s>>>(iters, o); break;
    case 8: mma_rate<8><<<blocks, threads, 0, s>>>(iters, o); break;
    default: return int(cudaErrorInvalidValue);
  }
  return int(cudaGetLastError());
}

}  // extern "C"
