// The margin losses' per-row middle, shared by the port's margin kernels
// (margin_loss_grad.cu, margin_lanes_loss_grad.cu): the loss codes and X
// types of their C interfaces, and loss_middle (loss_middle_of, the loss
// chosen at run time), the per-example loss and gradient multiplier of
// spark_agd_tpu/ops/losses.py (dots_loss_and_mult).  Each kernel source
// is its own library, so everything here has internal linkage.

#pragma once

namespace {

enum LossKind { kLogistic = 0, kLeastSquares = 1, kHinge = 2 };
enum XType { kF32 = 0, kBF16 = 1 };

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

// The middle of loss `kind` (a runtime switch, for kernels instantiated
// once for all three losses: the margin kernel's stream mode, the lanes
// kernel's cluster mode).
__device__ __forceinline__ void loss_middle_of(int kind, float dot, float y,
                                               float* per, float* mult) {
  if (kind == kLogistic)
    loss_middle<kLogistic>(dot, y, per, mult);
  else if (kind == kLeastSquares)
    loss_middle<kLeastSquares>(dot, y, per, mult);
  else
    loss_middle<kHinge>(dot, y, per, mult);
}

}  // namespace
