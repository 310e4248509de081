"""spark_agd_tpu_torch — the PyTorch/CUDA port of ``spark_agd_tpu``.

TFOCS-style accelerated proximal gradient descent on one NVIDIA GPU: the
same losses, prox operators, optimizer loop and public API as the JAX
package, with the fused margin loss+gradient kernel written by hand in
CUDA for Hopper (``csrc/margin_loss_grad.cu``).  The package imports
``torch`` and never ``jax`` or ``spark_agd_tpu``.

Layer map (this slice: dense data, one device):

====  ==========================  ===========================================
L5    public API                  ``AcceleratedGradientDescent``, ``run``,
                                  ``make_runner`` (``api``)
L4    optimizer core              ``core.agd.run_agd`` (Python loop)
L3    math plugins                ``ops.losses`` (Gradient), ``ops.prox``
                                  (Updater), ``ops.fused_kernels`` (CUDA)
L1    data                        ``data.synthetic``, ``data.device_synth``
L0    local math                  ``core.tvec`` tensor / tree algebra
====  ==========================  ===========================================

Entry points run on the current CUDA device unless the caller passes
``device="cpu"``; with no CUDA device they raise.
"""

__version__ = "0.1.0"

from .ops.losses import (  # noqa: F401
    Gradient,
    MarginGradient,
    LogisticGradient,
    LeastSquaresGradient,
    HingeGradient,
    SoftmaxGradient,
    CustomGradient,
    GRADIENTS,
)
from .ops.fused_kernels import (  # noqa: F401
    FusedMarginGradient,
    FusedLogisticGradient,
)
from .ops.prox import (  # noqa: F401
    Prox,
    IdentityProx,
    L2Prox,
    MLlibSquaredL2Updater,
    L1Prox,
    ElasticNetProx,
    SimpleUpdater,
    SquaredL2Updater,
    L1Updater,
    PROXES,
)
from .api import AcceleratedGradientDescent, make_runner, run  # noqa: F401
from .core.agd import AGDConfig, AGDResult, AGDWarmState  # noqa: F401
