"""spark_agd_tpu_torch — the PyTorch/CUDA port of ``spark_agd_tpu``.

TFOCS-style accelerated proximal gradient descent on one NVIDIA GPU: the
same losses, prox operators, optimizer loop, public API and GLM
trainers as the JAX package, with the fused loss+gradient kernels written
by hand in CUDA for Hopper (``csrc/margin_loss_grad.cu``,
``csrc/softmax_loss_grad.cu``).  The package imports
``torch`` and never ``jax`` or ``spark_agd_tpu``.

Layer map (dense and CSR data, one device):

====  ==========================  ===========================================
L6    model layer                 ``models.glm`` trainers and models,
                                  ``models.evaluation`` metrics
L5    public API                  ``AcceleratedGradientDescent``, ``run``,
                                  ``make_runner`` (``api``)
L4    optimizer core              ``core.agd.run_agd`` (Python loop)
L3    math plugins                ``ops.losses`` (Gradient), ``ops.prox``
                                  (Updater), ``ops.fused_kernels`` (CUDA),
                                  ``ops.sparse`` (CSRMatrix products)
L1    data                        ``data.libsvm`` (+ ``native`` C++ parser),
                                  ``data.synthetic``, ``data.device_synth``
L0    local math                  ``core.tvec`` tensor / tree algebra;
                                  ``utils.checkpoint.atomic_savez``
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
    FusedSoftmaxGradient,
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
from .ops.sparse import CSRMatrix  # noqa: F401
from .data.libsvm import CSRData, load_libsvm  # noqa: F401
from .api import AcceleratedGradientDescent, make_runner, run  # noqa: F401
from .core.agd import AGDConfig, AGDResult, AGDWarmState  # noqa: F401
