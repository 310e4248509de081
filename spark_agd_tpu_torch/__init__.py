"""spark_agd_tpu_torch — the PyTorch/CUDA port of ``spark_agd_tpu``.

TFOCS-style accelerated proximal gradient descent on one NVIDIA GPU: the
same losses, prox operators, optimizer loop, public API and GLM
trainers as the JAX package, with the fused loss+gradient kernels written
by hand in CUDA for Hopper (``csrc/margin_loss_grad.cu``,
``csrc/margin_lanes_loss_grad.cu``, ``csrc/softmax_loss_grad.cu``).  The package imports
``torch`` and never ``jax`` or ``spark_agd_tpu``.

Layer map (dense and CSR data, one device):

====  ==========================  ===========================================
L6    model layer                 ``models.glm`` trainers and models,
                                  ``models.mlp`` (config 5),
                                  ``models.evaluation`` metrics
L5    public API                  ``AcceleratedGradientDescent``, ``run``,
                                  ``make_runner``, ``run_minibatch_sgd``,
                                  ``LBFGS``, ``run_lbfgs``; the lanes:
                                  ``sweep``, ``cross_validate``,
                                  ``LBFGS.sweep``; streamed:
                                  ``streaming_sweep``,
                                  ``streaming_lbfgs_sweep`` (``api``)
L4    optimizer core              ``core.agd.run_agd``, ``core.gd``,
                                  ``core.lbfgs`` (L-BFGS, OWL-QN) and
                                  ``core.host_lbfgs`` (Python loops);
                                  ``core.host_agd.run_agd_host`` (the
                                  streamed driver);
                                  ``core.host_agd`` and
                                  ``core.lbfgs.run_lanes`` (K lanes in
                                  lock-step); ``core.prng`` (JAX's
                                  Bernoulli bits and permutations)
L3    math plugins                ``ops.losses`` (Gradient), ``ops.prox``
                                  (Updater), ``ops.fused_kernels`` (CUDA),
                                  ``ops.sparse`` (CSRMatrix products)
L2    data plane, resilience      ``data.streaming`` (macro-batches
                                  through pinned memory on a side
                                  stream, ``StreamingDataset``,
                                  ``fold_stream``), ``data.ingest``;
                                  ``resilience`` (the supervisor,
                                  ``AutoCheckpointer``, faults, chaos,
                                  ``retry``/``errors``)
L1    data                        ``data.libsvm`` (+ ``native`` C++ parser),
                                  ``data.synthetic``, ``data.device_synth``
L0    local math                  ``core.tvec`` tensor / tree algebra;
                                  ``utils.checkpoint`` (npz checkpoints
                                  in the JAX package's format);
                                  ``utils.logging`` and ``obs.schema``
                                  (log lines and run records)
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
from .api import (  # noqa: F401
    AcceleratedGradientDescent,
    CVResult,
    LBFGS,
    cross_validate,
    make_cv_runner,
    make_lbfgs_runner,
    make_lbfgs_sweep_runner,
    make_runner,
    make_sweep_runner,
    run,
    run_lbfgs,
    run_minibatch_agd,
    run_minibatch_sgd,
    streaming_lbfgs_sweep,
    streaming_sweep,
    sweep,
    sweep_warm_state,
)
from .core.agd import AGDConfig, AGDResult, AGDWarmState  # noqa: F401
from .core.gd import GDResult  # noqa: F401
from .core.lbfgs import (  # noqa: F401
    LBFGSConfig,
    LBFGSResult,
    make_objective as make_lbfgs_objective,
    run_owlqn,
)
from .core.host_agd import (  # noqa: F401
    HostAGDMultiResult,
    HostAGDResult,
    HostMultiWarm,
    make_prox_multi,
    multi_warm_state,
    run_agd_host,
    run_agd_host_multi,
)
from .core.host_lbfgs import (  # noqa: F401
    HostLBFGSResult,
    HostLBFGSWarm,
    run_lbfgs_host,
    run_owlqn_host,
)
from .models.glm import (  # noqa: F401
    LogisticRegressionWithLBFGS,
    SoftmaxRegressionWithLBFGS,
)
from .models.mlp import (  # noqa: F401
    MLPClassifierWithAGD,
    MLPModel,
    mlp_gradient,
)
from . import obs  # noqa: F401
from .data.streaming import (  # noqa: F401
    StreamingDataset,
    make_streaming_eval_multi,
    make_streaming_smooth,
)
from . import resilience  # noqa: F401
from .resilience import (  # noqa: F401
    AutoCheckpointer,
    ChaosCampaign,
    FaultScript,
    ResiliencePolicy,
    SupervisedResult,
    run_agd_supervised,
)
