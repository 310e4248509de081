"""Model layer: the ``GeneralizedLinearAlgorithm``-style callers the
reference's optimizer was built to plug into (``glm.py``), the MLP of
BASELINE config 5 (``mlp.py``) and the ``mllib.evaluation`` metric
equivalents (``evaluation.py``)."""

from .evaluation import (  # noqa: F401
    binary_metrics,
    cv_validation_scores,
    confusion_matrix,
    log_loss,
    multiclass_metrics,
    regression_metrics,
    roc_auc,
)
from .glm import (  # noqa: F401
    GLMModel,
    load_model,
    save_model,
    GeneralizedLinearAlgorithm,
    LinearRegressionModel,
    LinearRegressionWithAGD,
    LogisticRegressionModel,
    LogisticRegressionWithAGD,
    LogisticRegressionWithLBFGS,
    SVMModel,
    SVMWithAGD,
    SoftmaxRegressionModel,
    SoftmaxRegressionWithAGD,
    SoftmaxRegressionWithLBFGS,
)
from .mlp import (  # noqa: F401
    MLPClassifierWithAGD,
    MLPModel,
    init_mlp_params,
    make_mlp_loss_sum,
    mlp_forward,
    mlp_gradient,
)
