"""Model layer: the ``GeneralizedLinearAlgorithm``-style callers the
reference's optimizer was built to plug into (``glm.py``) and the
``mllib.evaluation`` metric equivalents (``evaluation.py``).  The MLP of
BASELINE config 5 (``models/mlp.py``) arrives in a later slice."""

from .evaluation import (  # noqa: F401
    binary_metrics,
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
