"""Model evaluation metrics — the ``mllib.evaluation`` surface in torch.

Counterpart of ``spark_agd_tpu/models/evaluation.py``, every function of
it, ``cv_validation_scores`` (any metric over the lanes of a
cross-validation) included.  Each
metric is a batched reduction on the device its inputs lie on: AUC is
the rank-based Mann-Whitney statistic (one sort, average ranks for
ties), the confusion matrix one ``bincount``.  Counts are exact: ranks
come from integer group sizes, and the confusion matrix counts in
integers (0/1 masks) or sums mask weights in f64, so no float-atomic
order can change a result.

All functions take an optional ``mask`` (1.0 = valid) so padded batches
evaluate exactly like unpadded data.  Inputs may be tensors or anything
numpy takes; results are 0-d or small f32 tensors.
"""

from __future__ import annotations

import numpy as np
import torch


def _t(a, dtype=torch.float32, device=None) -> torch.Tensor:
    t = a if isinstance(a, torch.Tensor) else torch.as_tensor(np.asarray(a))
    return t.to(dtype=dtype, device=device if device is not None
                else t.device)


def _masked(v, mask):
    if mask is None:
        return v, torch.tensor(float(v.shape[0]), dtype=v.dtype,
                               device=v.device)
    m = _t(mask, v.dtype, v.device)
    return v * m, m.sum()


def _avg_ranks(scores, tie_break=None):
    """1-based ranks with ties sharing their group's average rank (the
    Mann-Whitney convention), in f64.  ``tie_break`` (optional secondary
    key) both orders equal-score rows and splits their tie group."""
    n = scores.shape[0]
    if tie_break is None:
        order = torch.sort(scores, stable=True).indices
    else:
        # lexsort by (scores, tie_break): sort by the secondary key, then
        # stably by the primary
        o2 = torch.sort(tie_break, stable=True).indices
        order = o2[torch.sort(scores[o2], stable=True).indices]
    s_sorted = scores[order]
    change = s_sorted[1:] != s_sorted[:-1]
    if tie_break is not None:
        t_sorted = tie_break[order]
        change = change | (t_sorted[1:] != t_sorted[:-1])
    new_group = torch.cat([torch.ones(1, dtype=torch.int64,
                                      device=scores.device),
                           change.to(torch.int64)])
    gid = torch.cumsum(new_group, 0) - 1
    counts = torch.bincount(gid)  # rows per tie group, exact
    start = torch.cumsum(counts, 0) - counts  # 0-based first position
    avg = start.to(torch.float64) + (counts.to(torch.float64) + 1.0) / 2.0
    ranks = torch.empty(n, dtype=torch.float64, device=scores.device)
    ranks[order] = avg[gid]
    return ranks


def roc_auc(scores, labels, mask=None):
    """Area under the ROC curve via the rank statistic:
    ``AUC = (Σ ranks(positives) − P(P+1)/2) / (P·N)``, with average ranks
    for ties.  Masked rows are excluded by pushing them below every valid
    score.  Returns NaN when either class is empty."""
    scores = _t(scores)
    y = _t(labels, torch.float64, scores.device)
    if mask is not None:
        m = (_t(mask, device=scores.device) > 0).to(torch.float64)
        # sink masked rows to -inf; the mask as tie-break key keeps them
        # strictly below any valid row, even a valid -inf
        scores = torch.where(m > 0, scores, -torch.inf)
        y = y * m
        valid = m
        ranks = _avg_ranks(scores, tie_break=m)
    else:
        valid = torch.ones_like(y)
        ranks = _avg_ranks(scores)
    n_pos = y.sum()
    n_val = valid.sum()
    n_neg = n_val - n_pos
    # masked rows occupy the lowest ranks: subtract that block from every
    # positive's rank
    n_masked = scores.shape[0] - n_val
    rank_sum_pos = (ranks * y).sum() - n_masked * n_pos
    auc = (rank_sum_pos - n_pos * (n_pos + 1.0) / 2.0) \
        / torch.clamp_min(n_pos * n_neg, 1.0)
    nan = torch.tensor(torch.nan, dtype=auc.dtype, device=auc.device)
    return torch.where((n_pos > 0) & (n_neg > 0), auc, nan).to(torch.float32)


def log_loss(probs, labels, mask=None, eps: float = 1e-7):
    """Mean binary cross-entropy of predicted probabilities."""
    p = torch.clamp(_t(probs), eps, 1.0 - eps)
    y = _t(labels, device=p.device)
    ll = -(y * torch.log(p) + (1.0 - y) * torch.log1p(-p))
    ll, n = _masked(ll, mask)
    return ll.sum() / torch.clamp_min(n, 1)


def binary_metrics(scores, labels, mask=None, threshold: float = 0.5
                   ) -> dict:
    """``BinaryClassificationMetrics``-style summary at one threshold
    plus threshold-free AUC.  ``scores > threshold`` predicts class 1."""
    scores = _t(scores)
    y = _t(labels, device=scores.device)
    pred = (scores > threshold).to(torch.float32)
    tp, _ = _masked(pred * y, mask)
    fp, _ = _masked(pred * (1.0 - y), mask)
    fn, _ = _masked((1.0 - pred) * y, mask)
    correct, n = _masked((pred == y).to(torch.float32), mask)
    tp, fp, fn = tp.sum(), fp.sum(), fn.sum()
    precision = tp / torch.clamp_min(tp + fp, 1.0)
    recall = tp / torch.clamp_min(tp + fn, 1.0)
    f1 = 2.0 * precision * recall / torch.clamp_min(precision + recall,
                                                    1e-30)
    return {
        "accuracy": correct.sum() / torch.clamp_min(n, 1),
        "precision": precision,
        "recall": recall,
        "f1": f1,
        "auc_roc": roc_auc(scores, y, mask),
    }


def regression_metrics(predictions, targets, mask=None) -> dict:
    """``RegressionMetrics`` equivalents: mse/rmse/mae/r2 and the
    explained-variance score ``1 − Var(t−p)/Var(t)`` (population
    variances)."""
    p = _t(predictions)
    t = _t(targets, device=p.device)
    err = p - t
    se, n = _masked(err * err, mask)
    ae, _ = _masked(err.abs(), mask)
    n = torch.clamp_min(n, 1)
    err_m, _ = _masked(err, mask)
    err_mean = err_m.sum() / n
    ve, _ = _masked((err - err_mean) ** 2, mask)
    tm, _ = _masked(t, mask)
    t_mean = tm.sum() / n
    tv, _ = _masked((t - t_mean) ** 2, mask)
    mse = se.sum() / n
    var_t = torch.clamp_min(tv.sum() / n, 1e-30)
    return {
        "mse": mse,
        "rmse": torch.sqrt(mse),
        "mae": ae.sum() / n,
        "r2": 1.0 - mse / var_t,
        "explained_variance": 1.0 - (ve.sum() / n) / var_t,
    }


def confusion_matrix(predictions, labels, num_classes: int, mask=None):
    """(K, K) counts[true, pred], f32.  Unmasked rows are counted in
    integers; a mask's weights are summed in f64."""
    p = _t(predictions, torch.int64)
    y = _t(labels, torch.int64, p.device)
    idx = y * num_classes + p
    size = num_classes * num_classes
    if mask is None:
        flat = torch.bincount(idx, minlength=size)
    else:
        flat = torch.bincount(idx, weights=_t(mask, torch.float64, p.device),
                              minlength=size)
    return flat[:size].to(torch.float32).reshape(num_classes, num_classes)


def cv_validation_scores(cv, X, y, *, score_fn, predict_fn=None,
                         base_mask=None):
    """Score every (fold, strength) lane of an ``api.cross_validate``
    result with any metric, e.g. select by held-out AUC instead of loss.

    ``score_fn(scores, labels, mask) -> scalar`` (e.g. :func:`roc_auc`);
    ``predict_fn(w) -> scores`` maps one lane's weights to scores
    (default: the margin ``X @ w``).  Rows the CV excluded stay excluded:
    ``base_mask`` defaults to ``cv.base_mask``.  Returns ``(per_lane (F,
    R), mean_per_strength (R,))``, the mean a ``nanmean`` over folds;
    select with a NaN-aware arg-max or -min and check that the winner is
    finite (a strength can be NaN in every fold)."""
    from ..core import tvec
    from ..ops.losses import _mm

    n_folds, n_regs = cv.val_loss.shape
    fold_ids = cv.fold_ids
    dev = fold_ids.device
    y = y if isinstance(y, torch.Tensor) else torch.as_tensor(np.asarray(y))
    y = y.to(dev)
    if base_mask is None:
        base_mask = getattr(cv, "base_mask", None)
    base = (torch.ones(y.shape[0], dtype=torch.float32, device=dev)
            if base_mask is None else _t(base_mask, device=dev))
    if predict_fn is None and not isinstance(X, torch.Tensor):
        from ..ops.sparse import CSRMatrix

        X = X.to(dev) if isinstance(X, CSRMatrix) \
            else torch.as_tensor(np.asarray(X)).to(dev)
    weights = cv.train_result.weights
    per_lane = []
    for f in range(n_folds):
        val_mask = base * (fold_ids == f)
        for r in range(n_regs):
            w = tvec.tmap(lambda a: a[f, r], weights)
            scores = _mm(X, w) if predict_fn is None else predict_fn(w)
            per_lane.append(torch.as_tensor(score_fn(scores, y, val_mask)))
    per_lane = torch.stack(per_lane).reshape(n_folds, n_regs)
    return per_lane, torch.nanmean(per_lane, dim=0)


def multiclass_metrics(predictions, labels, num_classes: int,
                       mask=None) -> dict:
    """``MulticlassMetrics`` equivalents from one confusion matrix:
    accuracy, per-class precision/recall/f1, macro averages."""
    cm = confusion_matrix(predictions, labels, num_classes, mask)
    total = torch.clamp_min(cm.sum(), 1.0)
    diag = torch.diagonal(cm)
    col = cm.sum(dim=0)  # predicted-as-k counts
    row = cm.sum(dim=1)  # true-k counts
    precision = diag / torch.clamp_min(col, 1.0)
    recall = diag / torch.clamp_min(row, 1.0)
    f1 = 2.0 * precision * recall / torch.clamp_min(precision + recall,
                                                    1e-30)
    return {
        "accuracy": diag.sum() / total,
        "confusion": cm,
        "precision_per_class": precision,
        "recall_per_class": recall,
        "f1_per_class": f1,
        "macro_precision": precision.mean(),
        "macro_recall": recall.mean(),
        "macro_f1": f1.mean(),
    }
