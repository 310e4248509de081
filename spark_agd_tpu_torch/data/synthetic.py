"""Synthetic data generators — the test-fixture data the reference uses.

A copy of ``spark_agd_tpu/data/synthetic.py`` (numpy only), kept in the
port so that it imports nothing of the JAX package.

``generate_gd_input`` re-provides MLlib's ``GradientDescentSuite.
generateGDInput(A, B, nPoints, seed)`` (consumed at reference Suite:46):
binary labels drawn from a logistic model with intercept A and slope B over
a standard-normal feature.  The reference prepends a 1.0 intercept column
before training (Suite:47-49); ``with_intercept_column`` does the same.
Exact bit-parity with the JVM RNG is neither possible nor needed — the
equivalence tests compare AGD and GD on *identical* data, which is what
makes the oracle comparison valid (SURVEY §3.4).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def generate_gd_input(
    intercept: float,
    slope: float,
    n_points: int,
    seed: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """Labels ~ Bernoulli(sigmoid(intercept + slope * x)), x ~ N(0, 1).

    Returns ``(X, y)`` with ``X`` of shape (n, 1) — features only, no
    intercept column (matching the MLlib generator's output shape).
    """
    rng = np.random.default_rng(seed)
    x = rng.normal(size=n_points)
    # logistic noise: yVal = A + B*x + logit(U) > 0  <=>  U < sigmoid(A+B*x)
    u = rng.random(n_points)
    y = ((intercept + slope * x + np.log(u) - np.log1p(-u)) > 0.0)
    return x[:, None].astype(np.float64), y.astype(np.float64)


def with_intercept_column(X: np.ndarray) -> np.ndarray:
    """Prepend the all-ones intercept column (reference Suite:47-49)."""
    return np.concatenate([np.ones((X.shape[0], 1), X.dtype), X], axis=1)


def generate_linear_input(
    weights: np.ndarray,
    n_points: int,
    seed: int,
    noise: float = 0.1,
) -> Tuple[np.ndarray, np.ndarray]:
    """Dense least-squares data: y = X @ w + noise (BASELINE config 2)."""
    rng = np.random.default_rng(seed)
    d = len(weights)
    X = rng.normal(size=(n_points, d))
    y = X @ np.asarray(weights) + noise * rng.normal(size=n_points)
    return X, y


def generate_multiclass_input(
    n_points: int,
    n_features: int,
    n_classes: int,
    seed: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """Softmax-separable classes (BASELINE config 4 shape)."""
    rng = np.random.default_rng(seed)
    W = rng.normal(size=(n_features, n_classes))
    X = rng.normal(size=(n_points, n_features))
    logits = X @ W + rng.gumbel(size=(n_points, n_classes))
    return X, np.argmax(logits, axis=1).astype(np.int32)
