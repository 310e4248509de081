"""Batched inference over a fixed ladder of padded batch shapes.

Counterpart of ``spark_agd_tpu/serve/engine.py``.  The JAX engine
compiles one XLA executable per (op, bucket) ahead of time so that the
request path never compiles; this engine keeps the same contract in the
form PyTorch gives it:

- **one program per (op, bucket)**: a plain function on tensors (``X @ w
  + b``, then a sigmoid, softmax, argmax or threshold: the model classes'
  own math) with one input buffer and one output buffer, both allocated
  at construction on the engine's device;
- **construction runs every program once**, so the cuBLAS handle and
  its workspace exist before the first request; ``compile_census``
  counts one entry per program and never changes afterwards;
- **weights are arguments**: ``bind`` swaps a same-spec generation's
  weights in under the engine's lock, so in-flight batches finish on
  the old generation and the next batch serves the new one; a
  different spec raises :class:`ServeSpecMismatch`, as in the JAX
  package;
- **batch shapes come from a fixed ladder** (powers of two up to
  ``max_batch``): a request pads to the nearest bucket with zero rows,
  which are sliced off before the caller sees them.

The products are ``torch.matmul``, as the JAX package leaves them to XLA
outside any Pallas kernel (``spark_agd_tpu/ops/sparse.py:278``).  The
engine runs eagerly; it launches on the card unless it is given
``device="cpu"``, and it never moves work to another device.

``telemetry=`` emits the JAX package's ``serve_warmup`` span and one
``engine_call`` trace span a batch; the ``program_cost`` records of
the JAX engine's compiled programs come with the profiling and analysis
slice.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .._device import resolve_device
from ..ops.losses import _mm

# model class name -> the short kind the program labels use
_KIND_SHORT = {
    "LogisticRegressionModel": "logistic",
    "SVMModel": "svm",
    "LinearRegressionModel": "linear",
    "SoftmaxRegressionModel": "softmax",
    "MLPModel": "mlp",
}

# ops each kind serves; SVM/linear have no probability (mirrors the
# model classes' own method surface)
_KIND_OPS = {
    "logistic": ("predict", "predict_proba"),
    "svm": ("predict",),
    "linear": ("predict",),
    "softmax": ("predict", "predict_proba"),
    "mlp": ("predict", "predict_proba"),
}

DEFAULT_MAX_BATCH = 64
DEFAULT_MIN_BUCKET = 8


class ServeSpecMismatch(ValueError):
    """A hot-swap candidate's shape signature differs from the programs
    the engine built (different feature count, class count, threshold
    mode, activation, or dtype).  Classified FATAL by the resilience
    taxonomy (``ValueError``): the fix is a new engine, not a retry."""


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    """The shape signature of a servable model — everything the programs
    and their buffers are built for (weights are NOT part of it; they
    stay arguments so generations sharing a spec share programs)."""

    kind: str                 # _KIND_SHORT value
    n_features: int
    num_classes: int          # 1 for the binary/regression family
    dtype: str                # weights dtype string, e.g. "float32"
    has_threshold: bool = False
    activation: Optional[str] = None  # MLP only
    hidden_units: int = 0             # MLP only

    @property
    def ops(self) -> Tuple[str, ...]:
        return _KIND_OPS[self.kind]


def _dtype_name(t: torch.Tensor) -> str:
    """``"float32"`` for ``torch.float32``: the JAX package's spelling."""
    return str(t.dtype).removeprefix("torch.")


def spec_of(model) -> ModelSpec:
    """Derive the shape signature of any registered model class."""
    name = type(model).__name__
    kind = _KIND_SHORT.get(name)
    if kind is None:
        raise TypeError(
            f"{name} is not a servable model class; known: "
            f"{sorted(_KIND_SHORT)}")
    if kind == "mlp":
        from ..models.mlp import _ACTIVATIONS

        act = next((n for n, f in _ACTIVATIONS.items()
                    if f is model.activation), None)
        if act is None:
            raise ValueError(
                "cannot serve an MLP with an unregistered activation "
                f"callable; known: {sorted(_ACTIVATIONS)}")
        d, h = model.params["W1"].shape
        k = model.params["W2"].shape[1]
        return ModelSpec(kind, int(d), int(k),
                         _dtype_name(model.params["W1"]),
                         activation=act, hidden_units=int(h))
    w = model.weights
    if kind == "softmax":
        return ModelSpec(kind, int(w.shape[0]), int(w.shape[1]),
                         _dtype_name(w))
    return ModelSpec(kind, int(w.shape[0]), 1, _dtype_name(w),
                     has_threshold=getattr(model, "threshold",
                                           None) is not None)


def params_of(model, spec: Optional[ModelSpec] = None, *,
              device=None) -> Dict[str, Any]:
    """The model's weights as the argument dict the programs take, on
    ``device`` when given (else where the model lies).  Scalars
    (intercept, threshold) are cast to the weights dtype, as the JAX
    package casts them."""
    spec = spec or spec_of(model)

    def place(t):
        t = torch.as_tensor(t)
        return t if device is None else t.to(device)

    if spec.kind == "mlp":
        return {k: place(v) for k, v in model.params.items()}
    w = place(model.weights)
    params: Dict[str, Any] = {
        "w": w, "b": torch.as_tensor(model.intercept, dtype=w.dtype,
                                     device=w.device)}
    if spec.has_threshold:
        params["thr"] = torch.as_tensor(model.threshold, dtype=w.dtype,
                                        device=w.device)
    return params


def _make_forward(spec: ModelSpec, op: str) -> Callable:
    """The ``(params, X) -> values`` function for one (kind, op) — the
    port model classes' own math, on a padded batch."""
    if op not in spec.ops:
        raise ValueError(
            f"op {op!r} is not served for kind {spec.kind!r} "
            f"(supported: {spec.ops})")
    kind = spec.kind

    def forward(params, X):
        if kind == "mlp":
            from ..models.mlp import _ACTIVATIONS, mlp_forward

            logits = mlp_forward(params, X, _ACTIVATIONS[spec.activation])
            if op == "predict_proba":
                return torch.softmax(logits, dim=-1)
            return torch.argmax(logits, dim=-1)
        if kind == "softmax":
            logits = _mm(X, params["w"]) + params["b"]
            if op == "predict_proba":
                return torch.softmax(logits, dim=-1)
            return torch.argmax(logits, dim=-1)
        margin = _mm(X, params["w"]) + params["b"]
        if kind == "logistic":
            p = torch.sigmoid(margin)
            if op == "predict_proba":
                return p
            if spec.has_threshold:
                return (p > params["thr"]).to(torch.float32)
            return p
        # svm / linear predict
        if kind == "svm" and spec.has_threshold:
            return (margin > params["thr"]).to(torch.float32)
        return margin

    return forward


class BucketLadder:
    """The fixed padding-shape ladder: powers of two from ``min_bucket``
    up to ``max_batch`` (``max_batch`` itself is always a rung, even
    when it is not a power of two).  ``bucket_for(n)`` maps any
    admissible request size to the smallest rung that holds it."""

    def __init__(self, max_batch: int = DEFAULT_MAX_BATCH,
                 min_bucket: int = DEFAULT_MIN_BUCKET,
                 buckets: Optional[Sequence[int]] = None):
        max_batch = int(max_batch)
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if buckets is None:
            b = min(int(min_bucket), max_batch)
            ladder = []
            while b < max_batch:
                ladder.append(b)
                b *= 2
            ladder.append(max_batch)
        else:
            ladder = sorted({int(b) for b in buckets})
            if not ladder or ladder[0] < 1:
                raise ValueError(f"invalid bucket ladder {buckets!r}")
            if ladder[-1] != max_batch:
                raise ValueError(
                    f"the top bucket must equal max_batch={max_batch}, "
                    f"got {ladder!r}")
        self.buckets: Tuple[int, ...] = tuple(ladder)
        self.max_batch = max_batch

    def bucket_for(self, n: int) -> int:
        if n < 1 or n > self.max_batch:
            raise ValueError(
                f"batch of {n} rows is not admissible (1 <= n <= "
                f"max_batch={self.max_batch})")
        for b in self.buckets:
            if n <= b:
                return b
        raise AssertionError("unreachable: ladder tops at max_batch")

    def __repr__(self):
        return f"BucketLadder{self.buckets}"


@dataclasses.dataclass
class _Program:
    """One (op, bucket) program: its forward and its two buffers."""

    forward: Callable
    inbuf: torch.Tensor       # (bucket, n_features), padding rows zero
    out: torch.Tensor         # the output of one call


class ServeEngine:
    """See module docstring.  Construction builds and runs every (op,
    bucket) program (an engine that exists can serve); ``bind``
    hot-swaps a new same-spec generation's weights.

    Thread-safety: ``serve_batch``/``predict``/``bind`` serialize on one
    internal lock (each program owns one pair of buffers); the
    micro-batching queue is the concurrency layer above.
    """

    def __init__(self, model, *, generation: int = 0,
                 max_batch: int = DEFAULT_MAX_BATCH,
                 min_bucket: int = DEFAULT_MIN_BUCKET,
                 buckets: Optional[Sequence[int]] = None,
                 ops: Optional[Sequence[str]] = None,
                 telemetry=None, device=None):
        self.device = resolve_device(device)
        self.spec = spec_of(model)
        self.ladder = BucketLadder(max_batch, min_bucket, buckets)
        self.ops: Tuple[str, ...] = tuple(ops or self.spec.ops)
        for op in self.ops:
            if op not in self.spec.ops:
                raise ValueError(
                    f"op {op!r} not served for kind {self.spec.kind!r} "
                    f"(supported: {self.spec.ops})")
        self.telemetry = telemetry
        self._lock = threading.Lock()
        self._params = params_of(model, self.spec, device=self.device)
        self._generation = int(generation)
        self._np_dtype = np.dtype(self.spec.dtype)
        self._dtype = getattr(torch, self.spec.dtype)
        self.hot_swaps = 0
        self._programs: Dict[Tuple[str, int], _Program] = {}
        self._build_programs()

    # -- warmup (build the whole ladder, run each program once) -----------
    def _build_programs(self) -> None:
        # the JAX package's ``serve_warmup`` span; its ``program_cost``
        # records (compiled-program introspection) come with the
        # profiling and analysis slice
        with (self.telemetry.span("serve_warmup")
              if self.telemetry is not None else contextlib.nullcontext()):
            for op in self.ops:
                forward = _make_forward(self.spec, op)
                for bucket in self.ladder.buckets:
                    inbuf = torch.zeros((bucket, self.spec.n_features),
                                        dtype=self._dtype,
                                        device=self.device)
                    out = forward(self._params, inbuf).clone()
                    self._programs[(op, bucket)] = _Program(forward, inbuf,
                                                            out)
            self.warm()

    def warm(self) -> None:
        """Run every program once on the calling thread (its buffers'
        contents are scratch): the handles and workspaces a product
        needs on this thread exist before the first request.  The queue's
        worker calls it when it starts."""
        with self._lock:
            for prog in self._programs.values():
                prog.out.copy_(prog.forward(self._params, prog.inbuf))
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)

    # -- introspection -----------------------------------------------------
    @property
    def generation(self) -> int:
        return self._generation

    @property
    def max_batch(self) -> int:
        return self.ladder.max_batch

    def compile_census(self) -> Dict[str, int]:
        """One entry per (op, bucket) program, each built once at
        construction; serving never adds an entry or a count."""
        return {f"{op}/b{bucket}": 1 for (op, bucket) in self._programs}

    # -- hot swap ----------------------------------------------------------
    def bind(self, model, generation: int) -> None:
        """Swap in a new generation's weights.  The spec must match the
        built programs (else :class:`ServeSpecMismatch`); an in-flight
        batch finishes on the old weights — the swap waits for the call
        lock, never interrupts."""
        new_spec = spec_of(model)
        if new_spec != self.spec:
            raise ServeSpecMismatch(
                f"generation {generation} has spec {new_spec}, engine "
                f"built for {self.spec}; refusing a hot swap that "
                "would rebuild the programs on the request path")
        # the new weights are placed on the device first, on this
        # thread's stream; under the lock only the params reference flips
        # (no copy into the old tensors), so a batch reads one generation
        new_params = params_of(model, new_spec, device=self.device)
        with self._lock:
            self._params = new_params
            self._generation = int(generation)
            self.hot_swaps += 1

    # -- the serving path --------------------------------------------------
    def serve_batch(self, X, op: str = "predict"
                    ) -> Tuple[np.ndarray, int, int]:
        """Serve one coalesced batch: pad to the nearest bucket, run the
        program, slice the padding back off.  Returns ``(values,
        generation, bucket)`` with ``values`` on the host.  Raises
        ``ValueError`` for inadmissible sizes or ops."""
        if op not in self.ops:
            raise ValueError(
                f"op {op!r} not served for kind {self.spec.kind!r} "
                f"(supported: {self.ops})")
        X = np.ascontiguousarray(X, dtype=self._np_dtype)
        if X.ndim != 2 or X.shape[1] != self.spec.n_features:
            raise ValueError(
                f"expected a (n, {self.spec.n_features}) batch, got "
                f"shape {X.shape}")
        n = X.shape[0]
        bucket = self.ladder.bucket_for(n)
        prog = self._programs.get((op, bucket))
        if prog is None:
            raise ValueError(
                f"no program for op={op!r} bucket={bucket} "
                f"(ops: {self.ops}, ladder: {self.ladder.buckets})")
        with self._lock:
            generation = self._generation
            # one causal ``engine_call`` span a batch (obs.trace): it
            # inherits the queue's serve_batch context through the
            # context variable (the same worker thread)
            with (self.telemetry.trace_span(
                    "engine_call", op=op, bucket=bucket,
                    generation=generation, tool="serve.engine")
                  if self.telemetry is not None
                  else contextlib.nullcontext()):
                prog.inbuf[:n].copy_(torch.from_numpy(X))
                if n < bucket:
                    prog.inbuf[n:].zero_()
                prog.out.copy_(prog.forward(self._params, prog.inbuf))
                # the host copy owns its memory: the output buffer is
                # the next call's
                host = prog.out[:n].to("cpu", copy=True).numpy()
        return host, generation, bucket

    def predict(self, X, op: str = "predict") -> np.ndarray:
        """Direct (queue-less) convenience: serve ``X`` of any size,
        chunking batches larger than ``max_batch`` through the top
        bucket.  Results concatenated on the host."""
        X = np.asarray(X, dtype=self._np_dtype)
        squeeze = X.ndim == 1
        if squeeze:
            X = X[None, :]
        chunks: List[np.ndarray] = []
        top = self.ladder.max_batch
        for start in range(0, X.shape[0], top):
            chunks.append(self.serve_batch(X[start:start + top], op)[0])
        vals = chunks[0] if len(chunks) == 1 else np.concatenate(chunks)
        return vals[0] if squeeze else vals

    def __repr__(self):
        return (f"ServeEngine(kind={self.spec.kind}, "
                f"d={self.spec.n_features}, ops={self.ops}, "
                f"ladder={self.ladder.buckets}, "
                f"generation={self._generation}, device={self.device})")
