"""Macro-batch streaming: full-batch AGD on data larger than the card.

Counterpart of ``spark_agd_tpu/data/streaming.py``.  AGD is a full-batch
method: every smooth evaluation sees every example.  When the dataset
does not fit the card's memory it streams through in macro-batches:
each batch's kernel forms the batch's sums (the reference's
``treeAggregate`` seqOp, reference ``:196-204``), the sums are added on
the card in batch order (the combOp), and the mean is taken once at the
end.  A streamed smooth holds a host loop, so it pairs with the host
drivers: ``core.host_agd.run_agd_host``, and ``run_agd_host_multi`` /
``core.host_lbfgs.run_lbfgs_host_multi`` for the K-lane sweeps.

Placement on the card:

- host-to-card copies are ``copy_(non_blocking=True)`` on a side CUDA
  stream from page-locked (pinned) host memory: a ring of reused pinned
  staging buffers, page-locked at their exact size with
  ``cudaHostRegister``.  A source tensor that is already pinned (see
  :func:`pin_host`) is sliced and copied directly, with no staging copy;
- a staging buffer is not refilled before its earlier copy has finished:
  the filling thread waits on that copy's event first;
- the card's copy of a batch is allocated on the side stream and marked
  with ``record_stream`` for the compute stream, so the caching
  allocator does not hand its memory out while a kernel still reads it;
  the compute stream waits on an event recorded after the batch's
  copies;
- the host runs at most ``prefetch + 1`` batches ahead of the card, so
  the card holds at most ``prefetch + 2`` batches at once, whatever the
  dataset's size;
- :func:`fold_stream` launches batch i's kernel before batch i+1 is
  prepared, adds the batch sums in batch order (a pass gives the same
  bits on repeat, and ``prefetch=0`` the same bits as ``prefetch=k``),
  and sums the per-batch counts once, after the pass;
- the prefetch thread (:class:`_Prefetcher`) does host work only: it
  reads, parses, pads and fills the pinned buffers.  Copies and kernel
  launches stay on the consuming thread.

With ``device="cpu"`` the batches are used where they lie, the fused
gradients run their plain versions, and nothing is pinned.  Counts are
Python ints (no wrap at any scale).

With ``mesh=`` (a data-axis ``parallel.mesh.Mesh``) each macro-batch is
sharded over the mesh as the in-memory mesh path shards its data: dense
by ``mesh.shard_batch`` (views of the batch, a shard copied to its slot),
CSR by the nnz-balanced ``mesh.shard_csr_batch`` under one fixed entry
budget a shard (``csr_nnz_per_shard``); each slot evaluates its shard and
the slots' sums are added in slot order (``parallel.dist_smooth``).  On
the card the placement is the one above, a pinned ring and side stream
for each distinct slot device: each device's rows (dense) or stacked
shards (CSR) are staged and copied as one run, and each slot's shard is a
view of it, so slots that repeat one card copy the batch once.
"""

from __future__ import annotations

import collections
import dataclasses
import logging
import queue
import threading
import time
import warnings
import weakref
from typing import (Callable, Iterable, Iterator, NamedTuple, Optional,
                    Tuple)

import numpy as np
import torch

from .._device import resolve_device, same_device
from .._later import reject_grid_mesh, reject_later
from ..core import tvec
from ..ops.losses import Gradient
from ..ops.sparse import CSRMatrix, _values_tensor
from ..parallel.mesh import host_tensor
from ..resilience import retry as retry_lib
from ..resilience.errors import StreamDataLoss

logger = logging.getLogger("spark_agd_tpu")


def iter_array_batches(X, y, batch_rows: int,
                       mask=None) -> Iterator[Tuple]:
    """Slice in-memory arrays into macro-batches (an ``np.memmap`` slices
    lazily, so this also serves on-disk dense data)."""
    n = X.shape[0]
    for s in range(0, n, batch_rows):
        e = min(s + batch_rows, n)
        yield X[s:e], y[s:e], None if mask is None else mask[s:e]


def _max_batch_nnz(indptr, batch_rows: int) -> int:
    """Largest entry count of any ``batch_rows``-row slice: the one
    batching-boundary computation, shared by the padding loop and the
    ``from_libsvm_parts`` shape inference so they cannot disagree."""
    indptr = np.asarray(indptr)
    n = len(indptr) - 1
    starts = np.arange(0, n, batch_rows)
    if not len(starts):
        return 0
    return max(1, int(np.max(
        indptr[np.minimum(starts + batch_rows, n)] - indptr[starts])))


def iter_csr_batches(indptr, indices, values, n_features: int, y,
                     batch_rows: int, mask=None,
                     with_csc="lazy",
                     nnz_pad: Optional[int] = None) -> Iterator[Tuple]:
    """Slice host CSR arrays into fixed-shape macro-batches: CPU
    :class:`~spark_agd_tpu_torch.ops.sparse.CSRMatrix` batches with numpy
    ``y`` and mask, the JAX package's batches entry for entry.

    Every batch is padded to the same ``(batch_rows, nnz_pad)``, by
    default the largest per-batch entry count (from ``indptr``); pass
    ``nnz_pad`` when batches from several sources must share one shape
    (``StreamingDataset.from_libsvm_parts``).  Padding follows the
    ``ops.sparse`` contract: inert 0.0 entries at the last row/column
    slot (ids stay nondecreasing), padded row slots masked 0.

    ``with_csc="lazy"`` (default) marks each batch as wanting the
    column-sorted twin (``CSRMatrix.want_csc``), and placement builds it
    on the card, a sort per batch.  ``True`` builds each batch's twin on
    the host (a stable argsort); ``False`` builds none (the transpose
    product then builds it at each evaluation).
    """
    indptr = np.asarray(indptr)
    indices = np.asarray(indices, np.int32)
    values = np.asarray(values)
    y = np.asarray(y)
    n = len(indptr) - 1
    starts = np.arange(0, n, batch_rows)
    if not len(starts):  # empty input: yield nothing, like the dense twin
        return
    max_batch_nnz = _max_batch_nnz(indptr, batch_rows)
    if nnz_pad is None:
        nnz_pad = max_batch_nnz
    elif max_batch_nnz > nnz_pad:
        raise ValueError(
            f"a macro-batch holds {max_batch_nnz} entries > nnz_pad="
            f"{nnz_pad}; raise nnz_pad (one shape must fit every batch; "
            f"from_libsvm_parts callers: pass nnz_pad sized for the "
            f"densest part)")
    for s in starts.tolist():
        e = min(s + batch_rows, n)
        lo, hi = int(indptr[s]), int(indptr[e])
        k = hi - lo
        rid = np.full(nnz_pad, batch_rows - 1, np.int32)
        cid = np.full(nnz_pad, n_features - 1, np.int32)
        val = np.zeros(nnz_pad, values.dtype)
        rid[:k] = np.repeat(np.arange(e - s, dtype=np.int32),
                            np.diff(indptr[s:e + 1]))
        cid[:k] = indices[lo:hi]
        val[:k] = values[lo:hi]
        csc = {}
        if with_csc == "lazy":
            csc = dict(want_csc=True)
        elif with_csc:
            order = np.argsort(cid[:k], kind="stable")
            crid = np.full(nnz_pad, batch_rows - 1, np.int32)
            ccid = np.full(nnz_pad, n_features - 1, np.int32)
            cval = np.zeros(nnz_pad, values.dtype)
            crid[:k] = rid[:k][order]
            ccid[:k] = cid[:k][order]
            cval[:k] = val[:k][order]
            csc = dict(csc_row_ids=torch.from_numpy(crid),
                       csc_col_ids=torch.from_numpy(ccid),
                       csc_values=_values_tensor(cval))
        Xb = CSRMatrix(torch.from_numpy(rid), torch.from_numpy(cid),
                       _values_tensor(val), (batch_rows, int(n_features)),
                       rows_sorted=True, **csc)
        yb = np.zeros(batch_rows, y.dtype)
        yb[:e - s] = y[s:e]
        mb = np.zeros(batch_rows, np.float32)
        mb[:e - s] = (np.ones(e - s, np.float32) if mask is None
                      else np.asarray(mask[s:e], np.float32))
        yield Xb, yb, mb


@dataclasses.dataclass(frozen=True)
class QuarantinePolicy:
    """When may a streamed epoch continue after poisoned shards?

    A shard that still fails parse/validation after its retry budget is
    quarantined: skipped for the rest of the process's life (sticky, so
    the batch sequence is the same on every later pass) while the epoch
    continues degraded.  ``min_data_fraction`` is the honesty floor:
    once fewer than this fraction of shards is healthy the stream
    refuses with a typed
    :class:`~spark_agd_tpu_torch.resilience.errors.StreamDataLoss`
    instead of fitting a sliver of the data."""

    min_data_fraction: float = 0.5

    def __post_init__(self):
        if not 0.0 <= self.min_data_fraction <= 1.0:
            raise ValueError("min_data_fraction must be in [0, 1]")


class StreamCursor(NamedTuple):
    """Mid-epoch resume point: which pass (since the last boundary
    checkpoint), which batch within it, plus the accumulator carry.

    ``pass_offset`` counts smooth/smooth-loss passes begun since the
    last boundary commit; ``batch_index`` is the number of batches
    already folded into ``acc_leaves``; ``n`` is the row count so far.
    Leaves round-trip through npz as exact bytes, so a resumed pass is
    bit-identical to the uninterrupted one."""

    pass_offset: int
    batch_index: int
    n: int
    acc_leaves: Tuple[np.ndarray, ...]


# npz entry names of an encoded cursor (the JAX package's), under the
# ``stream_`` namespace the checkpoint format reserves for rider entries
_CUR_PASS = "stream_pass"
_CUR_BATCH = "stream_batch"
_CUR_N = "stream_n"
_CUR_LEN = "stream_acc_len"
_CUR_ACC = "stream_acc_"


def _host_array(x) -> np.ndarray:
    """A leaf (tensor on any device, or array) as a numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def cursor_to_extra(cursor: StreamCursor) -> dict:
    """Encode a cursor as checkpoint rider entries (plain arrays)."""
    extra = {_CUR_PASS: np.asarray(int(cursor.pass_offset)),
             _CUR_BATCH: np.asarray(int(cursor.batch_index)),
             _CUR_N: np.asarray(int(cursor.n), np.int64),
             _CUR_LEN: np.asarray(len(cursor.acc_leaves))}
    for i, leaf in enumerate(cursor.acc_leaves):
        extra[f"{_CUR_ACC}{i}"] = _host_array(leaf)
    return extra


def cursor_from_extras(extras) -> Optional[StreamCursor]:
    """Decode the cursor out of loaded checkpoint extras; None when the
    entries are absent or torn (the epoch then restarts from the
    boundary: correct, just slower)."""
    if not extras or _CUR_PASS not in extras:
        return None
    try:
        k = int(extras[_CUR_LEN])
        leaves = tuple(np.asarray(extras[f"{_CUR_ACC}{i}"])
                       for i in range(k))
        return StreamCursor(int(extras[_CUR_PASS]),
                            int(extras[_CUR_BATCH]),
                            int(extras[_CUR_N]), leaves)
    except KeyError:
        return None


class AbandonedAttempt(RuntimeError):
    """Raised in a supervised attempt that the watchdog gave up on, at
    its next pass or commit, once a retry has claimed the
    :class:`StreamCheckpoint`: the abandoned attempt stops there, before
    it touches the pass counter or the checkpoint again."""


class StreamCheckpoint:
    """The mid-epoch commit protocol between :func:`fold_stream` and a
    checkpointer: every ``every_batches`` folded batches the current
    :class:`StreamCursor` is saved as rider entries on the last boundary
    warm state (``checkpointer.update_stream(extra) -> bool``), so a
    preemption mid-pass resumes from the boundary and replays forward to
    the cursor, skipping the committed batches without running their
    kernels, instead of restarting the epoch.

    The checkpointer is duck-typed: it has ``stream_hook`` (set to this
    object here), ``update_stream`` and ``loaded_extras`` (rider entries
    of a loaded checkpoint, adopted here).  ``on_commit(count)``
    (optional) fires after each commit.

    A supervisor calls :meth:`on_attempt` from the thread of each
    attempt it starts: the pass counter goes back to the boundary, and
    from then on only that thread may begin a pass or commit (another
    thread gets :class:`AbandonedAttempt`), so an attempt that timed out
    and still runs can neither shift the retry's pass ordinals nor write
    a cursor of its own."""

    def __init__(self, checkpointer, *, every_batches: int,
                 on_commit: Optional[Callable[[int], None]] = None):
        if every_batches < 1:
            raise ValueError("every_batches must be >= 1")
        self.checkpointer = checkpointer
        self.every_batches = int(every_batches)
        self.on_commit = on_commit
        self.commits = 0
        self._pass = 0  # passes begun since the last boundary commit
        self._pending: Optional[StreamCursor] = None
        self._armed: Optional[StreamCursor] = None  # pending at boundary
        self._owner: Optional[int] = None  # the live attempt's thread
        self._lock = threading.Lock()
        checkpointer.stream_hook = self
        if getattr(checkpointer, "loaded_extras", None):
            self.adopt(checkpointer.loaded_extras)

    def _check_owner(self) -> None:
        if self._owner is not None \
                and self._owner != threading.get_ident():
            raise AbandonedAttempt(
                "a retry took over this attempt's streamed passes")

    def begin_pass(self) -> Tuple[int, Optional[StreamCursor]]:
        """Start one streamed pass: returns ``(ordinal, cursor)`` where
        the cursor is non-None exactly when this pass is the one a
        loaded checkpoint interrupted (consumed once)."""
        with self._lock:
            self._check_owner()
            ordinal = self._pass
            self._pass += 1
            cur = None
            if self._pending is not None \
                    and self._pending.pass_offset == ordinal:
                cur = self._pending
                self._pending = None
            return ordinal, cur

    def maybe_commit(self, ordinal: int, batch_index: int, acc,
                     ns) -> bool:
        """Commit the cursor when the batch cadence is due.  ``acc`` is
        the live accumulator (its leaves come to the host: the one sync
        point of a streamed pass), ``ns`` the per-batch count list."""
        if batch_index % self.every_batches:
            return False
        leaves = tuple(_host_array(x) for x in tvec.leaves(acc))
        cur = StreamCursor(int(ordinal), int(batch_index),
                           sum(int(x) for x in ns), leaves)
        with self._lock:
            self._check_owner()
            if not self.checkpointer.update_stream(cursor_to_extra(cur)):
                return False  # no boundary carry yet to anchor the cursor
            self.commits += 1
        if self.on_commit is not None:
            self.on_commit(self.commits)
        return True

    # -- checkpointer hook interface --------------------------------------
    def on_attempt(self) -> None:
        """An attempt starts on the calling thread, from the last
        boundary carry: its passes count from 0 again, a cursor armed
        at the boundary is armed again, and the thread owns the
        protocol until the next attempt starts."""
        with self._lock:
            self._owner = threading.get_ident()
            self._pass = 0
            self._pending = self._armed

    def on_boundary(self) -> None:
        """A boundary commit landed: the pass counter resets and any
        not-yet-consumed cursor is stale.  A boundary seen before any
        pass began keeps the pending cursor (nothing was replayed)."""
        with self._lock:
            if self._pass > 0:
                self._pending = self._armed = None
            self._pass = 0

    def adopt(self, extras) -> None:
        """Arm the pending cursor from loaded checkpoint extras."""
        cur = cursor_from_extras(extras)
        if cur is not None:
            with self._lock:
                self._pending = self._armed = cur


class StreamingDataset:
    """A re-iterable source of ``(X, y, mask)`` macro-batches.

    ``factory`` is a zero-argument callable returning a fresh iterator:
    AGD evaluates the smooth function 2-3 times per outer iteration, so
    a one-shot generator is ruled out by the interface.
    """

    def __init__(self, factory: Callable[[], Iterable[Tuple]],
                 batch_rows: Optional[int] = None):
        self._factory = factory
        self.batch_rows = batch_rows
        # path -> reason for shards the reader quarantined
        # (``from_libsvm_parts(quarantine=...)``); empty otherwise
        self.quarantined: dict = {}

    @classmethod
    def from_arrays(cls, X, y, batch_rows: int, mask=None):
        """Macro-batches of rows of ``X`` (numpy array, memmap or CPU
        tensor; a pinned tensor is copied to the card without staging)."""
        return cls(lambda: iter_array_batches(X, y, batch_rows, mask),
                   batch_rows)

    @classmethod
    def from_csr(cls, indptr, indices, values, n_features: int, y,
                 batch_rows: int, mask=None, with_csc="lazy",
                 nnz_pad: Optional[int] = None):
        """Macro-batches over host CSR arrays (``data.libsvm.CSRData``'s
        fields); see :func:`iter_csr_batches`."""
        return cls(lambda: iter_csr_batches(
            indptr, indices, values, n_features, y, batch_rows, mask,
            with_csc, nnz_pad=nnz_pad), batch_rows)

    @classmethod
    def from_libsvm_parts(cls, paths, n_features: int, batch_rows: int,
                          with_csc="lazy",
                          nnz_pad: Optional[int] = None,
                          binarize_labels: bool = True,
                          retries=None, telemetry=None,
                          validate=False,
                          quarantine=None,
                          read_timeout: Optional[float] = None,
                          chaos=None):
        """Stream LIBSVM partition files (a Spark job's part-* output,
        for example) as fixed-shape CSR macro-batches without holding the
        whole dataset: one part is parsed (C++ parser, Python fallback)
        at a time, and each pass reads the parts from disk again.

        ``nnz_pad`` must bound every batch; by default it is sized from
        the first non-empty part (its largest batch, +25%, rounded up to
        128; that parse is kept for the first pass).  A later, denser
        part raises mid-stream: pass ``nnz_pad`` when part density
        varies.  ``n_features`` is required, and an index outside it
        fails at parse time.

        Fault hardening (every pass reads every part):

        - ``retries`` (a ``resilience.RetryPolicy``, default
          ``ingest.DEFAULT_READ_RETRIES``): each shard read runs under
          the retry engine; transient IO errors back off and re-read;
        - ``read_timeout`` (seconds per attempt): a reader that hangs
          raises a TRANSIENT ``AttemptTimeout``;
        - ``validate`` (``False`` / ``"raise"`` / ``"drop"``): typed
          ``DataValidationError`` on the first bad row, or the bad rows
          dropped and logged;
        - ``quarantine`` (``True`` / :class:`QuarantinePolicy` /
          ``None``): a shard still failing after its retries is skipped
          (sticky, on ``dataset.quarantined``) until fewer than
          ``min_data_fraction`` of the shards survive, and then the
          stream raises
          :class:`~spark_agd_tpu_torch.resilience.errors.StreamDataLoss`;
        - ``chaos`` (a ``resilience.chaos.ChaosSchedule``): fault
          injection for drills: ``before_shard(visit, path=...)`` fires
          inside each retried shard read (``visit`` counts the shard
          reads of every pass), so ``slow_reader``/``hang_reader``
          sleeps run under the watchdog and ``corrupt_shard`` garbles
          the file before the parse that finds it.

        ``telemetry=`` comes with the observability slice and raises.
        """
        from . import ingest, libsvm

        reject_later(telemetry=telemetry)
        paths = list(paths)
        if not paths:
            raise ValueError("from_libsvm_parts needs at least one path")
        if validate not in (False, "raise", "drop"):
            raise ValueError(
                f"validate must be False, 'raise', or 'drop'; "
                f"got {validate!r}")
        if quarantine is True:
            quarantine = QuarantinePolicy()
        policy = retries if retries is not None \
            else ingest.DEFAULT_READ_RETRIES
        if read_timeout is not None:
            policy = dataclasses.replace(
                policy, attempt_timeout=float(read_timeout))
        quarantined: dict = {}
        visit = [0]  # cumulative shard-read index (chaos at_iter axis)

        def parse_part(path, visit_index=0, use_chaos=True):
            """One attempt at one shard: the chaos hook (inside the
            retry loop, under the watchdog), parse, index-range check,
            validation policy."""
            if use_chaos and chaos is not None:
                chaos.before_shard(visit_index, path=path)
            d = libsvm.load_libsvm(path, n_features=n_features)
            if len(d.indices) and int(d.indices.max()) >= n_features:
                raise ValueError(
                    f"{path}: feature index {int(d.indices.max())} >= "
                    f"n_features={n_features}: an undersized feature "
                    f"space would clamp or drop entries in the products")
            if validate:
                d = ingest._validated_parts([path], [d], n_features,
                                            validate, None)[0]
            y = d.binarized_labels() if binarize_labels else d.labels
            return d.indptr, d.indices, d.values, y.astype(np.float32)

        def load_part(path):
            """One shard under the retry/quarantine contract; None =
            quarantined (skip), any raise is fatal for the epoch."""
            vi = visit[0]
            visit[0] += 1
            attempts = [1]

            def on_retry(n_failures, exc, delay):
                attempts[0] = n_failures + 1
                logger.warning(
                    "stream shard read failed (%s: %s); retry %d/%d "
                    "in %.2fs", type(exc).__name__, exc, n_failures,
                    policy.max_attempts - 1, delay)

            try:
                return retry_lib.call_with_retry(
                    parse_part, path, visit_index=vi, policy=policy,
                    label="stream_shard", on_retry=on_retry)
            except Exception as e:  # noqa: BLE001 — policy applied below
                if quarantine is None:
                    raise
                quarantined[path] = f"{type(e).__name__}: {e}"
                healthy = len(paths) - len(quarantined)
                frac = healthy / len(paths)
                logger.warning(
                    "quarantining shard %s after %d attempt(s): %s "
                    "(%d/%d shards healthy)", path, attempts[0],
                    quarantined[path], healthy, len(paths))
                if frac < quarantine.min_data_fraction:
                    raise StreamDataLoss(
                        healthy, len(paths),
                        quarantine.min_data_fraction) from e
                return None

        first_cache = {}
        if nnz_pad is None:
            # shape inference runs outside the chaos and quarantine
            # paths: construction fails loudly on unreadable data rather
            # than sizing the shape off a degraded subset
            for path in paths:  # the first non-empty part sizes the shape
                arrays = retry_lib.call_with_retry(
                    parse_part, path, use_chaos=False, policy=policy,
                    label="stream_shard")
                m0 = _max_batch_nnz(arrays[0], batch_rows)
                if m0:
                    first_cache[path] = arrays
                    nnz_pad = -(-int(m0 * 1.25) // 128) * 128
                    break
            else:
                raise ValueError("all parts are empty")

        def factory():
            for path in paths:
                if path in quarantined:  # sticky: stable batch sequence
                    continue
                # the inference parse is reused exactly once (first pass)
                arrays = first_cache.pop(path, None)
                if arrays is None:
                    arrays = load_part(path)
                if arrays is None:
                    continue
                yield from iter_csr_batches(
                    *arrays[:3], n_features, arrays[3], batch_rows,
                    with_csc=with_csc, nnz_pad=nnz_pad)

        ds = cls(factory, batch_rows)
        ds.quarantined = quarantined
        return ds

    def __iter__(self):
        return iter(self._factory())


# ---------------------------------------------------------------------------
# Placement: host batches onto the device
# ---------------------------------------------------------------------------


def _pad_rows(t: torch.Tensor, rows: int) -> torch.Tensor:
    """``t`` with zero rows appended up to ``rows``."""
    pad = torch.zeros((rows - t.shape[0],) + tuple(t.shape[1:]),
                      dtype=t.dtype, device=t.device)
    return torch.cat([t, pad])


# The leaves of a batch in a fixed order, and how each is rebuilt: a
# dense batch is (X, y, mask); a CSR batch its entry arrays, its twin's
# (None without one), then y and mask.
_CSR_LEAVES = ("row_ids", "col_ids", "values", "csc_row_ids",
               "csc_col_ids", "csc_values")


class _HostBatch(NamedTuple):
    """A batch ready to copy: ``leaves`` are pinned CPU tensors (the
    source's own, or views of a staging slot; ``staged`` holds the
    indices of those) or tensors already on the device; ``slot`` is the
    staging slot the batch holds, or None."""

    kind: str
    leaves: tuple
    meta: tuple
    slot: Optional[int]
    staged: frozenset


def _split(X, y, mask, pad_to):
    """``(kind, [(tensor or None, padded rows or None)...], meta)`` of a
    raw batch: padding is recorded, not applied."""
    if isinstance(X, CSRMatrix):
        leaves = [(getattr(X, name), None) for name in _CSR_LEAVES]
        leaves += [(host_tensor(y), None),
                   (None if mask is None else host_tensor(mask), None)]
        return "csr", leaves, (X.shape, X.want_csc)
    X, y = host_tensor(X), host_tensor(y)
    n = X.shape[0]
    if pad_to is not None and n < pad_to:
        base = (torch.ones(n, dtype=torch.float32) if mask is None
                else host_tensor(mask).to(torch.float32))
        return "dense", [(X, pad_to), (y, pad_to), (base, pad_to)], ()
    m = None if mask is None else host_tensor(mask)
    return "dense", [(X, None), (y, None), (m, None)], ()


def _assemble(kind, leaves, meta):
    """The device batch ``(X, y, mask)`` of placed leaves; a CSR batch
    that wants its column-sorted twin gets it here, on the device."""
    if kind in ("dense", "leaves"):
        return tuple(leaves)
    rid, cid, val, crid, ccid, cval, y, mask = leaves
    shape, want_csc = meta
    Xd = CSRMatrix(rid, cid, val, shape, csc_row_ids=crid,
                   csc_col_ids=ccid, csc_values=cval, rows_sorted=True,
                   want_csc=want_csc)
    if Xd.want_csc and not Xd.has_csc:
        Xd = Xd.with_csc()
    return Xd, y, mask


def _place_cpu(X, y, mask, pad_to):
    """The CPU placement: tensors where they lie, padded to ``pad_to``."""
    kind, leaves, meta = _split(X, y, mask, pad_to)
    out = [None if t is None else (t if rows is None else _pad_rows(t, rows))
           for t, rows in leaves]
    return _assemble(kind, out, meta)


def pin_host(t: torch.Tensor) -> torch.Tensor:
    """Page-lock the memory of the contiguous CPU tensor ``t`` in place
    (``cudaHostRegister``, at its exact size: the caching host allocator
    behind ``pin_memory=True`` rounds a request up to a power of two), so
    that streams over it copy to the card directly; returns ``t``.
    Release it with :func:`unpin_host`."""
    if t.device.type != "cpu" or not t.is_contiguous():
        raise ValueError("pin_host takes a contiguous CPU tensor")
    err = int(torch.cuda.cudart().cudaHostRegister(
        t.data_ptr(), t.numel() * t.element_size(),
        1))  # cudaHostRegisterPortable: pinned for every device
    if err:
        raise RuntimeError(f"cudaHostRegister failed: CUDA error {err}")
    return t


def unpin_host(t: torch.Tensor) -> None:
    """Undo :func:`pin_host`, after every copy from ``t`` has finished
    (the device is synchronized first)."""
    torch.cuda.synchronize()
    err = int(torch.cuda.cudart().cudaHostUnregister(t.data_ptr()))
    if err:
        raise RuntimeError(f"cudaHostUnregister failed: CUDA error {err}")


def _release_rings(rings):
    """Finalizer of a placer's staging rings: wait for each slot's last
    copy, then unregister its memory."""
    for ring in rings:
        for slot in ring:
            if slot.event is not None:
                slot.event.synchronize()
            if slot.buf is not None:
                torch.cuda.cudart().cudaHostUnregister(slot.buf.data_ptr())
                slot.buf = None


class _Slot:
    """One pinned staging buffer and the event of its last copy."""

    def __init__(self):
        self.buf: Optional[torch.Tensor] = None  # uint8, page-locked
        self.event = None

    def ensure(self, nbytes: int):
        """Grow to ``nbytes`` (its earlier copy has finished)."""
        if self.buf is not None and self.buf.numel() >= nbytes:
            return
        if self.buf is not None:
            torch.cuda.cudart().cudaHostUnregister(self.buf.data_ptr())
            self.buf = None
        self.buf = pin_host(torch.empty(nbytes, dtype=torch.uint8))


_ALIGN = 256  # bytes between leaves in a staging slot


class _Stopped(Exception):
    """The pass ended while a producer waited for a staging slot."""


class _DevicePlacer:
    """Host batches onto one CUDA device through pinned memory on a side
    stream (see the module docstring).  One placer serves every pass of
    the smooth that owns it; each pass opens a :class:`_PassPlacement`.
    ``copies`` counts the leaves copied directly and through staging,
    and the bytes."""

    def __init__(self, device: torch.device, pad_to: Optional[int],
                 prefetch: int):
        self.device = device
        self.pad_to = pad_to
        self.prefetch = int(prefetch)
        self.side = None
        self.rings = []  # the current staging ring is the last
        self.open = 0  # placements not yet closed
        self._lock = threading.RLock()
        self.copies = collections.Counter()

    def open_pass(self) -> "_PassPlacement":
        """A placement for one pass, on the current ring; on a ring of
        its own while another pass is still open (an attempt that the
        supervisor's watchdog gave up on may still be streaming), so two
        live passes never fill the same staging slot."""
        with self._lock:
            if self.side is None:
                self.side = torch.cuda.Stream(device=self.device)
                self.new_ring()
                weakref.finalize(self, _release_rings, self.rings)
            elif self.open:
                self.new_ring()
            self.open += 1
            return _PassPlacement(self)

    def new_ring(self):
        """Start a staging ring of ``prefetch + 2`` slots: at first use,
        while another pass is open, and when a producer thread outlived
        its pass (its ring is left to it, and released with the
        placer)."""
        with self._lock:
            self.rings.append([_Slot() for _ in range(self.prefetch + 2)])


class _PassPlacement:
    """One pass's placement: :meth:`host` runs on the producing thread
    (padding and filling a staging slot), :meth:`place` on the consuming
    thread (copies on the side stream, the compute stream's wait)."""

    def __init__(self, placer: _DevicePlacer):
        self.placer = placer
        self.slots = placer.rings[-1]
        self.stop = threading.Event()
        self.free = queue.Queue()
        for i in range(len(self.slots)):
            self.free.put(i)
        self.compute = torch.cuda.current_stream(placer.device)
        self.in_flight = collections.deque()
        self.lead = placer.prefetch + 1  # batches the host may run ahead
        self.throttle_s = 0.0

    def _acquire(self) -> int:
        while True:
            if self.stop.is_set():
                raise _Stopped
            try:
                return self.free.get(timeout=0.05)
            except queue.Empty:
                continue

    def host(self, X, y, mask) -> _HostBatch:
        """Pad and stage one raw batch (producer side)."""
        return self.stage(*_split(X, y, mask, self.placer.pad_to))

    def stage(self, kind, leaves, meta) -> _HostBatch:
        """Stage ``leaves``, ``(tensor or None, padded rows or None)``
        pairs, into one slot of the ring (producer side); :meth:`place`
        rebuilds the batch by ``kind`` (``"leaves"``: the tuple of placed
        tensors)."""
        dev = self.placer.device

        def direct(t, rows):
            return rows is None and (t.device == dev or t.is_pinned())

        staged = [(i, t, rows) for i, (t, rows) in enumerate(leaves)
                  if t is not None and not direct(t, rows)]
        out = [t for t, _ in leaves]
        slot = None
        if staged:
            slot = self._acquire()
            s = self.slots[slot]
            if s.event is not None:
                s.event.synchronize()  # its last copy has finished
            sizes = []
            for _, t, rows in staged:
                shape = (rows or t.shape[0],) + tuple(t.shape[1:])
                nbytes = int(np.prod(shape)) * t.element_size()
                sizes.append((shape, -(-nbytes // _ALIGN) * _ALIGN))
            s.ensure(max(sum(b for _, b in sizes), 1))
            offset = 0
            for (i, t, rows), (shape, nbytes) in zip(staged, sizes):
                view = s.buf[offset:offset + nbytes].view(t.dtype)
                view = view[:int(np.prod(shape))].view(shape)
                n = t.shape[0]
                view[:n].copy_(t)
                if rows is not None:
                    view[n:].zero_()
                out[i] = view
                offset += nbytes
        return _HostBatch(kind, tuple(out), meta, slot,
                          frozenset(i for i, _, _ in staged))

    def discard(self, hb: _HostBatch):
        """A pulled batch that is skipped (a resumed pass): its slot goes
        back unused."""
        if hb.slot is not None:
            self.free.put(hb.slot)

    def _throttle(self):
        """Wait until the card holds at most ``lead`` unfinished batches
        besides the one about to be placed."""
        ev = torch.cuda.Event()
        ev.record(self.compute)  # after every kernel launched so far
        self.in_flight.append(ev)
        while len(self.in_flight) > self.lead:
            t0 = time.perf_counter()
            self.in_flight.popleft().synchronize()
            self.throttle_s += time.perf_counter() - t0

    def place(self, hb: _HostBatch):
        """Copy one staged batch to the device (consumer side); returns
        ``(X, y, mask)`` on the device, the mask all ones where the batch
        had none (so no count is copied from the host)."""
        p = self.placer
        self._throttle()
        fresh, out = [], []
        copies = p.copies
        with torch.cuda.stream(p.side):
            for i, t in enumerate(hb.leaves):
                if t is None or t.device == p.device:
                    out.append(t)
                    continue
                d = torch.empty(t.shape, dtype=t.dtype, device=p.device)
                d.copy_(t, non_blocking=True)
                copies["staged" if i in hb.staged else "direct"] += 1
                copies["bytes"] += t.numel() * t.element_size()
                fresh.append(d)
                out.append(d)
            done = torch.cuda.Event()
            done.record(p.side)
        self.compute.wait_event(done)
        for d in fresh:
            d.record_stream(self.compute)
        if hb.slot is not None:
            self.slots[hb.slot].event = done
            self.free.put(hb.slot)
        if hb.kind == "dense" and out[2] is None:
            out[2] = torch.ones(out[0].shape[0], dtype=torch.float32,
                                device=p.device)
        return _assemble(hb.kind, out, hb.meta)

    def close(self):
        if not self.stop.is_set():
            self.stop.set()
            with self.placer._lock:
                self.placer.open -= 1


def _make_placer(device: torch.device, pad_to, prefetch: int = 0):
    """The shared macro-batch placement: on the CPU a function of the
    raw batch; on a CUDA device a :class:`_DevicePlacer`, which
    :func:`fold_stream` drives in its two halves."""
    if device.type == "cuda":
        return _DevicePlacer(device, pad_to, prefetch)

    def _place(X, y, mask):
        return _place_cpu(X, y, mask, pad_to)

    return _place


def _device_groups(mesh) -> dict:
    """Each distinct device of this process's slots -> ``(first slot, one
    past its last slot)``, in the order of first appearance."""
    groups = {}
    for s, dev in enumerate(mesh.slots()):
        groups[dev] = (groups.get(dev, (s, s))[0], s + 1)
    return groups


class _MeshSplit:
    """The host half of a mesh placement, the same on the CPU and the
    card: :meth:`split` shards a raw batch's rows over the mesh (dense by
    ``mesh.shard_spans``, ``shard_batch``'s even split, its padding not
    stored; CSR by the nnz-balanced ``mesh.csr_batch_layout`` under the
    fixed entry budget, resolved from the first batch when not given)
    and groups the leaves by slot device: each device takes one
    contiguous run of rows (dense) or of stacked shards (CSR) covering
    its slots.  ``build(placed)`` then takes each slot's shard as a view
    of its device's placed leaves."""

    def __init__(self, mesh, pad_to, csr_nnz_per_shard):
        self.mesh = mesh
        self.pad_to = pad_to
        self.budget = csr_nnz_per_shard
        self.groups = _device_groups(mesh)
        self.warned_eager_twin = False

    def split(self, X, y, mask):
        """``(leaves by device, build)`` of one raw batch."""
        if isinstance(X, CSRMatrix):
            return self._split_csr(X, y, mask)
        return self._split_dense(X, y, mask)

    def _split_dense(self, X, y, mask):
        from ..parallel import mesh as mesh_lib

        mesh = self.mesh
        X, y = host_tensor(X), host_tensor(y)
        n = X.shape[0]
        rps, spans = mesh_lib.shard_spans(mesh, n, self.pad_to)
        k = mesh.shape[mesh_lib.DATA_AXIS]
        masked = mask is not None or rps * k != n
        m = None if mask is None else host_tensor(mask).to(torch.float32)
        starts = {dev: spans[lo][0] for dev, (lo, _) in self.groups.items()}
        leaves = {}
        for dev, (lo, hi) in self.groups.items():
            a, b = spans[lo][0], spans[hi - 1][1]
            leaves[dev] = (X[a:b], y[a:b], None if m is None else m[a:b])

        def build(placed):
            xs, ys, ms = [], [], []
            for dev, (a, b) in zip(mesh.slots(), spans):
                Xd, yd, md = placed[dev]
                i, j = a - starts[dev], b - starts[dev]
                xs.append(Xd[i:j])
                ys.append(yd[i:j])
                if md is not None:
                    ms.append(md[i:j])
                elif masked:
                    ms.append(torch.ones(j - i, dtype=torch.float32,
                                         device=dev))
            return mesh_lib.sharded_rows_batch(
                mesh, xs, ys, ms if masked else None, spans, rps, k,
                X.shape[1:], y.shape[1:])

        return leaves, build

    def _split_csr(self, X, y, mask):
        from ..parallel import mesh as mesh_lib

        mesh = self.mesh
        if X.has_csc and not self.warned_eager_twin:
            self.warned_eager_twin = True
            warnings.warn(
                "mesh CSR streaming with an eager per-batch CSC twin: "
                "the sharder builds per-shard twins and drops the "
                "batch's; build the dataset with with_csc='lazy' to "
                "skip the wasted per-batch sort", stacklevel=3)
        if self.budget is None:
            n_shards = mesh.shape[mesh_lib.DATA_AXIS]
            self.budget = max(128, -(-int(X.nnz * 1.25 / n_shards)
                                     // 128) * 128)
        lay = mesh_lib.csr_batch_layout(mesh, X, y, mask,
                                        nnz_per_shard=self.budget)
        stacked = mesh_lib.csr_layout_tensors(lay, X.values.dtype)
        names = tuple(stacked)
        leaves = {dev: tuple(stacked[nm][lo:hi] for nm in names)
                  for dev, (lo, hi) in self.groups.items()}

        def build(placed):
            per_slot = {nm: [] for nm in names}
            for s, dev in enumerate(mesh.slots()):
                first = self.groups[dev][0]
                for nm, t in zip(names, placed[dev]):
                    per_slot[nm].append(t[s - first])
            return mesh_lib.csr_batch_of_shards(
                per_slot, mesh, X.shape[0], X.shape[1], lay["rps"])

        return leaves, build


class _MeshPlacer:
    """Macro-batches onto a mesh with CUDA slots: one
    :class:`_DevicePlacer` (its pinned staging ring and side stream) for
    each distinct CUDA device of the slots.  The host half
    (:class:`_MeshSplit`) runs where the batch is pulled and stages each
    device's leaves in that device's ring; the device half copies them
    and takes the slots' shards as views, so a mesh whose slots repeat
    one card copies each batch once, as the single-device stream does.
    A CPU slot's leaves are used where they lie."""

    def __init__(self, mesh, pad_to, csr_nnz_per_shard, prefetch: int):
        self.split = _MeshSplit(mesh, pad_to, csr_nnz_per_shard).split
        self.devices = {dev: _DevicePlacer(dev, None, prefetch)
                        for dev in _device_groups(mesh)
                        if dev.type == "cuda"}

    @property
    def copies(self) -> collections.Counter:
        out = collections.Counter()
        for p in self.devices.values():
            out.update(p.copies)
        return out

    def open_pass(self) -> "_MeshPassPlacement":
        return _MeshPassPlacement(self)

    def new_ring(self):
        for p in self.devices.values():
            p.new_ring()


class _MeshPassPlacement:
    """One pass of a :class:`_MeshPlacer`: a :class:`_PassPlacement` for
    each CUDA device, driven as one."""

    def __init__(self, placer: _MeshPlacer):
        self.split = placer.split
        self.parts = {dev: p.open_pass() for dev, p in placer.devices.items()}

    @property
    def throttle_s(self) -> float:
        return sum(p.throttle_s for p in self.parts.values())

    def host(self, X, y, mask):
        leaves, build = self.split(X, y, mask)
        staged = {dev: (self.parts[dev].stage(
                      "leaves", [(t, None) for t in ts], ())
                        if dev in self.parts else ts)
                  for dev, ts in leaves.items()}
        return staged, build

    def discard(self, hb):
        for dev, h in hb[0].items():
            if dev in self.parts:
                self.parts[dev].discard(h)

    def place(self, hb):
        staged, build = hb
        return build({dev: (self.parts[dev].place(h) if dev in self.parts
                            else h) for dev, h in staged.items()})

    def close(self):
        for p in self.parts.values():
            p.close()


def _make_mesh_placer(mesh, pad_to, csr_nnz_per_shard, prefetch: int = 0):
    """The mesh placement of raw batches, sharded over ``mesh`` (padded to
    ``pad_to`` rows, CSR under ``csr_nnz_per_shard``): a
    :class:`_MeshPlacer` when a slot is on a CUDA device, else a function
    of the raw batch returning its ``ShardedBatch``."""
    if any(dev.type == "cuda" for dev in mesh.slots()):
        return _MeshPlacer(mesh, pad_to, csr_nnz_per_shard, prefetch)
    split = _MeshSplit(mesh, pad_to, csr_nnz_per_shard).split

    def _place(X, y, mask):
        leaves, build = split(X, y, mask)
        return build(leaves)

    return _place


def _mesh_batch_sums(gradient, mesh, with_grad):
    """The batch kernel of a mesh stream: each slot's shard of the placed
    batch through ``gradient.batch_loss_and_grad`` (the fused gradients
    stage a shard per call, without copying it), the slots' sums added
    in slot order."""
    from ..ops.sparse import RowShardedCSR
    from ..parallel import dist_smooth

    def kernel(w, X, y, mask):
        if isinstance(X, RowShardedCSR):
            ls, gs, n = dist_smooth.csr_shard_sums(
                gradient, X, y, mask, mesh)[0](w)
        else:
            ops = [None if xs.shape[0] == 0 else
                   (xs, ys, None if mask is None else mask.shards[i])
                   for i, (xs, ys) in enumerate(zip(X.shards, y.shards))]
            ls, gs, n = dist_smooth._slot_sums(gradient, mesh, ops, w,
                                               X.dtype)
        return (ls, gs, n) if with_grad else (ls, n)

    return kernel


def _mean_divisor(n: int, like: torch.Tensor) -> torch.Tensor:
    """The row count as a 0-d CPU tensor of ``like``'s dtype (the JAX
    package divides by the count cast to the sums' dtype)."""
    return torch.tensor(n, dtype=like.dtype)


def make_streaming_smooth(
    gradient: Gradient,
    dataset: StreamingDataset,
    *,
    mesh=None,
    pad_to: Optional[int] = None,
    csr_nnz_per_shard: Optional[int] = None,
    prefetch: int = 0,
    stream_ckpt=None,
    telemetry=None,
    device=None,
    pass_stats: Optional[list] = None,
):
    """Build host-level ``(smooth, smooth_loss)`` that stream
    macro-batches: ``smooth(w) -> (mean loss, mean gradient)`` and
    ``smooth_loss(w) -> mean loss``, means over every valid row of the
    dataset.  Each batch is one call of ``gradient.batch_loss_and_grad``
    (one launch of the margin kernel a batch through
    ``FusedMarginGradient``, which stages an unprepared batch without
    copying X).

    ``device`` (default: the current CUDA device, raising without one;
    ``"cpu"`` for the CPU) is where batches are placed and evaluated.
    ``pad_to`` pads a short batch with mask-0 rows to that many rows
    (the result is unchanged).  ``prefetch`` (default 0) is the depth of
    the background ingest thread (:func:`fold_stream`).  ``stream_ckpt``
    (a :class:`StreamCheckpoint`) commits a cursor on its cadence; the
    two functions share one pass counter, as host AGD calls them in a
    fixed order.  ``pass_stats`` (a list, port only) receives one dict a
    pass of either function (:func:`fold_stream`'s ``stats``).
    ``mesh`` (a data-axis ``parallel.mesh.Mesh``) shards each batch over
    the mesh (see the module docstring); ``device`` is then its lead
    device.  ``csr_nnz_per_shard`` pins the entries a shard of every CSR
    batch (default ``1.25 x batch nnz / shards``, rounded up to 128): a
    batch that cannot fit raises with the knob's name; it is inert
    without a mesh.  Build a CSR dataset with ``with_csc="lazy"`` for
    the mesh: the sharder builds each shard's twin.  ``telemetry=`` comes
    with the observability slice and raises.
    """
    reject_later(telemetry=telemetry)
    if mesh is not None and mesh is not False:
        from ..parallel import mesh as mesh_lib

        mesh_lib.check_data_mesh(mesh)
        if device is not None and not same_device(device, mesh.lead):
            raise ValueError(f"device={device} is not the mesh's lead "
                             f"device {mesh.lead}")
        _place = _make_mesh_placer(mesh, pad_to, csr_nnz_per_shard,
                                   prefetch)
        batch_sums = _mesh_batch_sums(gradient, mesh, True)
        batch_loss_sums = _mesh_batch_sums(gradient, mesh, False)
    else:
        _place = _make_placer(resolve_device(device), pad_to, prefetch)

        def batch_sums(w, X, y, mask):
            return gradient.batch_loss_and_grad(w, X, y, mask)

        def batch_loss_sums(w, X, y, mask):
            ls, _, n = gradient.batch_loss_and_grad(w, X, y, mask)
            return ls, n
    pass_stats = [] if pass_stats is None else pass_stats

    def smooth(w):
        def unflatten(leaves):
            # [loss sum] + the gradient's leaves; a cursor whose leaf
            # count does not match w's structure is stale
            ref = tvec.leaves(w)
            if len(leaves) != 1 + len(ref):
                return None
            return [torch.as_tensor(leaves[0]).to(ref[0].device),
                    tvec.unflatten_like(w, iter(leaves[1:]))]

        stats: dict = {}
        (ls, gs), n = fold_stream(
            batch_sums,
            lambda a, b: [a[0] + b[0], tvec.add(a[1], b[1])],
            _place, dataset, w, prefetch=prefetch,
            stream_ckpt=stream_ckpt, acc_unflatten=unflatten,
            stats=stats)
        pass_stats.append(stats)
        nf = _mean_divisor(n, ls)
        return ls / nf, tvec.scale(1.0 / nf, gs)

    def smooth_loss(w):
        def unflatten(leaves):
            if len(leaves) != 1:
                return None
            return [torch.as_tensor(leaves[0]).to(
                tvec.leaves(w)[0].device)]

        stats: dict = {}
        (ls,), n = fold_stream(
            batch_loss_sums, lambda a, b: [a[0] + b[0]], _place, dataset,
            w, prefetch=prefetch, stream_ckpt=stream_ckpt,
            acc_unflatten=unflatten, stats=stats)
        pass_stats.append(stats)
        return ls / _mean_divisor(n, ls)

    return smooth, smooth_loss


def make_streaming_eval_multi(
    gradient: Gradient,
    dataset: StreamingDataset,
    *,
    mesh=None,
    pad_to: Optional[int] = None,
    csr_nnz_per_shard: Optional[int] = None,
    with_grad: bool = True,
    device=None,
    pass_stats: Optional[list] = None,
):
    """Evaluate K weight vectors over one pass of the stream.

    ``eval_multi(W) -> (mean_losses (K,), mean_grads)`` where ``W``
    carries a leading lane axis ((K, D), or a tree of stacked leaves);
    ``with_grad=False`` returns the ``(K,)`` losses only.  Per
    macro-batch the K lanes are one call of
    ``gradient.lanes_loss_and_grad``, which reads X once for up to 16
    lanes where the gradient has the lanes kernel
    (``FusedMarginGradient``).  ``device`` and ``pass_stats`` as in
    :func:`make_streaming_smooth`; ``mesh=`` (the streamed sweeps over a
    mesh, the grid family) comes with a later slice and raises, and
    ``csr_nnz_per_shard`` is inert without it.
    """
    reject_grid_mesh(mesh, "make_streaming_eval_multi")
    eval_multi, eval_loss_multi = _eval_multi_pair(
        gradient, dataset, pad_to, resolve_device(device), pass_stats)
    return eval_multi if with_grad else eval_loss_multi


def _eval_multi_pair(gradient, dataset, pad_to, dev, pass_stats):
    """:func:`make_streaming_eval_multi`'s two evaluators, with and
    without the gradient, over one placer: a sweep needs both, and they
    share one ring of pinned staging buffers."""
    _place = _make_placer(dev, pad_to)
    pass_stats = [] if pass_stats is None else pass_stats

    def batch_sums(W, X, y, mask):
        ls, gs, n = gradient.lanes_loss_and_grad(W, X, y, mask)
        return ls, gs, n[0]  # the count is the mask's: the same per lane

    def batch_loss_sums(W, X, y, mask):
        ls, _, n = gradient.lanes_loss_and_grad(W, X, y, mask)
        return ls, n[0]

    def lanes(W):
        return tvec.tmap(lambda a: torch.as_tensor(a, device=dev), W)

    def eval_multi(W):
        stats: dict = {}
        (ls, gs), n = fold_stream(
            batch_sums, lambda a, b: [a[0] + b[0], tvec.add(a[1], b[1])],
            _place, dataset, lanes(W), stats=stats)
        pass_stats.append(stats)
        nf = _mean_divisor(n, ls)
        return ls / nf, tvec.scale(1.0 / nf, gs)

    def eval_loss_multi(W):
        stats: dict = {}
        (ls,), n = fold_stream(
            batch_loss_sums, lambda a, b: [a[0] + b[0]], _place, dataset,
            lanes(W), stats=stats)
        pass_stats.append(stats)
        return ls / _mean_divisor(n, ls)

    return eval_multi, eval_loss_multi


class _Prefetcher:
    """Bounded background ingest: a daemon thread pulls batches off the
    iterator into a ``queue.Queue(maxsize=depth)``, so batch k+1's host
    work (read, parse, pad, fill a pinned buffer) overlaps batch k's
    device work instead of following it.  Copies and launches stay on
    the consuming thread, and the queue bound caps host memory at
    ``depth`` batches.  The sentinel marks exhaustion; a producer
    exception is raised again at the consumer's next pull.

    Shutdown contract (:meth:`close`): every ``put`` is a bounded-wait
    loop on a stop event, so a consumer that abandons the stream
    mid-pass (a kernel raised) can always stop the pump, even when the
    queue is full; ``close`` joins the thread (with a timeout) and never
    raises: it runs in the consumer's ``finally`` and must not mask the
    original exception."""

    _END = object()

    def __init__(self, it, depth: int):
        self._q = queue.Queue(maxsize=depth)
        self._err = None
        self._stop = threading.Event()

        def pump():
            try:
                for b in it:
                    while not self._stop.is_set():
                        try:
                            self._q.put(b, timeout=0.05)
                            break
                        except queue.Full:
                            continue
                    if self._stop.is_set():
                        return
            except BaseException as e:  # noqa: BLE001 — relayed, below
                self._err = e
            finally:
                # the sentinel must land even when the consumer stopped
                # reading; a live consumer may still be draining a full
                # queue, so dropping a real batch to make room is legal
                # only after the stop flag is set
                while True:
                    try:
                        self._q.put(self._END, timeout=0.05)
                        break
                    except queue.Full:
                        if self._stop.is_set():
                            try:
                                self._q.get_nowait()
                            except queue.Empty:
                                pass

        self._thread = threading.Thread(
            target=pump, name="fold-stream-prefetch", daemon=True)
        self._thread.start()

    def __call__(self):
        b = self._q.get()
        if b is self._END:
            if self._err is not None:
                raise self._err
            return None
        return b

    def close(self, timeout: float = 5.0) -> bool:
        """Stop the pump and join its thread; True when the thread
        exited within ``timeout``.  Idempotent, never raises."""
        self._stop.set()
        # drain so a pump blocked mid-put sees the stop flag promptly
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        self._thread.join(timeout)
        return not self._thread.is_alive()


def _total(ns) -> int:
    """The sum of the per-batch counts as a Python int: one copy to the
    host when they are tensors."""
    if ns and all(isinstance(x, torch.Tensor) for x in ns):
        devices = {x.device for x in ns}
        if len(devices) == 1:
            return int(torch.stack([x.reshape(()).to(torch.int64)
                                    for x in ns]).sum())
    return sum(int(x) for x in ns)


def fold_stream(kernel, combine, place, dataset, w, prefetch: int = 0, *,
                stream_ckpt=None, acc_unflatten=None, stats=None):
    """Stream the dataset through ``kernel(w, X, y, mask) -> (sums...,
    n)``, combining the sums with ``combine`` in batch order and the
    counts as one host int after the pass.

    ``place`` is either a function of a raw batch returning the placed
    batch, or a device placer (from :func:`_make_placer`), whose host
    half (padding, filling a pinned staging slot) runs where the batch
    is pulled and whose device half (the copies) runs here.

    The loop keeps the device busy: batch i's kernel is launched before
    batch i+1 is pulled and placed, so host work and the copy of batch
    i+1 run while the device computes batch i, and no count comes to the
    host before the pass ends.  ``prefetch > 0`` adds a bounded
    background thread (:class:`_Prefetcher`) that keeps up to
    ``prefetch`` batches ready; ``0`` is the single-threaded loop.  The
    thread is joined on every exit, a kernel that raises mid-pass
    included, and the original exception propagates.

    Mid-epoch resume (``stream_ckpt``, a :class:`StreamCheckpoint`): the
    fold registers each pass via ``begin_pass`` and commits a
    :class:`StreamCursor` every ``every_batches`` folded batches.  When a
    loaded checkpoint armed a cursor for this pass, its first
    ``batch_index`` batches are pulled and discarded (no placement, no
    kernel) and the accumulator is seeded from the cursor's leaves via
    ``acc_unflatten(leaves) -> acc`` (None rejects the cursor: the pass
    then runs in full).

    ``stats`` (optional dict) is filled in place: ``batches``, ``rows``,
    ``pass_s``, ``stall_s`` (time blocked waiting on ingest),
    ``skipped_batches`` and ``resumed_from_batch``; on a device,
    ``throttle_s`` (time the host waited for the device to drain),
    ``h2d_bytes`` and the leaves copied directly and through staging
    (``direct_copies``, ``staged_copies``).
    """
    t_pass = time.perf_counter()
    stall = [0.0]
    it = iter(dataset)
    opener = getattr(place, "open_pass", None)
    placement = opener() if opener is not None else None
    if placement is not None:
        it = (placement.host(*b) for b in it)
        to_device, drop = placement.place, placement.discard
        copies_before = dict(place.copies)
    else:
        def to_device(b):
            return place(*b)

        def drop(b):
            return None

    pf = None
    if prefetch > 0:
        pf = _Prefetcher(it, prefetch)
        raw_pull = pf
    else:
        def raw_pull():
            return next(it, None)

    def pull():
        t0 = time.perf_counter()
        b = raw_pull()
        stall[0] += time.perf_counter() - t0
        return b

    ordinal, resume = (stream_ckpt.begin_pass()
                       if stream_ckpt is not None else (0, None))
    acc = None
    ns = []
    skip = 0
    if resume is not None and acc_unflatten is not None:
        seeded = acc_unflatten(resume.acc_leaves)
        if seeded is not None:
            acc = seeded
            ns = [int(resume.n)]
            skip = int(resume.batch_index)
    batch_index = skip
    try:
        for _ in range(skip):  # already folded into the cursor's carry
            b = pull()
            if b is None:
                break
            drop(b)
        first = pull()
        if first is None and skip == 0:
            raise ValueError("streaming dataset yielded no batches")
        nxt = None if first is None else to_device(first)
        while nxt is not None:
            *sums, n = kernel(w, *nxt)  # batch i's launch
            ns.append(n)
            acc = sums if acc is None else combine(acc, sums)
            batch_index += 1
            if stream_ckpt is not None:
                stream_ckpt.maybe_commit(ordinal, batch_index, acc, ns)
            b = pull()  # batch i+1's host work overlaps the device's
            nxt = None if b is None else to_device(b)
    finally:
        if placement is not None:
            placement.close()
        if pf is not None and not pf.close() and placement is not None:
            place.new_ring()
    total = _total(ns)
    if stats is not None:
        stats["batches"] = batch_index
        stats["rows"] = total
        stats["pass_s"] = time.perf_counter() - t_pass
        stats["stall_s"] = stall[0]
        stats["skipped_batches"] = skip
        if skip:
            stats["resumed_from_batch"] = skip
        if placement is not None:
            stats["throttle_s"] = placement.throttle_s
            for key, name in (("bytes", "h2d_bytes"),
                              ("direct", "direct_copies"),
                              ("staged", "staged_copies")):
                stats[name] = place.copies[key] - copies_before.get(key, 0)
    return acc, total
