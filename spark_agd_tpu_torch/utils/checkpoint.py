"""Checkpoint / resume: elastic restart for AGD, lanes and L-BFGS runs.

Counterpart of ``spark_agd_tpu/utils/checkpoint.py``, with its file
format: one ``.npz`` per checkpoint, written atomically (tempfile +
rename) with a ``__crc32__`` entry of per-entry checksums, holding the
``x``/``z`` leaves as ``x_0``, ``x_1``, ... in the leaf order of
``core.tvec.leaves`` (dicts by sorted key, as JAX flattens them), the
scalar carry, the cumulative loss history and a fingerprint of the
problem.  The entry names and the fingerprint string are the JAX
package's, so a checkpoint written by either package resumes in the
other.  Loading needs a *template* (normally ``w0``) for the tree
structure; the leaves land on the template's device.

``run_agd_checkpointed`` drives ``core.agd.run_agd`` in segments of
``segment_iters`` iterations, saving the carry after each and resuming from ``path`` when it exists.  The warm
carry is exact (``prior_iters`` feeds the ``nIter > 1`` gate), so a
split run gives the straight run's bits.  The lanes
(``run_agd_multi_checkpointed``) and L-BFGS / OWL-QN
(``run_lbfgs_checkpointed``) have the same contract.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import tempfile
import zipfile
import zlib
from typing import Any, Dict, NamedTuple, Optional

import numpy as np
import torch

from ..core import agd, tvec
from ..core.agd import AGDConfig, AGDWarmState

logger = logging.getLogger("spark_agd_tpu")


class CheckpointCorruptError(RuntimeError):
    """``path`` holds a truncated or garbage npz (a kill mid-write on a
    non-atomic filesystem, a torn volume, a bad sector): the typed
    error every loader raises instead of a raw ``zipfile.BadZipFile``
    or zlib error.  ``AutoCheckpointer`` falls back to the previous
    generation; ``load_checkpoint`` falls back to ``.bak`` itself."""

    def __init__(self, path: str, cause: Optional[BaseException] = None):
        detail = f" ({type(cause).__name__}: {cause})" if cause else ""
        super().__init__(f"checkpoint at {path!r} is corrupt or "
                         f"truncated{detail}")
        self.path = path


def _host(leaf) -> np.ndarray:
    """A leaf (a tensor on any device, or an array) as a numpy array; a
    device tensor is copied to the host here."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _flat(tree) -> list:
    return [_host(leaf) for leaf in tvec.leaves(tree)]


# the npz entry holding the per-entry CRC32 map (JSON: name -> crc);
# written by atomic_savez, verified and stripped by read_npz_entries
CRC_ENTRY = "__crc32__"


def _entry_crc32(value: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(value).tobytes())


def read_npz_entries(path: str) -> Dict[str, np.ndarray]:
    """Read EVERY entry of an npz into host arrays, turning any parse
    failure (bad zip directory, truncated member, zlib garbage) into one
    typed :class:`CheckpointCorruptError`.  ``np.load`` is lazy, so the
    full read up front keeps a truncated member from failing midway
    through rebuilding a tree.  Entries listed in ``__crc32__`` are
    checked against their CRC32, so a silent bit-flip raises the same
    error; files without the entry load unchecked."""
    try:
        with np.load(path) as data:
            entries = {k: np.asarray(data[k]) for k in data.files}
    except (zipfile.BadZipFile, EOFError, OSError, KeyError,
            ValueError) as e:
        raise CheckpointCorruptError(path, e) from e
    crc_entry = entries.pop(CRC_ENTRY, None)
    if crc_entry is not None:
        try:
            crcs = json.loads(str(crc_entry))
        except ValueError as e:
            raise CheckpointCorruptError(path, e) from e
        for name, expect in crcs.items():
            if name not in entries:
                raise CheckpointCorruptError(
                    path, KeyError(f"checksummed entry {name!r} missing"))
            if _entry_crc32(entries[name]) != int(expect):
                raise CheckpointCorruptError(
                    path, ValueError(
                        f"entry {name!r} fails its CRC32 (silent "
                        "bit-flip or partial rewrite)"))
    return entries


class _Entries:
    """Dict view over read npz entries whose missing-key error is the
    typed corruption error (a file that unzips but lacks a required key
    is a torn write, not another format)."""

    def __init__(self, path: str, entries: Dict[str, np.ndarray]):
        self._path = path
        self._entries = entries

    def __contains__(self, key):
        return key in self._entries

    def __getitem__(self, key):
        try:
            return self._entries[key]
        except KeyError as e:
            raise CheckpointCorruptError(self._path, e) from e

    def prefixed(self, prefix: str) -> Dict[str, np.ndarray]:
        """Every entry under a namespace prefix: how rider entries (the
        ``stream_*`` mid-epoch cursor) come back out of a file."""
        return {k: v for k, v in self._entries.items()
                if k.startswith(prefix)}


def _load_tree(data, template, name: str):
    """One tree from its ``{name}_{i}`` entries, in ``template``'s
    structure and on its leaves' devices: the one copy of the leaf-naming
    scheme all loaders share."""
    n = len(tvec.leaves(template))
    return tvec.unflatten_like(
        template, iter([data[f"{name}_{i}"] for i in range(n)]))


def _treedef(tree) -> str:
    """The body of the JAX ``PyTreeDef`` string of ``tree`` (``*`` a
    leaf, dicts by sorted key, a one-element tuple ``(*,)``)."""
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_treedef(tree[k])}"
                               for k in sorted(tree)) + "}"
    if isinstance(tree, (list, tuple)):
        inner = ", ".join(_treedef(t) for t in tree)
        if isinstance(tree, list):
            return f"[{inner}]"
        return f"({inner},)" if len(tree) == 1 else f"({inner})"
    if tree is None:
        return "None"
    return "*"


def _shape_dtype(leaf) -> str:
    """``shape:dtype`` as the JAX package renders a leaf (numpy's dtype
    names; ``bfloat16`` for bf16)."""
    if isinstance(leaf, torch.Tensor):
        return (f"{tuple(leaf.shape)}:"
                f"{str(leaf.dtype).removeprefix('torch.')}")
    a = np.asarray(leaf)
    return f"{a.shape}:{a.dtype}"


def problem_fingerprint(w0: Any, config) -> str:
    """A stable id of what a checkpoint continues: the weight tree's
    structure, shapes and dtypes plus every config field except
    ``num_iterations`` (which differs between a killed run and its
    resume).  The string is the JAX package's
    (``f"{treedef}|{shapes}|{sorted(cfg.items())}"``), rendered without
    JAX, so the two packages agree on which problem a file belongs to.
    The smooth and prox closures are code and cannot be fingerprinted."""
    shapes = ";".join(_shape_dtype(leaf) for leaf in tvec.leaves(w0))
    cfg = dataclasses.asdict(config)
    cfg.pop("num_iterations")
    return f"PyTreeDef({_treedef(w0)})|{shapes}|{sorted(cfg.items())}"


def host_warm(warm: AGDWarmState) -> AGDWarmState:
    """``warm`` with its iterates copied to host arrays and its scalars
    as Python values: what a checkpointer holds, so that writing it later
    (from a signal handler) needs nothing from the device."""
    return AGDWarmState(
        x=tvec.tmap(_host, warm.x), z=tvec.tmap(_host, warm.z),
        theta=float(warm.theta), big_l=float(warm.big_l),
        bts=bool(warm.bts), prior_iters=int(warm.prior_iters))


def warm_payload(warm: AGDWarmState, loss_history=None, *,
                 converged: bool = False, aborted: bool = False,
                 fingerprint: Optional[str] = None,
                 extra: Optional[dict] = None) -> dict:
    """The npz payload of one ``AGDWarmState`` checkpoint.  ``extra``:
    namespaced rider entries (the streaming layer's ``stream_*`` cursor)
    saved beside the core keys, handed back by the loaders as
    ``LoadedCheckpoint.extras``; a key that collides with the core
    payload raises."""
    payload = {}
    for name, tree in (("x", warm.x), ("z", warm.z)):
        for i, leaf in enumerate(_flat(tree)):
            payload[f"{name}_{i}"] = leaf
    payload["theta"] = np.asarray(float(warm.theta))
    payload["big_l"] = np.asarray(float(warm.big_l))
    payload["bts"] = np.asarray(bool(warm.bts))
    payload["prior_iters"] = np.asarray(int(warm.prior_iters))
    payload["converged"] = np.asarray(bool(converged))
    payload["aborted"] = np.asarray(bool(aborted))
    if fingerprint is not None:
        payload["fingerprint"] = np.asarray(fingerprint)
    payload["loss_history"] = (np.zeros(0) if loss_history is None
                               else np.asarray(loss_history))
    if extra:
        for k, v in extra.items():
            if k in payload:
                raise ValueError(
                    f"extra checkpoint entry {k!r} collides with a "
                    "core payload key; namespace rider entries "
                    "(e.g. 'stream_*')")
            payload[k] = np.asarray(v)
    return payload


def save_checkpoint(path: str, warm: AGDWarmState, loss_history=None,
                    *, converged: bool = False, aborted: bool = False,
                    fingerprint: Optional[str] = None,
                    extra: Optional[dict] = None) -> None:
    """Atomically write the continuation carry (+ cumulative loss
    history).  ``converged``/``aborted`` mark a terminal checkpoint:
    resuming it runs no further iterations.  ``extra``: rider entries,
    see :func:`warm_payload`."""
    atomic_savez(path, warm_payload(
        warm, loss_history, converged=converged, aborted=aborted,
        fingerprint=fingerprint, extra=extra))


def atomic_savez(path: str, payload: dict):
    """Write an npz atomically (tempfile in the target dir + rename), so
    a kill mid-write can never leave a torn file.  Creates the directory
    if needed.  Shared by checkpoints and model persistence.

    Every write carries a ``__crc32__`` entry mapping each payload entry
    to the CRC32 of its bytes."""
    payload = dict(payload)
    payload[CRC_ENTRY] = np.asarray(json.dumps(
        {k: _entry_crc32(np.asarray(v)) for k, v in payload.items()}))
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".npz.tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **payload)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


class LoadedCheckpoint(NamedTuple):
    warm: AGDWarmState
    loss_history: np.ndarray
    converged: bool
    aborted: bool
    fingerprint: Optional[str]
    # namespaced rider entries (the ``stream_*`` mid-epoch cursor) that
    # rode the file; empty for checkpoints written without extras
    extras: Dict[str, np.ndarray] = {}


def _check_fingerprint(path, data, expect) -> Optional[str]:
    fp = str(data["fingerprint"]) if "fingerprint" in data else None
    if expect is not None and fp is not None and fp != expect:
        raise ValueError(
            f"checkpoint at {path!r} belongs to a different problem "
            "(weight structure or config changed); delete it or use "
            "a different path")
    return fp


def checkpoint_from_entries(path: str, data: _Entries, template: Any,
                            expect_fingerprint: Optional[str] = None,
                            ) -> LoadedCheckpoint:
    """Rebuild one ``AGDWarmState`` checkpoint from read npz entries:
    the parsing half of :func:`load_checkpoint`."""
    fp = _check_fingerprint(path, data, expect_fingerprint)
    if "multi" in data:
        raise ValueError(
            f"checkpoint at {path!r} is a MULTI-lane checkpoint "
            "(run_agd_multi_checkpointed); load it with "
            "load_multi_checkpoint / resume it with the multi "
            "driver")
    if "lbfgs" in data:
        raise ValueError(
            f"checkpoint at {path!r} is an L-BFGS checkpoint "
            "(run_lbfgs_checkpointed); load it with "
            "load_lbfgs_checkpoint")
    warm = AGDWarmState(
        x=_load_tree(data, template, "x"), z=_load_tree(data, template, "z"),
        theta=float(data["theta"]), big_l=float(data["big_l"]),
        bts=bool(data["bts"]), prior_iters=int(data["prior_iters"]))
    hist = np.asarray(data["loss_history"])
    converged = bool(data["converged"]) if "converged" in data else False
    aborted = bool(data["aborted"]) if "aborted" in data else False
    return LoadedCheckpoint(warm, hist, converged, aborted, fp,
                            extras=data.prefixed("stream_"))


def load_checkpoint(path: str, template: Any,
                    expect_fingerprint: Optional[str] = None, *,
                    fallback_to_bak: bool = True,
                    ) -> Optional[LoadedCheckpoint]:
    """Rebuild a checkpoint from ``path``; None if the file does not
    exist.  ``template`` gives the tree structure (and leaf order) and
    the device of the weights, normally ``w0``.  A different
    ``expect_fingerprint`` raises ``ValueError``.

    A truncated or garbage file raises :class:`CheckpointCorruptError`,
    unless ``fallback_to_bak`` (default) and ``path + ".bak"`` exists
    (the ``AutoCheckpointer`` chain): that generation is loaded instead
    (logged), and the corrupt primary is left for the next save to
    replace."""
    if not os.path.exists(path):
        return None
    try:
        data = _Entries(path, read_npz_entries(path))
        return checkpoint_from_entries(path, data, template,
                                       expect_fingerprint)
    except CheckpointCorruptError:
        bak = path + ".bak"
        if fallback_to_bak and os.path.exists(bak):
            logger.warning(
                "checkpoint %r is corrupt; falling back to previous "
                "generation %r", path, bak)
            return load_checkpoint(bak, template, expect_fingerprint,
                                   fallback_to_bak=False)
        raise


# the iteration-zero carry is defined once, in core.agd
fresh_warm_state = AGDWarmState.initial


def warm_from_result(res, prior_iters: int) -> AGDWarmState:
    """Continuation carry out of an ``AGDResult`` / ``HostAGDResult``."""
    return AGDWarmState(
        x=res.weights, z=res.final_z, theta=float(res.final_theta),
        big_l=float(res.final_l), bts=bool(res.final_bts),
        prior_iters=int(prior_iters))


class CheckpointedResult(NamedTuple):
    weights: Any
    loss_history: np.ndarray
    num_iters: int  # total outer iterations across all runs of this path
    aborted_non_finite: bool
    resumed_from: int  # iterations already in the checkpoint at startup


def run_agd_checkpointed(
    smooth,
    prox,
    reg_value,
    w0: Any,
    config: AGDConfig,
    *,
    path: str,
    segment_iters: int = 10,
    smooth_loss=None,
    driver: str = "fused",
    staged=None,
    resilience=None,
) -> CheckpointedResult:
    """AGD with periodic checkpoints: ``segment_iters`` outer iterations
    a segment, the carry saved after each.  Kill the process anywhere;
    rerunning the same call continues from the last saved segment.

    Each segment runs ``core.agd.run_agd``; ``driver`` ("fused" or
    "host") is checked as the JAX package checks it, and both run that
    one loop.  ``staged`` (fused only): the ``(build,
    data_args)`` pair of ``core.smooth.make_smooth_staged``, used in
    place of ``smooth``/``smooth_loss``.  ``resilience`` (a
    ``resilience.RetryPolicy``, or ``True`` for the defaults): each
    segment runs under the retry engine, so a TRANSIENT failure reruns
    that segment from its saved carry.  The full supervision set is
    ``resilience.supervisor.run_agd_supervised``."""
    if segment_iters <= 0:
        raise ValueError("segment_iters must be positive")
    if driver not in ("fused", "host"):
        raise ValueError(f"unknown driver {driver!r}: 'fused' | 'host'")
    if staged is not None and driver != "fused":
        raise ValueError(
            "staged=(build, data_args) applies to the fused driver "
            "only; the host driver never embeds data in a program")
    fp = problem_fingerprint(w0, config)
    loaded = load_checkpoint(path, w0, expect_fingerprint=fp)
    if loaded is not None:
        warm = loaded.warm
        hist = list(np.asarray(loaded.loss_history))
        if loaded.converged or loaded.aborted:
            # terminal checkpoint: the run already stopped by its own
            # criteria, so rerunning runs no further iterations
            return CheckpointedResult(
                weights=warm.x, loss_history=np.asarray(hist),
                num_iters=int(warm.prior_iters),
                aborted_non_finite=loaded.aborted,
                resumed_from=int(warm.prior_iters))
    else:
        warm = AGDWarmState.initial(w0, config)
        hist = []
    resumed_from = int(warm.prior_iters)

    def run_segment(warm_state, k):
        cfg_k = dataclasses.replace(config, num_iterations=k)
        sm, sl = (staged[0](*staged[1]) if staged is not None
                  else (smooth, smooth_loss))
        return agd.run_agd(sm, prox, reg_value, warm_state.x, cfg_k,
                           smooth_loss=sl, warm=warm_state)

    if resilience is not None:
        from ..resilience import retry as retry_lib

        retry_policy = (retry_lib.RetryPolicy() if resilience is True
                        else resilience)
        plain_segment = run_segment

        def run_segment(warm_state, k):  # noqa: F811 (the retry shell)
            return retry_lib.call_with_retry(
                plain_segment, warm_state, k, policy=retry_policy,
                label="checkpointed_segment")

    total = config.num_iterations
    aborted = False
    while int(warm.prior_iters) < total:
        k = min(segment_iters, total - int(warm.prior_iters))
        res = run_segment(warm, k)
        done = int(res.num_iters)
        hist.extend(np.asarray(res.loss_history)[:done].tolist())
        warm = warm_from_result(res, int(warm.prior_iters) + done)
        aborted = bool(res.aborted_non_finite)
        save_checkpoint(path, warm, np.asarray(hist),
                        converged=bool(res.converged), aborted=aborted,
                        fingerprint=fp)
        if bool(res.converged) or aborted or done == 0:
            break

    return CheckpointedResult(
        weights=warm.x, loss_history=np.asarray(hist),
        num_iters=int(warm.prior_iters), aborted_non_finite=aborted,
        resumed_from=resumed_from)


# ---------------------------------------------------------------------------
# The lanes: the same format discipline (one atomic npz, a fingerprint,
# terminal semantics) for the K-lane lock-step host driver
# (core.host_agd.run_agd_host_multi), so a regularization path over a
# stream survives a kill.
# ---------------------------------------------------------------------------


def save_multi_checkpoint(path: str, warm, loss_history,
                          *, fingerprint: Optional[str] = None) -> None:
    """Atomically persist a ``core.host_agd.HostMultiWarm`` (+ the
    cumulative ``(iters, K)`` loss-history rows)."""
    payload = {}
    for name, tree in (("x", warm.x), ("z", warm.z)):
        for i, leaf in enumerate(_flat(tree)):
            payload[f"{name}_{i}"] = leaf
    for field in ("theta", "big_l", "bts", "prior_iters", "converged",
                  "aborted", "num_backtracks", "num_restarts",
                  "last_loss"):
        payload[field] = np.asarray(getattr(warm, field))
    if fingerprint is not None:
        payload["fingerprint"] = np.asarray(fingerprint)
    payload["loss_history"] = np.asarray(loss_history)
    payload["multi"] = np.asarray(True)
    atomic_savez(path, payload)


def load_multi_checkpoint(path: str, template: Any,
                          expect_fingerprint: Optional[str] = None):
    """Rebuild a multi-lane checkpoint; ``template`` is the STACKED
    weight tree.  Returns ``(HostMultiWarm, hist)``, or None when the
    file does not exist."""
    from ..core import host_agd

    if not os.path.exists(path):
        return None
    data = _Entries(path, read_npz_entries(path))
    _check_fingerprint(path, data, expect_fingerprint)
    if "multi" not in data:
        raise ValueError(
            f"checkpoint at {path!r} is a single-run checkpoint, "
            "not a multi-lane one")
    warm = host_agd.HostMultiWarm(
        x=_load_tree(data, template, "x"), z=_load_tree(data, template, "z"),
        theta=np.asarray(data["theta"]),
        big_l=np.asarray(data["big_l"]),
        bts=np.asarray(data["bts"]),
        prior_iters=np.asarray(data["prior_iters"]),
        converged=np.asarray(data["converged"]),
        aborted=np.asarray(data["aborted"]),
        num_backtracks=np.asarray(data["num_backtracks"]),
        num_restarts=np.asarray(data["num_restarts"]),
        last_loss=np.asarray(data["last_loss"]))
    return warm, np.asarray(data["loss_history"])


class CheckpointedMultiResult(NamedTuple):
    weights: Any               # stacked (K, ...) tree
    loss_history: np.ndarray   # cumulative (total_iters, K)
    num_iters: np.ndarray      # (K,) totals across all launches
    aborted_non_finite: np.ndarray  # (K,)
    converged: np.ndarray      # (K,)
    resumed_from: np.ndarray   # (K,) iterations already checkpointed


def run_agd_multi_checkpointed(
    smooth_multi,
    prox_multi,
    reg_value_multi,
    w0_stacked: Any,
    config: AGDConfig,
    *,
    path: str,
    segment_iters: int = 10,
    smooth_loss_multi=None,
) -> CheckpointedMultiResult:
    """The K-lane twin of :func:`run_agd_checkpointed` over
    ``core.host_agd.run_agd_host_multi``: ``segment_iters`` lock-step
    iterations a segment, the full per-lane carry saved after each, an
    exact resume (stopped lanes stay stopped) after any kill."""
    from ..core import host_agd

    if segment_iters <= 0:
        raise ValueError("segment_iters must be positive")
    fp = problem_fingerprint(w0_stacked, config)
    loaded = load_multi_checkpoint(path, w0_stacked,
                                   expect_fingerprint=fp)
    if loaded is not None:
        warm, hist = loaded
        hist = list(hist)
    else:
        warm, hist = None, []

    def _active_done(w):
        if w is None:
            return 0, True
        act = ~(w.converged | w.aborted)
        return (int(w.prior_iters[act].max()) if act.any()
                else int(config.num_iterations)), act.any()

    done, any_active = _active_done(warm)
    resumed_from = (np.zeros(_n_lanes(w0_stacked), np.int64)
                    if warm is None else warm.prior_iters.copy())
    while any_active and done < config.num_iterations:
        k = min(segment_iters, config.num_iterations - done)
        cfg_k = dataclasses.replace(config, num_iterations=k)
        res = host_agd.run_agd_host_multi(
            smooth_multi, prox_multi, reg_value_multi, w0_stacked,
            cfg_k, smooth_loss_multi=smooth_loss_multi, warm=warm)
        seg_rows = np.asarray(res.loss_history)
        hist.extend(seg_rows.tolist())
        warm = host_agd.multi_warm_state(
            res, prior_iters=(0 if warm is None else warm.prior_iters))
        save_multi_checkpoint(path, warm, np.asarray(hist),
                              fingerprint=fp)
        if seg_rows.shape[0] == 0:
            break
        done, any_active = _active_done(warm)

    if warm is None:  # a zero-iteration request on a fresh path
        warm = host_agd.HostMultiWarm.initial(w0_stacked, config)
    return CheckpointedMultiResult(
        weights=warm.x,
        loss_history=(np.asarray(hist) if hist
                      else np.zeros((0, _n_lanes(w0_stacked)))),
        num_iters=warm.prior_iters,
        aborted_non_finite=warm.aborted, converged=warm.converged,
        resumed_from=np.asarray(resumed_from))


def _n_lanes(w0_stacked) -> int:
    return tvec.leaves(w0_stacked)[0].shape[0]


# ---------------------------------------------------------------------------
# L-BFGS: the same format discipline for the quasi-Newton host driver.
# The carry is weights, gradient and up to m curvature pairs
# (core.host_lbfgs.HostLBFGSWarm), and a resumed chain reproduces the
# uninterrupted run (nothing is re-evaluated at the junction).
# ---------------------------------------------------------------------------


def save_lbfgs_checkpoint(path: str, warm, loss_history=None, *,
                          converged: bool = False,
                          ls_failed: bool = False,
                          aborted: bool = False,
                          fingerprint: Optional[str] = None) -> None:
    """Atomic write of a ``core.host_lbfgs.HostLBFGSWarm`` (+ cumulative
    history).  ``converged``/``ls_failed``/``aborted`` mark a terminal
    checkpoint: resuming it is a no-op."""
    payload = {"lbfgs": np.asarray(True)}
    for i, leaf in enumerate(_flat(warm.w)):
        payload[f"w_{i}"] = leaf
    for i, leaf in enumerate(_flat(warm.g)):
        payload[f"g_{i}"] = leaf
    payload["f"] = np.asarray(float(warm.f))
    payload["prior_iters"] = np.asarray(int(warm.prior_iters))
    payload["n_pairs"] = np.asarray(len(warm.pairs))
    payload["rho"] = np.asarray([float(p[2]) for p in warm.pairs],
                                np.float64)
    for k, (s, y, _) in enumerate(warm.pairs):
        for i, leaf in enumerate(_flat(s)):
            payload[f"p{k}s_{i}"] = leaf
        for i, leaf in enumerate(_flat(y)):
            payload[f"p{k}y_{i}"] = leaf
    payload["converged"] = np.asarray(bool(converged))
    payload["ls_failed"] = np.asarray(bool(ls_failed))
    payload["aborted"] = np.asarray(bool(aborted))
    if fingerprint is not None:
        payload["fingerprint"] = np.asarray(fingerprint)
    payload["loss_history"] = (np.zeros(0) if loss_history is None
                               else np.asarray(loss_history))
    atomic_savez(path, payload)


class LoadedLBFGSCheckpoint(NamedTuple):
    warm: Any  # core.host_lbfgs.HostLBFGSWarm
    loss_history: np.ndarray
    converged: bool
    ls_failed: bool
    aborted: bool
    fingerprint: Optional[str]


def load_lbfgs_checkpoint(path: str, template: Any,
                          expect_fingerprint: Optional[str] = None,
                          ) -> Optional[LoadedLBFGSCheckpoint]:
    """Rebuild an L-BFGS checkpoint; None if absent.  ``template`` gives
    the weight tree's structure and device (normally ``w0``)."""
    from ..core.host_lbfgs import HostLBFGSWarm

    if not os.path.exists(path):
        return None
    data = _Entries(path, read_npz_entries(path))
    if "lbfgs" not in data:
        raise ValueError(
            f"checkpoint at {path!r} is not an L-BFGS checkpoint; "
            "load it with load_checkpoint / load_multi_checkpoint")
    fp = _check_fingerprint(path, data, expect_fingerprint)
    rho = np.asarray(data["rho"])
    pairs = tuple(
        (_load_tree(data, template, f"p{k}s"),
         _load_tree(data, template, f"p{k}y"), float(rho[k]))
        for k in range(int(data["n_pairs"])))
    warm = HostLBFGSWarm(
        w=_load_tree(data, template, "w"), f=float(data["f"]),
        g=_load_tree(data, template, "g"), pairs=pairs,
        prior_iters=int(data["prior_iters"]))
    return LoadedLBFGSCheckpoint(
        warm, np.asarray(data["loss_history"]),
        bool(data["converged"]), bool(data["ls_failed"]),
        bool(data["aborted"]), fp)


class CheckpointedLBFGSResult(NamedTuple):
    weights: Any
    loss_history: np.ndarray
    num_iters: int  # TOTAL iterations across all segments
    converged: bool
    ls_failed: bool
    aborted_non_finite: bool
    resumed_from: int


def run_lbfgs_checkpointed(
    objective,
    w0: Any,
    config,
    path: str,
    *,
    segment_iters: int = 10,
    l1_reg: float = 0.0,
) -> CheckpointedLBFGSResult:
    """Host L-BFGS with periodic checkpoints: ``segment_iters``
    iterations a segment, the carry saved after each; rerunning the same
    call after a kill continues to the uninterrupted run's answer
    (``core.host_lbfgs``'s exact resume).  ``l1_reg > 0`` drives the
    OWL-QN host twin (``objective`` is then the smooth part; histories
    hold F = f + l1·‖w‖₁), and the strength joins the fingerprint."""
    from ..core import host_lbfgs

    if segment_iters <= 0:
        raise ValueError("segment_iters must be positive")
    if l1_reg < 0:
        raise ValueError("l1_reg must be >= 0")
    # the suffix only in the OWL-QN mode: an l1_reg=0 fingerprint is the
    # plain L-BFGS one, and different strengths refuse each other's files
    fp = problem_fingerprint(w0, config)
    if l1_reg > 0:
        fp += f"|l1={float(l1_reg)!r}"
    loaded = load_lbfgs_checkpoint(path, w0, expect_fingerprint=fp)
    if loaded is not None:
        warm = loaded.warm
        hist = list(np.asarray(loaded.loss_history))
        if loaded.converged or loaded.ls_failed or loaded.aborted:
            return CheckpointedLBFGSResult(
                weights=warm.w, loss_history=np.asarray(hist),
                num_iters=int(warm.prior_iters),
                converged=loaded.converged, ls_failed=loaded.ls_failed,
                aborted_non_finite=loaded.aborted,
                resumed_from=int(warm.prior_iters))
    else:
        warm = None
        hist = []
    resumed_from = int(warm.prior_iters) if warm is not None else 0

    total = config.num_iterations
    converged = ls_failed = aborted = False
    while True:
        prior = warm.prior_iters if warm is not None else 0
        if warm is not None and prior >= total:
            break
        # a fresh run enters at least once even when total == 0, so the
        # w0 evaluation happens and the return below has a carry
        cap = min(prior + segment_iters, total)
        cfg_k = dataclasses.replace(config, num_iterations=cap)
        if l1_reg > 0:
            res = host_lbfgs.run_owlqn_host(objective, w0, l1_reg,
                                            cfg_k, warm=warm)
        else:
            res = host_lbfgs.run_lbfgs_host(objective, w0, cfg_k,
                                            warm=warm)
        seg_hist = np.asarray(res.loss_history)
        hist.extend(seg_hist.tolist() if not hist
                    else seg_hist[1:].tolist())
        warm = host_lbfgs.HostLBFGSWarm.from_result(
            res, prior_iters=prior)
        converged = bool(res.converged)
        ls_failed = bool(res.ls_failed)
        aborted = bool(res.aborted_non_finite)
        save_lbfgs_checkpoint(path, warm, np.asarray(hist),
                              converged=converged, ls_failed=ls_failed,
                              aborted=aborted, fingerprint=fp)
        if converged or ls_failed or aborted or res.num_iters == 0:
            break

    return CheckpointedLBFGSResult(
        weights=warm.w, loss_history=np.asarray(hist),
        num_iters=int(warm.prior_iters), converged=converged,
        ls_failed=ls_failed, aborted_non_finite=aborted,
        resumed_from=resumed_from)
