"""Versioned model registry over the CRC-verified manifest machinery.

Counterpart of ``spark_agd_tpu/serve/registry.py``, over the port's
``resilience.manifest`` (a copy of the JAX package's) and
``models.glm.save_model`` / ``load_model`` (the JAX package's npz
layout), so a generation set published by either package loads in the
other.  A published generation is one shard npz (the model snapshot,
written atomically with per-entry CRCs) plus one
``manifest-gNNNNNNNN.json`` carrying the file-level CRC32/size,
committed by atomically repointing ``manifest.json``:

- a generation is visible only once fully landed (manifest-after-shard
  ordering);
- a torn, truncated, or bit-flipped shard FAILS ``verify_manifest`` and
  the loader walks back one generation instead of serving garbage;
- old generations are the rollback chain (``keep`` newest retained).

Hot swap: ``refresh(engine=...)`` loads the newest verifiable
generation and binds its weights into the running engine — in-flight
batches finish on the old generation and the next batch serves the new
one.  Loaded models go to the registry's ``device`` (the current CUDA
device unless the caller passes ``device="cpu"``).

``telemetry=`` emits the JAX package's ``recovery`` records: a publish
(``checkpoint``), a skipped generation (``checkpoint_fallback``) and a
swap (``hot_swap``).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, List, Optional

from .._device import resolve_device
from ..resilience import manifest as mf
from ..utils.checkpoint import CheckpointCorruptError

DEFAULT_KEEP = 4

# serving is single-process on the loading side: the one shard of a
# published generation is written as process 0
_SHARD_PROCESS = 0


@dataclasses.dataclass
class LoadedModel:
    """One verified, loaded generation."""

    generation: int
    model: Any
    path: str                 # the shard file the model came from
    manifest: mf.Manifest


class ModelRegistry:
    """See module docstring."""

    def __init__(self, directory: str, *, telemetry=None,
                 fingerprint: Optional[str] = None,
                 keep: int = DEFAULT_KEEP, device=None):
        self.directory = str(directory)
        self.telemetry = telemetry
        self.device = resolve_device(device)
        self.fingerprint = fingerprint
        self.keep = max(1, int(keep))
        self._current: Optional[LoadedModel] = None

    # -- publishing --------------------------------------------------------
    def newest_generation(self) -> int:
        """Newest committed generation id (0 when none)."""
        gens = mf.committed_generations(self.directory)
        return gens[0] if gens else 0

    def publish(self, model, *, converged: bool = False,
                prior_iters: int = 0) -> int:
        """Commit one model snapshot as the next generation: shard
        first (atomic npz), manifest after — the same write ordering
        the distributed checkpointer uses, so a crash mid-publish
        leaves an invisible orphan, never a half-visible generation.
        Returns the new generation id."""
        from ..models.glm import save_model

        os.makedirs(self.directory, exist_ok=True)
        generation = self.newest_generation() + 1
        shard = mf.shard_name(generation, _SHARD_PROCESS)
        path = os.path.join(self.directory, shard)
        save_model(model, path)
        entry = mf.ShardEntry(path=shard, process=_SHARD_PROCESS,
                              crc32=mf.crc32_file(path),
                              size=os.path.getsize(path))
        man = mf.Manifest(generation=generation, process_count=1,
                          shards=[entry], fingerprint=self.fingerprint,
                          converged=bool(converged),
                          prior_iters=int(prior_iters))
        mf.write_manifest(self.directory, man)
        mf.gc_generations(self.directory, self.keep)
        if self.telemetry is not None:
            self.telemetry.recovery(
                action="checkpoint", generation=generation, path=shard,
                source="serve.registry", tool="serve.registry")
        return generation

    # -- loading -----------------------------------------------------------
    def load(self, generation: Optional[int] = None) -> LoadedModel:
        """Load one specific generation (default: the HEAD manifest's),
        REFUSING anything unverifiable: a missing manifest raises
        ``LookupError``, a failed file-level CRC/size check or an
        unparseable shard raises ``CheckpointCorruptError`` — exactly
        the training-side loader contract, with no fallback."""
        man = mf.load_manifest(self.directory, generation)
        if man is None:
            raise LookupError(
                f"no committed generation"
                + (f" g{generation}" if generation is not None else "")
                + f" in {self.directory!r}")
        return self._load_manifest(man)

    def _load_manifest(self, man: mf.Manifest) -> LoadedModel:
        from ..models.glm import load_model

        problems = mf.verify_manifest(man, self.directory)
        if problems:
            raise CheckpointCorruptError(
                self.directory,
                ValueError(f"generation g{man.generation}: "
                           + "; ".join(problems)))
        path = man.shard_path(self.directory, _SHARD_PROCESS)
        try:
            model = load_model(path, self.device)
        except (ValueError, KeyError, OSError) as e:
            raise CheckpointCorruptError(path, e) from e
        return LoadedModel(man.generation, model, path, man)

    def load_newest(self) -> Optional[LoadedModel]:
        """Walk committed generations newest → oldest, returning the
        first that verifies and loads; unverifiable generations are
        skipped with a ``checkpoint_fallback`` recovery record (the
        multi-generation ``.bak`` chain, serving edition).  None when
        nothing loadable exists."""
        for generation in mf.committed_generations(self.directory):
            man = mf.load_manifest(self.directory, generation)
            if man is None:
                continue
            try:
                return self._load_manifest(man)
            except CheckpointCorruptError as e:
                if self.telemetry is not None:
                    self.telemetry.recovery(
                        action="checkpoint_fallback",
                        generation=generation, reason=str(e)[:200],
                        source="serve.registry", tool="serve.registry")
        return None

    # -- hot swap ----------------------------------------------------------
    @property
    def current(self) -> Optional[LoadedModel]:
        return self._current

    def refresh(self, engine=None) -> Optional[int]:
        """Poll for a newer loadable generation; when found, bind it
        into ``engine`` (when given) and emit a ``hot_swap`` recovery
        record.  Returns the new generation id, or None when already
        current (or nothing loadable).  A spec-incompatible generation
        propagates ``ServeSpecMismatch`` from the engine — the registry
        never half-swaps."""
        newest = self.newest_generation()
        have = self._current.generation if self._current else 0
        if newest <= have and self._current is not None:
            return None
        loaded = self.load_newest()
        if loaded is None or (self._current is not None
                              and loaded.generation <= have):
            return None
        if engine is not None:
            engine.bind(loaded.model, loaded.generation)
        previous = have
        self._current = loaded
        if self.telemetry is not None:
            self.telemetry.recovery(
                action="hot_swap", generation=loaded.generation,
                from_generation=previous, source="serve.registry",
                tool="serve.registry")
        return loaded.generation

    # -- rollback ----------------------------------------------------------
    def previous(self, generation: Optional[int] = None) -> Optional[int]:
        """The newest VERIFIABLE committed generation strictly older
        than ``generation`` (default: the currently-bound generation,
        falling back to HEAD's).  Unverifiable generations along the
        walk are skipped with a ``checkpoint_fallback`` recovery record,
        exactly like ``load_newest``; None when nothing older is
        loadable — the rollback chain is exhausted."""
        if generation is None:
            if self._current is not None:
                generation = self._current.generation
            else:
                head = mf.load_manifest(self.directory)
                if head is None:
                    return None
                generation = head.generation
        for g in mf.committed_generations(self.directory):
            if g >= generation:
                continue
            man = mf.load_manifest(self.directory, g)
            if man is None:
                continue
            if not mf.verify_manifest(man, self.directory):
                return g
            if self.telemetry is not None:
                self.telemetry.recovery(
                    action="checkpoint_fallback", generation=g,
                    reason="skipped while walking back: failed "
                           "file-level verification",
                    source="serve.registry", tool="serve.registry")
        return None

    def repoint(self, generation: int, engine=None) -> LoadedModel:
        """Deliberately move serving HEAD to ``generation`` — forward
        (promotion) or backward (rollback).  The target must be a
        committed, verifiable generation: a missing manifest raises
        ``LookupError``, a torn shard raises ``CheckpointCorruptError``
        (``checkpoint_fallback``-recorded) — the registry never repoints
        at garbage.  On success the manifest HEAD pointer is atomically
        rewritten (so a restart serves this generation), the model is
        bound into ``engine`` when given, and a ``hot_swap`` recovery
        record ties the movement into the trace."""
        man = mf.load_manifest(self.directory, generation)
        if man is None:
            raise LookupError(
                f"no committed generation g{generation} in "
                f"{self.directory!r}")
        try:
            loaded = self._load_manifest(man)
        except CheckpointCorruptError:
            if self.telemetry is not None:
                self.telemetry.recovery(
                    action="checkpoint_fallback", generation=generation,
                    reason="repoint refused: target failed "
                           "verification",
                    source="serve.registry", tool="serve.registry")
            raise
        mf.repoint_head(self.directory, man)
        if engine is not None:
            engine.bind(loaded.model, loaded.generation)
        previous = (self._current.generation
                    if self._current is not None else 0)
        self._current = loaded
        if self.telemetry is not None:
            self.telemetry.recovery(
                action="hot_swap", generation=loaded.generation,
                from_generation=previous, source="serve.registry",
                tool="serve.registry")
        return loaded

    def gc(self) -> List[str]:
        """Housekeeping: drop all but the ``keep`` newest generations
        (same in-flight-orphan sparing as the training GC)."""
        return mf.gc_generations(self.directory, self.keep)
