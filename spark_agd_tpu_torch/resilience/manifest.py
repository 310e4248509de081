"""Checksummed manifests — the COMMIT RECORD of a multi-host checkpoint.

A copy of ``spark_agd_tpu/resilience/manifest.py``, which needs only the
standard library and numpy; ``tests/test_torch_logging.py`` holds
everything after this docstring to the original, line for line.

The reference never faces this problem: Spark checkpoints nothing, and a
lost executor's partitions recompute from lineage.  Our SPMD port has N
processes each writing a shard file, and "the checkpoint exists" is only
true once ALL of them landed — a generation with a missing, torn, or
stale shard must be invisible to every loader.  The orbax-style answer
implemented here:

- every generation ``g`` consists of N shard files
  (``shard-g00000007.h000.npz`` …) plus ONE ``manifest-g00000007.json``;
- shard files are written first (atomic tempfile+rename per host); the
  manifest is written by the primary host ONLY AFTER an all-host
  barrier, so its existence proves every shard landed;
- the manifest carries the generation id, the saving topology
  (``process_count``, ``mesh_shape``), the problem fingerprint, and one
  ``{path, process, crc32, size}`` entry per shard — CRC32 of the FILE
  bytes, so a loader can verify a generation without parsing any npz;
- ``manifest.json`` is an atomically-replaced copy of the newest
  committed manifest (the "HEAD pointer"); per-generation manifests
  stay on disk as the fallback chain — the multi-host extension of the
  single-host ``.bak`` retention.

Loaders (``resilience.distributed``) walk generations newest → oldest
and REFUSE any generation whose manifest is unreadable, whose shard set
is incomplete, whose CRCs/sizes mismatch, or whose shards disagree on
the embedded generation id — falling back one generation instead of
resuming from a torn write.

Deliberately jax-free (stdlib + numpy): manifest reading/writing is
plain file IO a monitor process can do without a backend.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import tempfile
import time
import zlib
from typing import Dict, List, Optional

MANIFEST_FORMAT = "spark_agd_tpu.dist_checkpoint"
MANIFEST_VERSION = 1

# the HEAD pointer: an atomically-replaced copy of the newest committed
# per-generation manifest
HEAD_NAME = "manifest.json"

_MANIFEST_RE = re.compile(r"^manifest-g(\d{8})\.json$")


def shard_name(generation: int, process: int) -> str:
    """The shard file name convention: generation-stamped so a torn
    write of generation g+1 can never collide with (or shadow) a
    committed generation-g file."""
    return f"shard-g{generation:08d}.h{process:03d}.npz"


def manifest_name(generation: int) -> str:
    return f"manifest-g{generation:08d}.json"


def crc32_file(path: str, chunk: int = 1 << 20) -> int:
    """CRC32 of the file's bytes (streamed; shard files can be large)."""
    crc = 0
    with open(path, "rb") as f:
        while True:
            block = f.read(chunk)
            if not block:
                return crc
            crc = zlib.crc32(block, crc)


@dataclasses.dataclass(frozen=True)
class ShardEntry:
    """One host's shard in a committed generation."""

    path: str      # file name relative to the checkpoint directory
    process: int   # the saving host's process index
    crc32: int     # CRC32 of the file bytes
    size: int      # file size in bytes


@dataclasses.dataclass(frozen=True)
class Manifest:
    """One committed generation — see module docstring."""

    generation: int
    process_count: int
    shards: List[ShardEntry]
    mesh_shape: Optional[Dict[str, int]] = None
    fingerprint: Optional[str] = None
    converged: bool = False
    aborted: bool = False
    prior_iters: int = 0
    timestamp_unix: float = 0.0

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        d["format"] = MANIFEST_FORMAT
        d["manifest_version"] = MANIFEST_VERSION
        return json.dumps(d, indent=1, sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "Manifest":
        d = json.loads(text)
        if d.get("format") != MANIFEST_FORMAT:
            raise ValueError(
                f"not a {MANIFEST_FORMAT} manifest "
                f"(format={d.get('format')!r})")
        if d.get("manifest_version") != MANIFEST_VERSION:
            raise ValueError(
                f"manifest version {d.get('manifest_version')!r} "
                f"unsupported (this code reads {MANIFEST_VERSION})")
        shards = [ShardEntry(**s) for s in d["shards"]]
        return cls(
            generation=int(d["generation"]),
            process_count=int(d["process_count"]),
            shards=shards,
            mesh_shape=d.get("mesh_shape"),
            fingerprint=d.get("fingerprint"),
            converged=bool(d.get("converged", False)),
            aborted=bool(d.get("aborted", False)),
            prior_iters=int(d.get("prior_iters", 0)),
            timestamp_unix=float(d.get("timestamp_unix", 0.0)))

    def shard_path(self, directory: str, process: int) -> str:
        for s in self.shards:
            if s.process == process:
                return os.path.join(directory, s.path)
        raise KeyError(f"manifest g{self.generation} has no shard for "
                       f"process {process}")


def _atomic_write_text(path: str, text: str) -> None:
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".json.tmp")
    try:
        with os.fdopen(fd, "w") as f:
            f.write(text)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def write_manifest(directory: str, manifest: Manifest) -> str:
    """Commit one generation: write its per-generation manifest, then
    atomically repoint ``manifest.json`` at it.  The per-generation
    write is the commit point; a kill between the two writes leaves a
    stale HEAD, which loaders tolerate (they scan per-generation
    manifests when HEAD is older or unreadable)."""
    if manifest.timestamp_unix == 0.0:
        manifest = dataclasses.replace(
            manifest, timestamp_unix=round(time.time(), 3))
    text = manifest.to_json()
    path = os.path.join(directory, manifest_name(manifest.generation))
    _atomic_write_text(path, text)
    _atomic_write_text(os.path.join(directory, HEAD_NAME), text)
    return path


def repoint_head(directory: str, manifest: Manifest) -> str:
    """Atomically repoint ``manifest.json`` at an ALREADY-COMMITTED
    generation without writing a new one — the rollback half of the
    commit protocol (``serve.registry.repoint``).  The per-generation
    manifest chain is untouched; only the HEAD pointer moves, so a
    restart loads the repointed generation while every newer committed
    generation stays on disk as evidence."""
    head = os.path.join(directory, HEAD_NAME)
    _atomic_write_text(head, manifest.to_json())
    return head


def committed_generations(directory: str) -> List[int]:
    """Generation ids with a per-generation manifest on disk, newest
    first.  (A committed manifest may still fail verification — torn
    shards — which is what the loader's fallback walk is for.)"""
    if not os.path.isdir(directory):
        return []
    gens = []
    for name in os.listdir(directory):
        m = _MANIFEST_RE.match(name)
        if m:
            gens.append(int(m.group(1)))
    return sorted(gens, reverse=True)


def load_manifest(directory: str,
                  generation: Optional[int] = None) -> Optional[Manifest]:
    """Parse one manifest — the HEAD copy when ``generation`` is None
    (falling back to the newest per-generation file when HEAD is absent
    or unreadable).  Returns None when the directory holds no manifest
    at all; raises ``ValueError`` on a present-but-garbage file only
    when it was explicitly requested by generation."""
    if generation is not None:
        path = os.path.join(directory, manifest_name(generation))
        if not os.path.exists(path):
            return None
        with open(path) as f:
            return Manifest.from_json(f.read())
    head = os.path.join(directory, HEAD_NAME)
    if os.path.exists(head):
        try:
            with open(head) as f:
                return Manifest.from_json(f.read())
        except (ValueError, OSError):
            pass  # torn HEAD rewrite: fall through to the scan
    gens = committed_generations(directory)
    if not gens:
        return None
    return load_manifest(directory, gens[0])


def verify_manifest(manifest: Manifest, directory: str) -> List[str]:
    """File-level verification of one committed generation: every shard
    present, with the manifest's exact size and CRC32.  Returns the
    problem list (``[]`` = the generation is loadable); the npz-level
    checks (embedded generation id, per-entry CRCs) happen in the
    loader, which must parse the shards anyway."""
    problems = []
    if len(manifest.shards) != manifest.process_count:
        problems.append(
            f"manifest g{manifest.generation} lists "
            f"{len(manifest.shards)} shards for process_count="
            f"{manifest.process_count}")
    seen = set()
    for s in manifest.shards:
        if s.process in seen:
            problems.append(f"duplicate shard for process {s.process}")
        seen.add(s.process)
        path = os.path.join(directory, s.path)
        if not os.path.exists(path):
            problems.append(f"shard {s.path} missing")
            continue
        size = os.path.getsize(path)
        if size != s.size:
            problems.append(
                f"shard {s.path}: size {size} != manifest {s.size} "
                "(torn write)")
            continue
        crc = crc32_file(path)
        if crc != s.crc32:
            problems.append(
                f"shard {s.path}: CRC32 {crc:#010x} != manifest "
                f"{s.crc32:#010x} (corrupt or stale file)")
    return problems


def gc_generations(directory: str, keep: int) -> List[str]:
    """Delete shard+manifest files of all but the ``keep`` newest
    committed generations (primary-host housekeeping after a commit).
    Returns the removed file names.  Uncommitted shard files (a torn
    write's orphans from a DEAD generation — older than the newest
    committed one) are removed too; orphans NEWER than the newest
    commit are left alone (they may be a commit in flight)."""
    gens = committed_generations(directory)
    if not gens:
        return []
    keep_set = set(gens[:max(1, keep)])
    newest = gens[0]
    removed = []
    for name in sorted(os.listdir(directory)):
        m = _MANIFEST_RE.match(name)
        g = None
        if m:
            g = int(m.group(1))
        else:
            s = re.match(r"^shard-g(\d{8})\.h\d{3}\.npz$", name)
            if s:
                g = int(s.group(1))
        if g is None or g in keep_set or g > newest:
            continue
        os.unlink(os.path.join(directory, name))
        removed.append(name)
    return removed
