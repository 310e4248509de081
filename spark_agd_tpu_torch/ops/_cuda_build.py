"""Build the port's CUDA sources with ``nvcc`` (loaded with ctypes).

Each library is one shared object with a plain C interface, compiled at
first use from ``spark_agd_tpu_torch/csrc`` into
``spark_agd_tpu_torch/_build/`` for ``sm_90a`` (Hopper): beside the
sources, in a checkout and in an install alike, so the package directory
must be writable at first use.
The file name carries a hash of the sources and flags, so an edited
source builds anew and an unchanged one is reused.  Nothing here runs at
import time.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

PACKAGE = Path(__file__).resolve().parents[1]
CSRC = PACKAGE / "csrc"
BUILD_DIR = PACKAGE / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def find_nvcc() -> str:
    """``nvcc`` on the PATH, else under ``$CUDA_HOME`` or
    ``/usr/local/cuda``; raises when there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME, /usr/local/cuda); "
                       "the port's CUDA kernels build on a machine with the "
                       "CUDA toolkit")


class BuiltLibrary:
    """A compiled shared object: its path, how long the build took (0.0
    when an earlier build was reused) and the compiler's report."""

    def __init__(self, path: Path, seconds: float, log: str):
        self.path = path
        self.seconds = seconds
        self.log = log


def build(name: str, sources) -> BuiltLibrary:
    """Compile ``sources`` (file names under ``csrc/``, or paths to
    sources elsewhere) into ``_build/lib<name>-<hash>.so``, unless it
    exists.  The hash covers the sources and every header beside
    them."""
    paths = [CSRC / s for s in sources]
    headers = sorted({h for p in paths for h in p.parent.glob("*.cuh")})
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in paths + headers:
        digest.update(p.name.encode())
        digest.update(p.read_bytes())
    out = BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"
    if out.is_file():
        return BuiltLibrary(out, 0.0, "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, paths)]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}) building "
                               f"{name}:\n{proc.stdout}{proc.stderr}")
        # another process may have built the same file meanwhile; the
        # rename is atomic either way
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return BuiltLibrary(out, time.perf_counter() - t0,
                        proc.stdout + proc.stderr)
