"""Build the port's CUDA sources into shared libraries and load them with ctypes.

Each source under ``flow_timesnet_tpu_torch/csrc/`` exposes a plain C
interface, so ``nvcc`` compiles it in seconds without PyTorch's headers. The
library lands in ``build/flow_timesnet_tpu_torch/`` at the repository root,
named by a hash of the source, the shared headers (``csrc/*.cuh``) and the
flags, so an edited source or header is rebuilt
and an unchanged one is loaded as it is. Nothing is built at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "flow_timesnet_tpu_torch"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-lineinfo", "-Xptxas", "-v",
    "-shared", "-Xcompiler", "-fPIC",
)


def find_nvcc() -> str:
    """``nvcc`` from PATH, else from ``$CUDA_HOME/bin`` or the toolkit's default prefix."""

    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    for cand in (shutil.which("nvcc"), os.path.join(home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(f"nvcc not found on PATH or in {home}/bin")


def library_path(source: str) -> Path:
    """Where the library built from ``csrc/<source>`` lives for this content:
    the source, every header of ``csrc/`` (the sources include them) and the
    flags."""

    digest = hashlib.sha256()
    digest.update((CSRC_DIR / source).read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        digest.update(header.name.encode())
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{Path(source).stem}-{digest.hexdigest()[:16]}.so"


def build(source: str) -> Path:
    """Compile ``csrc/<source>`` unless its library exists; returns its path.

    The compiler's report (registers, shared memory, spills per kernel) is
    kept beside the library as ``<name>.log``. Concurrent builders are safe:
    each writes a private temporary file and renames it into place.
    """

    out = library_path(source)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC_DIR / source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for {source}:\n{proc.stdout}\n{proc.stderr}")
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return out


def sources() -> List[str]:
    """Every CUDA source of the package, by name under ``csrc/``."""

    return sorted(p.name for p in CSRC_DIR.glob("*.cu"))


def build_all() -> Dict[str, Path]:
    """Build every source at once, one ``nvcc`` process each."""

    with ThreadPoolExecutor(max_workers=max(1, len(sources()))) as pool:
        return dict(zip(sources(), pool.map(build, sources())))


def load(source: str) -> ctypes.CDLL:
    """Build ``csrc/<source>`` if needed and load it."""

    return ctypes.CDLL(str(build(source)))
