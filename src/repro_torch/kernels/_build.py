"""Build the CUDA kernel libraries from the package's sources at first use.

Each library is one ``.cu`` file with a plain C interface, compiled by
``nvcc`` for ``sm_90a`` into a shared object and loaded with ``ctypes``.
The output goes to ``_build/`` beside the source, named by a hash of the
source and the flags, so an edited source is rebuilt and an unchanged one
is loaded as is.  ``build_all`` starts one ``nvcc`` per library at once.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_KERNELS = Path(__file__).resolve().parent
# library name -> its source; one nvcc invocation per entry
SOURCES = {
    "staleness_agg": _KERNELS / "staleness_agg" / "csrc" / "staleness_agg.cu",
}

_loaded: dict = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def _target(name: str) -> Path:
    src = SOURCES[name]
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return src.parent.parent / "_build" / f"lib{name}-{digest.hexdigest()[:16]}.so"


def log_path(name: str) -> Path:
    """The compiler's output (``-Xptxas -v``: registers, spills) of a build."""
    return _target(name).with_suffix(".log")


def build_all(names=None) -> dict:
    """Compile every missing library (one ``nvcc`` each, all started
    together), load them, and return ``{name: ctypes.CDLL}``."""
    names = list(SOURCES if names is None else names)
    procs = {}
    for name in names:
        if name in _loaded:
            continue
        out = _target(name)
        if out.exists():
            continue
        out.parent.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT), tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        log_path(name).write_bytes(log)
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"{name}:\n{log.decode(errors='replace')}")
        else:
            os.replace(tmp, out)   # atomic: a concurrent loader sees all or nothing
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    for name in names:
        if name not in _loaded:
            _loaded[name] = ctypes.CDLL(str(_target(name)))
    return {name: _loaded[name] for name in names}


def library(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed."""
    if name not in _loaded:
        build_all([name])
    return _loaded[name]
