"""Build and load the hand-written CUDA kernels.

Each source under ``csrc/`` compiles with ``nvcc`` into a shared library
with a plain C interface, which the kernel's wrapper loads with
``ctypes``.  Libraries go to ``build/kernels/`` at the root of the
checkout, named by a hash of their source, and are built at first use;
``build_all`` starts one ``nvcc`` per source, all at once.
Nothing is built when a module is imported: the CPU tests import every
module and have no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().with_name("csrc")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES: Dict[str, str] = {"flash_decode": "flash_decode.cu",
                           "int8_matmul": "int8_matmul.cu",
                           "mel_frontend": "mel_frontend.cu",
                           "flash_attention": "flash_attention.cu",
                           "mamba_scan": "mamba_scan.cu"}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# The two long builds run nvcc's optimizer on every core, which cuts
# flash_decode.cu's build, the longest, by more than half; ptxas reports
# the same registers, stack and spills for every kernel of both.
# int8_matmul.cu is left out: one of its kernels takes 64 registers there
# instead of 62.  scripts/chip_build_times.py measures both (PERF.md).
SPLIT_COMPILE = ("flash_decode", "flash_attention")


def nvcc_flags(name: str) -> tuple:
    """The flags that build ``name``'s source."""
    split = ("--split-compile=0",) if name in SPLIT_COMPILE else ()
    return NVCC_FLAGS + split

_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a"
                           " machine with the CUDA toolkit")
    return found


def library_path(name: str) -> Path:
    src = (CSRC / SOURCES[name]).read_bytes()
    tag = hashlib.sha256(src + " ".join(nvcc_flags(name)).encode()
                         ).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{tag}.so"


def _start(name: str):
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = library_path(name)
    # build under a private name, publish with an atomic rename: two
    # processes building at once never load a half-written library
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *nvcc_flags(name), "-o", str(tmp),
           str(CSRC / SOURCES[name])]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    return proc, tmp, out


def _finish(name: str, job) -> str:
    proc, tmp, out = job
    stdout, stderr = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"kernel build failed: {name}: nvcc exited"
                           f" {proc.returncode}\n{stdout}{stderr}")
    os.replace(tmp, out)
    return stderr


def build_all(names: Iterable[str] = tuple(SOURCES)) -> Dict[str, str]:
    """Compile every named source with ``nvcc``, one process per source,
    all started together; returns each compiler's log (ptxas' register
    and shared-memory report).  Once every process has ended, raises
    with the output of each one that failed."""
    jobs = {name: _start(name) for name in names}
    logs, errors = {}, []
    for name, job in jobs.items():
        try:
            logs[name] = _finish(name, job)
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))
    return logs


def build(name: str) -> str:
    """Compile ``name``'s source with ``nvcc``; returns the compiler's
    log.  Raises with the compiler's output on failure."""
    return _finish(name, _start(name))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``name``, built first if it is missing."""
    if name not in _loaded:
        path = library_path(name)
        if not path.exists():
            build(name)
        _loaded[name] = ctypes.CDLL(str(path))
    return _loaded[name]
