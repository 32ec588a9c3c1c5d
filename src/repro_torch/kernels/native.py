"""Build, load and launch support for the port's CUDA kernels.

Every ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, and loaded with :mod:`ctypes`
(seconds to build, where a source including PyTorch's headers takes
minutes).  The build runs at first use, all sources at once (one ``nvcc``
process per source, started together), into ``src/repro_torch/_build/``
(listed in ``.gitignore``).  A library's file name carries a hash of its
source and flags, so an edited source is never served by a stale build.
``nvcc``'s ``-Xptxas -v`` report (registers, shared memory, spills) is kept
beside each library as ``<name>-<hash>.log``.

Nothing here runs at import: the CPU tests import every module of the port
on a machine without ``nvcc`` or a card.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

SOURCES = ("vmul_reduce", "rmsnorm", "flash_attention", "ssd_chunk")   # csrc/<name>.cu
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_PKG = Path(__file__).resolve().parent.parent

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


class LaunchCounter:
    """Launches of one CUDA kernel.  Its wrapper adds one where it launches
    the kernel and nowhere else, so a run can show that the main path went
    through the kernel (``chip_smoke.py`` resets and reads these).  A kernel
    built in variants also counts each launch under its variant in
    :attr:`by_variant`."""

    def __init__(self, name: str, variants: "tuple[str, ...]" = ()) -> None:
        self.name = name
        self.variants = variants
        self.reset()

    def reset(self) -> None:
        self.count = 0
        self.by_variant = dict.fromkeys(self.variants, 0)


def csrc_dir() -> Path:
    return _PKG / "csrc"


def build_dir() -> Path:
    return _PKG / "_build"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and Path(CUDA_HOME, "bin", "nvcc").exists():
        return str(Path(CUDA_HOME, "bin", "nvcc"))
    raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                       "the CUDA toolkit is installed")


def library_path(name: str) -> Path:
    src = csrc_dir() / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + repr(NVCC_FLAGS).encode())
    return build_dir() / f"{name}-{digest.hexdigest()[:12]}.so"


def build(names: "tuple[str, ...]" = SOURCES) -> dict[str, Path]:
    """Compile every missing library of ``names``, one ``nvcc`` per source,
    all started together.  Raises with the compiler's output on failure."""
    out = {n: library_path(n) for n in names}
    todo = [n for n in names if not out[n].exists()]
    if not todo:
        return out
    build_dir().mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for n in todo:
        tmp = out[n].with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(csrc_dir() / f"{n}.cu")]
        procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True))
    failed = []
    for n, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        out[n].with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{n}.cu (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out[n])            # atomic: readers never see a partial .so
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return out


@functools.cache
def libraries() -> dict[str, ctypes.CDLL]:
    """Every kernel library, built on first use and loaded once per process."""
    return {n: ctypes.CDLL(str(p)) for n, p in build().items()}


def c_function(library: str, symbol: str, argtypes: list) -> "ctypes._CFuncPtr":
    fn = getattr(libraries()[library], symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def check_launch(rc: int, kernel: str) -> None:
    """Raise when a C entry point reports a CUDA error (its
    ``cudaGetLastError()``): a refused launch never runs, and no later
    synchronise would report it."""
    if rc != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed with error code {rc}")


def raw_stream(index: int) -> int:
    """PyTorch's current CUDA stream on device ``index``, as the int ctypes
    passes, without building a ``torch.cuda.Stream`` object (the lookup the
    compiled code PyTorch generates makes on every launch)."""
    return torch._C._cuda_getCurrentRawStream(index)
