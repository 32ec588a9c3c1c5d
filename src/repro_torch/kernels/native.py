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

Two threads may reach a kernel at once (the serving thread and a scheduler
worker capturing a CUDA graph): :func:`build` and :func:`libraries` run
under one process-wide lock, so each library is built and loaded once, and
a :class:`LaunchCounter` adds under its own lock.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

SOURCES = ("vmul_reduce", "rmsnorm", "flash_attention", "ssd_chunk")   # csrc/<name>.cu
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_PKG = Path(__file__).resolve().parent.parent

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# one build and one load of the libraries per process, whatever the threads
_build_lock = threading.RLock()
# per thread: where a CUDA-graph capture in progress books its launches
_capturing = threading.local()


class LaunchCounter:
    """Launches of one CUDA kernel, by variant.  Its wrapper calls
    :meth:`add` where it launches the kernel and nowhere else, so a run can
    show that the main path went through the kernel (``chip_smoke.py``
    resets and reads :attr:`count` and :attr:`by_variant`)."""

    def __init__(self, name: str, variants: "tuple[str, ...]") -> None:
        self.name = name
        self.variants = variants
        self._lock = threading.Lock()
        self.reset()

    def reset(self) -> None:
        with self._lock:
            self.count = 0
            self.by_variant = dict.fromkeys(self.variants, 0)

    def add(self, variant: str, n: int = 1) -> None:
        """Book ``n`` launches of ``variant``.  On a thread that is
        capturing a CUDA graph (:func:`recording_launches`) they go to the
        capture's record instead: a capture records launches and runs none,
        and its replays add them here."""
        record = getattr(_capturing, "record", None)
        if record is not None:
            record[(self, variant)] = record.get((self, variant), 0) + n
            return
        with self._lock:
            self.count += n
            self.by_variant[variant] += n


@contextlib.contextmanager
def recording_launches():
    """Collect the launches the calling thread books while the block runs,
    as ``{(counter, variant): n}``, instead of adding them to the counters
    (a CUDA-graph capture).  Other threads keep counting as usual."""
    outer = getattr(_capturing, "record", None)
    _capturing.record = record = {}
    try:
        yield record
    finally:
        _capturing.record = outer


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
    all started together.  Raises with the compiler's output on failure.
    A second thread waits for the first one's build instead of starting its
    own ``nvcc`` onto the same output."""
    with _build_lock:
        return _build(names)


def _build(names: "tuple[str, ...]") -> dict[str, Path]:
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


def libraries() -> dict[str, ctypes.CDLL]:
    """Every kernel library, built on first use and loaded once per process."""
    with _build_lock:
        return _load()


@functools.cache
def _load() -> dict[str, ctypes.CDLL]:
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
