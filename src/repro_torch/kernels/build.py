"""Build and load the hand-written CUDA kernels.

Each source under ``kernels/indexmac/csrc`` is compiled by ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface (no PyTorch
headers, so a build takes seconds) and loaded with ``ctypes``. Libraries
go to ``build/repro_torch/`` at the repository root (listed in
``.gitignore``), named by a hash of the sources and flags, so an edited
source is rebuilt and an unchanged one is not. :func:`build_all` starts
one ``nvcc`` per source at once and waits for all of them.

Nothing here runs at import: the first launch of a kernel builds and
loads its library.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "indexmac" / "csrc"
SOURCES = {"nm_spmm": "nm_spmm.cu", "nm_spmm_q": "nm_spmm_q.cu",
           "nm_spmm_decode": "nm_spmm_decode.cu",
           "nm_spmm_decode_q": "nm_spmm_decode_q.cu"}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}


def build_dir() -> Path:
    """``build/repro_torch`` at the root of the checkout."""
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch"


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    for cand in (os.path.join(home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                       "build only where the CUDA toolkit is installed")


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.iterdir()):  # every source and header
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return build_dir() / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all(names=tuple(SOURCES)) -> dict[str, str]:
    """Compile every missing library, one ``nvcc`` per source in
    parallel. Returns ``{name: ptxas report}`` for the libraries built
    now (registers, shared memory and spills per kernel)."""
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    reports, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exit {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent builder sees all or none
        reports[name] = log
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return reports


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name`` (built first if it is missing)."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build_all((name,))
            lib = ctypes.CDLL(str(library_path(name)))
            _LIBS[name] = lib
        return lib


class CudaKernel:
    """One C entry point of a kernel library, and its launch count.

    ``argtypes`` are ctypes types (``c_void_p`` for every pointer and the
    stream, ``c_int`` for ints). Calling it launches the kernel; a
    non-zero return (the C function's ``cudaGetLastError()``) raises,
    and only a launch that succeeded adds one to ``launches``.
    """

    def __init__(self, name: str, argtypes: tuple):
        self.name = name
        self.argtypes = list(argtypes)
        self.launches = 0
        self._fn = None

    def __call__(self, *args) -> None:
        if self._fn is None:
            fn = getattr(load(self.name), self.name)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        rc = self._fn(*args)
        if rc != 0:
            raise RuntimeError(f"{self.name}: kernel launch failed with CUDA "
                               f"error {rc}")
        self.launches += 1
