"""Build and bind the hand-written Hopper kernels in ``nnal_tpu_torch/csrc``.

Each ``.cu`` source exposes a plain C function and is compiled on its own
by ``nvcc`` for ``sm_90a`` into a shared library under
``nnal_tpu_torch/_build/`` (named by the hash of the source and of its
nvcc flags -- the common ones plus any a kernel adds -- so an edited
source or flag rebuilds and an unchanged one loads as is), then bound
with ``ctypes``.  Nothing builds at import time: the first launch builds, or
:func:`build_all` builds every kernel at once with one ``nvcc`` process
per source running in parallel.  A failed build raises with nvcc's
stderr.

``_build/`` is the port's counterpart of the JAX package's persistent XLA
compilation cache (``nnal_tpu/core/compile_cache.py``): XLA compiles
every program at run time and keeps it on disk under a key hashed from
the program; the port compiles only its hand-written kernels and host
libraries (``runtime/gxx`` builds into the same directory), and the hash
of source and flags in each file name is that key.  Nothing else of that
module has a role here (``NNAL_COMPILE_CACHE``, its directory switch,
configures JAX); ``cli/prime_cache`` fills the directory ahead of a run.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import List, Optional, Sequence

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def find_nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin): the CUDA kernels cannot build")


class CudaKernel:
    """One ``csrc`` source, its C entry point, and a launch counter.

    ``launches`` counts calls that launched the kernel on the card (the
    wrapper calls :meth:`launch`); plain-version calls never touch it."""

    def __init__(self, name: str, source: str, symbol: str,
                 argtypes: Sequence, extra_flags: Sequence[str] = ()):
        self.name = name
        self.source = CSRC / source
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.flags = (*NVCC_FLAGS, *extra_flags)
        self.launches = 0
        self.build_log = ""
        self.build_s = 0.0
        self._fn = None

    def lib_path(self) -> Path:
        digest = hashlib.sha256(self.source.read_bytes()
                                + " ".join(self.flags).encode()).hexdigest()
        return BUILD_DIR / f"{self.source.stem}-{digest[:16]}.so"

    def _start_build(self) -> Optional[subprocess.Popen]:
        out = self.lib_path()
        if out.exists():
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
        os.close(fd)
        proc = subprocess.Popen(
            [find_nvcc(), *self.flags, "-o", tmp, str(self.source)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        proc.tmp, proc.out, proc.t0 = tmp, out, time.perf_counter()
        return proc

    def _finish_build(self, proc: Optional[subprocess.Popen]) -> None:
        if proc is None:
            return
        stdout, stderr = proc.communicate()
        self.build_s = time.perf_counter() - proc.t0
        self.build_log = stdout + stderr
        if proc.returncode != 0:
            os.unlink(proc.tmp)
            raise RuntimeError(f"nvcc failed for {self.source.name} "
                               f"(rc={proc.returncode}):\n{stderr}")
        os.replace(proc.tmp, proc.out)

    def _bind(self):
        if self._fn is None:
            self._finish_build(self._start_build())
            fn = getattr(ctypes.CDLL(str(self.lib_path())), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def launch(self, *args) -> None:
        """Call the C entry point (which launches on the given stream and
        returns ``cudaGetLastError()``); raise on a refused launch."""
        err = self._bind()(*args)
        if err != 0:
            raise RuntimeError(f"{self.name}: CUDA launch failed with "
                               f"cudaError {err}")
        self.launches += 1


def build_all(kernels: List[CudaKernel]) -> None:
    """Build every kernel not yet built, one nvcc per source, in parallel,
    then bind them all."""
    procs = [(k, k._start_build()) for k in kernels]
    for k, p in procs:
        k._finish_build(p)
    for k in kernels:
        k._bind()


def stream_ptr(t) -> int:
    """The current CUDA stream of ``t``'s device, as an int for ctypes.
    The raw lookup (what PyTorch's own generated code calls) skips the
    ``torch.cuda.Stream`` object that ``torch.cuda.current_stream`` builds,
    a host cost that a small launch feels (``chip_smoke.py`` times both)."""
    import torch

    return torch._C._cuda_getCurrentRawStream(t.device.index)


VOIDP = ctypes.c_void_p
INT = ctypes.c_int
LONG = ctypes.c_longlong
