"""Build and load the hand-written CUDA kernels (nvcc -> ctypes).

Each kernel source under ``csrc/`` has a plain C interface, so it compiles
with ``nvcc`` alone in seconds (no PyTorch headers) into the git-ignored
``build/kernels`` directory at first launch, and loads with ctypes.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path
from typing import Callable, Optional, Sequence

from ..utils import tracing


class KernelError(RuntimeError):
    """A kernel library failed to build, load or launch. The engine never
    answers in its place: callers that degrade on other failures let this
    one through."""


CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
    "-ldl",  # csrc/hopper.cuh looks up libcuda's cuTensorMapEncodeTiled
)


def nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = Path(cuda_home) / "bin" / "nvcc"
    return str(path) if path.exists() else "nvcc"


def build_library(source: str, verbose: bool = False,
                  defines: Sequence[str] = (), tag: str = "") -> Path:
    """Compile ``csrc/<source>.cu`` into ``build/kernels/libsemcode_<source>.so``
    (``libsemcode_<source>_<tag>.so`` for a build with extra ``-D`` flags).

    Each build writes its own file and renames it into place, so concurrent
    processes never load a partial library. Raises on a compiler error;
    ``verbose`` prints ptxas's registers, shared memory and spills."""
    src = CSRC / f"{source}.cu"
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib = BUILD_DIR / f"libsemcode_{source}{'_' + tag if tag else ''}.so"
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, *defines, "-o", str(tmp), str(src)]
    if verbose:
        cmd.insert(1, "-Xptxas=-v")
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as exc:  # no nvcc on this machine
        raise KernelError(f"cannot run {cmd[0]}: {exc}") from exc
    if proc.returncode != 0:
        raise KernelError(
            f"nvcc failed building {src.name}:\n{proc.stdout}\n{proc.stderr}"
        )
    if verbose and (proc.stdout or proc.stderr):
        print(proc.stdout + proc.stderr, flush=True)
    os.replace(tmp, lib)
    return lib


class KernelLibrary:
    """One compiled kernel library, built and loaded at first launch.

    ``bind`` declares the C functions' argument and return types on the
    loaded ``ctypes.CDLL``."""

    def __init__(self, source: str, bind: Callable[[ctypes.CDLL], None],
                 defines: Sequence[str] = (), tag: str = ""):
        self.source = source
        self.defines = tuple(defines)
        self.tag = tag
        self._bind = bind
        self._lock = threading.Lock()
        self._lib: Optional[ctypes.CDLL] = None

    def build(self, verbose: bool = False) -> Path:
        return build_library(self.source, verbose=verbose,
                             defines=self.defines, tag=self.tag)

    def get(self, lib_path: Optional[Path] = None) -> ctypes.CDLL:
        """The loaded library; ``lib_path`` installs one built elsewhere
        (a caller may build in parallel with other work)."""
        with self._lock:
            if self._lib is None or lib_path is not None:
                path = lib_path
                if path is None:
                    with tracing.phase("kernels.build", self.source):
                        path = self.build()
                    tracing.count("kernels.built")
                try:
                    lib = ctypes.CDLL(str(path))
                except OSError as exc:
                    raise KernelError(f"cannot load {path}: {exc}") from exc
                self._bind(lib)
                self._lib = lib
                tracing.count("kernels.loaded")
            return self._lib
