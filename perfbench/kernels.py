"""Kernel libraries kept between runs in one checkout.

The program compiles each hand-written CUDA library with ``nvcc`` at its
first launch in every process (``semcode_tpu_torch/ops/build.py``). A run
installs, through ``KernelLibrary.get(lib_path=...)``, a library that an
earlier run in the same checkout built from the same sources and flags, and
keeps each library it built itself for the next run. A library is found by a
hash of ``build.py``, every file under ``csrc/``, its ``-D`` flags and its
name, so a change to any of them builds afresh and a stale build is never
loaded. The cache sits at a fixed path inside the checkout (``build/`` is
git-ignored).
"""

from __future__ import annotations

import hashlib
import os
import shutil
from pathlib import Path
from typing import List, Tuple

from .spec import ROOT

CACHE = ROOT / "build" / "perfbench-kernels"
# the modules whose KernelLibrary serves the timed path
MODULES = ("ivf_scan", "scan_top2", "dot_max")


def libraries() -> List[Tuple[object, Path]]:
    """(library, the file its build writes) of each module in MODULES."""
    import importlib

    from semcode_tpu_torch.ops import build

    out = []
    for name in MODULES:
        lib = importlib.import_module(f"semcode_tpu_torch.ops.{name}")._library
        tag = f"_{lib.tag}" if lib.tag else ""
        out.append((lib, Path(build.BUILD_DIR) / f"libsemcode_{lib.source}{tag}.so"))
    return out


def key(lib) -> str:
    """The hash a library's build is found by."""
    from semcode_tpu_torch.ops import build

    h = hashlib.sha256()
    h.update(Path(build.__file__).read_bytes())
    for src in sorted(Path(build.CSRC).iterdir()):
        if src.is_file():
            h.update(src.name.encode() + b"\0" + src.read_bytes())
    h.update(repr((lib.source, lib.defines, lib.tag)).encode())
    return h.hexdigest()[:32]


def cached(lib) -> Path:
    tag = f"_{lib.tag}" if lib.tag else ""
    return CACHE / key(lib) / f"libsemcode_{lib.source}{tag}.so"


def install() -> List[str]:
    """Load every library an earlier run kept; returns what it did. A
    library that fails to load is left for the program to build."""
    done = []
    for lib, _ in libraries():
        path = cached(lib)
        if not path.exists():
            continue
        try:
            lib.get(lib_path=path)
            done.append(f"{lib.source}: installed")
        except Exception as exc:  # noqa: BLE001 - the program builds it instead
            done.append(f"{lib.source}: not installed ({exc})")
    return done


def keep() -> List[str]:
    """Keep each library this process built (loaded, and not yet in the
    cache); returns their names."""
    done = []
    for lib, built in libraries():
        path = cached(lib)
        if lib._lib is None or path.exists() or not built.exists():
            continue
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        shutil.copyfile(built, tmp)
        os.replace(tmp, path)
        done.append(lib.source)
    return done
