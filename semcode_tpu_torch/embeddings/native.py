"""ctypes loader for the native featurizer (native/featurizer.cpp).

Builds the shared library on first use, into the git-ignored ``build/native``
directory (never into ``native/``, which belongs to the JAX package), if a
C++ toolchain is available, and falls back to the pure-Python featurizer
otherwise. The native path is byte-for-byte equivalent (same tokens,
buckets, signs, weights) — enforced by tests/test_native_featurizer.py for
the source and by tests/test_torch_hash_embedder.py for this loader.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..logger import get_logger

log = get_logger("embeddings.native")

_ROOT = Path(__file__).resolve().parents[2]
_SRC = _ROOT / "native" / "featurizer.cpp"
_LIB = _ROOT / "build" / "native" / "libsemcode_native.so"

_lib: Optional[ctypes.CDLL] = None
_tried = False


def _build() -> bool:
    if not _SRC.exists():
        return False
    # concurrent processes (test workers) may build at once: each writes its
    # own file and renames it into place, so no loader sees a partial library
    tmp = _LIB.with_name(f"{_LIB.name}.{os.getpid()}.tmp")
    try:
        _LIB.parent.mkdir(parents=True, exist_ok=True)
        subprocess.run(
            [
                "g++",
                "-O3",
                "-march=native",
                "-shared",
                "-fPIC",
                "-o",
                str(tmp),
                str(_SRC),
                "-lz",
            ],
            check=True,
            capture_output=True,
            timeout=120,
        )
        os.replace(tmp, _LIB)
        return True
    except (subprocess.SubprocessError, FileNotFoundError) as exc:
        log.warning("native_build_failed", error=str(exc))
        return False


def get_native():
    """Return the loaded CDLL or None."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    stale = (
        _LIB.exists()
        and _SRC.exists()
        and _SRC.stat().st_mtime > _LIB.stat().st_mtime
    )
    if (not _LIB.exists() or stale) and not _build() and not _LIB.exists():
        return None
    try:
        lib = ctypes.CDLL(str(_LIB))
        lib.semcode_featurize_batch.argtypes = [
            ctypes.c_char_p,
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_int,
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
        ]
        lib.semcode_featurize_batch.restype = None
        if hasattr(lib, "semcode_strip_noise"):
            lib.semcode_strip_noise.argtypes = [
                ctypes.c_char_p,
                ctypes.c_long,
                ctypes.c_char_p,
            ]
            lib.semcode_strip_noise.restype = None
        _lib = lib
        log.info("native_featurizer_loaded", path=str(_LIB))
    except OSError as exc:
        log.warning("native_load_failed", error=str(exc))
        _lib = None
    return _lib


def strip_noise_native(text: str) -> Optional[str]:
    """C implementation of cparse.strip_noise (byte-parity, ASCII only —
    multibyte chars would shift char/byte offsets; unicode files use the
    Python path). None when unavailable."""
    if not text.isascii():
        return None
    lib = get_native()
    if lib is None or not hasattr(lib, "semcode_strip_noise"):
        return None
    raw = text.encode("ascii")
    out = ctypes.create_string_buffer(len(raw) + 1)
    lib.semcode_strip_noise(raw, len(raw), out)
    return out.raw[: len(raw)].decode("ascii")


def featurize_batch(
    texts: Sequence[str], max_features: int, n_buckets: int
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Native batch featurization; None when the library is unavailable."""
    lib = get_native()
    if lib is None:
        return None
    encoded: List[bytes] = [t.encode("utf-8", errors="replace") for t in texts]
    offsets = np.zeros(len(texts) + 1, dtype=np.int64)
    np.cumsum([len(b) for b in encoded], out=offsets[1:])
    buffer = b"".join(encoded)
    ids = np.zeros((len(texts), max_features), dtype=np.int32)
    wts = np.zeros((len(texts), max_features), dtype=np.float32)
    lib.semcode_featurize_batch(
        buffer, offsets, len(texts), max_features, n_buckets, ids, wts
    )
    return ids, wts
