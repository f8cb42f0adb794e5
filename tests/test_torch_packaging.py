"""The port's wheel ships what its kernels need to build.

The kernel libraries are built at first launch from the sources under
``semcode_tpu_torch/ops/csrc``, so an installed package must carry every
source file and every file they ``#include "..."``: each such file is
covered by a glob of the package's ``package-data`` in ``pyproject.toml``,
and each glob there matches a file.
"""

import fnmatch
import re
import tomllib
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PACKAGE = ROOT / "semcode_tpu_torch"
INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def _globs():
    meta = tomllib.loads((ROOT / "pyproject.toml").read_text(encoding="utf-8"))
    return meta["tool"]["setuptools"]["package-data"]["semcode_tpu_torch"]


def _covered(rel: str, globs) -> bool:
    return any(fnmatch.fnmatch(rel, g) for g in globs)


def test_kernel_sources_and_their_includes_are_package_data():
    globs = _globs()
    sources = sorted((PACKAGE / "ops" / "csrc").glob("*.cu"))
    assert sources, "no kernel sources found"
    needed = set()
    for src in sources:
        needed.add(src)
        for name in INCLUDE.findall(src.read_text(encoding="utf-8")):
            target = (src.parent / name).resolve()
            assert target.is_file(), f"{src.name} includes a missing {name}"
            needed.add(target)
    assert any(p.suffix == ".cuh" for p in needed)  # hopper.cuh
    missing = [str(p.relative_to(PACKAGE)) for p in sorted(needed)
               if not _covered(p.relative_to(PACKAGE).as_posix(), globs)]
    assert not missing, f"not shipped by package-data {globs}: {missing}"


def test_every_package_data_glob_matches_a_file():
    for glob in _globs():
        assert list(PACKAGE.glob(glob)), f"package-data glob {glob!r} matches nothing"
