"""The kernel cache: a library one run built is installed by the next, and a
change to any source builds afresh."""

import shutil

from perfbench import kernels


class FakeLibrary:
    """What the cache reads of a ``KernelLibrary``."""

    def __init__(self, source):
        self.source, self.defines, self.tag = source, (), ""
        self._lib = None
        self.installed = None

    def get(self, lib_path=None):
        self.installed = lib_path
        self._lib = object()
        return self._lib


def test_a_built_library_is_kept_then_installed(tmp_path, monkeypatch):
    from semcode_tpu_torch.ops import build

    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    monkeypatch.setattr(build, "CSRC", csrc)
    monkeypatch.setattr(kernels, "CACHE", tmp_path / "cache")
    built = tmp_path / "libsemcode_ivf_scan.so"
    built.write_bytes(b"built once")
    lib = FakeLibrary("ivf_scan")
    monkeypatch.setattr(kernels, "libraries", lambda: [(lib, built)])

    assert kernels.install() == [] and kernels.keep() == []  # nothing built yet
    lib._lib = object()  # the program built and loaded it
    assert kernels.keep() == ["ivf_scan"]
    assert kernels.keep() == []  # kept once

    fresh = FakeLibrary("ivf_scan")
    monkeypatch.setattr(kernels, "libraries", lambda: [(fresh, built)])
    assert kernels.install() == ["ivf_scan: installed"]
    assert fresh.installed.read_bytes() == b"built once"

    first = kernels.key(fresh)
    (csrc / "hopper.cuh").write_text((csrc / "hopper.cuh").read_text() + "\n// changed\n")
    assert kernels.key(fresh) != first
    newer = FakeLibrary("ivf_scan")
    monkeypatch.setattr(kernels, "libraries", lambda: [(newer, built)])
    assert kernels.install() == [] and newer.installed is None
