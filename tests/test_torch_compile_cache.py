"""backend.enable_compile_cache and _build's nvcc counter, on the host: the
counterpart of jax_backend/backend.py:enable_compile_cache, held to the
property warm boot needs, zero nvcc runs on a second boot over the same
sources.  A stub nvcc (``_build._nvcc``) writes each library it is asked for,
so the build's bookkeeping runs without a CUDA toolkit.
"""

import os
import stat

import pytest

from lighthouse_tpu_torch.crypto.bls.torch_backend import _build
from lighthouse_tpu_torch.crypto.bls.torch_backend import backend as TB
from lighthouse_tpu_torch.utils.metrics import COMPILE_CACHE_ERRORS

STUB_NVCC = """#!/bin/sh
# writes the file after -o, as nvcc writes the library it builds
while [ $# -gt 0 ]; do
  if [ "$1" = "-o" ]; then shift; out="$1"; fi
  shift
done
echo "ptxas info    : Used 1 registers"
: > "$out"
"""


@pytest.fixture
def stub_nvcc(tmp_path, monkeypatch):
    """A stub nvcc, no library loaded, and the build root restored after."""
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(STUB_NVCC)
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IXUSR)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(_build, "BUILD_ROOT", _build.BUILD_ROOT)
    monkeypatch.setattr(_build, "_LOADED", {})
    return nvcc


def test_second_build_into_a_kept_root_starts_no_nvcc(tmp_path, stub_nvcc):
    cache = tmp_path / "kernel_cache"
    assert TB.enable_compile_cache(str(cache)) is True
    assert _build.build_dir() == cache.resolve() / _build.source_hash()
    runs0 = _build.nvcc_runs
    first = _build.build_all()
    assert _build.nvcc_runs == runs0 + len(_build.LIBRARIES) == runs0 + 6
    assert first["built"] == sorted(_build.LIBRARIES)
    for name in _build.LIBRARIES:
        assert (_build.build_dir() / f"lib{name}.so").exists()
    # a restart on the same sources: the same root, nothing to compile
    assert TB.enable_compile_cache(str(cache)) is True
    second = _build.build_all()
    assert _build.nvcc_runs == runs0 + 6 and second["built"] == []


def test_unwritable_root_returns_false_and_counts(tmp_path, stub_nvcc):
    (tmp_path / "a_file").write_text("")
    before = _build.BUILD_ROOT
    errors0 = COMPILE_CACHE_ERRORS.value()
    assert TB.enable_compile_cache(str(tmp_path / "a_file" / "cache")) is False
    assert COMPILE_CACHE_ERRORS.value() == errors0 + 1
    assert _build.BUILD_ROOT == before
    if os.geteuid() != 0:  # root writes through directory permissions
        ro = tmp_path / "read_only"
        ro.mkdir()
        ro.chmod(stat.S_IRUSR | stat.S_IXUSR)
        assert TB.enable_compile_cache(str(ro)) is False
        assert COMPILE_CACHE_ERRORS.value() == errors0 + 2


def test_moving_the_root_after_a_library_loaded_is_refused(tmp_path, stub_nvcc, monkeypatch):
    first = tmp_path / "first"
    assert TB.enable_compile_cache(str(first)) is True
    monkeypatch.setitem(_build._LOADED, "mont", object())  # a library loaded from it
    errors0 = COMPILE_CACHE_ERRORS.value()
    assert TB.enable_compile_cache(str(tmp_path / "second")) is False
    assert COMPILE_CACHE_ERRORS.value() == errors0 + 1
    assert _build.BUILD_ROOT == first.resolve()
    assert not (tmp_path / "second").exists()
    # naming the root the libraries came from is no move
    assert TB.enable_compile_cache(str(first)) is True
