"""The native host library builds from the committed sources: once
under a file lock when several processes ask at the same time, and a
failed build is logged instead of passing silently."""

import ctypes
import logging
import os
import shutil
import subprocess
import threading

import pytest

from kiss_tpu.utils import native


@pytest.fixture
def csrc_copy(tmp_path, monkeypatch):
    src = os.path.join(os.path.dirname(native._CSRC), "csrc")
    dst = tmp_path / "csrc"
    shutil.copytree(src, dst, ignore=shutil.ignore_patterns("build"))
    monkeypatch.setattr(native, "_CSRC", str(dst))
    monkeypatch.setattr(native, "_BUILD", str(dst / "build"))
    return dst


@pytest.mark.skipif(shutil.which("make") is None, reason="no make")
def test_concurrent_builds_produce_one_loadable_library(csrc_copy):
    threads = [threading.Thread(target=native._make) for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    build = csrc_copy / "build"
    names = sorted(os.listdir(build))
    assert names == [".lock", "libkiss_io.so"], names  # no temp leftovers
    lib = ctypes.CDLL(str(build / "libkiss_io.so"))
    assert hasattr(lib, "ki_lms_induced_sort")


@pytest.mark.skipif(
    shutil.which("make") is None or shutil.which("g++") is None,
    reason="no make or g++",
)
def test_builds_with_a_compiler_lacking_openmp(csrc_copy, tmp_path,
                                               monkeypatch):
    """A compiler that cannot link OpenMP still builds the library (the
    LMS sort then runs serial)."""
    cxx = tmp_path / "cxx-no-openmp"
    cxx.write_text('#!/bin/sh\nfor a in "$@"; do\n'
                   '  [ "$a" = -fopenmp ] && exit 1\ndone\n'
                   'exec g++ "$@"\n')
    cxx.chmod(0o755)
    monkeypatch.setenv("CXX", str(cxx))
    native._make()
    lib = ctypes.CDLL(str(csrc_copy / "build" / "libkiss_io.so"))
    assert hasattr(lib, "ki_lms_induced_sort")


def test_failed_build_logs_warning(csrc_copy, monkeypatch, caplog):
    def fail(*args, **kwargs):
        raise subprocess.CalledProcessError(2, args[0], stderr=b"boom")

    monkeypatch.setattr(subprocess, "run", fail)
    with caplog.at_level(logging.WARNING, logger="kiss_tpu"):
        native._make()
    msgs = [r.getMessage() for r in caplog.records]
    assert any("native library build failed" in m and "boom" in m
               for m in msgs), msgs


def test_library_is_not_committed():
    """csrc/build/ is a build output, listed in .gitignore."""
    root = os.path.dirname(native._CSRC)
    with open(os.path.join(root, ".gitignore")) as f:
        assert "csrc/build/" in f.read().split()
