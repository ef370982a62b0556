"""ctypes bridge to the native C++ IO library (csrc/kiss_io.cpp).

The reference implements its entire host runtime in C++; here the
device compute is JAX/XLA, and this module keeps the host-side hot
paths native: streaming FASTA/FASTQ parsing and bit packing run through
``libkiss_io.so`` when available, with pure-numpy fallbacks so the
package works before/without a toolchain. The library is built from the
committed sources at first use (one ``make`` per process, under a file
lock so concurrent processes never race the build).
"""

from __future__ import annotations

import ctypes
import fcntl
import logging
import os
import subprocess
import threading

import numpy as np

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "csrc")
_BUILD = os.path.join(_CSRC, "build")
_SO = os.path.join(_BUILD, "libkiss_io.so")

_lock = threading.Lock()
_lib = None
_tried = False


def _load():
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        if os.path.exists(os.path.join(_CSRC, "Makefile")):
            _make()
        if not os.path.exists(_SO):
            return None
        try:
            lib = ctypes.CDLL(_SO)
        except OSError:
            return None
        i8p = np.ctypeslib.ndpointer(np.int8, flags="C_CONTIGUOUS")
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        u64p = np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS")
        lib.ki_parse_sequence.restype = ctypes.c_int64
        lib.ki_parse_sequence.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, i8p,
        ]
        lib.ki_fold_acgt.restype = None
        lib.ki_fold_acgt.argtypes = [i8p, ctypes.c_int64]
        lib.ki_pack_dibits.restype = None
        lib.ki_pack_dibits.argtypes = [i8p, ctypes.c_int64, u8p]
        lib.ki_unpack_dibits.restype = None
        lib.ki_unpack_dibits.argtypes = [u8p, ctypes.c_int64, i8p]
        lib.ki_pack_bits.restype = None
        lib.ki_pack_bits.argtypes = [u8p, ctypes.c_int64, u64p]
        if hasattr(lib, "ki_lms_induced_sort"):
            i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
            lib.ki_lms_induced_sort.restype = ctypes.c_int
            lib.ki_lms_induced_sort.argtypes = [
                i8p, ctypes.c_int64, ctypes.c_int64, i64p,
            ]
            lib.ki_set_threads.restype = None
            lib.ki_set_threads.argtypes = [ctypes.c_int]
        _lib = lib
        return _lib


def _make() -> None:
    """Bring the library up to date with ``make`` (a no-op when it is
    current), holding an exclusive lock on ``build/.lock`` so that
    concurrent processes build once and the rest wait for it."""
    try:
        os.makedirs(_BUILD, exist_ok=True)
        with open(os.path.join(_BUILD, ".lock"), "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            subprocess.run(
                ["make", "-C", _CSRC, "-s"],
                check=True,
                capture_output=True,
                timeout=300,
            )
    except (OSError, subprocess.SubprocessError) as e:
        detail = getattr(e, "stderr", None) or b""
        logging.getLogger("kiss_tpu").warning(
            "native library build failed (%s) %s; using the numpy "
            "fallbacks", e, detail.decode(errors="replace")[-2000:],
        )


def available() -> bool:
    return _load() is not None


def parse_sequence(data: bytes) -> np.ndarray | None:
    """Native FASTA/FASTQ/text parse -> int8 codes, or None if the
    library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    out = np.empty(len(data), dtype=np.int8)
    n = lib.ki_parse_sequence(data, len(data), out)
    return out[:n].copy()


def fold_acgt_inplace(buf: np.ndarray) -> bool:
    lib = _load()
    if lib is None:
        return False
    assert buf.dtype == np.int8 and buf.flags.c_contiguous
    lib.ki_fold_acgt(buf, buf.shape[0])
    return True


def set_threads(n: int) -> None:
    """Cap OpenMP threads for native sort stages (the -t knob)."""
    lib = _load()
    if lib is not None and hasattr(lib, "ki_set_threads"):
        lib.ki_set_threads(n)


def lms_induced_sort(seq: np.ndarray, k: int) -> np.ndarray | None:
    """Native LMS + induced k-ordered suffix sort (csrc/kiss_lms.cpp),
    or None if the library is unavailable. ``k = -1`` = full sort.
    Returns the n+1-slot SA as int64 (callers narrow the dtype)."""
    lib = _load()
    if lib is None or not hasattr(lib, "ki_lms_induced_sort"):
        return None
    seq = np.ascontiguousarray(seq, dtype=np.int8)
    sa = np.empty(len(seq) + 1, dtype=np.int64)
    rc = lib.ki_lms_induced_sort(seq, len(seq), k, sa)
    if rc != 0:
        raise ValueError(
            f"ki_lms_induced_sort rejected n={len(seq)}, k={k} (rc={rc})"
        )
    return sa


def pack_dibits(vals: np.ndarray) -> np.ndarray | None:
    lib = _load()
    if lib is None:
        return None
    vals = np.ascontiguousarray(vals, dtype=np.int8)
    out = np.empty((len(vals) + 3) // 4, dtype=np.uint8)
    lib.ki_pack_dibits(vals, len(vals), out)
    return out
