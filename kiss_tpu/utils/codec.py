"""Vectorized DNA <-> integer codec.

Vectorized counterpart of the reference ``Codec``
(reference: include/biovoltron/utility/istring.hpp:27-126). An "istring"
here is a numpy ``int8`` array with values 0(A) 1(C) 2(G) 3(T) 4(other),
instead of a ``std::basic_string<int8_t>``; all conversions are table
lookups over whole arrays rather than per-character loops.
"""

from __future__ import annotations

import numpy as np

# ASCII -> integer code table; non-ACGT maps to 4
# (reference: istring.hpp:28-36)
_INTS = np.full(256, 4, dtype=np.int8)
for _i, _c in enumerate("ACGT"):
    _INTS[ord(_c)] = _i
    _INTS[ord(_c.lower())] = _i

# integer code -> ASCII (reference: istring.hpp:53)
_CHARS = np.frombuffer(b"ACGTN", dtype=np.uint8)


def to_istring(seq: str | bytes | np.ndarray) -> np.ndarray:
    """Encode an ASCII DNA string to an int8 code array.

    (reference: istring.hpp:93-98 ``Codec::to_istring``)
    """
    if isinstance(seq, str):
        seq = seq.encode()
    if isinstance(seq, (bytes, bytearray, memoryview)):
        seq = np.frombuffer(seq, dtype=np.uint8)
    return _INTS[seq]


def to_string(iseq: np.ndarray) -> str:
    """Decode an int8 code array back to an ASCII string.

    (reference: istring.hpp:86-91 ``Codec::to_string``)
    """
    iseq = np.asarray(iseq)
    return _CHARS[iseq].tobytes().decode()


def is_valid(seq: str | bytes) -> np.ndarray:
    """Per-character validity (strict ACGT). (reference: istring.hpp:48-51)"""
    return to_istring(seq) != 4


def hash(iseq: np.ndarray) -> int:  # noqa: A001 - mirrors reference name
    """2-bit pack an istring into an integer key, first char most
    significant. (reference: istring.hpp:59-65 ``Codec::hash``)
    """
    key = 0
    for c in np.asarray(iseq).tolist():
        key = (key << 2) | (int(c) & 3)
    return key


def rhash(key: int, size: int) -> np.ndarray:
    """Inverse of :func:`hash`. (reference: istring.hpp:67-75)"""
    out = np.empty(size, dtype=np.int8)
    for i in range(size):
        shift = (size - i - 1) * 2
        out[i] = (key >> shift) & 3
    return out


def rev_comp(iseq: np.ndarray) -> np.ndarray:
    """Reverse complement; 4 (N) stays 4. (reference: istring.hpp:77-84)"""
    iseq = np.asarray(iseq)
    comp = np.where(iseq == 4, np.int8(4), (3 - iseq).astype(np.int8))
    return comp[::-1].copy()


def fold_to_acgt(iseq: np.ndarray) -> np.ndarray:
    """The ``c % 4`` alphabet fold every reference command applies before
    sorting/indexing (N maps to A).

    (reference: include/command/suffix_sort.hpp:33)
    """
    return (np.asarray(iseq) % 4).astype(np.int8)
