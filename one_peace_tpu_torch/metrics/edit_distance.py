"""Levenshtein edit distance over token-id sequences (native C++ backend,
capability equivalent of fairseq's libnat — native/edit_distance.cpp).

The port's copy of ``one_peace_tpu/metrics/edit_distance.py``: the library is
built on first use with g++ into ``build/native/`` beside the package, as the
FLAC decoder is (``data/flac.py``)."""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import List, Optional, Sequence

import numpy as np

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_ROOT = os.path.join(os.path.dirname(__file__), "..", "..")
_SRC = os.path.abspath(os.path.join(_ROOT, "native", "edit_distance.cpp"))
_SO = os.path.abspath(os.path.join(_ROOT, "build", "native", "libeditdist.so"))


def _lib() -> ctypes.CDLL:
    global _LIB
    with _LOCK:
        if _LIB is None:
            os.makedirs(os.path.dirname(_SO), exist_ok=True)
            if (not os.path.exists(_SO)
                    or os.path.getmtime(_SO) < os.path.getmtime(_SRC)):
                subprocess.run(["g++", "-O3", "-shared", "-fPIC", _SRC,
                                "-o", _SO], check=True, capture_output=True)
            lib = ctypes.CDLL(_SO)
            lib.edit_distance.restype = ctypes.c_int64
            _LIB = lib
    return _LIB


def edit_distance(a: Sequence[int], b: Sequence[int]) -> int:
    aa = np.asarray(a, np.int32)
    bb = np.asarray(b, np.int32)
    return int(_lib().edit_distance(
        aa.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(aa),
        bb.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(bb)))


def edit_distance_batch(a: np.ndarray, b: np.ndarray, pad_id: int = 1) -> np.ndarray:
    """a (N, La), b (N, Lb) padded id arrays -> (N,) distances."""
    a = np.ascontiguousarray(a, np.int32)
    b = np.ascontiguousarray(b, np.int32)
    out = np.zeros(len(a), np.int64)
    _lib().edit_distance_batch(
        a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        b.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        len(a), a.shape[1], b.shape[1], pad_id,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    return out


def edit_alignment(a: Sequence[int], b: Sequence[int]) -> List[int]:
    """Per-position of b: matched index in a (-1 = insertion)."""
    aa = np.asarray(a, np.int32)
    bb = np.asarray(b, np.int32)
    ops = np.zeros(len(bb), np.int32)
    _lib().edit_alignment(
        aa.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(aa),
        bb.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(bb),
        ops.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return ops.tolist()
