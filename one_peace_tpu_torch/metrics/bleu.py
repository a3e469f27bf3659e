"""Corpus BLEU over token-id sequences, backed by the native C++ scorer
(native/bleu.cpp) — the capability equivalent of fairseq's libbleu.

The port's copy of ``one_peace_tpu/metrics/bleu.py``: the library is built
on first use with g++ into ``build/native/`` beside the package, as the FLAC
decoder is (``data/flac.py``)."""

from __future__ import annotations

import ctypes
import math
import os
import subprocess
import threading
from typing import List, Optional, Sequence

import numpy as np

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_ROOT = os.path.join(os.path.dirname(__file__), "..", "..")
_SRC = os.path.abspath(os.path.join(_ROOT, "native", "bleu.cpp"))
_SO = os.path.abspath(os.path.join(_ROOT, "build", "native", "libbleu.so"))


class _BleuStat(ctypes.Structure):
    _fields_ = [
        ("reflen", ctypes.c_int64),
        ("predlen", ctypes.c_int64),
        ("match", ctypes.c_int64 * 4),
        ("count", ctypes.c_int64 * 4),
    ]


def _lib() -> ctypes.CDLL:
    global _LIB
    with _LOCK:
        if _LIB is None:
            os.makedirs(os.path.dirname(_SO), exist_ok=True)
            if (not os.path.exists(_SO)
                    or os.path.getmtime(_SO) < os.path.getmtime(_SRC)):
                subprocess.run(["g++", "-O3", "-shared", "-fPIC", _SRC,
                                "-o", _SO], check=True, capture_output=True)
            _LIB = ctypes.CDLL(_SO)
    return _LIB


class BleuScorer:
    def __init__(self):
        self.stat = _BleuStat()
        _lib().bleu_zero_init(ctypes.byref(self.stat))

    def add(self, ref: Sequence[int], pred: Sequence[int]) -> None:
        ref_arr = np.asarray(ref, np.int32)
        pred_arr = np.asarray(pred, np.int32)
        _lib().bleu_add(
            ctypes.byref(self.stat),
            ref_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(ref_arr),
            pred_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(pred_arr))

    def precisions(self) -> List[float]:
        return [
            self.stat.match[i] / self.stat.count[i] if self.stat.count[i] else 0.0
            for i in range(4)
        ]

    def brevity(self) -> float:
        if self.stat.predlen == 0:
            return 0.0
        return min(1.0, math.exp(1 - self.stat.reflen / self.stat.predlen))

    def score(self, order: int = 4, smooth: str = "none") -> float:
        """Corpus BLEU with optional smoothing:

        - ``'none'``: plain precisions (0 if any order has no match);
        - ``'exp'``: sacreBLEU exponential smoothing — each zero-match
          order n gets p_n = 1/(2^k * count_n) with k growing per zero
          order (the reference's eval path uses sacrebleu with
          smooth_method='exp', ref fairseq/tasks/translation.py:434-435);
        - ``'add-1'``: add-one to match and count per order (the
          semantics of libbleu's ``bleu_one_init``).
        """
        ps = []
        smooth_mteval = 1.0
        for i in range(order):
            match, count = self.stat.match[i], self.stat.count[i]
            if smooth == "add-1":
                # smoothing first: count==0 (every prediction shorter than
                # n tokens) still yields (0+1)/(0+1)=1 under add-one,
                # matching libbleu's bleu_one_init semantics
                ps.append((match + 1.0) / (count + 1.0))
            elif count == 0:
                return 0.0
            elif match == 0:
                if smooth == "exp":
                    smooth_mteval *= 2.0
                    ps.append(1.0 / (smooth_mteval * count))
                else:
                    return 0.0
            else:
                ps.append(match / count)
        log_avg = sum(math.log(p) for p in ps) / order
        return 100.0 * self.brevity() * math.exp(log_avg)
