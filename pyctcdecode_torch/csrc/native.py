"""ctypes bindings of the native n-gram engine (``csrc/ctclm.cpp``).

:class:`NativeNGram` answers the queries of the Python
:class:`~pyctcdecode_torch.models.ngram.NGramTables` (the same scoring,
bit for bit) while parsing ARPA text in C++, and exports each order's
entries for :func:`~pyctcdecode_torch.models.device_tables.build_device_lm`.
A copy of the JAX reference package's bindings; the library is built with
``g++`` into ``build/`` at first use (:mod:`.build`).

:func:`load_native` is soft: it returns ``None`` when the library cannot be
built or loaded (``open_ngram_file(..., backend="auto")`` then reads with
Python); :class:`NativeNGram` raises instead.
"""
from __future__ import annotations

import ctypes
import logging
import os
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np

logger = logging.getLogger(__name__)

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_LIB_ERROR: Optional[str] = None  # why the library could not be built or loaded

_I32P = np.ctypeslib.ndpointer(dtype=np.int32, flags="C_CONTIGUOUS")
_F32P = np.ctypeslib.ndpointer(dtype=np.float32, flags="C_CONTIGUOUS")


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.ctclm_load_arpa.restype = ctypes.c_void_p
    lib.ctclm_load_arpa.argtypes = [ctypes.c_char_p]
    lib.ctclm_error.restype = ctypes.c_char_p
    lib.ctclm_error.argtypes = [ctypes.c_void_p]
    lib.ctclm_free.argtypes = [ctypes.c_void_p]
    for name in ("ctclm_order", "ctclm_vocab_size", "ctclm_unk_id",
                 "ctclm_bos_id", "ctclm_eos_id"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p]
    lib.ctclm_unk_prob10.restype = ctypes.c_float
    lib.ctclm_unk_prob10.argtypes = [ctypes.c_void_p]
    lib.ctclm_word_id.restype = ctypes.c_int
    lib.ctclm_word_id.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.ctclm_vocab_bytes.restype = ctypes.c_int64
    lib.ctclm_vocab_bytes.argtypes = [ctypes.c_void_p]
    lib.ctclm_export_vocab.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    for name in ("ctclm_table_slots", "ctclm_table_count"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int64
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.ctclm_table_max_probes.restype = ctypes.c_int
    lib.ctclm_table_max_probes.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.ctclm_export_table.argtypes = [
        ctypes.c_void_p, ctypes.c_int, _I32P, _F32P, _F32P,
    ]
    lib.ctclm_score.restype = ctypes.c_float
    lib.ctclm_score.argtypes = [
        ctypes.c_void_p, _I32P, ctypes.c_int, ctypes.c_int32, _I32P, _I32P,
    ]
    lib.ctclm_score_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, _I32P, _I32P, _I32P, _F32P, _I32P, _I32P,
    ]
    return lib


def load_native() -> Optional[ctypes.CDLL]:
    """Load (building on first use) the native library; None on failure."""
    global _LIB, _LIB_ERROR
    with _LOCK:
        if _LIB is not None:
            return _LIB
        if _LIB_ERROR is not None:
            return None
        try:
            from .build import NATIVE_SOURCE, build

            _LIB = _bind(ctypes.CDLL(str(build([NATIVE_SOURCE])[NATIVE_SOURCE])))
        except Exception as err:  # no g++, a failed build or load
            _LIB_ERROR = f"{type(err).__name__}: {err}"
            logger.info("native ctclm engine unavailable (%s); using Python runtime", err)
            return None
        return _LIB


class NativeNGram:
    """A natively-parsed ARPA model with BaseScore-parity queries."""

    def __init__(self, path: str):
        lib = load_native()
        if lib is None:
            raise RuntimeError(f"native ctclm engine unavailable ({_LIB_ERROR})")
        self._lib = lib
        self._h = lib.ctclm_load_arpa(path.encode("utf-8"))
        err = lib.ctclm_error(self._h)
        if err:
            msg = err.decode()
            lib.ctclm_free(self._h)
            self._h = None
            raise ValueError(f"failed to parse ARPA file {path!r}: {msg}")
        self.order = lib.ctclm_order(self._h)
        if self.order > 15:
            raise ValueError(f"n-gram order {self.order} exceeds native limit (15)")
        self.unk_id = lib.ctclm_unk_id(self._h)
        self.bos_id = lib.ctclm_bos_id(self._h)
        self.eos_id = lib.ctclm_eos_id(self._h)
        self.unk_prob10 = float(lib.ctclm_unk_prob10(self._h))
        self.path = os.path.abspath(path)
        self._ctx_width = max(self.order - 1, 1)

    def __del__(self):
        if getattr(self, "_h", None) is not None:
            self._lib.ctclm_free(self._h)

    # -- vocabulary --------------------------------------------------------
    def word_id(self, word: str) -> int:
        """Vocabulary id for ``word``; the <unk> id when absent."""
        wid = self._lib.ctclm_word_id(self._h, word.encode("utf-8"))
        return self.unk_id if wid < 0 else wid

    def __contains__(self, word: str) -> bool:
        wid = self._lib.ctclm_word_id(self._h, word.encode("utf-8"))
        return wid >= 0 and wid != self.unk_id

    def vocab_list(self) -> List[str]:
        """Vocabulary strings in id order."""
        nbytes = self._lib.ctclm_vocab_bytes(self._h)
        buf = ctypes.create_string_buffer(int(nbytes))
        self._lib.ctclm_export_vocab(self._h, buf)
        return buf.raw[: nbytes - 1].decode("utf-8").split("\n")

    # -- scoring -----------------------------------------------------------
    def raw_score(
        self, context: Tuple[int, ...], word_id: int
    ) -> Tuple[float, Tuple[int, ...]]:
        """log10 p(word | context) + outgoing state (NGramTables parity)."""
        w = self._ctx_width
        ctx = np.full(w, -1, dtype=np.int32)
        use = context[-w:] if context else ()
        for i, wid in enumerate(use):
            ctx[w - len(use) + i] = wid
        out_ctx = np.empty(w, dtype=np.int32)
        out_len = np.empty(1, dtype=np.int32)
        score = self._lib.ctclm_score(
            self._h, ctx, len(use), np.int32(word_id), out_ctx, out_len
        )
        n = int(out_len[0])
        return float(score), tuple(int(v) for v in out_ctx[w - n :]) if n else ()

    def score_batch(
        self, ctx: np.ndarray, ctx_len: np.ndarray, wids: np.ndarray
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Vectorized scoring: ctx [n, order-1] right-aligned (-1 pad)."""
        n = len(wids)
        ctx = np.ascontiguousarray(ctx, dtype=np.int32)
        ctx_len = np.ascontiguousarray(ctx_len, dtype=np.int32)
        wids = np.ascontiguousarray(wids, dtype=np.int32)
        scores = np.empty(n, dtype=np.float32)
        out_ctx = np.empty((n, self._ctx_width), dtype=np.int32)
        out_len = np.empty(n, dtype=np.int32)
        self._lib.ctclm_score_batch(
            self._h, n, ctx, ctx_len, wids, scores, out_ctx, out_len
        )
        return scores, out_ctx, out_len

    # -- table export (device upload path) ---------------------------------
    def export_tables(self) -> List[Dict[str, np.ndarray]]:
        """Per-order hash tables in the device layout (see device_tables)."""
        out = []
        for n in range(1, self.order + 1):
            slots = int(self._lib.ctclm_table_slots(self._h, n))
            keys = np.empty((slots, n), dtype=np.int32)
            probs = np.empty(slots, dtype=np.float32)
            backoffs = np.empty(slots, dtype=np.float32)
            self._lib.ctclm_export_table(self._h, n, keys, probs, backoffs)
            out.append(
                {
                    "keys": keys,
                    "probs": probs,
                    "backoffs": backoffs,
                    "max_probes": int(self._lib.ctclm_table_max_probes(self._h, n)),
                    "count": int(self._lib.ctclm_table_count(self._h, n)),
                }
            )
        return out


__all__ = ["NativeNGram", "load_native"]
