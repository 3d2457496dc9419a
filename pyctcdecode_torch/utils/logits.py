"""Input normalization: accept probabilities, logits, or log-probs.

Parity surface: ref ``decoder.py:180-197, 699-705, 759-765``. Rows summing to
~1 are treated as probabilities (log + clip); anything else goes through a
clipped log-softmax. Host-side numpy: the decoder uploads the normalized
float32 log-probs once per call.
"""
from __future__ import annotations

import math
from typing import List, Sequence

import numpy as np

from ..constants import MIN_TOKEN_CLIP_P


def log_softmax_np(x: np.ndarray, axis: int = -1) -> np.ndarray:
    """Numerically stable log-softmax (scipy-equivalent, non-finite-max safe)."""
    x_max = np.amax(x, axis=axis, keepdims=True)
    if x_max.ndim > 0:
        x_max[~np.isfinite(x_max)] = 0
    elif not np.isfinite(x_max):
        x_max = 0
    shifted = x - x_max
    with np.errstate(divide="ignore"):
        log_z = np.log(np.sum(np.exp(shifted), axis=axis, keepdims=True))
    return shifted - log_z


def normalize_to_logp(logits: np.ndarray) -> np.ndarray:
    """Sniff the input domain and return clipped log-probabilities."""
    with np.errstate(invalid="ignore"):
        row_sum_mean = float(logits.sum(axis=1).mean()) if logits.size else float("nan")
    if math.isclose(row_sum_mean, 1):
        # probabilities
        return np.log(np.clip(logits, MIN_TOKEN_CLIP_P, 1))
    # raw logits (or already log-probs; log-softmax is idempotent-enough and
    # matches the reference behavior exactly)
    return np.clip(log_softmax_np(logits, axis=1), math.log(MIN_TOKEN_CLIP_P), 0)


def normalize_batch(mats: Sequence[np.ndarray]) -> List[np.ndarray]:
    """``[normalize_to_logp(m).astype(float32) for m in mats]``.

    The per-utterance sniff is kept: each matrix decides on its own whether
    it holds probabilities or logits.
    """
    return [normalize_to_logp(np.asarray(m)).astype(np.float32) for m in mats]
