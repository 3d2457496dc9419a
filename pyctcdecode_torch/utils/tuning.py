"""Hyperparameter tuning: alpha/beta grid search against a dev set.

The reference tunes LM fusion weights with an ad-hoc notebook loop over
``reset_params`` + a 15-process pool (ref ``tutorials/03_eval_performance
.ipynb`` cell 27, ``01_pipeline_nemo.ipynb`` cell 27). Here the sweep is a
first-class API: the fusion weights are read on every decode call of
either engine (``reset_params``), so a sweep costs sweep-size x one
batched decode and nothing is rebuilt. A copy of the JAX reference
package's, which has no framework in it.
"""
from __future__ import annotations

import dataclasses
import logging
from typing import Iterable, List, Sequence, Tuple

import numpy as np

from .metrics import word_error_rate

logger = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class GridPoint:
    """One sweep result."""

    alpha: float
    beta: float
    wer: float


def grid_search_alpha_beta(
    decoder: "object",
    logits_list: Sequence[np.ndarray],
    references: Sequence[str],
    alphas: Iterable[float] = (0.5, 0.6, 0.7, 0.8),
    betas: Iterable[float] = (1.0, 2.0, 3.0, 4.0),
    beam_width: int = 50,
    **decode_kwargs: "object",
) -> Tuple[GridPoint, List[GridPoint]]:
    """Sweep (alpha, beta), returning the best point and the full grid.

    Works with both the host and the device decoder (anything exposing
    ``reset_params`` and ``decode_batch``); the host engine's
    ``decode_batch`` takes a pool first (``None`` here).
    """
    results: List[GridPoint] = []
    original = None
    lm = getattr(decoder, "language_model", None)
    if lm is None and hasattr(decoder, "_language_model"):
        lm = decoder._language_model
    if lm is not None:
        original = (lm.alpha, lm.beta)
    try:
        for alpha in alphas:
            for beta in betas:
                decoder.reset_params(alpha=float(alpha), beta=float(beta))
                if hasattr(decoder, "decode_batch") and not _needs_pool(decoder):
                    hyps = decoder.decode_batch(
                        logits_list, beam_width=beam_width, **decode_kwargs
                    )
                else:  # host engine signature takes a pool first
                    hyps = decoder.decode_batch(
                        None, logits_list, beam_width=beam_width, **decode_kwargs
                    )
                wer = word_error_rate(references, hyps)
                results.append(GridPoint(float(alpha), float(beta), wer))
                logger.info("alpha=%.2f beta=%.2f -> WER %.4f", alpha, beta, wer)
    finally:
        if original is not None:
            decoder.reset_params(alpha=original[0], beta=original[1])
    best = min(results, key=lambda r: r.wer)
    return best, results


def _needs_pool(decoder) -> bool:
    """True for the host engine whose decode_batch takes a pool argument."""
    import inspect

    params = list(inspect.signature(decoder.decode_batch).parameters)
    return bool(params) and params[0] == "pool"
