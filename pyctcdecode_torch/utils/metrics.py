"""Transcript quality metrics (WER / CER).

The reference delegates WER to NeMo in its notebooks
(``tutorials/01_pipeline_nemo.ipynb`` cell 26); this framework ships its own
implementation because WER parity is the north-star acceptance metric. The
definition matches NeMo's ``word_error_rate``: total edit distance over total
reference length, aggregated across the corpus.

For sharded evaluation, :func:`wer_numerator_denominator` returns the raw
(edits, words) pair so shards can be summed before the division.
"""
from __future__ import annotations

from typing import Sequence, Tuple


def edit_distance(ref: Sequence, hyp: Sequence) -> int:
    """Levenshtein distance over arbitrary token sequences."""
    if len(ref) == 0:
        return len(hyp)
    if len(hyp) == 0:
        return len(ref)
    prev = list(range(len(hyp) + 1))
    for i, r in enumerate(ref, start=1):
        cur = [i] + [0] * len(hyp)
        for j, h in enumerate(hyp, start=1):
            cost = 0 if r == h else 1
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + cost)
        prev = cur
    return prev[-1]


def wer_numerator_denominator(
    references: Sequence[str], hypotheses: Sequence[str], use_cer: bool = False
) -> Tuple[int, int]:
    """(total edit distance, total reference tokens) over a corpus shard."""
    if len(references) != len(hypotheses):
        raise ValueError(
            f"Got {len(hypotheses)} hypotheses for {len(references)} references."
        )
    edits = 0
    total = 0
    for ref, hyp in zip(references, hypotheses):
        r: Sequence = list(ref) if use_cer else ref.split()
        h: Sequence = list(hyp) if use_cer else hyp.split()
        edits += edit_distance(r, h)
        total += len(r)
    return edits, total


def word_error_rate(
    references: Sequence[str], hypotheses: Sequence[str], use_cer: bool = False
) -> float:
    """Corpus-level WER (or CER with ``use_cer``)."""
    edits, total = wer_numerator_denominator(references, hypotheses, use_cer=use_cer)
    if total == 0:
        raise ValueError("Reference corpus is empty; WER is undefined.")
    return edits / total


def character_error_rate(references: Sequence[str], hypotheses: Sequence[str]) -> float:
    """Corpus-level CER: :func:`word_error_rate` over characters."""
    return word_error_rate(references, hypotheses, use_cer=True)
