"""The port's batched host replay against its per-row replay and the JAX package's.

Seeded random token paths (char alphabet; ``-1`` pads and ``-3`` timeline
carry markers mixed in; with and without a frame-id map) go through
``replay_token_paths_batch`` of both packages and, row by row, through the
port's ``replay_token_path`` with the trailing partial appended. Words and
frame spans must be identical. BPE paths (pieces, the right-bounded
``▁⁇▁``) replay row by row in both packages, trailing partial included.
"""
import numpy as np
import pytest

import pyctcdecode_torch as P
from pyctcdecode_torch import torch_decoder as tdec
from pyctcdecode_tpu import tpu_decoder as jdec

from .torch_cases import BPE_LABELS, LM_WORDS, piece_vocabulary
from .torch_cases import one_torch_thread  # noqa: F401  (autouse fixture)

LABELS = [" ", "a", "b", "c", "'", ""]
BLANK = LABELS.index("")
SPACE = LABELS.index(" ")


def _paths(seed, rows, steps, n_labels=len(LABELS)):
    rng = np.random.RandomState(seed)
    toks = rng.randint(0, n_labels, size=(rows, steps)).astype(np.int64)
    # runs of repeats, as CTC paths have them
    toks = np.where(rng.rand(rows, steps) < 0.4, np.roll(toks, 1, axis=1), toks)
    toks = np.where(rng.rand(rows, steps) < 0.2, -3, toks)
    toks[np.arange(steps)[None, :] >= rng.randint(0, steps + 1, size=(rows, 1))] = -1
    frame_ids = np.cumsum(rng.randint(0, 3, size=(rows, steps)), axis=1).astype(np.int64)
    return toks, frame_ids


def _per_row(toks, frame_ids):
    out = []
    for i, row in enumerate(toks):
        words, frames, (partial, pframes) = tdec.replay_token_path(
            row.tolist(), LABELS, False, frame_ids=None if frame_ids is None else frame_ids[i].tolist()
        )
        if partial:
            words.append(partial)
            frames.append(pframes)
        out.append((words, frames))
    return out


@pytest.mark.parametrize("with_ids", [False, True], ids=["positions", "frame_ids"])
@pytest.mark.parametrize("seed,rows,steps", [(0, 1, 1), (1, 7, 23), (2, 40, 60), (3, 5, 0)])
def test_batched_replay_matches_per_row_and_jax(seed, rows, steps, with_ids):
    toks, frame_ids = _paths(seed, rows, steps)
    fid = frame_ids if with_ids else None
    got = tdec.replay_token_paths_batch(toks, LABELS, BLANK, SPACE, frame_ids=fid)
    assert got == _per_row(toks, fid)
    if steps:
        assert got == jdec.replay_token_paths_batch(toks, LABELS, BLANK, SPACE, frame_ids=fid)


def test_all_rows_skipped():
    toks = np.full((3, 5), -1, dtype=np.int64)
    toks[1, 2] = -3
    assert tdec.replay_token_paths_batch(toks, LABELS, BLANK, SPACE) == [([], [])] * 3


@pytest.mark.parametrize("labels", [BPE_LABELS, piece_vocabulary(LM_WORDS)], ids=["bpe", "pieces"])
@pytest.mark.parametrize("with_ids", [False, True], ids=["positions", "frame_ids"])
def test_bpe_replay_matches_jax(labels, with_ids):
    """The per-row BPE replay (words, spans, trailing partial) against the JAX package's."""
    labels = P.Alphabet.build_alphabet(labels).labels
    toks, frame_ids = _paths(3, 30, 40, len(labels))
    for i, row in enumerate(toks):
        fid = frame_ids[i].tolist() if with_ids else None
        want = jdec.replay_token_path(row.tolist(), labels, True, frame_ids=fid)
        assert tdec.replay_token_path(row.tolist(), labels, True, frame_ids=fid) == want
