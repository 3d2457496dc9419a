"""Traffic: a mix's data file names its generator, which makes a run's inputs from the seed.

A mix (``cardbench/traffic/<mix>.json``) is data: its ``generator`` key
names ``cardbench/generators/<generator>.py``, and every other key is a
parameter that generator reads. A generator's ``make(mix, seed, ctx)``
returns the inputs and, for live traffic, when each falls due:

* ``{"kind": "batch", "pool": [[logits, ...], ...]}``: the batches of a
  closed loop of batch calls, which the loop cycles through;
* ``{"kind": "stream", "chunk_frames": n, "streams": [{"utterances":
  [logits, ...], "due": iterable}, ...]}``: live streams, each playing its
  utterances back to back (cycled) in chunks of ``chunk_frames`` frames;
  ``due`` gives the seconds after the loop opens at which the stream's
  chunks fall due, one for each chunk in playing order, without end.

``kind`` picks the loop that serves the inputs (``harness.loops``). The
arrival law and the utterance law live in the generator, so a new law is a
new generator file. ``ctx`` holds what the configuration gives: the
speakers' ``words``, the decoder's ``labels`` (the logits' columns),
``is_bpe`` and ``frame_s``. The helpers below are shared by generators: a
seed and its salts, frame counts spread evenly, utterances under the
dev-other noise model.
"""
from __future__ import annotations

from types import SimpleNamespace
from typing import Dict, List, Sequence

import numpy as np

from . import manifest
from .data import DEV_OTHER_DIFFICULTY, TRANSCRIPT, render_utterance


def seeded(seed: int, *salt: int) -> np.random.RandomState:
    """A RandomState from any whole number (the seed may exceed 32 bits) and salts."""
    return np.random.RandomState(np.random.MT19937(np.random.SeedSequence([int(seed) & (2**63 - 1), *salt])))


def frame_counts(frames: Sequence[int], n: int) -> List[int]:
    """``n`` frame counts spread evenly over ``[shortest, longest]``."""
    lo, hi = frames
    return [int(x) for x in np.rint(np.linspace(lo, hi, n))]


def corpus_words(config: Dict, lm_words: Sequence[str]) -> List[str]:
    """The speakers' working vocabulary: a fixed draw of the LM's words plus the transcript's."""
    spec = config["corpus"]
    rng = np.random.RandomState(spec["seed"])
    return [lm_words[i] for i in rng.randint(0, len(lm_words), spec["words"])] + TRANSCRIPT.split()


def context(words: Sequence[str], labels: Sequence[str], is_bpe: bool, frame_s: float) -> SimpleNamespace:
    return SimpleNamespace(words=list(words), labels=list(labels), is_bpe=is_bpe, frame_s=frame_s)


def utterances(rng: np.random.RandomState, counts: Sequence[int], ctx, difficulty=DEV_OTHER_DIFFICULTY
               ) -> List[np.ndarray]:
    """Raw float32 logits ``[frames, V]``, one utterance of each of ``counts`` frames, in that order."""
    return [render_utterance(rng, ctx.words, ctx.labels, ctx.is_bpe, n, difficulty)[1] for n in counts]


def make(mix: Dict, seed: int, ctx) -> Dict:
    """The seed's inputs from the mix's generator, found by name."""
    return manifest.module("generators", mix["generator"]).make(mix, seed, ctx)


def chunks(mat: np.ndarray, chunk_frames: int) -> List[np.ndarray]:
    return [mat[i : i + chunk_frames] for i in range(0, mat.shape[0], chunk_frames)]
