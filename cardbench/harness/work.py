"""The yardstick of a decode step: the least work the inputs need, and the chip's peaks.

A step of the beam search advances every active utterance (one whose
frames are not used up) by one frame. Whatever implements it, a step has
to read the frame's log-probabilities and each beam's state once and write
the new state and the backpointers once, look each beam's partial word up
in the lexicon trie under every label, and probe the n-gram tables of
every order for each beam's word commit. That is what is counted here,
from shapes, per active utterance and frame:

* the logit frame, ``V`` float32;
* the beam state, read and written: ``B`` beams of
  :data:`STATE_BYTES_FIXED` (acoustic and fused score, trie node, last
  label, the partial word's first frame) and, for each LM member ``m``,
  its ``order_m - 1`` context words;
* the backpointers written: ``B`` parents and labels, 4 bytes a beam;
* the trie rows: for each beam, one child slot of 4 bytes for every letter
  a label adds to the word in progress, summed over the labels
  (:func:`trie_letters`: a label of three letters walks three trie levels;
  the blank, a char alphabet's space and the word marker walk none), once
  in each member's trie and once more in the hotword trie when the call
  has hotwords;
* the LM probes: for each member, ``B * order_m`` n-gram entries of
  :data:`ENTRY_BYTES` (a key, a probability and a backoff).

Operations: a few a candidate (the score sum, the admission test, the
merge's log-add, the window and top-B comparisons), :data:`OPS_PER_CANDIDATE`
for each of the ``B * V`` candidates. The counts do not depend on how many
kernels a program runs, so a fusion keeps the yardstick.

Peaks of one NVIDIA H100 SXM (the data sheet, at its 700 W limit): HBM
3.35 TB/s, 67 TFLOP/s float32 outside the tensor cores.
"""
from __future__ import annotations

from typing import Dict, Sequence

PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOPS = 67e12
STATE_BYTES_FIXED = 4 * 5  # acoustic score, fused score, trie node, last label, partial start
WORD_BYTES = 4  # one context word of the LM state
ENTRY_BYTES = 16
BACKPOINTER_BYTES = 4
OPS_PER_CANDIDATE = 8


def trie_letters(labels: Sequence[str], is_bpe: bool) -> int:
    """Letters the labels add to the word in progress, summed: the trie levels one beam's expansion walks.

    ``labels`` as the decoder reads them (the blank ``""``). A char
    alphabet's space ends a word and adds nothing; a BPE piece adds its
    letters without the word marker ``▁`` (``▁ab`` adds two, ``▁⁇▁`` one).
    """
    if is_bpe:
        return sum(len(lab.replace("▁", "")) for lab in labels)
    return sum(len(lab) for lab in labels if lab != " ")


def row_step(vocab: int, beam: int, letters: int, orders: Sequence[int], hotwords: bool = False) -> Dict[str, float]:
    """Bytes and operations of one active utterance's step.

    ``letters``: :func:`trie_letters`; ``orders``: each LM member's order;
    ``hotwords``: whether the call boosts hotwords (one more trie walked).
    """
    state = STATE_BYTES_FIXED + WORD_BYTES * sum(order - 1 for order in orders)
    tries = len(orders) + int(hotwords)
    nbytes = (
        4 * vocab
        + 2 * beam * state
        + beam * BACKPOINTER_BYTES
        + beam * letters * 4 * tries
        + beam * sum(orders) * ENTRY_BYTES
    )
    return dict(bytes=float(nbytes), ops=float(beam * vocab * OPS_PER_CANDIDATE))


def least_seconds(row_steps: int, vocab: int, beam: int, letters: int, orders: Sequence[int],
                  hotwords: bool = False) -> float:
    """The least time ``row_steps`` active utterance-steps take at the chip's peaks."""
    w = row_step(vocab, beam, letters, orders, hotwords)
    return max(row_steps * w["bytes"] / PEAK_BYTES_S, row_steps * w["ops"] / PEAK_F32_FLOPS)
