"""Packed per-token transition metadata for the device engine.

The reference's host engine classifies each alphabet label into blank / word-boundary / regular and derives the
partial-word "piece" each label contributes (ref ``decoder.py:443-534``
transition semantics). This module packs the same facts into fixed-shape
integer arrays so the device scan can apply all transitions with gathers
and masks instead of branches:

* ``kind[V]``          — 0 blank, 1 boundary (space / ``▁``-prefixed), 2 regular
* ``piece_chars[V,L]`` — char ids of the label's *boundary* piece, i.e. the
  label with leading/trailing ``▁`` stripped (-1 pad); seeds a fresh partial
  word when the token is taken as a word boundary (ref decoder.py:476-482)
* ``piece_len[V]``     — boundary piece length
* ``raw_chars[V,L]`` / ``raw_len[V]`` — char ids of the *raw* label; appended
  verbatim when the token extends a partial word (ref decoder.py:519-534
  appends ``char`` unstripped, trailing ``▁`` included)
* ``right_bound[V]``   — BPE label also *ends* with ``▁`` (forces a break
  before the next token, ref ``decoder.py:474-482``)
* ``seed_hash_lo/hi[V]`` — partial-hash pair of the boundary piece walked
  from the empty string

The character id space is shared with the device vocab trie: it covers
every char of every alphabet piece plus every char of every trie key, so
decodable strings always hash injectively.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional

import numpy as np

from ..alphabet import BPE_TOKEN, Alphabet
from .hashing import hash_extend_char

KIND_BLANK = 0
KIND_BOUNDARY = 1
KIND_REGULAR = 2


def build_char_vocab(
    alphabet: Alphabet, extra_strings: Iterable[str] = ()
) -> Dict[str, int]:
    """Stable char → id map over alphabet pieces and any extra key strings."""
    chars: List[str] = []
    seen = set()

    def _add(s: str) -> None:
        for ch in s:
            if ch not in seen:
                seen.add(ch)
                chars.append(ch)

    for label in alphabet.labels:
        _add(label)  # raw labels (incl. any ▁ chars) are appendable verbatim
    for s in extra_strings:
        _add(s)
    return {ch: i for i, ch in enumerate(chars)}


@dataclasses.dataclass(frozen=True)
class TokenArrays:
    """Fixed-shape token transition tables (numpy, moved to device by caller)."""

    kind: np.ndarray  # int32 [V]
    piece_chars: np.ndarray  # int32 [V, L] (-1 pad) — boundary piece
    piece_len: np.ndarray  # int32 [V]
    raw_chars: np.ndarray  # int32 [V, L] (-1 pad) — raw label
    raw_len: np.ndarray  # int32 [V]
    right_bound: np.ndarray  # bool [V]
    seed_hash_lo: np.ndarray  # uint32 [V]
    seed_hash_hi: np.ndarray  # uint32 [V]
    blank_id: int
    is_bpe: bool
    char2id: Dict[str, int]

    @property
    def vocab_size(self) -> int:
        return int(self.kind.shape[0])

    @property
    def max_piece_len(self) -> int:
        return int(self.piece_chars.shape[1])


def build_token_arrays(
    alphabet: Alphabet, char2id: Optional[Dict[str, int]] = None
) -> TokenArrays:
    """Pack an :class:`Alphabet` into :class:`TokenArrays`.

    Semantics mirror the host ``_TokenTable``: BPE pieces drop a leading
    and (for right-bounded tokens like ``▁⁇▁``) trailing ``▁``; the char
    alphabet's space is a boundary with an empty piece.
    """
    labels = alphabet.labels
    is_bpe = alphabet.is_bpe
    if char2id is None:
        char2id = build_char_vocab(alphabet)
    v = len(labels)
    kinds = np.zeros(v, dtype=np.int32)
    right = np.zeros(v, dtype=bool)
    pieces: List[str] = []
    blank_id = -1
    for i, lab in enumerate(labels):
        if lab == "":
            kinds[i] = KIND_BLANK
            blank_id = i
            pieces.append("")
            continue
        piece = lab
        if is_bpe and lab[:1] == BPE_TOKEN:
            kinds[i] = KIND_BOUNDARY
            piece = piece[1:]
        elif not is_bpe and lab == " ":
            kinds[i] = KIND_BOUNDARY
            piece = ""
        else:
            kinds[i] = KIND_REGULAR
        if is_bpe and lab[-1:] == BPE_TOKEN:
            right[i] = True
            if piece[-1:] == BPE_TOKEN:
                piece = piece[:-1]
        pieces.append(piece)
    if blank_id < 0:
        raise ValueError("Alphabet has no CTC blank label ('').")

    max_len = max(
        1, max(len(p) for p in pieces), max(len(lab) for lab in labels)
    )
    piece_chars = np.full((v, max_len), -1, dtype=np.int32)
    piece_len = np.zeros(v, dtype=np.int32)
    raw_chars = np.full((v, max_len), -1, dtype=np.int32)
    raw_len = np.zeros(v, dtype=np.int32)
    seed_lo = np.zeros(v, dtype=np.uint32)
    seed_hi = np.zeros(v, dtype=np.uint32)
    with np.errstate(over="ignore"):
        for i, piece in enumerate(pieces):
            piece_len[i] = len(piece)
            lo = np.uint32(0)
            hi = np.uint32(0)
            for j, ch in enumerate(piece):
                cid = np.uint32(char2id[ch])
                piece_chars[i, j] = cid
                lo, hi = hash_extend_char(np, lo, hi, cid)
            seed_lo[i] = lo
            seed_hi[i] = hi
        for i, lab in enumerate(labels):
            raw_len[i] = len(lab)
            for j, ch in enumerate(lab):
                raw_chars[i, j] = char2id[ch]
    return TokenArrays(
        kind=kinds,
        piece_chars=piece_chars,
        piece_len=piece_len,
        raw_chars=raw_chars,
        raw_len=raw_len,
        right_bound=right,
        seed_hash_lo=seed_lo,
        seed_hash_hi=seed_hi,
        blank_id=blank_id,
        is_bpe=is_bpe,
        char2id=dict(char2id),
    )
