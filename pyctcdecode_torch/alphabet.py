"""Vocabulary normalization for CTC decoding.

Behavioral parity target: reference ``pyctcdecode/alphabet.py:10-170``.
An :class:`Alphabet` normalizes raw model labels (characters or BPE pieces)
into the canonical form the decoder engines consume:

* CTC blank is the empty string ``""``.
* Word boundary in character alphabets is ``" "``; in BPE alphabets pieces
  that begin a word carry a leading ``"▁"``.
* The unknown token is ``"⁇"`` (char) / ``"▁⁇▁"`` (BPE, bounded both sides).

The normalized label list also drives the static token-classification tables
used by the device engine (see ``pyctcdecode_torch/ops/tokens.py``), so this module
is the single source of truth for token semantics.
"""
from __future__ import annotations

import json
import logging
import re
from typing import Collection, List

BPE_TOKEN = "▁"  # word-boundary marker inside BPE alphabets
UNK_TOKEN = "⁇"  # unknown token, char-style alphabets
UNK_BPE_TOKEN = "▁⁇▁"  # unknown token, BPE-style alphabets (bounded both sides)

_SPECIAL_PTN = re.compile(r"^[<\[].+[>\]]$")
_BLANK_PTN = re.compile(r"^[<\[]pad[>\]]$", flags=re.IGNORECASE)
_UNK_PTN = re.compile(r"^[<\[]unk[>\]]$", flags=re.IGNORECASE)

logger = logging.getLogger(__name__)


def _looks_like_bpe(labels: List[str]) -> bool:
    """Detect BPE-style alphabets by their `##`/`▁` piece prefixes."""
    bpe = any(lab.startswith("##") for lab in labels) or any(
        lab.startswith(BPE_TOKEN) for lab in labels
    )
    logger.info(
        "label set classified as %s-style", "piece (BPE)" if bpe else "character"
    )
    return bpe


def _validate(labels: List[str], is_bpe: bool) -> None:
    if len(set(labels)) != len(labels):
        raise ValueError("every label must be unique; the vocabulary contains duplicates")
    if is_bpe and any(" " in lab for lab in labels):
        raise ValueError("a bare space label cannot appear in a piece-style (BPE) vocabulary")


def _substitute(labels: List[str], ptn: re.Pattern, replacement: str, what: str) -> List[str]:
    """Replace every label matching ``ptn`` with ``replacement``."""
    out = []
    for lab in labels:
        if ptn.match(lab):
            logger.info("treating label %r as %s and rewriting it to %r", lab, what, replacement)
            out.append(replacement)
        else:
            out.append(lab)
    return out


def _normalize_regular(labels: List[str]) -> List[str]:
    """Normalize a character-style alphabet (ref alphabet.py:34-73 semantics)."""
    out = list(labels)
    # "|" is a common stand-in for the word separator.
    if "|" in out and " " not in out:
        logger.info("no ' ' label present; rewriting the '|' separator label to ' '")
        out[out.index("|")] = " "
    # <pad>/[pad] style blank tokens.
    out = _substitute(out, _BLANK_PTN, "", "the CTC blank")
    # bare "_" as blank if no blank present yet
    if "_" in out and "" not in out:
        logger.info("no blank label present; treating the bare '_' label as the CTC blank")
        out[out.index("_")] = ""
    if "" not in out:
        logger.info("no CTC blank in the label list; appending '' as the final label")
        out.append("")
    out = _substitute(out, _UNK_PTN, UNK_TOKEN, "the unknown token")
    if any(len(lab) > 1 for lab in out):
        logger.warning(
            "multi-character labels found in a character-style alphabet; if "
            "this vocabulary is BPE its pieces were not recognized as such"
        )
    if " " not in out:
        logger.warning("no ' ' label: word segmentation will never trigger for this alphabet")
    return out


def _hash_style_to_bpe(token: str) -> str:
    """Convert one `##`-style piece into `▁`-style."""
    if token.startswith("##"):
        return token[2:]
    if _SPECIAL_PTN.match(token) or token in ("", BPE_TOKEN, UNK_BPE_TOKEN):
        return token
    return BPE_TOKEN + token


def _normalize_bpe(labels: List[str]) -> List[str]:
    """Normalize a BPE-style alphabet (ref alphabet.py:88-110 semantics)."""
    out = list(labels)
    if any(lab.startswith("##") for lab in labels):
        out = [_hash_style_to_bpe(lab) for lab in out]
    out = _substitute(out, _BLANK_PTN, "", "the CTC blank")
    if "" not in out:
        logger.info("no CTC blank in the label list; appending '' as the final label")
        out.append("")
    out = _substitute(out, _UNK_PTN, UNK_BPE_TOKEN, "the unknown token")
    if UNK_BPE_TOKEN not in out:
        logger.warning("piece-style alphabet lacks the unknown piece %s", UNK_BPE_TOKEN)
    return out


class Alphabet:
    """Normalized label set plus the BPE/char mode flag."""

    def __init__(self, labels: List[str], is_bpe: bool) -> None:
        self._labels = labels
        self._is_bpe = is_bpe

    @property
    def is_bpe(self) -> bool:
        """Whether the alphabet is BPE style."""
        return self._is_bpe

    @property
    def labels(self) -> List[str]:
        """Copy of the normalized labels (index == logit column)."""
        return list(self._labels)

    @classmethod
    def build_alphabet(cls, labels: List[str]) -> "Alphabet":
        """Build a normalized alphabet from raw model labels."""
        is_bpe = _looks_like_bpe(labels)
        _validate(labels, is_bpe)
        normalized = _normalize_bpe(labels) if is_bpe else _normalize_regular(labels)
        return cls(normalized, is_bpe)

    def dumps(self) -> str:
        """Serialize to a JSON string."""
        return json.dumps({"labels": self.labels, "is_bpe": self.is_bpe})

    @classmethod
    def loads(cls, s: str) -> "Alphabet":
        """Deserialize from a JSON string (strict keys)."""
        payload = json.loads(s)
        expected = {"labels", "is_bpe"}
        got = set(payload.keys())
        if got != expected:
            raise ValueError(
                f"alphabet JSON must contain exactly the keys {sorted(expected)}; "
                f"got {sorted(got)}"
            )
        return cls(payload["labels"], payload["is_bpe"])


def verify_alphabet_coverage(alphabet: Alphabet, unigrams: Collection[str]) -> None:
    """Warn when unigram characters are mostly absent from the alphabet."""
    label_chars = set(alphabet.labels)
    unigram_chars = set("".join(unigrams))
    if unigram_chars and len(unigram_chars - label_chars) / len(unigram_chars) > 0.2:
        logger.warning(
            "over 20%% of unigram characters cannot be produced by this "
            "alphabet; check that the LM vocabulary matches the acoustic labels"
        )
