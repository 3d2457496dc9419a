"""Hotword (context-biasing) scorer.

Parity surface: ref ``language_model.py:115-189``. Hotword n-grams are split
into unigrams; a full-word match means a whitespace-delimited chunk of the
transcript equals a hotword unigram exactly (the reference implements this
with a ``(?<!\\S)…(?!\\S)``-bounded alternation regex — chunk equality is the
equivalent closed form, verified against its tests). Partial matches are
scored through a prefix trie scaled by the shortest possible completion.
"""
from __future__ import annotations

from typing import Iterable, Optional

from ..constants import DEFAULT_HOTWORD_WEIGHT
from ..utils.trie import CharTrie


class HotwordScorer:
    """Per-call scorer boosting user-supplied words/phrases."""

    def __init__(self, unigrams: Iterable[str], weight: float = DEFAULT_HOTWORD_WEIGHT) -> None:
        self._unigram_set = frozenset(unigrams)
        self._char_trie = CharTrie.fromkeys(self._unigram_set)
        self._weight = weight

    @property
    def weight(self) -> float:
        return self._weight

    @property
    def unigrams(self) -> frozenset:
        return self._unigram_set

    def __contains__(self, item: str) -> bool:
        """Prefix membership: is ``item`` a prefix of any hotword unigram."""
        return self._char_trie.has_prefix(item)

    def score(self, text: str) -> float:
        """Weight times the number of transcript words that are hotwords."""
        if not self._unigram_set:
            return 0.0
        return self._weight * sum(1 for chunk in text.split() if chunk in self._unigram_set)

    def score_partial_token(self, token: str) -> float:
        """Partial credit proportional to progress toward the shortest completion."""
        min_len = self._char_trie.shortest_completion_len(token)
        if min_len <= 0:
            return 0.0
        return self._weight * len(token) / min_len

    @classmethod
    def build_scorer(
        cls,
        hotwords: Optional[Iterable[str]] = None,
        weight: float = DEFAULT_HOTWORD_WEIGHT,
    ) -> "HotwordScorer":
        """Split hotword phrases into unigrams and build a scorer."""
        phrases = [s.strip() for s in (hotwords or []) if s.strip()]
        unigrams = [w for phrase in phrases for w in phrase.split()]
        return cls(unigrams, weight)
