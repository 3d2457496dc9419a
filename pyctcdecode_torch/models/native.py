"""Native-engine n-gram model: the facade of :class:`~.ngram.NGramModel` over the C++ engine.

Wraps :class:`pyctcdecode_torch.csrc.native.NativeNGram` with the surface
the decoders consume (ref role: the KenLM ``Model`` object,
``language_model.py:306-360``). Scores equal the Python runtime's bit for
bit; ARPA parsing is much faster, which matters for LMs of hundreds of MB
of text. :func:`~.ngram.open_ngram_file` returns one for plain ARPA text
under ``backend="native"`` (and ``"auto"`` where the engine builds).
"""
from __future__ import annotations

from typing import List, Optional, Tuple

from .ngram import EOS_WORD, UNK_WORD


class NativeNGramModel:
    """KenLM-equivalent model facade backed by the C++ engine."""

    def __init__(self, native) -> None:
        self._native = native

    @classmethod
    def from_file(cls, path: str) -> "NativeNGramModel":
        from ..csrc.native import NativeNGram

        return cls(NativeNGram(path))

    @property
    def native(self) -> "object":
        return self._native

    @property
    def order(self) -> int:
        return self._native.order

    @property
    def path(self) -> Optional[str]:
        return self._native.path

    def __contains__(self, word: str) -> bool:
        return word in self._native

    def begin_sentence_state(self) -> Tuple[int, ...]:
        """(<s>,) when the model has a <s> unigram entry, else empty."""
        bos = self._native.bos_id
        if bos < 0:
            return ()
        if self.order == 1:
            return (bos,)
        _, out = self._native.raw_score((), bos)
        # state is (bos,) iff <s> has a unigram entry; raw_score's outgoing
        # state computation answers exactly that
        return out if out == (bos,) else ()

    def null_context_state(self) -> Tuple[int, ...]:
        return ()

    def raw_score_word(
        self, state: Tuple[int, ...], word: str
    ) -> Tuple[float, Tuple[int, ...]]:
        """log10 p(word | state) plus outgoing state (KenLM BaseScore)."""
        return self._native.raw_score(state, self._native.word_id(word))

    def raw_end_score(self, state: Tuple[int, ...]) -> float:
        """log10 p(</s> | state)."""
        eos = self._native.eos_id
        wid = eos if eos >= 0 else self._native.word_id(EOS_WORD)
        score, _ = self._native.raw_score(state, wid)
        return score

    def state_words(self, state: Tuple[int, ...]) -> List[str]:
        """Debug helper: map a state's ids back to words."""
        vocab = self._native.vocab_list()
        return [vocab[i] if 0 <= i < len(vocab) else UNK_WORD for i in state]
