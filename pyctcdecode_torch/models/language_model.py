"""Shallow-fusion language model wrapper.

Parity surface: ref ``language_model.py:230-502``. :class:`LanguageModel`
wraps this package's own n-gram runtime (``models/ngram.py`` for ARPA and
``.ctclm``, ``models/kenlm_bin.py`` for KenLM binaries), applying the
fused-score formula

``alpha * (raw_log10 + unk_offset*[oov] + eos_log10) * ln(10) + beta``

per committed word (ref ``language_model.py:338-360``), the OOV rule
(unigram-set miss when a unigram set exists, OR model-vocab miss), and the
partial-word scoring (prefix-trie miss penalty, length-scaled past
``AVG_TOKEN_LEN``; ref ``language_model.py:326-336``).
:class:`MultiLanguageModel` averages the fused scores of two or more
members. The device engine reads every member's ``alpha``, ``beta``,
``unk_score_offset`` and ``score_boundary`` per decode call; the host
scoring methods document the same rules. ``save_to_dir`` / ``load_from_dir``
keep the reference's three-file directory (``attrs.json``,
``unigrams.txt``, the model file).
"""
from __future__ import annotations

import json
import logging
import os
import shutil
from typing import Any, Collection, Dict, Optional, Sequence, Set, Tuple, Union

import numpy as np

from ..constants import (
    AVG_TOKEN_LEN,
    DEFAULT_ALPHA,
    DEFAULT_BETA,
    DEFAULT_SCORE_LM_BOUNDARY,
    DEFAULT_UNK_LOGP_OFFSET,
    LOG_BASE_CHANGE_FACTOR,
)
from ..utils import profiling
from ..utils.trie import CharTrie
from .base import AbstractLanguageModel, AbstractLMState, MultiLMState, NGramLMState
from .kenlm_bin import KenLMBinaryModel
from .ngram import NGramModel, open_ngram_file

# the n-gram runtimes a LanguageModel wraps: ARPA / .ctclm, and KenLM binaries
NGramRuntime = Union[NGramModel, KenLMBinaryModel]

logger = logging.getLogger(__name__)


def _prepare_unigram_set(unigrams: Collection[str], model: NGramRuntime) -> Set[str]:
    """Keep only unigrams known to the n-gram model's vocabulary."""
    if len(unigrams) < 1000:
        logger.warning(
            "the supplied vocabulary has just %s unigrams; real models "
            "usually ship far more (toy/test data?)",
            len(unigrams),
        )
    unigram_set = {t for t in set(unigrams) if t in model}
    retained = 1.0 if len(unigrams) == 0 else len(unigram_set) / len(unigrams)
    if retained < 0.1:
        logger.warning(
            "the n-gram model recognizes only %s%% of the supplied unigrams; "
            "the vocabulary and the LM probably come from different sources",
            round(retained * 100, 1),
        )
    return unigram_set


class LanguageModel(AbstractLanguageModel):
    """n-gram LM with shallow-fusion weighting for beam-search decoding.

    ``ngram_model`` is an :class:`~.ngram.NGramModel` (ARPA or ``.ctclm``)
    or a :class:`~.kenlm_bin.KenLMBinaryModel` (a KenLM binary); both
    engines take either. With the host tracer on, the constructor (the
    unigram check and the word trie) is a root span ``lm.language_model``
    of its own (inside another call, such as ``build_ctcdecoder``'s, it
    opens none).
    """

    JSON_ATTRS = ("alpha", "beta", "unk_score_offset", "score_boundary")
    _ATTRS_SERIALIZED_FILENAME = "attrs.json"
    _UNIGRAMS_SERIALIZED_FILENAME = "unigrams.txt"

    def __init__(
        self,
        ngram_model: NGramRuntime,
        unigrams: Optional[Collection[str]] = None,
        alpha: float = DEFAULT_ALPHA,
        beta: float = DEFAULT_BETA,
        unk_score_offset: float = DEFAULT_UNK_LOGP_OFFSET,
        score_boundary: bool = DEFAULT_SCORE_LM_BOUNDARY,
    ) -> None:
        self._model = ngram_model
        with profiling.call("lm.language_model"):
            if unigrams is None:
                logger.warning(
                    "decoding without a known-word vocabulary: every partial word "
                    "is scored as unknown, which usually costs accuracy"
                )
                unigram_set: Set[str] = set()
                char_trie = None
            else:
                unigram_set = _prepare_unigram_set(unigrams, ngram_model)
                char_trie = CharTrie.fromkeys(unigram_set)
        self._unigram_set = unigram_set
        self._char_trie = char_trie
        self.alpha = alpha
        self.beta = beta
        self.unk_score_offset = unk_score_offset
        self.score_boundary = score_boundary

    # -- introspection -------------------------------------------------------
    @property
    def ngram_model(self) -> NGramRuntime:
        return self._model

    @property
    def unigram_set(self) -> Set[str]:
        return set(self._unigram_set)

    @property
    def order(self) -> int:
        return self._model.order

    # tunable knob -> required type (live-retunable without reloading tables)
    _TUNABLE = {
        "alpha": float,
        "beta": float,
        "unk_score_offset": float,
        "score_boundary": bool,
    }

    def reset_params(self, **params: Dict[str, Any]) -> None:
        """Re-tune alpha/beta/unk_score_offset/score_boundary in place."""
        for name, required in self._TUNABLE.items():
            value = params.get(name)
            if value is None:
                continue
            if not isinstance(value, required):
                raise ValueError(
                    f"{name} accepts {required.__name__} values only; "
                    f"received {type(value).__name__}"
                )
            setattr(self, name, value)

    # -- scoring --------------------------------------------------------------
    def get_start_state(self) -> NGramLMState:
        """<s>-conditioned state when score_boundary, else empty context."""
        if self.score_boundary:
            return NGramLMState(self._model.begin_sentence_state())
        return NGramLMState(self._model.null_context_state())

    def score_partial_token(self, partial_token: str) -> float:
        """Prefix-membership penalty for an in-progress word (ref lm.py:326-336)."""
        if self._char_trie is None:
            is_oov = 1.0
        else:
            is_oov = float(not self._char_trie.has_prefix(partial_token))
        unk_score = self.unk_score_offset * is_oov
        if len(partial_token) > AVG_TOKEN_LEN:
            unk_score = unk_score * len(partial_token) / AVG_TOKEN_LEN
        return unk_score

    def _is_oov(self, word: str) -> bool:
        return (len(self._unigram_set) > 0 and word not in self._unigram_set) or (
            word not in self._model
        )

    def score(
        self, prev_state: AbstractLMState, word: str, is_last_word: bool = False
    ) -> Tuple[float, NGramLMState]:
        """Fused shallow-fusion score of one word (ref language_model.py:338-360)."""
        if not isinstance(prev_state, NGramLMState):
            raise AssertionError(
                f"LanguageModel.score needs an NGramLMState; "
                f"received {type(prev_state).__name__}"
            )
        raw, end_context = self._model.raw_score_word(prev_state.context, word)
        if self._is_oov(word):
            raw += self.unk_score_offset
        if is_last_word and self.score_boundary:
            # end-of-sentence credit; the returned state stays extendable
            raw += self._model.raw_end_score(end_context)
        fused = self.alpha * raw * LOG_BASE_CHANGE_FACTOR + self.beta
        return fused, NGramLMState(end_context)

    # -- serialization (ref language_model.py:362-452) -------------------------
    @property
    def serializable_attrs(self) -> Dict[str, Any]:
        attrs = {}
        for name in LanguageModel.JSON_ATTRS:
            val = getattr(self, name)
            if val is None:
                raise ValueError(f"cannot serialize: tunable attribute {name!r} is unset")
            attrs[name] = val
        return attrs

    def save_to_dir(self, filepath: str, unigram_encoding: Optional[str] = None) -> None:
        """Write attrs.json + unigrams.txt + the LM file into ``filepath``."""
        if self._model.path is None:
            # check BEFORE writing: failing after attrs/unigrams land
            # leaves a 2-of-3-files directory that load_from_dir rejects
            # with a misleading layout error
            raise ValueError("Language model has no backing file; cannot serialize.")
        attrs_path = os.path.join(filepath, self._ATTRS_SERIALIZED_FILENAME)
        with open(attrs_path, "w") as fh:
            json.dump(self.serializable_attrs, fh)

        unigrams_path = os.path.join(filepath, self._UNIGRAMS_SERIALIZED_FILENAME)
        with open(unigrams_path, "w", encoding=unigram_encoding) as fh:
            for unigram in sorted(self._unigram_set):
                fh.write(unigram + "\n")

        src = self._model.path
        dst = os.path.join(filepath, os.path.basename(src))
        logger.info("copying the n-gram model file %s -> %s (may be large)", src, dst)
        if os.path.abspath(src) != os.path.abspath(dst):
            shutil.copy2(src, dst)

    @staticmethod
    def parse_directory_contents(filepath: str) -> Dict[str, str]:
        """Validate the strict 3-file LM directory layout."""
        contents = [
            c
            for c in os.listdir(filepath)
            if not c.startswith(".") and not c.startswith("__")
        ]
        if len(contents) != 3:
            raise ValueError(
                "a serialized LM directory holds exactly three files "
                f"(attributes, unigrams, model); this one holds {contents}"
            )
        if LanguageModel._ATTRS_SERIALIZED_FILENAME not in contents:
            raise ValueError(
                f"missing {LanguageModel._ATTRS_SERIALIZED_FILENAME} in the LM "
                f"directory; present: {contents}"
            )
        contents.remove(LanguageModel._ATTRS_SERIALIZED_FILENAME)
        if LanguageModel._UNIGRAMS_SERIALIZED_FILENAME not in contents:
            raise ValueError(
                f"missing {LanguageModel._UNIGRAMS_SERIALIZED_FILENAME} in the LM "
                f"directory; present: {contents}"
            )
        contents.remove(LanguageModel._UNIGRAMS_SERIALIZED_FILENAME)
        lm_file = contents[0]
        ext = os.path.splitext(lm_file)[1]
        if ext == ".gz" and lm_file.endswith(".arpa.gz"):
            ext = ".arpa"  # gzipped ARPA round-trips through save_to_dir
        if ext not in {".arpa", ".bin", ".binary", ".ctclm"}:
            raise ValueError(
                f"unrecognized LM file {lm_file!r}: supported extensions are "
                ".arpa, .bin, .binary and .ctclm"
            )
        return {
            "json_attrs": os.path.join(filepath, LanguageModel._ATTRS_SERIALIZED_FILENAME),
            "unigrams": os.path.join(filepath, LanguageModel._UNIGRAMS_SERIALIZED_FILENAME),
            "ngram_model": os.path.join(filepath, lm_file),
        }

    @classmethod
    def load_from_dir(
        cls, filepath: str, unigram_encoding: Optional[str] = None
    ) -> "LanguageModel":
        """Load the strict 3-file LM directory layout (ref lm.py:434-452)."""
        filenames = cls.parse_directory_contents(filepath)
        with open(filenames["json_attrs"], "r") as fh:
            attrs = json.load(fh)
        if set(attrs.keys()) != set(cls.JSON_ATTRS):
            raise ValueError(
                f"attrs.json must define exactly {cls.JSON_ATTRS}; "
                f"it defines {sorted(attrs.keys())}"
            )
        with open(filenames["unigrams"], "r", encoding=unigram_encoding) as fh:
            unigrams = fh.read().splitlines()
        model = open_ngram_file(filenames["ngram_model"])
        return cls(model, unigrams, **attrs)


class MultiLanguageModel(AbstractLanguageModel):
    """Average-fusion ensemble of two or more language models."""

    def __init__(self, language_models: Sequence[AbstractLanguageModel]) -> None:
        if len(language_models) < 2:
            raise ValueError("an ensemble needs two or more member language models")
        self._language_models = list(language_models)

    def reset_params(self, **params: "object") -> None:
        """Re-tune every member's fusion knobs in place.

        Deliberate divergence: the reference's MultiLanguageModel inherits
        the abstract no-op (ref language_model.py:226-227), so re-tuning
        an ensemble there silently does nothing — a tuning-sweep trap.
        Forwarding to the members is strictly more useful and matches the
        single-LM semantics.
        """
        for lm in self._language_models:
            lm.reset_params(**params)

    @property
    def order(self) -> int:
        return max(lm.order for lm in self._language_models)

    def get_start_state(self) -> MultiLMState:
        return MultiLMState([lm.get_start_state() for lm in self._language_models])

    def score_partial_token(self, partial_token: str) -> float:
        return float(
            np.mean([lm.score_partial_token(partial_token) for lm in self._language_models])
        )

    def score(
        self, prev_state: AbstractLMState, word: str, is_last_word: bool = False
    ) -> Tuple[float, MultiLMState]:
        """Average of member scores; state is the tuple of member states."""
        if not isinstance(prev_state, MultiLMState):
            raise AssertionError(
                f"MultiLanguageModel.score needs a MultiLMState; "
                f"received {type(prev_state).__name__}"
            )
        if len(prev_state.states) != len(self._language_models):
            raise AssertionError(
                f"state carries {len(prev_state.states)} member states but the "
                f"ensemble has {len(self._language_models)} models"
            )
        total = 0.0
        out_states = []
        for state, lm in zip(prev_state.states, self._language_models):
            fused, out = lm.score(state, word, is_last_word=is_last_word)
            total += fused
            out_states.append(out)
        return total / len(self._language_models), MultiLMState(out_states)
