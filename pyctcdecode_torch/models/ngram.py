"""Self-contained n-gram language model runtime.

The reference delegates n-gram scoring to the external KenLM C++ bindings
(ref ``language_model.py:28-34, 306-360``). This framework ships its own
runtime instead, with two backends over one table format:

* this module — exact Python/numpy scorer (the semantic ground truth),
* ``models/device_tables.py`` — packed hash tables probed on the device.

Scoring semantics mirror KenLM's ``BaseScore`` exactly (standard Katz
backoff over an ARPA model, log10 domain, float32 table values):

``p(w | h) = P(h[-m+1:], w)  +  sum_{j=m..k} B(h[-j:])``

where ``m`` is the longest matched n-gram ending in ``w``, ``k = len(h)``,
and ``B`` is the (0-when-absent) backoff weight. The outgoing state is the
longest suffix of ``h + (w,)`` (capped at order-1) present in the tables,
which reproduces KenLM's observable state behavior for well-formed ARPA
files (every n-gram's suffix exists as an entry).
"""
from __future__ import annotations

import logging
import os
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from ..utils import profiling

logger = logging.getLogger(__name__)

UNK_WORD = "<unk>"
BOS_WORD = "<s>"
EOS_WORD = "</s>"


class NGramTables:
    """Parsed ARPA model: vocabulary plus per-order (prob, backoff) maps.

    Probabilities and backoffs are stored as float32 (KenLM stores 32-bit
    floats; matching its precision keeps golden scores bit-comparable).
    Keys are tuples of int32 word ids.
    """

    def __init__(
        self,
        order: int,
        vocab: Dict[str, int],
        ngrams: List[Dict[Tuple[int, ...], Tuple[np.float32, np.float32]]],
        path: Optional[str] = None,
    ) -> None:
        self.order = order
        self.vocab = vocab  # word -> id; UNK_WORD is always present with id 0
        self.ngrams = ngrams  # ngrams[n-1]: key len n
        self.path = path
        self.unk_id = vocab[UNK_WORD]

    # -- vocabulary ---------------------------------------------------------
    def word_id(self, word: str) -> int:
        """Id for ``word``; the <unk> id when out of vocabulary."""
        return self.vocab.get(word, self.unk_id)

    def __contains__(self, word: str) -> bool:
        """Vocabulary membership; <unk> itself reports False (KenLM parity)."""
        wid = self.vocab.get(word)
        return wid is not None and wid != self.unk_id

    # -- scoring ------------------------------------------------------------
    def raw_score(
        self, context: Tuple[int, ...], word_id: int
    ) -> Tuple[float, Tuple[int, ...]]:
        """log10 p(word | context) and the outgoing context state.

        ``context`` must already be a valid state (a tuple of <= order-1 word
        ids that exists in the tables, or empty).
        """
        full = context[-(self.order - 1):] + (word_id,) if self.order > 1 else (word_id,)
        k = len(full) - 1  # number of context words
        # longest n-gram ending in word_id
        matched = 0
        prob = np.float32(0.0)
        for n in range(len(full), 0, -1):
            hit = self.ngrams[n - 1].get(full[-n:])
            if hit is not None:
                matched, prob = n, hit[0]
                break
        if matched == 0:
            # word_id has no unigram entry: only possible for ill-formed
            # tables; fall back to the <unk> unigram like KenLM does.
            uni = self.ngrams[0].get((self.unk_id,))
            prob = uni[0] if uni is not None else np.float32(-99.0)
            matched = 1
        # accumulate backoff weights of the unmatched context suffixes
        score = np.float32(prob)
        for j in range(matched, k + 1):
            ent = self.ngrams[j - 1].get(full[-j - 1:-1])
            if ent is not None:
                score = np.float32(score + ent[1])
        # outgoing state: longest suffix of full present in the tables
        max_state = min(len(full), self.order - 1)
        out_state: Tuple[int, ...] = ()
        for n in range(max_state, 0, -1):
            if full[-n:] in self.ngrams[n - 1]:
                out_state = full[-n:]
                break
        return float(score), out_state

    def begin_sentence_state(self) -> Tuple[int, ...]:
        """(<s>,) when the model has a <s> unigram entry, else empty."""
        bos = self.vocab.get(BOS_WORD)
        if bos is None or (bos,) not in self.ngrams[0]:
            return ()
        return (bos,)

    def null_context_state(self) -> Tuple[int, ...]:
        return ()


def _parse_count_header(line: str) -> Optional[Tuple[int, int]]:
    # "ngram N=COUNT"
    if not line.startswith("ngram "):
        return None
    try:
        n_part, count_part = line[6:].split("=", 1)
        return int(n_part), int(count_part)
    except ValueError:
        return None


def read_arpa(path: str) -> NGramTables:
    """Parse a (possibly gzipped) ARPA file into :class:`NGramTables`.

    Ref format consumed by KenLM / produced by kenlm's ``lmplz``; the
    reference's unigram extraction is ``language_model.py:67-84``.
    """
    import gzip

    opener = gzip.open if path.endswith(".gz") else open
    vocab: Dict[str, int] = {UNK_WORD: 0}
    ngrams: List[Dict[Tuple[int, ...], Tuple[np.float32, np.float32]]] = []
    order = 0
    current_n = 0

    with opener(path, "rt", encoding="utf-8") as fh:
        section = "header"
        for raw in fh:
            line = raw.strip()
            if not line:
                continue
            if line == "\\data\\":
                section = "counts"
                continue
            if line == "\\end\\":
                break
            if line.endswith("-grams:") and line.startswith("\\"):
                current_n = int(line[1:].split("-", 1)[0])
                order = max(order, current_n)
                while len(ngrams) < current_n:
                    ngrams.append({})
                section = "ngrams"
                continue
            if section == "counts":
                parsed = _parse_count_header(line)
                if parsed is not None:
                    n, _count = parsed
                    order = max(order, n)
                continue
            if section != "ngrams" or current_n == 0:
                continue
            parts = line.split()
            # "prob w1 ... wN [backoff]"
            if len(parts) < current_n + 1:
                continue
            prob = np.float32(parts[0])
            words = parts[1 : 1 + current_n]
            backoff = (
                np.float32(parts[1 + current_n])
                if len(parts) > current_n + 1
                else np.float32(0.0)
            )
            ids = []
            for w in words:
                wid = vocab.get(w)
                if wid is None:
                    wid = len(vocab)
                    vocab[w] = wid
                ids.append(wid)
            ngrams[current_n - 1][tuple(ids)] = (prob, backoff)

    if not ngrams or not ngrams[0]:
        raise ValueError(f"No n-grams found in ARPA file {path!r}.")
    while len(ngrams) < order:
        ngrams.append({})
    return NGramTables(order=order, vocab=vocab, ngrams=ngrams, path=os.path.abspath(path))


def load_unigram_set_from_arpa(arpa_path: str) -> Set[str]:
    """Read the \\1-grams section of an ARPA file into a set of words.

    Parity with ref ``language_model.py:67-84``: only lines with exactly
    three tab-separated fields (prob, word, backoff) contribute. With the
    host tracer on, the read is a root span ``lm.unigrams`` of its own
    (inside another call it opens none).
    """
    import gzip

    unigrams = set()
    opener = gzip.open if arpa_path.endswith(".gz") else open
    with profiling.call("lm.unigrams"), opener(arpa_path, "rt") as fh:
        in_unigrams = False
        for raw in fh:
            line = raw.strip()
            if line == "\\1-grams:":
                in_unigrams = True
            elif line == "\\2-grams:":
                break
            if in_unigrams and line:
                parts = line.split("\t")
                if len(parts) == 3:
                    unigrams.add(parts[1])
    if not unigrams:
        raise ValueError("No unigrams found in arpa file. Something is wrong with the file.")
    return unigrams


class NGramModel:
    """KenLM-compatible model facade over :class:`NGramTables`.

    Provides the surface the decoding stack needs: ``order``, ``__contains__``
    (vocab membership), ``BaseScore``-equivalent :meth:`raw_score_word`, and
    boundary state constructors. Loading a ``.arpa`` file goes through
    :func:`read_arpa`; the compiled ``.ctclm`` format is handled in
    ``models/binfmt.py``.
    """

    def __init__(self, tables: NGramTables) -> None:
        self._tables = tables

    @classmethod
    def from_file(cls, path: str) -> "NGramModel":
        """Open an ARPA (possibly gzipped) or compiled .ctclm model file."""
        ext = os.path.splitext(path)[1].lower()
        if ext in (".arpa", ".gz") or path.endswith(".arpa.gz"):
            return cls(read_arpa(path))
        if ext in (".bin", ".binary", ".ctclm"):
            from . import binfmt

            return cls(binfmt.read_binary(path))
        # default: try ARPA text
        return cls(read_arpa(path))

    @property
    def tables(self) -> NGramTables:
        return self._tables

    def vocab_words(self) -> List[str]:
        """The vocabulary in id order (for unigram-set inference on
        compiled ``.ctclm`` models, which have no ARPA text to scan)."""
        return sorted(self._tables.vocab, key=self._tables.vocab.__getitem__)

    @property
    def order(self) -> int:
        return self._tables.order

    @property
    def path(self) -> Optional[str]:
        return self._tables.path

    def __contains__(self, word: str) -> bool:
        return word in self._tables

    def begin_sentence_state(self) -> Tuple[int, ...]:
        return self._tables.begin_sentence_state()

    def null_context_state(self) -> Tuple[int, ...]:
        return self._tables.null_context_state()

    def raw_score_word(
        self, state: Tuple[int, ...], word: str
    ) -> Tuple[float, Tuple[int, ...]]:
        """log10 p(word | state) plus outgoing state (KenLM BaseScore)."""
        return self._tables.raw_score(state, self._tables.word_id(word))

    def raw_end_score(self, state: Tuple[int, ...]) -> float:
        """log10 p(</s> | state)."""
        score, _ = self.raw_score_word(state, EOS_WORD)
        return score


def open_ngram_file(path: str, backend: str = "auto") -> "object":
    """Open an n-gram model file, dispatching on its kind (as the JAX reference package).

    * ``.bin`` / ``.binary`` starting with KenLM's ``mmap lm `` magic: a
      :class:`~.kenlm_bin.KenLMBinaryModel` (PROBING, TRIE or QUANT_TRIE),
      whatever the backend;
    * ``.ctclm`` (and a ``.bin`` / ``.binary`` without that magic), and
      gzipped ARPA: an :class:`NGramModel` read in Python;
    * plain ARPA text: with ``backend="native"`` a
      :class:`~.native.NativeNGramModel` (the C++ engine, built with ``g++``
      at first use; raises where it cannot be built or the file not
      parsed); with ``"python"`` an :class:`NGramModel`; with ``"auto"``
      the native engine where it builds, else (logged) Python. Both give
      the same scores and the same device tables.

    ``backend="native"`` for any file but plain ARPA text raises
    :class:`ValueError`: the C++ parser reads nothing else.

    With the host tracer on, the read is a root span ``lm.read`` of its own
    (inside another call, such as ``build_ctcdecoder``'s, it opens none).
    """
    if backend not in ("auto", "native", "python"):
        raise ValueError(
            f"backend must be 'auto', 'native' or 'python'; got {backend!r}"
        )
    with profiling.call("lm.read"):
        return _open_ngram_file(path, backend)


def _open_ngram_file(path: str, backend: str) -> "object":
    ext = os.path.splitext(path)[1].lower()
    gzipped = path.endswith(".gz")
    is_arpa = ext not in (".bin", ".binary", ".ctclm")
    if ext in (".bin", ".binary"):
        with open(path, "rb") as fh:
            head = fh.read(16)
        if head.startswith(b"mmap lm "):  # KenLM binary magic prefix
            from .kenlm_bin import KenLMBinaryModel

            return KenLMBinaryModel.from_file(path)
    if backend == "native" and (not is_arpa or gzipped):
        raise ValueError(
            f"backend='native' supports plain-text ARPA files only; "
            f"{path!r} needs the python backend"
        )
    if backend == "python" or not is_arpa or gzipped:
        return NGramModel.from_file(path)
    from .native import NativeNGramModel

    if backend == "native":
        return NativeNGramModel.from_file(path)
    from ..csrc.native import load_native

    if load_native() is not None:
        try:
            return NativeNGramModel.from_file(path)
        except Exception as err:
            logger.warning("native ARPA load failed (%s); falling back to Python", err)
    return NGramModel.from_file(path)
