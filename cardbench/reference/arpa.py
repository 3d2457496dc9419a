"""The reference's own n-gram model: an ARPA reader and KenLM's backoff score, in plain Python.

``p(w | h) = P(h[-m+1:], w) + sum_{j=m..k} B(h[-j:])`` in log10, where ``m``
is the longest n-gram ending in ``w`` that the model lists, ``k = len(h)``
and ``B`` is a listed context's backoff (0 when absent). The state after a
word is the longest suffix of ``h + (w,)``, at most ``order - 1`` words,
that the model lists. A word the model does not list scores as ``<unk>``.
Values are held and summed in float64.

Words are kept as strings; n-grams are keyed by their words joined with
one space. :attr:`ArpaModel.words` lists the words in the order they first
appear in the file, ``<unk>`` first: the numbering KenLM and ARPA readers
give them, by which a decoder's word-id state is read back as words.
"""
from __future__ import annotations

import marshal
import os
from typing import Dict, List, Tuple

UNK = "<unk>"
BOS = "<s>"
EOS = "</s>"


class ArpaModel:
    """An ARPA n-gram model read into dictionaries of log10 probabilities and backoffs."""

    @classmethod
    def cached(cls, path: str) -> "ArpaModel":
        """The model of ``path``, through a ``marshal`` copy of this reader's own parse beside it.

        The copy is written on the first read and used while the ARPA file
        keeps its size and modification time; it holds nothing but what
        :meth:`__init__` read from the file.
        """
        stat = os.stat(path)
        stamp = (stat.st_size, stat.st_mtime_ns)
        copy = path + ".refparse"
        try:
            with open(copy, "rb") as fh:
                saved = marshal.loads(fh.read())  # one read: marshal.load reads a file in small pieces
            if tuple(saved[0]) == stamp:
                model = cls.__new__(cls)
                model.prob, model.backoff, model.words, model.unigram_lines = saved[1:]
                model.order = len(model.prob)
                return model
        except (OSError, EOFError, ValueError, TypeError):
            pass
        model = cls(path)
        tmp = f"{copy}.part{os.getpid()}"
        with open(tmp, "wb") as fh:
            marshal.dump((stamp, model.prob, model.backoff, model.words, model.unigram_lines), fh)
        os.replace(tmp, copy)
        return model

    def __init__(self, path: str) -> None:
        self.prob: List[Dict[str, float]] = []
        self.backoff: List[Dict[str, float]] = []
        self.words: List[str] = [UNK]
        seen = {UNK}
        self.unigram_lines: List[str] = []  # words of the 1-gram lines with a backoff (prob, word, backoff)
        n = 0
        with open(path, "r", encoding="utf-8") as fh:
            for raw in fh:
                line = raw.strip()
                if not line:
                    continue
                if line == "\\end\\":
                    break
                if line.startswith("\\") and line.endswith("-grams:"):
                    n = int(line[1:].split("-", 1)[0])
                    while len(self.prob) < n:
                        self.prob.append({})
                        self.backoff.append({})
                    continue
                if n == 0:
                    continue
                parts = line.split()
                if len(parts) < n + 1:
                    continue
                key = " ".join(parts[1 : n + 1])
                self.prob[n - 1][key] = float(parts[0])
                if len(parts) > n + 1:
                    self.backoff[n - 1][key] = float(parts[n + 1])
                if n == 1:
                    if len(line.split("\t")) == 3:
                        self.unigram_lines.append(parts[1])
                    if key not in seen:
                        seen.add(key)
                        self.words.append(key)
                else:
                    for w in parts[1 : n + 1]:
                        if w not in seen:
                            seen.add(w)
                            self.words.append(w)
        self.order = len(self.prob)
        if self.order == 0 or not self.prob[0]:
            raise ValueError(f"no n-grams in {path!r}")

    def __contains__(self, word: str) -> bool:
        """Whether the model lists ``word`` (``<unk>`` itself does not count)."""
        return word != UNK and word in self.prob[0]

    def start_state(self, score_boundary: bool) -> Tuple[str, ...]:
        if score_boundary and BOS in self.prob[0]:
            return (BOS,)
        return ()

    def score(self, state: Tuple[str, ...], word: str) -> Tuple[float, Tuple[str, ...]]:
        """log10 p(word | state) and the state after it."""
        if word not in self.prob[0]:
            word = UNK
        full = (state[-(self.order - 1):] if self.order > 1 else ()) + (word,)
        k = len(full) - 1
        matched, prob = 0, 0.0
        for m in range(len(full), 0, -1):
            hit = self.prob[m - 1].get(" ".join(full[-m:]))
            if hit is not None:
                matched, prob = m, hit
                break
        if matched == 0:
            matched, prob = 1, self.prob[0].get(UNK, -99.0)
        score = prob
        for j in range(matched, k + 1):
            score += self.backoff[j - 1].get(" ".join(full[-j - 1 : -1]), 0.0)
        out: Tuple[str, ...] = ()
        for m in range(min(len(full), self.order - 1), 0, -1):
            if " ".join(full[-m:]) in self.prob[m - 1]:
                out = full[-m:]
                break
        return score, out
