"""The plain reference: CTC beam search with shallow n-gram fusion, one utterance at a time.

A frozen, self-contained statement of the decoder's semantics (those of
pyctcdecode's ``BeamSearchDecoderCTC``): per frame, every live beam is
extended by every admitted token (log-probability at least
``token_min_logp``, and the frame's best token); blank and a repeated token
extend the acoustic score only; a word boundary (a char alphabet's space,
a BPE piece that starts with ``▁``, or any piece after a right-bounded one)
hands the finished word to the LM; anything else extends the word in
progress. Beams that denote the same prefix merge (log-add, the first
keeps its place, the last gives the rest); each beam's fused score is its
acoustic score plus the LM's score of its committed words plus the penalty
of its partial word; beams below the best by more than ``beam_prune_logp``
go, then all but the best ``beam_width`` (a stable sort). At the end (or a
forced commit) the partial words are committed and scored, with ``</s>``
credited at the end.

The LM's fused score of a word is ``alpha * ln(10) * (log10 p + unk_offset
* [oov] + [end] log10 p(</s>)) + beta``; a partial word that no known word
starts with costs ``unk_offset``, scaled by its length over 6 letters.

An ensemble (pyctcdecode's ``MultiLanguageModel``) is two or more
:class:`Member` s, each an n-gram model with its own weights, OOV offset and
``<s>`` / ``</s>`` boundary: a word's fused score is the members' mean, a
partial word's penalty too, and the LM state is the tuple of the members'
states. Hotwords (pyctcdecode's ``HotwordScorer``; phrases split into
unigrams) add ``weight`` for every word of a text that is a hotword, counted
over the whole text each time, and score a partial word that starts a
hotword as ``weight * len(partial) / len(the shortest hotword it starts)``
in place of the LM's penalty.

``precision="f64"`` computes in float64. ``precision="bf16"`` rounds every
score this decoder forms (each frame's log-probabilities, each beam's
running sums, each LM score) to bfloat16: the lower-precision control that
the comparison has to reject.

This module imports nothing of the program under test.
"""
from __future__ import annotations

import math
from typing import Dict, Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np

from .arpa import EOS, ArpaModel

BPE_TOKEN = "▁"
NULL_FRAMES = (-1, -1)
AVG_TOKEN_LEN = 6
HOTWORD_WEIGHT = 10.0  # pyctcdecode's default hotword_weight
MIN_TOKEN_CLIP_P = 1e-15
LN10 = 1.0 / math.log10(math.e)


def to_bf16(x: float) -> float:
    """``x`` rounded to the nearest bfloat16 (ties to even)."""
    bits = int(np.array(x, dtype=np.float32).view(np.uint32))
    bits = ((bits + 0x7FFF + ((bits >> 16) & 1)) >> 16) << 16
    return float(np.array(bits & 0xFFFFFFFF, dtype=np.uint32).view(np.float32))


def normalize_labels(raw: Sequence[str]) -> Tuple[List[str], bool]:
    """A model's raw labels as the decoder reads them, and whether they are BPE pieces.

    BPE (some label starts with ``▁``): ``<unk>`` becomes ``▁⁇▁``. Char:
    ``|`` is the word delimiter where there is no space label (it becomes
    ``" "``), and ``<unk>`` becomes ``⁇``. Either way ``<pad>`` is the blank
    ``""``, and a blank is appended when there is none. Other labels, such as
    a tokenizer's ``<s>`` and ``</s>``, are letters like any other.
    """
    labels = list(raw)
    is_bpe = any(lab.startswith(BPE_TOKEN) for lab in labels)
    if not is_bpe and "|" in labels and " " not in labels:
        labels[labels.index("|")] = " "
    out = []
    for lab in labels:
        low = lab.lower()
        if low in ("<pad>", "[pad]"):
            out.append("")
        elif low in ("<unk>", "[unk]"):
            out.append("▁⁇▁" if is_bpe else "⁇")
        else:
            out.append(lab)
    if "" not in out:
        out.append("")
    return out, is_bpe


def log_softmax(mat: np.ndarray) -> np.ndarray:
    """Clipped float64 log-softmax of raw logits, row by row."""
    x = mat.astype(np.float64)
    x = x - x.max(axis=1, keepdims=True)
    out = x - np.log(np.exp(x).sum(axis=1, keepdims=True))
    return np.clip(out, math.log(MIN_TOKEN_CLIP_P), 0.0)


class Beam:
    """One hypothesis: committed text, the word handed to the LM, the word in progress, scores."""

    __slots__ = ("text", "next_word", "partial", "last", "frames", "pframes", "logit", "lm", "force")

    def __init__(self, text, next_word, partial, last, frames, pframes, logit, lm=0.0, force=False):
        self.text = text
        self.next_word = next_word
        self.partial = partial
        self.last = last
        self.frames = frames
        self.pframes = pframes
        self.logit = logit
        self.lm = lm
        self.force = force

    def copy(self, **kw) -> "Beam":
        b = Beam(self.text, self.next_word, self.partial, self.last, self.frames, self.pframes,
                 self.logit, self.lm, self.force)
        for k, v in kw.items():
            setattr(b, k, v)
        return b


def _join(left: str, right: str) -> str:
    if not left or not right:
        return left or right
    return left + " " + right


class Member:
    """One LM of the fusion: an n-gram model, its weights, its known words and their prefixes."""

    def __init__(self, model: ArpaModel, alpha: float = 0.5, beta: float = 1.5, unk_score_offset: float = -10.0,
                 score_boundary: bool = True) -> None:
        self.model = model
        self.alpha, self.beta = alpha, beta
        self.unk = unk_score_offset
        self.score_boundary = score_boundary
        self.unigrams = {w for w in model.unigram_lines if w in model}
        self.prefixes = {w[:i] for w in self.unigrams for i in range(len(w) + 1)}

    def start_state(self) -> Tuple[str, ...]:
        return self.model.start_state(self.score_boundary)

    def word_score(self, state, word: str, end: bool):
        """The fused score of ``word`` after ``state`` (unrounded), and the state after it."""
        raw, out = self.model.score(state, word)
        if (self.unigrams and word not in self.unigrams) or word not in self.model:
            raw += self.unk
        if end and self.score_boundary:
            raw += self.model.score(out, EOS)[0]
        return self.alpha * raw * LN10 + self.beta, out

    def partial_score(self, partial: str) -> float:
        score = self.unk * float(partial not in self.prefixes)
        if len(partial) > AVG_TOKEN_LEN:
            score = score * len(partial) / AVG_TOKEN_LEN
        return score


class ReferenceDecoder:
    """The reference decoder over ``labels`` (raw model labels) and an ARPA model or an ensemble.

    ``lm``: an :class:`ArpaModel`, fused with the weights given here, or a
    sequence of two or more :class:`Member` s (the weights here are then
    unused). ``hotwords``: words or phrases, boosted by ``hotword_weight``.
    """

    def __init__(self, raw_labels: Sequence[str], lm: Union[ArpaModel, Sequence[Member]], alpha: float = 0.5,
                 beta: float = 1.5, unk_score_offset: float = -10.0, score_boundary: bool = True,
                 precision: str = "f64", hotwords: Iterable[str] = (),
                 hotword_weight: float = HOTWORD_WEIGHT) -> None:
        if precision not in ("f64", "bf16"):
            raise ValueError(f"precision must be 'f64' or 'bf16'; got {precision!r}")
        self.labels, self.is_bpe = normalize_labels(raw_labels)
        self.ensemble = not isinstance(lm, ArpaModel)
        self.lm = None if self.ensemble else lm  # a single LM's model, whose ``words`` read its states
        self.members = list(lm) if self.ensemble else [Member(lm, alpha, beta, unk_score_offset, score_boundary)]
        if self.ensemble and len(self.members) < 2:
            raise ValueError("an ensemble needs two or more members")
        self.q = to_bf16 if precision == "bf16" else float
        self.hot = {w for phrase in hotwords for w in phrase.split()}
        self.hot_weight = float(hotword_weight)
        self.hot_len: Dict[str, int] = {}  # each prefix of a hotword: the length of the shortest it starts
        for w in self.hot:
            for i in range(1, len(w) + 1):
                self.hot_len[w[:i]] = min(self.hot_len.get(w[:i], len(w)), len(w))
        self.kind, self.piece, self.rbound = [], [], []
        for lab in self.labels:
            if lab == "":
                kind = "blank"
            elif (self.is_bpe and lab[:1] == BPE_TOKEN) or (not self.is_bpe and lab == " "):
                kind = "boundary"
            else:
                kind = "regular"
            piece = lab[1:] if self.is_bpe and lab[:1] == BPE_TOKEN else lab
            rb = bool(self.is_bpe and lab != "" and lab[-1:] == BPE_TOKEN)
            if rb and piece[-1:] == BPE_TOKEN:
                piece = piece[:-1]
            self.kind.append(kind)
            self.piece.append(piece)
            self.rbound.append(rb)

    # -- the LM ----------------------------------------------------------------
    def _word_score(self, state, word: str, end: bool):
        """The members' mean fused score of ``word``; the state after it (a tuple of the members' for an ensemble)."""
        if not self.ensemble:
            s, out = self.members[0].word_score(state, word, end)
            return self.q(s), out
        scored = [m.word_score(st, word, end) for m, st in zip(self.members, state)]
        return self.q(sum(self.q(s) for s, _ in scored) / len(scored)), tuple(out for _, out in scored)

    def _partial_score(self, partial: str) -> float:
        if partial in self.hot_len:
            return self.q(self.hot_weight * len(partial) / self.hot_len[partial])
        scores = [m.partial_score(partial) for m in self.members]
        return self.q(scores[0] if len(scores) == 1 else sum(scores) / len(scores))

    def _hot_score(self, text: str) -> float:
        """``weight`` for every word of ``text`` that is a hotword."""
        return self.q(self.hot_weight * sum(1 for w in text.split() if w in self.hot))

    def start(self) -> dict:
        """A fresh stream: the empty beam and the LM score caches."""
        states = tuple(m.start_state() for m in self.members)
        state0 = states if self.ensemble else states[0]
        return dict(beams=[Beam("", "", "", None, [], NULL_FRAMES, 0.0)],
                    lm_cache={("", False): (0.0, state0)}, p_cache={}, frames=0)

    def _fuse(self, st: dict, beams: List[Beam], end: bool = False) -> List[Beam]:
        cache, p_cache, q = st["lm_cache"], st["p_cache"], self.q
        out = []
        for b in beams:
            text = _join(b.text, b.next_word)
            key = (text, end)
            if key not in cache:
                prev_raw, prev_state = cache[(b.text, False)]
                s, end_state = self._word_score(prev_state, b.next_word, end)
                cache[key] = (q(prev_raw + s), end_state)
            score = cache[key][0]
            if self.hot:
                score = q(score + self._hot_score(text))
            if b.partial:
                if b.partial not in p_cache:
                    p_cache[b.partial] = self._partial_score(b.partial)
                score = q(score + p_cache[b.partial])
            out.append(b.copy(text=text, next_word="", lm=q(b.logit + score)))
        return out

    # -- the search -------------------------------------------------------------
    def _apply(self, b: Beam, tok: int, p: float, t: int) -> Beam:
        char = self.labels[tok]
        logit = self.q(b.logit + p)
        if char == "" or b.last == char:
            pf = b.pframes if char == "" else (b.pframes[0], t + 1)
            return b.copy(last=char, pframes=pf, logit=logit)
        boundary = self.kind[tok] == "boundary" or (self.is_bpe and b.force)
        if boundary:
            frames = b.frames if b.partial == "" else b.frames + [b.pframes]
            if self.is_bpe:
                partial, pf, force = self.piece[tok], (t, t + 1), self.rbound[tok]
            else:
                partial, pf, force = "", NULL_FRAMES, False
            return Beam(b.text, b.partial, partial, char, frames, pf, logit, 0.0, force)
        pf = (t, t + 1) if b.pframes[0] < 0 else (b.pframes[0], t + 1)
        return Beam(b.text, b.next_word, b.partial + char, char, b.frames, pf, logit, 0.0, b.force)

    @staticmethod
    def _merge(beams: List[Beam]) -> List[Beam]:
        slot: Dict[tuple, int] = {}
        out: List[Beam] = []
        for b in beams:
            key = (_join(b.text, b.next_word), b.partial, b.last, b.force)
            i = slot.get(key)
            if i is None:
                slot[key] = len(out)
                out.append(b)
            else:
                a, c = out[i].logit, b.logit
                hi, lo = (a, c) if a >= c else (c, a)
                out[i] = b.copy(logit=hi + math.log1p(math.exp(lo - hi)))
        return out

    def _prune(self, scored: List[Beam], beam_width: int, prune_logp: float) -> List[Beam]:
        cutoff = max(b.lm for b in scored) + prune_logp
        return sorted([b for b in scored if b.lm >= cutoff], key=lambda b: b.lm, reverse=True)[:beam_width]

    def advance(self, st: dict, logits: np.ndarray, beam_width: int = 100, prune_logp: float = -10.0,
                token_min_logp: float = -5.0) -> None:
        """Run the frames of ``logits`` (raw) over the stream ``st``."""
        logp = log_softmax(logits)
        beams = st["beams"]
        for off, col in enumerate(logp):
            t = st["frames"] + off
            best = int(col.argmax())
            admitted = np.flatnonzero(col >= token_min_logp)
            if best not in admitted:
                admitted = np.sort(np.append(admitted, best))
            expanded = []
            for tok in admitted:
                p = self.q(float(col[tok]))
                expanded.extend(self._apply(b, int(tok), p, t) for b in beams)
            scored = self._fuse(st, self._merge(expanded))
            beams = [b.copy(lm=0.0) for b in self._prune(scored, beam_width, prune_logp)]
        st["beams"] = beams
        st["frames"] += logp.shape[0]

    def rank(self, st: dict, beam_width: int = 100, prune_logp: float = -10.0,
             commit: bool = False, end: bool = False) -> List[Beam]:
        """The ranked view of the stream's beams; ``commit`` or ``end`` commits the partial words."""
        beams = st["beams"]
        if commit or end:
            beams = self._merge([
                Beam(b.text, b.partial, "", None, b.frames if b.partial == "" else b.frames + [b.pframes],
                     NULL_FRAMES, b.logit)
                for b in beams])
        return self._prune(self._fuse(st, beams, end=end), beam_width, prune_logp)

    def decode(self, logits: np.ndarray, beam_width: int = 100, prune_logp: float = -10.0,
               token_min_logp: float = -5.0) -> List[dict]:
        """Every output beam of one utterance: text, word frames, LM state (words), scores."""
        st = self.start()
        self.advance(st, logits, beam_width, prune_logp, token_min_logp)
        ranked = self.rank(st, beam_width, prune_logp, commit=True, end=True)
        return [output(b, st) for b in ranked]

    def stream(self, chunks: Sequence[np.ndarray], beam_width: int = 100, prune_logp: float = -10.0,
               token_min_logp: float = -5.0) -> List[List[Beam]]:
        """The ranked view after each chunk, the last chunk ending the utterance."""
        st = self.start()
        views = []
        for i, chunk in enumerate(chunks):
            self.advance(st, chunk, beam_width, prune_logp, token_min_logp)
            views.append(self.rank(st, beam_width, prune_logp, end=(i == len(chunks) - 1)))
        return views


def output(b: Beam, st: dict) -> dict:
    """An output beam as plain data: the text with its word frames, the LM state, the scores."""
    key = (b.text, True)
    state: Optional[Tuple[str, ...]] = st["lm_cache"][key][1] if key in st["lm_cache"] else None
    return dict(text=" ".join(b.text.split()), frames=list(zip(b.text.split(), b.frames)),
                state=state, logit=b.logit, lm=b.lm)
