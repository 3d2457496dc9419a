"""Host engine for CTC beam search (the port's parity oracle), and the beam records.

A framework-free copy of the JAX reference package's host decoder
(``decoder.py``): :class:`BeamSearchDecoderCTC` runs the CTC beam search
with shallow n-gram fusion in plain Python over numpy float64 log-probs,
on this package's ``LanguageModel`` / ``MultiLanguageModel`` and
``HotwordScorer``. The device engine (:mod:`pyctcdecode_torch.engine`,
driven by :class:`~pyctcdecode_torch.torch_decoder.TorchBeamSearchDecoderCTC`)
is held against it where the reference package is not at hand, as on a
machine with a GPU and no JAX; it is also the single-core host baseline.
Both decoders return the records defined here (ref ``decoder.py:50-115``).

Semantics pinned here (each covered by tests):

* per-(token, beam) transitions — blank/repeat extend the acoustic score
  only; a BPE ``▁`` piece or a char-alphabet space promotes the in-progress
  word for LM scoring; anything else extends the in-progress word
  (ref decoder.py:443-534).
* duplicate-prefix combination in log space, keyed on
  (committed text ⊕ pending word, partial word, last token), first
  occurrence keeps its rank, newest occurrence donates metadata
  (ref decoder.py:211-224).
* incremental LM fusion with per-text score caching, hotword boosting, OOV
  and partial-word rules (ref decoder.py:346-424).
* score-window pruning against the best hypothesis, stable trimming to the
  beam width, optional recent-history deduplication
  (ref decoder.py:165-167, 227-258, 536-554).

One deliberate divergence: the reference keeps the BPE "previous piece was
right-bounded" flag in a loop variable shared by every beam
(``force_next_break``, ref decoder.py:442,474-482); here it is per-beam
state, which only matters on alphabets with ``▁…▁`` double-bounded pieces.

Serialization (``save_to_dir``, ``parse_directory_contents``,
``load_from_dir``, ``load_from_hf_hub``) keeps the reference's directory:
``alphabet.json`` and, with a language model, ``language_model/`` (its
``attrs.json``, ``unigrams.txt`` and model file: ARPA, ``.arpa.gz``, a
KenLM binary or ``.ctclm``).
"""
from __future__ import annotations

import dataclasses
import functools
import logging
import math
import multiprocessing as mp
import os
from multiprocessing.pool import Pool
from pathlib import Path
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np

from .alphabet import BPE_TOKEN, Alphabet
from .constants import (
    DEFAULT_BEAM_WIDTH,
    DEFAULT_HOTWORD_WEIGHT,
    DEFAULT_MIN_TOKEN_LOGP,
    DEFAULT_PRUNE_BEAMS,
    DEFAULT_PRUNE_LOGP,
)
from .models.base import AbstractLanguageModel, AbstractLMState
from .models.hotwords import HotwordScorer
from .models.language_model import LanguageModel
from .utils.logits import normalize_to_logp

logger = logging.getLogger(__name__)

# frame span of one word: (start_frame, end_frame)
Frames = Tuple[int, int]
WordFrames = Tuple[str, Frames]

NULL_FRAMES: Frames = (-1, -1)


def _not_ported(option: str) -> NotImplementedError:
    return NotImplementedError(f"{option} is not ported to pyctcdecode_torch yet")


@dataclasses.dataclass(frozen=True, slots=True)
class Beam:
    """One beam hypothesis during decoding.

    ``text`` holds LM-scored committed words, ``next_word`` a finished but
    not-yet-scored word, ``partial_word`` the in-progress word.
    """

    text: str
    next_word: str
    partial_word: str
    last_char: Optional[str]
    text_frames: List[Frames]
    partial_frames: Frames
    logit_score: float
    force_next_break: bool = False

    @classmethod
    def from_lm_beam(cls, lm_beam: "LMBeam") -> "Beam":
        """Strip the LM score off an :class:`LMBeam`."""
        return Beam(
            text=lm_beam.text,
            next_word=lm_beam.next_word,
            partial_word=lm_beam.partial_word,
            last_char=lm_beam.last_char,
            text_frames=lm_beam.text_frames,
            partial_frames=lm_beam.partial_frames,
            logit_score=lm_beam.logit_score,
            force_next_break=lm_beam.force_next_break,
        )



@dataclasses.dataclass(frozen=True, slots=True)
class LMBeam:
    """Beam plus its fused (logit + LM + hotword) score.

    Field order mirrors the reference's ``LMBeam`` so positional construction
    stays drop-in compatible; the per-beam BPE break flag rides at the end.
    """

    text: str
    next_word: str
    partial_word: str
    last_char: Optional[str]
    text_frames: List[Frames]
    partial_frames: Frames
    logit_score: float
    lm_score: float = 0.0
    force_next_break: bool = False


@dataclasses.dataclass(frozen=True, slots=True)
class OutputBeam:
    """Final decoded hypothesis."""

    text: str
    last_lm_state: Optional[AbstractLMState]
    text_frames: List[WordFrames]
    logit_score: float  # cumulative acoustic log score
    lm_score: float  # cumulative fused score

    def get_mp_safe_beam(self) -> "OutputBeam":
        """Version of this beam safe to send across process boundaries."""
        if self.last_lm_state is None:
            last_lm_state = None
        else:
            last_lm_state = self.last_lm_state.get_mp_safe_state()
        return dataclasses.replace(self, last_lm_state=last_lm_state)


# LM score cache: (text, is_eos) -> (fused score incl. hotwords, fused score, state)
LMScoreCacheKey = Tuple[str, bool]
LMScoreCacheValue = Tuple[float, float, AbstractLMState]
LMScoreCache = Dict[LMScoreCacheKey, LMScoreCacheValue]

EMPTY_START_BEAM = Beam("", "", "", None, [], NULL_FRAMES, 0.0)


def _forkable_pool(pool: Optional[Pool]) -> Optional[Pool]:
    """Return ``pool`` unless its workers were started with *spawn*.

    Spawned workers import a fresh interpreter and therefore cannot see the
    class-level model registry that fork-children inherit copy-on-write, so
    such pools are declined (ref decoder.py:146-157 semantics).
    """
    if pool is not None and isinstance(
        pool._ctx, mp.context.SpawnContext  # type: ignore[attr-defined]
    ):
        logger.warning(
            "the supplied process pool uses the 'spawn' start method, whose "
            "workers cannot inherit the shared language-model registry; "
            "decoding sequentially in this process instead"
        )
        return None
    return pool


def collapse_spaces(text: str) -> str:
    """Squeeze whitespace runs to single spaces and strip the ends."""
    return " ".join(text.split())


def log_add(s1: float, s2: float) -> float:
    """log(exp(s1) + exp(s2)) without overflow.

    log1p keeps the last f64 ulp where ``log(1 + x)`` loses it for tiny
    ``x`` — matching ``np.logaddexp``, which the reference merge uses.
    """
    big, small = (s1, s2) if s1 >= s2 else (s2, s1)
    return big + math.log1p(math.exp(small - big))


def _join_words(left: str, right: str) -> str:
    """Concatenate two word strings with one space; empties vanish."""
    if not left or not right:
        return left or right
    return left + " " + right


def _combine_prefixes(beams: List[Beam]) -> List[Beam]:
    """Fold beams that denote the same decoding prefix into one.

    Two beams are the same prefix when their (committed ⊕ pending word,
    in-progress word, last token, break flag) keys match; their acoustic
    probabilities add (log-domain), the earliest keeps its list position and
    the latest supplies the metadata (ref decoder.py:211-224 contract).
    """
    slot_of: Dict[Tuple[str, str, Optional[str], bool], int] = {}
    folded: List[Beam] = []
    for beam in beams:
        key = (
            _join_words(beam.text, beam.next_word),
            beam.partial_word,
            beam.last_char,
            beam.force_next_break,
        )
        slot = slot_of.get(key)
        if slot is None:
            slot_of[key] = len(folded)
            folded.append(beam)
        else:
            folded[slot] = dataclasses.replace(
                beam,
                logit_score=log_add(folded[slot].logit_score, beam.logit_score),
            )
    return folded


def _best_beams(beams: List[LMBeam], beam_width: int) -> List[LMBeam]:
    """Stable top-``beam_width`` by fused score (ties keep input order)."""
    return sorted(beams, key=lambda b: b.lm_score, reverse=True)[:beam_width]


def _collapse_history(beams: List[LMBeam], lm_order: int) -> List[Beam]:
    """Keep one beam per LM-visible recent history.

    Hypotheses that agree on the last ``lm_order - 1`` committed words plus
    the in-progress word can never be re-ranked differently by the LM, so
    only the best (first, since input is sorted) survives. LM scores are
    stripped from the survivors (ref decoder.py:227-258). The key also
    carries ``force_next_break`` — part of this stack's documented
    per-beam fix of the reference's shared-loop-variable break flag
    (PARITY.md): beams differing only in a pending forced break DO
    transition differently on right-bounded BPE pieces, so they must not
    collapse (the reference cannot include the flag because it does not
    track it per beam).
    """
    window = max(1, lm_order - 1)
    survivors: List[Beam] = []
    taken = set()
    for lm_beam in beams:
        key = (
            tuple(lm_beam.text.split()[-window:]),
            lm_beam.partial_word,
            lm_beam.last_char,
            lm_beam.force_next_break,
        )
        if key in taken:
            continue
        taken.add(key)
        survivors.append(Beam.from_lm_beam(lm_beam))
    return survivors


class _TokenTable:
    """Static per-token transition metadata derived from the alphabet.

    Shared ground truth between the host engine (here) and the device
    engine's packed token-class arrays (``ops/tokens.py``).
    """

    BLANK = 0
    BOUNDARY = 1  # char-alphabet space or BPE ▁-prefixed piece
    REGULAR = 2

    def __init__(self, alphabet: Alphabet) -> None:
        self.labels = alphabet.labels
        self.is_bpe = alphabet.is_bpe
        self.kind: List[int] = []
        self.boundary_piece: List[str] = []  # partial seed when used as boundary
        self.right_bound: List[bool] = []  # BPE token also *ends* with ▁
        for lab in self.labels:
            if lab == "":
                self.kind.append(self.BLANK)
            elif self.is_bpe and lab[:1] == BPE_TOKEN:
                self.kind.append(self.BOUNDARY)
            elif not self.is_bpe and lab == " ":
                self.kind.append(self.BOUNDARY)
            else:
                self.kind.append(self.REGULAR)
            piece = lab
            if self.is_bpe and piece[:1] == BPE_TOKEN:
                piece = piece[1:]
            rbound = bool(self.is_bpe and lab != "" and lab[-1:] == BPE_TOKEN)
            if rbound:
                piece = piece[:-1] if piece[-1:] == BPE_TOKEN else piece
            self.boundary_piece.append(piece)
            self.right_bound.append(rbound)


class BeamSearchDecoderCTC:
    """CTC beam-search decoder with optional shallow-fusion LM (host engine).

    Language models are registered in a class-level container keyed by a
    random token so forked batch workers share them copy-on-write instead of
    pickling (ref decoder.py:261-290).
    """

    model_container: Dict[bytes, Optional[AbstractLanguageModel]] = {}

    _ALPHABET_SERIALIZED_FILENAME = "alphabet.json"
    _LANGUAGE_MODEL_SERIALIZED_DIRECTORY = "language_model"

    def __init__(
        self,
        alphabet: Alphabet,
        language_model: Optional[AbstractLanguageModel] = None,
    ) -> None:
        """Create a decoder for logit matrices over ``alphabet.labels``."""
        self._alphabet = alphabet
        self._idx2vocab = dict(enumerate(alphabet.labels))
        self._is_bpe = alphabet.is_bpe
        self._tokens = _TokenTable(alphabet)
        self._model_key = os.urandom(16)
        BeamSearchDecoderCTC.model_container[self._model_key] = language_model

    # -- model registry lifecycle ------------------------------------------
    @property
    def _language_model(self) -> Optional[AbstractLanguageModel]:
        return BeamSearchDecoderCTC.model_container[self._model_key]

    def cleanup(self) -> None:
        """Drop this decoder's LM from the class registry."""
        if self._model_key in BeamSearchDecoderCTC.model_container:
            del BeamSearchDecoderCTC.model_container[self._model_key]

    @classmethod
    def clear_class_models(cls) -> None:
        """Drop every registered LM."""
        cls.model_container = {}

    def reset_params(
        self,
        alpha: Optional[float] = None,
        beta: Optional[float] = None,
        unk_score_offset: Optional[float] = None,
        lm_score_boundary: Optional[bool] = None,
    ) -> None:
        """Re-tune LM fusion parameters without rebuilding anything."""
        language_model = self._language_model
        if language_model is None:
            return
        updates = {
            "alpha": alpha,
            "beta": beta,
            "unk_score_offset": unk_score_offset,
            "score_boundary": lm_score_boundary,
        }
        language_model.reset_params(
            **{k: v for k, v in updates.items() if v is not None}
        )

    # -- validation ---------------------------------------------------------
    def _require_time_vocab_shape(self, logits: np.ndarray) -> None:
        if logits.ndim != 2:
            raise ValueError(
                f"logit input must be a 2-D (time, vocabulary) matrix; "
                f"received an array with {logits.ndim} dimension(s)"
            )
        if logits.shape[-1] != len(self._idx2vocab):
            raise ValueError(
                f"logit matrix of shape {logits.shape} does not cover this "
                f"decoder's {len(self._idx2vocab)}-label alphabet; the second "
                f"axis must equal the label count"
            )

    # -- LM fusion -----------------------------------------------------------
    def _fuse_lm_scores(
        self,
        beams: List[Beam],
        hotword_scorer: HotwordScorer,
        cached_lm_scores: LMScoreCache,
        cached_partial_token_scores: Dict[str, float],
        is_eos: bool = False,
    ) -> List[LMBeam]:
        """Attach fused scores, folding each pending word into its text.

        LM lookups are incremental — the cache stores the cumulative raw LM
        score and state per (text, eos) key, so a new word costs exactly one
        ``language_model.score`` call per *unique* extended text
        (ref decoder.py:346-424).
        """
        language_model = self._language_model

        def fused_for(beam: Beam, new_text: str) -> float:
            if language_model is None:
                return (
                    beam.logit_score
                    + hotword_scorer.score(new_text)
                    + hotword_scorer.score_partial_token(beam.partial_word)
                )
            cache_key = (new_text, is_eos)
            if cache_key not in cached_lm_scores:
                _, prev_raw, prev_state = cached_lm_scores[(beam.text, False)]
                word_score, end_state = language_model.score(
                    prev_state, beam.next_word, is_last_word=is_eos
                )
                raw = prev_raw + word_score
                cached_lm_scores[cache_key] = (
                    raw + hotword_scorer.score(new_text),
                    raw,
                    end_state,
                )
            score = cached_lm_scores[cache_key][0]
            partial = beam.partial_word
            if partial:
                if partial not in cached_partial_token_scores:
                    scorer: Any = (
                        hotword_scorer
                        if partial in hotword_scorer
                        else language_model
                    )
                    cached_partial_token_scores[partial] = (
                        scorer.score_partial_token(partial)
                    )
                score += cached_partial_token_scores[partial]
            return beam.logit_score + score

        out: List[LMBeam] = []
        for beam in beams:
            new_text = _join_words(beam.text, beam.next_word)
            out.append(
                LMBeam(
                    text=new_text,
                    next_word="",
                    partial_word=beam.partial_word,
                    last_char=beam.last_char,
                    text_frames=beam.text_frames,
                    partial_frames=beam.partial_frames,
                    logit_score=beam.logit_score,
                    force_next_break=beam.force_next_break,
                    lm_score=fused_for(beam, new_text),
                )
            )
        return out

    # -- transition system ----------------------------------------------------
    def _apply_token(
        self, beam: Beam, idx_char: int, char: str, p_char: float, frame_idx: int
    ) -> Beam:
        """Apply one token to one beam (the CTC + word-boundary transition)."""
        tok = self._tokens
        if char == "" or beam.last_char == char:
            # blank or repeated token: acoustic score only
            if char == "":
                new_frames = beam.partial_frames
            else:
                new_frames = (beam.partial_frames[0], frame_idx + 1)
            return dataclasses.replace(
                beam,
                last_char=char,
                partial_frames=new_frames,
                logit_score=beam.logit_score + p_char,
            )
        boundary = tok.kind[idx_char] == _TokenTable.BOUNDARY
        if self._is_bpe:
            boundary = boundary or beam.force_next_break
        if boundary:
            # word boundary: promote the in-progress word for LM scoring
            committed_frames = (
                beam.text_frames
                if beam.partial_word == ""
                else beam.text_frames + [beam.partial_frames]
            )
            if self._is_bpe:
                new_partial = tok.boundary_piece[idx_char]
                new_partial_frames: Frames = (frame_idx, frame_idx + 1)
                force = tok.right_bound[idx_char]
            else:
                new_partial = ""
                new_partial_frames = NULL_FRAMES
                force = False
            return Beam(
                text=beam.text,
                next_word=beam.partial_word,
                partial_word=new_partial,
                last_char=char,
                text_frames=committed_frames,
                partial_frames=new_partial_frames,
                logit_score=beam.logit_score + p_char,
                force_next_break=force,
            )
        # plain continuation of the in-progress word
        new_partial_frames = (
            (frame_idx, frame_idx + 1)
            if beam.partial_frames[0] < 0
            else (beam.partial_frames[0], frame_idx + 1)
        )
        return Beam(
            text=beam.text,
            next_word=beam.next_word,
            partial_word=beam.partial_word + char,
            last_char=char,
            text_frames=beam.text_frames,
            partial_frames=new_partial_frames,
            logit_score=beam.logit_score + p_char,
            force_next_break=beam.force_next_break,
        )

    @staticmethod
    def _admitted_tokens(logit_col: np.ndarray, token_min_logp: float) -> np.ndarray:
        """Frame candidate set: every token above threshold, plus the argmax."""
        max_idx = int(logit_col.argmax())
        admitted = np.flatnonzero(logit_col >= token_min_logp)
        if max_idx not in admitted:
            admitted = np.sort(np.append(admitted, max_idx))
        return admitted

    def _advance_frames(
        self,
        logits: np.ndarray,
        beams: List[Beam],
        beam_width: int,
        beam_prune_logp: float,
        token_min_logp: float,
        prune_history: bool,
        hotword_scorer: HotwordScorer,
        cached_lm_scores: LMScoreCache,
        cached_p_lm_scores: Dict[str, float],
        processed_frames: int = 0,
    ) -> List[Beam]:
        """Per frame: expand × admitted tokens, fold, fuse, prune, trim."""
        language_model = self._language_model
        for frame_offset, logit_col in enumerate(logits):
            frame_idx = processed_frames + frame_offset
            expanded: List[Beam] = []
            for idx_char in self._admitted_tokens(logit_col, token_min_logp):
                idx_char = int(idx_char)
                char = self._idx2vocab[idx_char]
                p_char = logit_col[idx_char]
                expanded.extend(
                    self._apply_token(beam, idx_char, char, p_char, frame_idx)
                    for beam in beams
                )

            scored = self._fuse_lm_scores(
                _combine_prefixes(expanded),
                hotword_scorer,
                cached_lm_scores,
                cached_p_lm_scores,
            )
            # keep only beams within the score window of the best, then trim
            cutoff = max(b.lm_score for b in scored) + beam_prune_logp
            trimmed = _best_beams(
                [b for b in scored if b.lm_score >= cutoff], beam_width
            )
            if prune_history:
                lm_order = 1 if language_model is None else language_model.order
                beams = _collapse_history(trimmed, lm_order=lm_order)
            else:
                beams = [Beam.from_lm_beam(b) for b in trimmed]
        return beams

    def _rank_hypotheses(
        self,
        beams: Sequence[Beam],
        beam_width: int,
        beam_prune_logp: float,
        hotword_scorer: HotwordScorer,
        cached_lm_scores: LMScoreCache,
        cached_p_lm_scores: Dict[str, float],
        force_next_word: bool = False,
        is_end: bool = False,
    ) -> List[LMBeam]:
        """Optionally commit trailing partial words, then LM-score and sort."""
        if force_next_word or is_end:
            committed: List[Beam] = []
            for beam in beams:
                frames = (
                    beam.text_frames
                    if beam.partial_word == ""
                    else beam.text_frames + [beam.partial_frames]
                )
                committed.append(
                    Beam(
                        text=beam.text,
                        next_word=beam.partial_word,
                        partial_word="",
                        last_char=None,
                        text_frames=frames,
                        partial_frames=NULL_FRAMES,
                        logit_score=beam.logit_score,
                    )
                )
            ranked_input = _combine_prefixes(committed)
        else:
            ranked_input = list(beams)
        scored = self._fuse_lm_scores(
            ranked_input,
            hotword_scorer,
            cached_lm_scores,
            cached_p_lm_scores,
            is_eos=is_end,
        )
        cutoff = max(b.lm_score for b in scored) + beam_prune_logp
        return _best_beams([b for b in scored if b.lm_score >= cutoff], beam_width)

    # -- one-shot decoding -----------------------------------------------------
    def _search(
        self,
        logits: np.ndarray,
        beam_width: int,
        beam_prune_logp: float,
        token_min_logp: float,
        prune_history: bool,
        hotword_scorer: HotwordScorer,
        lm_start_state: Optional[AbstractLMState] = None,
    ) -> List[OutputBeam]:
        language_model = self._language_model
        if language_model is None:
            cached_lm_scores: LMScoreCache = {}
        else:
            start_state = (
                language_model.get_start_state()
                if lm_start_state is None
                else lm_start_state
            )
            cached_lm_scores = {("", False): (0.0, 0.0, start_state)}
        cached_p_lm_scores: Dict[str, float] = {}

        beams = self._advance_frames(
            logits,
            [EMPTY_START_BEAM],
            beam_width,
            beam_prune_logp,
            token_min_logp,
            prune_history,
            hotword_scorer,
            cached_lm_scores,
            cached_p_lm_scores,
        )
        ranked = self._rank_hypotheses(
            beams,
            beam_width,
            beam_prune_logp,
            hotword_scorer,
            cached_lm_scores,
            cached_p_lm_scores,
            force_next_word=True,
            is_end=True,
        )
        return [
            OutputBeam(
                text=collapse_spaces(b.text),
                last_lm_state=(
                    cached_lm_scores[(b.text, True)][-1]
                    if (b.text, True) in cached_lm_scores
                    else None
                ),
                text_frames=list(zip(b.text.split(), b.text_frames)),
                logit_score=b.logit_score,
                lm_score=b.lm_score,
            )
            for b in ranked
        ]

    # -- streaming API -----------------------------------------------------------
    def get_starting_state(self) -> Tuple[List[Beam], LMScoreCache, Dict[str, float]]:
        """Initial beams plus warmed score caches for chunked decoding."""
        language_model = self._language_model
        if language_model is None:
            cached_lm_scores: LMScoreCache = {}
        else:
            cached_lm_scores = {
                ("", False): (0.0, 0.0, language_model.get_start_state())
            }
        return [EMPTY_START_BEAM], cached_lm_scores, {}

    def partial_decode_beams(
        self,
        logits: np.ndarray,
        cached_lm_scores: LMScoreCache,
        cached_p_lm_scores: Dict[str, float],
        beams: List[Beam],
        processed_frames: int,
        beam_width: int = DEFAULT_BEAM_WIDTH,
        beam_prune_logp: float = DEFAULT_PRUNE_LOGP,
        token_min_logp: float = DEFAULT_MIN_TOKEN_LOGP,
        prune_history: bool = DEFAULT_PRUNE_BEAMS,
        hotword_scorer: Optional[HotwordScorer] = None,
        force_next_word: bool = False,
        is_end: bool = False,
    ) -> List[LMBeam]:
        """Consume one chunk of logits, carrying caller-held decode state."""
        self._require_time_vocab_shape(logits)
        hotword_scorer = hotword_scorer or HotwordScorer.build_scorer([], weight=0.0)
        logits = normalize_to_logp(logits)
        beams = self._advance_frames(
            logits,
            beams,
            beam_width,
            beam_prune_logp,
            token_min_logp,
            prune_history,
            hotword_scorer,
            cached_lm_scores,
            cached_p_lm_scores,
            processed_frames=processed_frames,
        )
        return self._rank_hypotheses(
            beams,
            beam_width,
            beam_prune_logp,
            hotword_scorer,
            cached_lm_scores,
            cached_p_lm_scores,
            force_next_word=force_next_word,
            is_end=is_end,
        )

    def decode_beams(
        self,
        logits: np.ndarray,
        beam_width: int = DEFAULT_BEAM_WIDTH,
        beam_prune_logp: float = DEFAULT_PRUNE_LOGP,
        token_min_logp: float = DEFAULT_MIN_TOKEN_LOGP,
        prune_history: bool = DEFAULT_PRUNE_BEAMS,
        hotwords: Optional[Iterable[str]] = None,
        hotword_weight: float = DEFAULT_HOTWORD_WEIGHT,
        lm_start_state: Optional[AbstractLMState] = None,
    ) -> List[OutputBeam]:
        """Decode a logit matrix into ranked beams with full metadata.

        Args:
            logits: (time, vocab) token log-probabilities (or probabilities /
                raw logits; normalization is sniffed automatically).
            beam_width: maximum live beams per step.
            beam_prune_logp: window below the best beam's score to keep.
            token_min_logp: per-frame token admission threshold (argmax always
                admitted).
            prune_history: dedupe beams sharing recent n-gram history.
            hotwords: words/phrases to boost (may be OOV for the LM).
            hotword_weight: boost strength per hotword hit.
            lm_start_state: optional LM state for stateful chaining.

        Returns:
            Ranked :class:`OutputBeam` list.
        """
        self._require_time_vocab_shape(logits)
        hotword_scorer = HotwordScorer.build_scorer(hotwords, weight=hotword_weight)
        logits = normalize_to_logp(logits)
        return self._search(
            logits,
            beam_width=beam_width,
            beam_prune_logp=beam_prune_logp,
            token_min_logp=token_min_logp,
            prune_history=prune_history,
            hotword_scorer=hotword_scorer,
            lm_start_state=lm_start_state,
        )

    def decode(
        self,
        logits: np.ndarray,
        beam_width: int = DEFAULT_BEAM_WIDTH,
        beam_prune_logp: float = DEFAULT_PRUNE_LOGP,
        token_min_logp: float = DEFAULT_MIN_TOKEN_LOGP,
        hotwords: Optional[Iterable[str]] = None,
        hotword_weight: float = DEFAULT_HOTWORD_WEIGHT,
        lm_start_state: Optional[AbstractLMState] = None,
    ) -> str:
        """Decode a logit matrix to the single best transcript."""
        return self.decode_beams(
            logits,
            beam_width=beam_width,
            beam_prune_logp=beam_prune_logp,
            token_min_logp=token_min_logp,
            prune_history=True,  # only the top beam is returned
            hotwords=hotwords,
            hotword_weight=hotword_weight,
            lm_start_state=lm_start_state,
        )[0].text

    # -- batch decoding -----------------------------------------------------------
    def _decode_beams_for_pool(
        self,
        logits: np.ndarray,
        beam_width: int,
        beam_prune_logp: float,
        token_min_logp: float,
        prune_history: bool,
        hotwords: Optional[Iterable[str]],
        hotword_weight: float,
    ) -> List[OutputBeam]:
        """decode_beams variant whose outputs survive the pickle boundary."""
        decoded = self.decode_beams(
            logits=logits,
            beam_width=beam_width,
            beam_prune_logp=beam_prune_logp,
            token_min_logp=token_min_logp,
            prune_history=prune_history,
            hotwords=hotwords,
            hotword_weight=hotword_weight,
        )
        return [beam.get_mp_safe_beam() for beam in decoded]

    def _map_batch(
        self,
        pool: Optional[Pool],
        fn: Callable[[np.ndarray], Any],
        logits_list: Sequence[np.ndarray],
        validate: bool,
    ) -> List[Any]:
        """Run ``fn`` over the batch through ``pool`` (fork only) or inline."""
        valid_pool = _forkable_pool(pool)
        if valid_pool is None:
            return [fn(logits) for logits in logits_list]
        if validate:
            for logits in logits_list:
                self._require_time_vocab_shape(logits)
        return valid_pool.map(fn, logits_list)

    def decode_beams_batch(
        self,
        pool: Optional[Pool],
        logits_list: Sequence[np.ndarray],
        beam_width: int = DEFAULT_BEAM_WIDTH,
        beam_prune_logp: float = DEFAULT_PRUNE_LOGP,
        token_min_logp: float = DEFAULT_MIN_TOKEN_LOGP,
        prune_history: bool = DEFAULT_PRUNE_BEAMS,
        hotwords: Optional[Iterable[str]] = None,
        hotword_weight: float = DEFAULT_HOTWORD_WEIGHT,
    ) -> List[List[OutputBeam]]:
        """Data-parallel beam decode over a multiprocessing pool (fork only)."""
        return self._map_batch(
            pool,
            functools.partial(
                self._decode_beams_for_pool,
                beam_width=beam_width,
                beam_prune_logp=beam_prune_logp,
                token_min_logp=token_min_logp,
                hotwords=hotwords,
                prune_history=prune_history,
                hotword_weight=hotword_weight,
            ),
            logits_list,
            validate=True,
        )

    def decode_batch(
        self,
        pool: Optional[Pool],
        logits_list: Sequence[np.ndarray],
        beam_width: int = DEFAULT_BEAM_WIDTH,
        beam_prune_logp: float = DEFAULT_PRUNE_LOGP,
        token_min_logp: float = DEFAULT_MIN_TOKEN_LOGP,
        hotwords: Optional[Iterable[str]] = None,
        hotword_weight: float = DEFAULT_HOTWORD_WEIGHT,
    ) -> List[str]:
        """Data-parallel top-1 decode over a multiprocessing pool (fork only)."""
        return self._map_batch(
            pool,
            functools.partial(
                self.decode,
                beam_width=beam_width,
                beam_prune_logp=beam_prune_logp,
                token_min_logp=token_min_logp,
                hotwords=hotwords,
                hotword_weight=hotword_weight,
            ),
            logits_list,
            validate=False,
        )

    # -- serialization ----------------------------------------------------------
    def save_to_dir(self, filepath: str) -> None:
        """Write alphabet.json (+ language_model/ when present) to a directory."""
        alphabet_path = os.path.join(filepath, self._ALPHABET_SERIALIZED_FILENAME)
        with open(alphabet_path, "w") as fh:
            fh.write(self._alphabet.dumps())
        lm = self._language_model
        if lm is None:
            logger.info("no language model attached; serializing the alphabet only")
        else:
            lm_path = os.path.join(filepath, self._LANGUAGE_MODEL_SERIALIZED_DIRECTORY)
            os.makedirs(lm_path)
            logger.info("writing the language model under %s", lm_path)
            lm.save_to_dir(lm_path)

    @staticmethod
    def parse_directory_contents(filepath: str) -> Dict[str, Union[str, None]]:
        """Validate a serialized-decoder directory layout."""
        alphabet_name = BeamSearchDecoderCTC._ALPHABET_SERIALIZED_FILENAME
        lm_dir_name = BeamSearchDecoderCTC._LANGUAGE_MODEL_SERIALIZED_DIRECTORY
        contents = [
            c
            for c in os.listdir(filepath)
            if not c.startswith(".") and not c.startswith("__")
        ]
        if alphabet_name not in contents:
            raise ValueError(
                f"not a serialized decoder directory: {alphabet_name} is "
                f"absent from {filepath} (directory holds {contents})"
            )
        contents.remove(alphabet_name)
        lm_directory: Optional[str] = None
        if contents:
            if lm_dir_name not in contents:
                raise ValueError(
                    f"unexpected extra entries {contents} in a serialized "
                    f"decoder directory; only {lm_dir_name!r} may accompany "
                    f"{alphabet_name!r}"
                )
            lm_directory = os.path.join(filepath, lm_dir_name)
        return {
            "alphabet": os.path.join(filepath, alphabet_name),
            "language_model": lm_directory,
        }

    @classmethod
    def load_from_dir(
        cls, filepath: str, unigram_encoding: Optional[str] = None
    ) -> "BeamSearchDecoderCTC":
        """Load a serialized decoder directory."""
        filenames = cls.parse_directory_contents(filepath)
        with open(filenames["alphabet"], "r") as fh:  # type: ignore[arg-type]
            alphabet = Alphabet.loads(fh.read())
        language_model: Optional[AbstractLanguageModel] = None
        if filenames["language_model"] is not None:
            language_model = LanguageModel.load_from_dir(
                filenames["language_model"], unigram_encoding=unigram_encoding
            )
        return cls(alphabet, language_model=language_model)

    @classmethod
    def load_from_hf_hub(
        cls, model_id: str, cache_dir: Optional[str] = None, **kwargs: Any
    ) -> "BeamSearchDecoderCTC":
        """Load a decoder directory from the HuggingFace Hub (or its cache)."""
        if cache_dir is None:
            cache_dir = os.path.join(Path.home(), ".cache", "pyctcdecode_torch")
        try:
            from huggingface_hub import snapshot_download
        except ImportError as err:
            raise ImportError(
                "loading from the HuggingFace Hub requires the optional "
                "huggingface_hub package (pip install huggingface-hub)"
            ) from err
        cached_directory = snapshot_download(model_id, cache_dir=cache_dir, **kwargs)
        return cls.load_from_dir(cached_directory)
