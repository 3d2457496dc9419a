"""Public device decoder: batched beam search on the GPU + host text replay.

:class:`TorchBeamSearchDecoderCTC` mirrors the public API of the JAX
reference's ``TPUBeamSearchDecoderCTC`` (``decode``, ``decode_beams``,
``decode_batch``, ``decode_beams_batch``) and runs the per-frame pipeline of
:mod:`pyctcdecode_torch.engine` on one device. The host side normalizes
logits, and replays the device's token paths into words and word-level frame
spans (ref output semantics, decoder.py:604-667).

The device is explicit: ``device=None`` means CUDA and raises when no CUDA
device is present; ``device="cpu"`` runs the same engine with every kernel's
plain PyTorch version. Nothing falls back to the CPU on its own.
"""
from __future__ import annotations

import logging
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .alphabet import BPE_TOKEN, Alphabet
from .constants import (
    DEFAULT_BEAM_WIDTH,
    DEFAULT_HOTWORD_WEIGHT,
    DEFAULT_MIN_TOKEN_LOGP,
    DEFAULT_PRUNE_BEAMS,
    DEFAULT_PRUNE_LOGP,
)
from .decoder import NULL_FRAMES, OutputBeam, collapse_spaces
from .engine import EngineConfig, build_table_args, make_decode_fn
from .models.base import AbstractLMState, NGramLMState
from .models.device_tables import build_device_lm, context_suffix_backoffs
from .models.language_model import LanguageModel
from .ops.tokens import build_token_arrays
from .utils.logits import normalize_batch, normalize_to_logp

logger = logging.getLogger(__name__)


def _auto_k(counts: np.ndarray, v: int) -> int:
    """Smallest bucketed token preselect covering every frame's admission.

    ``counts`` holds per-frame admitted-token counts (tokens at or above the
    call's ``token_min_logp``; the argmax-inclusion rule never adds a token
    beyond that set when it is non-empty, ref decoder.py:444-445, so
    ``max(counts, 1)`` is the exact candidate-set width). Buckets step by
    ~1.5x (4, 6, 8, 12, 16, 24, 32, ...).
    """
    need = int(max(counts.max(initial=1), 1)) if counts.size else 1
    k = 4
    while k < need:
        k = k * 3 // 2 if (k & (k - 1)) == 0 else k * 4 // 3
    return min(k, v)


def replay_token_path(
    token_path: Sequence[int],
    labels: Sequence[str],
    is_bpe: bool,
    frame_offset: int = 0,
    frame_ids: Optional[Sequence[int]] = None,
) -> Tuple[List[str], List[Tuple[int, int]], Tuple[str, Tuple[int, int]]]:
    """Rebuild (words, word frame spans, trailing partial) from a token path.

    Applies the exact reference transition rules (ref decoder.py:452-534)
    to a single beam's chosen-token sequence; entries < 0 are padded frames
    and are skipped. The trailing partial word is force-committed by the
    caller when appropriate (finalization semantics, ref decoder.py:558-577).
    """
    words: List[str] = []
    frames: List[Tuple[int, int]] = []
    partial = ""
    partial_frames = NULL_FRAMES
    last: Optional[int] = None
    force = False
    for pos, tok in enumerate(token_path):
        if tok == -2:
            # forced word commit between chunks (ref decoder.py:558-577):
            # promote the partial, reset last-char so repeats restart
            if partial:
                words.append(partial)
                frames.append(partial_frames)
            partial = ""
            partial_frames = NULL_FRAMES
            last = None
            force = False
            continue
        if tok < 0:
            continue
        t = frame_ids[pos] if frame_ids is not None else frame_offset + pos
        char = labels[tok]
        if char == "" or last == tok:
            if char != "":
                partial_frames = (partial_frames[0], t + 1)
            last = tok
            continue
        if is_bpe and (char[:1] == BPE_TOKEN or force):
            force = False
            clean = char
            if char[:1] == BPE_TOKEN:
                clean = clean[1:]
            if char[-1:] == BPE_TOKEN:
                clean = clean[:-1]
                force = True
            if partial:
                words.append(partial)
                frames.append(partial_frames)
            partial = clean
            partial_frames = (t, t + 1)
        elif not is_bpe and char == " ":
            if partial:
                words.append(partial)
                frames.append(partial_frames)
            partial = ""
            partial_frames = NULL_FRAMES
        else:
            partial_frames = (
                (t, t + 1) if partial_frames[0] < 0 else (partial_frames[0], t + 1)
            )
            partial = partial + char
        last = tok
    return words, frames, (partial, partial_frames)


def replay_token_path_np(
    token_path: np.ndarray,
    labels: Sequence[str],
    blank_id: int,
    space_id: int,
    frame_ids: Optional[np.ndarray] = None,
    frame_offset: int = 0,
) -> Tuple[List[str], List[Tuple[int, int]]]:
    """Vectorized non-BPE :func:`replay_token_path` with the partial folded.

    Equivalent to ``replay_token_path(...)`` followed by appending the
    trailing partial (finalization semantics). Only for char alphabets
    without ``-2`` force-commit markers. Returns ``(words, word_frames)``.
    """
    toks = np.asarray(token_path)
    idx = np.flatnonzero(toks >= 0)
    if idx.size == 0:
        return [], []
    seq = toks[idx]
    if frame_ids is not None:
        t = np.asarray(frame_ids)[idx]
    else:
        t = frame_offset + idx
    prev = np.empty_like(seq)
    prev[0] = -1  # no predecessor: first real token is always "new"
    prev[1:] = seq[:-1]
    new = seq != prev
    letters = (seq != blank_id) & (seq != space_id)
    emit_letter = letters & new
    if not emit_letter.any():
        return [], []
    emit_space = (seq == space_id) & new
    word_of = np.cumsum(emit_space)  # word index per event position
    wl = word_of[emit_letter]
    first = np.flatnonzero(np.diff(wl, prepend=wl[0] - 1))
    last_plus = np.append(first[1:], wl.size)
    chars = [labels[c] for c in seq[emit_letter]]
    words = ["".join(chars[a:b]) for a, b in zip(first, last_plus)]
    # spans: start = first letter EMIT of the word; end = last letter
    # event (emit or repeat both extend the span, ref decoder.py:453-461,
    # 519-523) + 1. Letter repeats never straddle a word boundary (a space
    # or blank in between resets `last`), so grouping repeats by the
    # word of their position is exact.
    ws = word_of[letters]
    t_letters = t[letters]
    first_ws = np.flatnonzero(np.diff(ws, prepend=ws[0] - 1))
    last_ws = np.append(first_ws[1:], ws.size) - 1
    starts = t[emit_letter][first]
    ends = t_letters[last_ws] + 1
    frames = list(zip(starts.tolist(), ends.tolist()))
    return words, frames


def _resolve_device(device: Union[None, str, torch.device]) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "TorchBeamSearchDecoderCTC runs on CUDA by default and no CUDA "
                "device is available; pass device='cpu' to run on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)


def _not_ported(option: str) -> NotImplementedError:
    return NotImplementedError(f"{option} is not ported to pyctcdecode_torch yet")


class TorchBeamSearchDecoderCTC:
    """Device-resident CTC beam-search decoder (PyTorch engine)."""

    def __init__(
        self,
        alphabet: Alphabet,
        language_model: Optional[LanguageModel] = None,
        device: Union[None, str, torch.device] = None,
    ) -> None:
        self._device = _resolve_device(device)
        if alphabet.is_bpe:
            raise _not_ported("a BPE alphabet")
        if language_model is not None and not isinstance(language_model, LanguageModel):
            raise _not_ported(
                f"language model {type(language_model).__name__} (only a single "
                f"pyctcdecode_torch LanguageModel; MultiLanguageModel is not ported)"
            )
        self._alphabet = alphabet
        self._labels = alphabet.labels
        self._blank_id = self._labels.index("")  # CTC blank (always present)
        self._lm = language_model
        self._tokens = build_token_arrays(alphabet)
        self._device_lm = (
            build_device_lm(language_model, self._tokens)
            if language_model is not None
            else None
        )
        # tables are uploaded once here and reused by every decode call
        self._tabs = build_table_args(self._tokens, self._device_lm, self._device)

    # -- configuration ---------------------------------------------------
    @property
    def language_model(self) -> Optional[LanguageModel]:
        return self._lm

    @property
    def device(self) -> torch.device:
        return self._device

    def reset_params(self, **kwargs: Any) -> None:
        """Re-tune LM fusion knobs in place (read on every decode call)."""
        if self._lm is not None:
            self._lm.reset_params(**kwargs)

    def _engine_cfg(self, beam_width: int, k: int, prune_history: bool,
                    emit_paths: Optional[int] = None) -> EngineConfig:
        order = self._lm.order if self._lm is not None else 1
        return EngineConfig(
            beam_width=beam_width,
            vocab_size=len(self._labels),
            k_tokens=k,
            use_lm=self._lm is not None,
            order=order,
            prune_history=prune_history,
            emit_paths=emit_paths,
        )

    # -- call-time parameters ------------------------------------------------
    def _params_vector(self, token_min_logp: float, beam_prune_logp: float) -> np.ndarray:
        """The reference's f32 parameter layout (slot 2, the hotword weight, is 0)."""
        vals = [token_min_logp, beam_prune_logp, 0.0]
        if self._lm is not None:
            m = self._lm
            vals += [
                float(m.alpha),
                float(m.beta),
                float(m.unk_score_offset),
                1.0 if m.score_boundary else 0.0,
            ]
        return np.array(vals, dtype=np.float32)

    def _start_ctx(self, lm_start_state: Optional[AbstractLMState]) -> Optional[Dict]:
        """LM start dict ({"ctx", "len", "bo"}) for the engine."""
        if self._lm is None:
            return None
        state = lm_start_state if lm_start_state is not None else self._lm.get_start_state()
        if not isinstance(state, NGramLMState):
            raise AssertionError(f"Expected NGramLMState, got {type(state)}")
        width = max(self._lm.order - 1, 1)
        ctx = np.full(width, -1, dtype=np.int32)
        words = state.context[-width:] if self._lm.order > 1 else ()
        for i, wid in enumerate(words):
            ctx[width - len(words) + i] = wid
        bo = context_suffix_backoffs(self._device_lm, words)
        return {"ctx": ctx, "len": len(words), "bo": bo}

    # -- output assembly -----------------------------------------------------
    def _build_outputs(self, out: Dict[str, np.ndarray], n_frames: int,
                       top_n: Optional[int] = None) -> List[OutputBeam]:
        beam_src = out["beam_src"]
        logit = out["logit"]
        lm_score = out["lm_score"]
        paths = out["paths"]  # [R, T] device-backtraced
        limit = len(beam_src) if top_n is None else min(top_n, len(beam_src))
        limit = min(limit, paths.shape[0])
        n_live = 0
        while n_live < limit and lm_score[n_live] > -1.0e29:
            n_live += 1
        toks_all = paths[:n_live].T.astype(np.int64)
        space_id = self._labels.index(" ") if " " in self._labels else -100
        fast_replay = not self._alphabet.is_bpe and not (
            (toks_all[:n_frames] == -2).any() if n_live else False
        )
        results: List[OutputBeam] = []
        for rank in range(n_live):
            toks = toks_all[:n_frames, rank]
            if fast_replay:
                words, frames = replay_token_path_np(
                    toks, self._labels, self._blank_id, space_id
                )
            else:
                words, frames, (partial, pframes) = replay_token_path(
                    toks, self._labels, self._alphabet.is_bpe
                )
                if partial:
                    words.append(partial)
                    frames.append(pframes)
            if self._lm is None:
                last_state: Optional[AbstractLMState] = None
            else:
                n_ctx = int(out["ctx_len"][rank])
                ctx = out["ctx"][rank]
                width = ctx.shape[0]
                last_state = NGramLMState(
                    tuple(int(w) for w in ctx[width - n_ctx:]) if n_ctx else ()
                )
            results.append(
                OutputBeam(
                    text=collapse_spaces(" ".join(words)),
                    last_lm_state=last_state,
                    text_frames=list(zip(words, frames)),
                    logit_score=float(logit[rank]),
                    lm_score=float(lm_score[rank]),
                )
            )
        return results

    def _run(self, logp: np.ndarray, n_frames: np.ndarray, k: int, beam_width: int,
             beam_prune_logp: float, token_min_logp: float, prune_history: bool,
             top_n: Optional[int], lm_start_state: Optional[AbstractLMState]) -> Dict[str, np.ndarray]:
        """Upload, decode on the device, fetch the (small) outputs to numpy."""
        emit_paths = min(top_n, beam_width) if top_n is not None else None
        cfg = self._engine_cfg(beam_width, k, prune_history, emit_paths)
        fn = make_decode_fn(cfg, self._tabs)
        params = self._params_vector(token_min_logp, beam_prune_logp)
        with torch.inference_mode():
            out = fn(
                torch.as_tensor(logp, device=self._device),
                torch.as_tensor(n_frames, dtype=torch.int64, device=self._device),
                params,
                self._start_ctx(lm_start_state),
            )
            return {key: val.cpu().numpy() for key, val in out.items()}

    # -- public API ------------------------------------------------------------
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
        max_tokens_per_frame: Optional[Union[int, str]] = None,
        top_n: Optional[int] = None,
        blank_collapse: bool = False,
    ) -> List[OutputBeam]:
        """Decode one utterance on the device; returns ranked OutputBeams.

        ``max_tokens_per_frame``: ``None`` expands every vocabulary token
        per frame (always exact); an integer caps the per-frame top-K
        preselect (exact only when no frame admits more than K tokens at
        ``token_min_logp``); ``"auto"`` measures this call's admission and
        picks the smallest sufficient bucketed K. ``top_n`` limits text
        reconstruction to the best N beams (search is unaffected).
        """
        if hotwords is not None:
            raise _not_ported("hotwords")
        if blank_collapse:
            raise _not_ported("blank_collapse")
        if logits.ndim != 2 or logits.shape[1] != len(self._labels):
            raise ValueError(
                f"Input logits of shape {logits.shape}, but vocabulary is "
                f"size {len(self._labels)}"
            )
        v = len(self._labels)
        logp = normalize_to_logp(np.asarray(logits)).astype(np.float32)
        k = self._pick_k(max_tokens_per_frame, (logp >= token_min_logp).sum(-1), v)
        t = logp.shape[0]
        out = self._run(
            logp[None], np.array([t]), k, beam_width, beam_prune_logp,
            token_min_logp, prune_history, top_n, lm_start_state,
        )
        return self._build_outputs(
            {key: val[0] for key, val in out.items()}, n_frames=t, top_n=top_n
        )

    @staticmethod
    def _pick_k(max_tokens_per_frame: Optional[Union[int, str]], counts: np.ndarray, v: int) -> int:
        if max_tokens_per_frame == "auto":
            return _auto_k(counts, v)
        return v if max_tokens_per_frame is None else min(int(max_tokens_per_frame), v)

    def decode(
        self,
        logits: np.ndarray,
        beam_width: int = DEFAULT_BEAM_WIDTH,
        beam_prune_logp: float = DEFAULT_PRUNE_LOGP,
        token_min_logp: float = DEFAULT_MIN_TOKEN_LOGP,
        hotwords: Optional[Iterable[str]] = None,
        hotword_weight: float = DEFAULT_HOTWORD_WEIGHT,
        lm_start_state: Optional[AbstractLMState] = None,
        max_tokens_per_frame: Optional[Union[int, str]] = None,
        blank_collapse: bool = False,
    ) -> str:
        """Top transcript for one utterance."""
        return self.decode_beams(
            logits,
            beam_width=beam_width,
            beam_prune_logp=beam_prune_logp,
            token_min_logp=token_min_logp,
            prune_history=True,
            hotwords=hotwords,
            hotword_weight=hotword_weight,
            lm_start_state=lm_start_state,
            max_tokens_per_frame=max_tokens_per_frame,
            top_n=1,
            blank_collapse=blank_collapse,
        )[0].text

    def get_starting_state(self, *args: Any, **kwargs: Any) -> Any:
        """Streaming decode is not ported yet."""
        raise _not_ported("streaming (get_starting_state)")

    def partial_decode_beams(self, *args: Any, **kwargs: Any) -> Any:
        """Streaming decode is not ported yet."""
        raise _not_ported("streaming (partial_decode_beams)")

    @staticmethod
    def _without_pool_arg(first: Any, rest: Tuple[Any, ...]) -> Any:
        """Accept the reference batch calling convention.

        The reference batch APIs lead with a ``multiprocessing`` pool
        (ref decoder.py:801, 895); the device engine vectorizes the batch in
        one program, so a leading pool (or ``None``) is accepted and ignored.
        """
        if not rest:
            return first
        if len(rest) > 1:
            raise TypeError(
                "batch decode takes the logits list plus at most one leading "
                "pool argument"
            )
        return rest[0]

    def decode_beams_batch(
        self,
        logits_list: Sequence[np.ndarray],
        *_pool_compat: Any,
        beam_width: int = DEFAULT_BEAM_WIDTH,
        beam_prune_logp: float = DEFAULT_PRUNE_LOGP,
        token_min_logp: float = DEFAULT_MIN_TOKEN_LOGP,
        prune_history: bool = DEFAULT_PRUNE_BEAMS,
        hotwords: Optional[Iterable[str]] = None,
        hotword_weight: float = DEFAULT_HOTWORD_WEIGHT,
        max_tokens_per_frame: Optional[Union[int, str]] = None,
        batch_pad: int = 8,
        top_n: Optional[int] = None,
        collect_stats: bool = False,
        blank_collapse: bool = False,
        length_bucketing: bool = False,
        token_chunking: Optional[int] = None,
    ) -> List[List[OutputBeam]]:
        """Batched decode: all utterances in one ``[N, B]`` device program.

        Utterances are padded to the longest one; a padded frame freezes its
        utterance's state. The batch is padded to a multiple of
        ``batch_pad`` rows (the reference's shape-reuse rule, kept so both
        packages decode the same padded batch).
        """
        logits_list = self._without_pool_arg(logits_list, _pool_compat)
        for option, value in (
            ("hotwords", hotwords is not None),
            ("collect_stats", collect_stats),
            ("blank_collapse", blank_collapse),
            ("length_bucketing", length_bucketing),
            ("token_chunking", token_chunking),
        ):
            if value:
                raise _not_ported(option)
        if not logits_list:
            return []
        v = len(self._labels)
        for mat in logits_list:
            if mat.ndim != 2 or mat.shape[1] != v:
                raise ValueError(
                    f"Input logits of shape {mat.shape}, but vocabulary is size {v}"
                )
        n = len(logits_list)
        n_pad = ((n + batch_pad - 1) // batch_pad) * batch_pad
        lens = [m.shape[0] for m in logits_list]
        t_max = max(max(lens), 1)
        logp = np.zeros((n_pad, t_max, v), dtype=np.float32)
        for i, out in enumerate(normalize_batch(logits_list)):
            logp[i, : lens[i]] = out
        n_frames = np.zeros(n_pad, dtype=np.int64)
        n_frames[:n] = lens
        valid = np.arange(t_max)[None, :] < n_frames[:, None]
        counts = np.where(valid, (logp >= token_min_logp).sum(-1), 1)
        k = self._pick_k(max_tokens_per_frame, counts, v)
        out = self._run(
            logp, n_frames, k, beam_width, beam_prune_logp, token_min_logp,
            prune_history, top_n, None,
        )
        return [
            self._build_outputs(
                {key: val[i] for key, val in out.items()}, n_frames=lens[i], top_n=top_n
            )
            for i in range(n)
        ]

    def decode_batch(
        self,
        logits_list: Sequence[np.ndarray],
        *_pool_compat: Any,
        beam_width: int = DEFAULT_BEAM_WIDTH,
        beam_prune_logp: float = DEFAULT_PRUNE_LOGP,
        token_min_logp: float = DEFAULT_MIN_TOKEN_LOGP,
        hotwords: Optional[Iterable[str]] = None,
        hotword_weight: float = DEFAULT_HOTWORD_WEIGHT,
        max_tokens_per_frame: Optional[Union[int, str]] = None,
        blank_collapse: bool = False,
        length_bucketing: bool = False,
        token_chunking: Optional[int] = None,
    ) -> List[str]:
        """Batch top-1 transcripts (leading pool argument accepted, unused)."""
        logits_list = self._without_pool_arg(logits_list, _pool_compat)
        beams = self.decode_beams_batch(
            logits_list,
            beam_width=beam_width,
            beam_prune_logp=beam_prune_logp,
            token_min_logp=token_min_logp,
            prune_history=True,
            hotwords=hotwords,
            hotword_weight=hotword_weight,
            max_tokens_per_frame=max_tokens_per_frame,
            top_n=1,
            blank_collapse=blank_collapse,
            length_bucketing=length_bucketing,
            token_chunking=token_chunking,
        )
        return [b[0].text if b else "" for b in beams]
