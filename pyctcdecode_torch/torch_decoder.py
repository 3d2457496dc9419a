"""Public device decoder: batched beam search on the GPU + host text replay.

:class:`TorchBeamSearchDecoderCTC` mirrors the public API of the JAX
reference's ``TPUBeamSearchDecoderCTC`` (``decode``, ``decode_beams``,
``decode_batch``, ``decode_beams_batch``, ``decode_beams_batches``, and the
streaming pair ``get_starting_state`` / ``partial_decode_beams``) and runs
the per-frame pipeline of :mod:`pyctcdecode_torch.engine` on one device. The
host side normalizes logits, and replays the device's token paths into words
and word-level frame spans (ref output semantics, decoder.py:604-667).

Batch decoding is split into launch and collect: ``_dispatch_batch`` prepares
one batch on the host (normalization, optional blank collapse, optional token
timeline), uploads it and enqueues the whole decode on the device without
waiting for it; ``_collect_batch`` copies the (small) outputs back and builds
the ``OutputBeam`` lists. ``length_bucketing`` launches one decode per length
group, and ``decode_beams_batches`` keeps several batches launched before it
collects the oldest.

``save_to_dir`` / ``load_from_dir`` / ``load_from_hf_hub`` read and write
the host engine's directory layout (``alphabet.json``, ``language_model/``),
so a directory saved by either engine, or by the JAX reference package,
loads in the other.

The device is explicit: ``device=None`` means CUDA and raises when no CUDA
device is present; ``device="cpu"`` runs the same engine with every kernel's
plain PyTorch version. Nothing falls back to the CPU on its own.
"""
from __future__ import annotations

import collections
import copy
import dataclasses
import logging
import os
from pathlib import Path
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
from .decoder import NULL_FRAMES, BeamSearchDecoderCTC, LMBeam, OutputBeam, _not_ported
from .engine import (
    NEXT,
    EngineConfig,
    FinalizeGraph,
    SegmentGraph,
    _parent_dtype,
    _path_dtype,
    build_table_args,
    finalize_program,
    make_decode_fn,
    make_segment_decode_fns,
    make_stream_fns,
    run_segments,
    score_boundary_flags,
    stats_fields,
)
from .models.base import AbstractLMState, MultiLMState, NGramLMState
from .models.device_tables import (
    HOT_NODE_MASK,
    build_device_lm,
    build_hotword_tables,
    context_suffix_backoffs,
    empty_hotword_tables,
)
from .models.hotwords import HotwordScorer
from .models.language_model import LanguageModel, MultiLanguageModel
from .models.ngram import BOS_WORD, EOS_WORD
from .ops.backtrace import backtrace_paths
from .ops.merge import DEAD_THRESH
from .ops.tokens import build_token_arrays
from .utils import profiling
from .utils.logits import (
    normalize_batch,
    normalize_collapse_batch,
    token_timeline_batch,
)

logger = logging.getLogger(__name__)

# captured segment keys a decoder keeps (batch and stream keys alike), see _segment_graph: room for a
# decoder that serves dense and serving batches of every row count up to 32, with and without a
# hotword set, and streams with and without hotwords
GRAPH_KEYS = 32


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
    to a single beam's chosen-token sequence; entries < 0 (the -1 pad, the -3
    timeline carry marker) are skipped. The trailing partial word is force-committed by the
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


def replay_token_paths_batch(
    toks: np.ndarray,
    labels: Sequence[str],
    blank_id: int,
    space_id: int,
    frame_ids: Optional[np.ndarray] = None,
) -> List[Tuple[List[str], List[Tuple[int, int]]]]:
    """Vectorized non-BPE :func:`replay_token_path` with the trailing partial
    folded in (finalization semantics): one numpy pass over ALL rows.

    ``toks``: ``[R, T]`` chosen-token paths (entries < 0 skipped — the
    -1 pad and -3 timeline carry markers); ``frame_ids``: optional
    ``[R, T]`` original frame index per position (blank-collapse /
    timeline mapping). Only for char alphabets without ``-2``
    force-commit markers. Returns one ``(words, word_frames)`` pair per row.

    Flattening all rows into one event stream replaces hundreds of small
    per-utterance numpy calls with ~15 numpy passes. Row boundaries join
    the word-segmentation key, so no word or repeat-run can straddle
    rows. Fuzz-pinned against the per-row replay in tests.
    """
    r_rows, t_pad = toks.shape
    out: List[Tuple[List[str], List[Tuple[int, int]]]] = [
        ([], []) for _ in range(r_rows)
    ]
    flat = toks.reshape(-1)
    keep = flat >= 0
    if not keep.any():
        return out
    pos = np.flatnonzero(keep)
    seq = flat[pos].astype(np.int64)
    row = pos // t_pad
    if frame_ids is not None:
        t = np.asarray(frame_ids).reshape(-1)[pos].astype(np.int64)
    else:
        t = (pos % t_pad).astype(np.int64)
    first_of_row = np.empty(seq.shape, dtype=bool)
    first_of_row[0] = True
    first_of_row[1:] = row[1:] != row[:-1]
    prev = np.empty_like(seq)
    prev[0] = -1
    prev[1:] = seq[:-1]
    new = (seq != prev) | first_of_row
    letters = (seq != blank_id) & (seq != space_id)
    emit_letter = letters & new
    if not emit_letter.any():
        return out
    emit_space = (seq == space_id) & new
    # global segment id: increments at every space emit AND at row starts,
    # so segments (words) never merge across rows
    word_of = np.cumsum(emit_space | first_of_row)
    wl = word_of[emit_letter]
    first = np.flatnonzero(np.diff(wl, prepend=wl[0] - 1))
    last_plus = np.append(first[1:], wl.size)
    # width set by the longest label: a fixed U1 would silently truncate
    # multi-char labels, which non-BPE alphabets may technically carry
    # (the blank's empty string is fine — blanks never reach emit_letter)
    lab_w = max(1, max(len(lab) for lab in labels))
    lab_arr = np.array(list(labels), dtype=f"U{lab_w}")
    chars = lab_arr[seq[emit_letter]]
    words = ["".join(chars[a:b]) for a, b in zip(first, last_plus)]
    # spans: start = the word's first letter EMIT; end = its last letter
    # event (emit or repeat both extend the span, ref decoder.py:453-461,
    # 519-523) + 1. A letter repeat shares its word's segment id (a
    # space/blank in between would break the repeat), so grouping by
    # segment id is exact.
    ws = word_of[letters]
    t_letters = t[letters]
    first_ws = np.flatnonzero(np.diff(ws, prepend=ws[0] - 1))
    last_ws = np.append(first_ws[1:], ws.size) - 1
    starts = t[emit_letter][first]
    ends = t_letters[last_ws] + 1
    row_of_word = row[emit_letter][first]
    # regroup flat words into rows (row_of_word is non-decreasing)
    bounds = np.searchsorted(row_of_word, np.arange(r_rows + 1))
    starts_l = starts.tolist()
    ends_l = ends.tolist()
    for i in range(r_rows):
        a, b = bounds[i], bounds[i + 1]
        if a == b:
            continue
        out[i] = (
            words[a:b],
            list(zip(starts_l[a:b], ends_l[a:b])),
        )
    return out


def _block(row_block: Optional[Tuple[int, int]], n: int, planes: Tuple[np.ndarray, ...],
           frame_ids: Optional[List[np.ndarray]], offsets: Optional[List[float]]):
    """Rows ``[start, start + count)`` of a padded batch's planes, and of its per-utterance lists.

    Returns ``(planes, real rows in the block, frame ids, offsets)``; with
    no ``row_block``, everything as it is.
    """
    if row_block is None:
        return planes, n, frame_ids, offsets
    start, count = row_block
    real = max(0, min(n, start + count) - start)
    cut = tuple(p[start : start + count] for p in planes)
    return (cut, real,
            None if frame_ids is None else frame_ids[start : start + real],
            None if offsets is None else offsets[start : start + real])


def _resolve_device(device: Union[None, str, torch.device]) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "TorchBeamSearchDecoderCTC runs on CUDA by default and no CUDA "
                "device is available; pass device='cpu' to run on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)


def _check_segment_frames(segment_frames: Optional[int]) -> Optional[int]:
    if segment_frames is None:
        return None
    if int(segment_frames) != segment_frames or segment_frames < 0:
        raise ValueError(f"segment_frames must be a non-negative int or None; got {segment_frames!r}")
    return int(segment_frames)


@dataclasses.dataclass
class DeviceStreamState:
    """Caller-held streaming decode state (ref decoder.py:669-728 analog).

    ``beam_state`` (``[1, B]`` planes) lives on the device between chunks;
    ``chunks`` holds the host copies of the per-chunk backpointers that
    rebuild transcripts (cleared at each force-commit boundary, where the
    transcripts fold into ``prefix_words`` / ``prefix_spans`` instead).
    """

    beam_state: Dict[str, torch.Tensor]
    chunks: List[Tuple[np.ndarray, np.ndarray, int]]
    processed_frames: int
    beam_width: int
    k_tokens: int
    prune_history: bool
    use_hotwords: bool = False
    hot_sig: Any = None  # (sorted hotwords, weight) of the last chunk
    last_partials: Optional[List[str]] = None  # carried slots' partial words
    # committed transcript prefix per carried slot, folded at force-commit
    # boundaries so that ``chunks`` (and the per-call backtrace cost) stays
    # proportional to the frames since the last commit, not the stream length
    prefix_words: Optional[List[List[str]]] = None
    prefix_spans: Optional[List[List[Tuple[int, int]]]] = None
    call_id: int = -1  # the tracer's id of this stream (utils.profiling), -1 before a traced call


_SENTENCE_WORDS = frozenset((BOS_WORD, EOS_WORD))


def _count_replay(word_lists: Iterable[Sequence[str]]) -> None:
    """Count the replayed beams (``replay.beams``) and those whose words hold ``<s>`` or ``</s>``; nothing when off."""
    tr = profiling.TRACER
    if tr is None:
        return
    word_lists = list(word_lists)
    tr.count("replay.beams", len(word_lists))
    tr.count("replay.sentence_beams", sum(1 for words in word_lists if not _SENTENCE_WORDS.isdisjoint(words)))


def _backtrace_chunks(
    chunks: Sequence[Tuple[np.ndarray, np.ndarray, int]], start_slots: np.ndarray
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Walk backpointers across chunk boundaries, for all ``start_slots`` at once.

    ``chunks``: ``(parents [Tc, B], trace [Tc, B], first frame)`` per chunk.
    Returns the chosen tokens ``[R, T]`` of each slot's beam (oldest frame
    first), the absolute frame ids ``[T]`` they share, and the slot each
    beam reached at the start of the oldest chunk ``[R]`` (its origin in any
    folded committed prefix). The reference walks one slot at a time; the
    frame loop here advances every slot with one numpy gather.
    """
    cur = np.asarray(start_slots, dtype=np.int64)
    total = sum(parents.shape[0] for parents, _, _ in chunks)
    toks = np.empty((cur.size, total), dtype=np.int64)
    frames = np.empty(total, dtype=np.int64)
    end = total
    for parents, trace, offset in reversed(chunks):
        tc = parents.shape[0]
        frames[end - tc : end] = offset + np.arange(tc)
        for t in range(tc - 1, -1, -1):
            toks[:, end - tc + t] = trace[t, cur]
            cur = parents[t, cur].astype(np.int64)
        end -= tc
    return toks, frames, cur


class TorchBeamSearchDecoderCTC:
    """Device-resident CTC beam-search decoder (PyTorch engine)."""

    def __init__(
        self,
        alphabet: Alphabet,
        language_model: Union[None, LanguageModel, MultiLanguageModel] = None,
        device: Union[None, str, torch.device] = None,
        segment_frames: Optional[int] = None,
        fast_topk: bool = False,
    ) -> None:
        self._device = _resolve_device(device)
        # batch decodes run in segments of this many steps, each a captured
        # CUDA graph on the card (see engine.make_segment_decode_fns); 0 runs
        # the eager frame loop; None picks 16 on CUDA and 0 on the CPU
        self._segment_frames = _check_segment_frames(segment_frames)
        # ``fast_topk`` is the reference's option (an approximate top-k whose
        # set is exact, in enumeration order, boundary ties aside). The
        # exact stable sort meets that contract, and on the H100 an unsorted
        # top-k with re-sorts was slower, so either value ranks exactly
        if language_model is None:
            members: List[LanguageModel] = []
        elif isinstance(language_model, MultiLanguageModel):
            members = list(language_model._language_models)
            for m in members:
                if isinstance(m, MultiLanguageModel):
                    raise NotImplementedError(
                        "nested MultiLanguageModel is not supported on the "
                        "device engine"
                    )
        else:
            members = [language_model]
        for m in members:
            if not isinstance(m, LanguageModel):
                raise _not_ported(
                    f"language model {type(m).__name__} (members must be "
                    f"pyctcdecode_torch LanguageModels)"
                )
        self._alphabet = alphabet
        self._labels = alphabet.labels
        self._blank_id = self._labels.index("")  # CTC blank (always present)
        self._lm = language_model
        self._lm_members = members
        with profiling.call("build"):
            profiling.stage("build.device_lm")
            self._tokens = build_token_arrays(alphabet)
            self._device_lm = [build_device_lm(m, self._tokens) for m in members]
            profiling.stage("build.upload")
            # tables are uploaded once here and reused by every decode call
            self._tabs = build_table_args(self._tokens, self._device_lm, self._device)
        # hotword tables on the device, keyed by the unigram set
        self._hot_cache: Dict[Tuple[str, ...], Dict[str, Any]] = {}
        self._empty_hot_tables: Optional[Dict[str, Any]] = None
        self._pinned: Optional[torch.Tensor] = None  # host staging of the outputs, see _fetch
        self._copy_stream: Optional[torch.cuda.Stream] = None  # the fetches' copies, see _fetch
        self._new_graph_cache()

    def _new_graph_cache(self) -> None:
        """An empty cache of captured segment graphs (``_segment_graph``), with its own memory pool."""
        self._graphs: "collections.OrderedDict[Any, SegmentGraph]" = collections.OrderedDict()
        self._graph_pool: Any = None

    # -- configuration ---------------------------------------------------
    @property
    def language_model(self) -> Union[None, LanguageModel, MultiLanguageModel]:
        return self._lm

    @property
    def device(self) -> torch.device:
        return self._device

    def with_options(self, **overrides: Any) -> "TorchBeamSearchDecoderCTC":
        """A decoder sharing this one's device tables under other engine options.

        ``overrides`` may set ``fast_topk`` (accepted; every decoder ranks
        exactly, see the constructor) and ``segment_frames``; any other
        name raises ``ValueError``. Building the device tables is the
        costly part of construction (seconds for a LibriSpeech-scale
        n-gram), while the options only change how a decode runs, so a
        parity decoder and a throughput decoder can share them. The clone
        gets its own copies of the ``LanguageModel`` wrappers (the n-gram
        model and the device tables stay shared), so ``reset_params`` on one
        never retunes the other, and it starts with no captured graphs. The
        original is unchanged.
        """
        allowed = ("fast_topk", "segment_frames")
        bad = sorted(set(overrides) - set(allowed))
        if bad:
            raise ValueError(f"unknown engine option(s) {bad}; with_options accepts {list(allowed)}")
        clone = copy.copy(self)
        clone._new_graph_cache()
        clone._pinned = None
        clone._copy_stream = None
        if self._lm is not None:
            clone._lm_members = [copy.copy(m) for m in self._lm_members]
            if isinstance(self._lm, MultiLanguageModel):
                clone._lm = copy.copy(self._lm)
                clone._lm._language_models = list(clone._lm_members)
            else:
                clone._lm = clone._lm_members[0]
        if "segment_frames" in overrides:
            clone._segment_frames = _check_segment_frames(overrides["segment_frames"])
        return clone

    def reset_params(self, **kwargs: Any) -> None:
        """Re-tune LM fusion knobs in place (read on every decode call, captured graphs included)."""
        if self._lm is not None:
            self._lm.reset_params(**kwargs)

    def _segment_frames_effective(self) -> int:
        """Steps per segment of a batch decode (0: the eager frame loop).

        The default is the reference's rule: 16-step segments on an
        accelerator, the eager loop on the CPU, where there is no launch
        cost for a graph to save.
        """
        if self._segment_frames is not None:
            return self._segment_frames
        return 16 if self._device.type == "cuda" else 0

    def _engine_cfg(self, beam_width: int, k: int, prune_history: bool,
                    use_hotwords: bool, emit_paths: Optional[int] = None,
                    token_timeline: bool = False, collect_stats: bool = False) -> EngineConfig:
        return EngineConfig(
            beam_width=beam_width,
            vocab_size=len(self._labels),
            k_tokens=k,
            prune_history=prune_history,
            emit_paths=emit_paths,
            token_timeline=token_timeline,
            use_hotwords=use_hotwords,
            is_bpe=self._alphabet.is_bpe,
            orders=tuple(m.order for m in self._lm_members),
            collect_stats=collect_stats,
        )

    # -- call-time parameters ------------------------------------------------
    def _hot_tables(self, hotwords: Optional[Iterable[str]],
                    weight: float) -> Tuple[Optional[Dict[str, Any]], float]:
        """This call's hotword trie on the device and its weight.

        Returns ``(None, 0.0)`` when no hotwords are given. The tables of
        the last 8 unigram sets stay on the device. The tracer counts
        ``hot.tables_built`` where a call builds and uploads a trie and
        ``hot.tables_cached`` where the cache answers.
        """
        scorer = HotwordScorer.build_scorer(hotwords, weight=weight)
        if not scorer.unigrams:
            return None, 0.0
        key = tuple(sorted(scorer.unigrams))
        hot = self._hot_cache.get(key)
        if hot is None:
            profiling.count("hot.tables_built")
            hot = self._hot_to_device(build_hotword_tables(list(key), self._tokens.char2id, self._tokens))
            if len(self._hot_cache) >= 8:  # bound per-call table churn
                self._hot_cache.pop(next(iter(self._hot_cache)))
            self._hot_cache[key] = hot
        else:
            profiling.count("hot.tables_cached")
        return hot, float(weight)

    def _hot_to_device(self, tables: Dict[str, np.ndarray]) -> Dict[str, Any]:
        """Packed hot-trie tables on the device, the host's ``next`` table beside them.

        The engine reads ``next``, ``seed`` and ``dead``; a stream whose
        hotword set changes walks its carried partial words through
        ``next_host`` (:meth:`partial_decode_beams`).
        """
        return {
            "next": torch.as_tensor(tables["next"], device=self._device).to(torch.int64),
            "seed": torch.as_tensor(tables["seed"], device=self._device).to(torch.int64),
            "dead": int(tables["dead"]),
            "next_host": tables["next"],
        }

    def _empty_hot(self) -> Dict[str, Any]:
        """Root-only hotword trie (streaming chunks without hotwords)."""
        if self._empty_hot_tables is None:
            self._empty_hot_tables = self._hot_to_device(empty_hotword_tables(self._tokens))
        return self._empty_hot_tables

    def _params_vector(self, token_min_logp: float, beam_prune_logp: float,
                       hotword_weight: float = 0.0) -> np.ndarray:
        """The reference's f32 parameter layout (see ``engine._params_dict``)."""
        vals = [token_min_logp, beam_prune_logp, hotword_weight]
        for m in self._lm_members:
            vals += [
                float(m.alpha),
                float(m.beta),
                float(m.unk_score_offset),
                1.0 if m.score_boundary else 0.0,
            ]
        return np.array(vals, dtype=np.float32)

    def _start_ctx(self, lm_start_state: Optional[AbstractLMState]) -> Tuple[Dict, ...]:
        """Per-LM-member start dicts ({"ctx", "len", "bo"}) for the engine."""
        if not self._lm_members:
            return ()
        if lm_start_state is None:
            states = [m.get_start_state() for m in self._lm_members]
        elif isinstance(lm_start_state, MultiLMState):
            states = list(lm_start_state.states)
            if len(states) != len(self._lm_members):
                raise AssertionError(
                    f"Number of states ({len(states)}) does not match number "
                    f"of language models ({len(self._lm_members)})."
                )
        else:
            states = [lm_start_state]
        start = []
        for m, dlm, state in zip(self._lm_members, self._device_lm, states):
            if not isinstance(state, NGramLMState):
                raise AssertionError(f"Expected NGramLMState, got {type(state)}")
            width = max(m.order - 1, 1)
            ctx = np.full(width, -1, dtype=np.int32)
            words = state.context[-width:] if m.order > 1 else ()
            for i, wid in enumerate(words):
                ctx[width - len(words) + i] = wid
            bo = context_suffix_backoffs(dlm, words)
            start.append({"ctx": ctx, "len": len(words), "bo": bo})
        return tuple(start)

    # -- device launch and fetch ---------------------------------------------
    def _launch(self, inputs: Any, n_frames: np.ndarray, k: int, beam_width: int,
                beam_prune_logp: float, token_min_logp: float, prune_history: bool,
                top_n: Optional[int], lm_start_state: Optional[AbstractLMState],
                hot: Optional[Dict[str, Any]], hot_weight: float,
                token_timeline: bool = False, collect_stats: bool = False,
                tabs: Optional[Dict[str, Any]] = None) -> Dict[str, torch.Tensor]:
        """Upload and enqueue one decode; returns its outputs as device tensors.

        ``inputs``: log-probs ``[N, T, V]``, or with ``token_timeline`` the
        tuple ``(toks, tlogp, is_final)``; ``hot``: the call's hotword tables
        (:meth:`_hot_tables`) or None; ``tabs``: device tables other than the
        decoder's own (a row-sharded LM's). With segments
        (:meth:`_segment_frames_effective`), the steps pad to a multiple of the segment with inactive steps (their
        paths hold -1). Nothing here waits for the device.
        """
        emit_paths = min(top_n, beam_width) if top_n is not None else None
        cfg = self._engine_cfg(beam_width, k, prune_history, hot is not None, emit_paths,
                               token_timeline, collect_stats)
        tables = self._tabs if tabs is None else tabs
        seg = self._segment_frames_effective()
        params = self._params_vector(token_min_logp, beam_prune_logp, hot_weight)
        planes = tuple(inputs) if token_timeline else (inputs,)
        pad = -planes[0].shape[1] % seg if seg else 0
        if pad:  # inactive steps; a timeline's empty token slots hold -1
            fills = (-1, 0, 0) if token_timeline else (0,)
            planes = tuple(np.pad(p, [(0, 0), (0, pad)] + [(0, 0)] * (p.ndim - 2), constant_values=fill)
                           for p, fill in zip(planes, fills))
        tr = profiling.TRACER
        if tr is not None:
            tr.count("steps.active", int(np.sum(n_frames)))
            tr.count("steps.launched", planes[0].shape[0] * planes[0].shape[1])
            tr.stage("batch.upload")
        dev = self._device
        with torch.inference_mode():
            dev_in: Any = tuple(torch.as_tensor(p, device=dev) for p in planes)
            if token_timeline:
                dev_in = (dev_in[0].to(torch.int64),) + dev_in[1:]  # widened once here
            else:
                dev_in = dev_in[0]
            nf = torch.as_tensor(n_frames, dtype=torch.int64, device=dev)
            start = self._start_ctx(lm_start_state)
            profiling.stage("batch.enqueue")
            if not seg:
                return make_decode_fn(cfg, tables)(dev_in, nf, params, start, hot)
            return self._run_segmented(cfg, seg, tables, dev_in, nf, params, start, hot)

    def _run_segmented(self, cfg: EngineConfig, seg: int, tables: Dict[str, Any], dev_in: Any,
                       n_frames: torch.Tensor, params: np.ndarray, start: Tuple[Dict, ...],
                       hot: Optional[Dict[str, Any]]) -> Dict[str, torch.Tensor]:
        """One decode through ``seg``-step segments (the reference's ``_run_segmented``).

        The host walks the segments: on the card each is one replay of the
        key's captured graph (:meth:`_segment_graph`), and the decode ends
        with one replay of the key's finalize graph (:meth:`_finalize_graph`)
        and one :func:`~pyctcdecode_torch.ops.backtrace.backtrace_paths`
        launch; on the CPU ``seg_fn`` and ``fin_fn`` run eagerly. Every
        segment's backpointers go into logs this decode owns, and the
        finalize graph's outputs are copied into tensors it owns, so a
        graph's next decode (a pipelined batch launched before this one is
        fetched) cannot overwrite them.
        """
        init_fn, seg_fn, fin_fn = make_segment_decode_fns(cfg, tables, seg)
        n = n_frames.shape[0]
        t_pad = (dev_in[2] if cfg.token_timeline else dev_in).shape[1]
        state = init_fn(start, n)
        prm = torch.as_tensor(params, device=self._device)
        log_shape = (n, t_pad, cfg.beam_width)
        parents = torch.empty(log_shape, dtype=_parent_dtype(cfg.beam_width), device=self._device)
        trace = torch.empty(log_shape, dtype=_path_dtype(cfg.vocab_size), device=self._device)

        def seg_in(s: int) -> Any:
            cut = slice(s * seg, (s + 1) * seg)
            if cfg.token_timeline:
                return tuple(plane[:, cut] for plane in dev_in)
            return dev_in[:, cut]

        graph = None
        if self._device.type == "cuda":
            graph = self._segment_graph(cfg, seg, seg_fn, state, seg_in(0), n_frames, prm, tables, hot)
        state = run_segments(seg_fn, seg, state, seg_in, t_pad // seg, n_frames, prm, hot, parents, trace, graph)
        if graph is None:
            return fin_fn(state, params, parents, trace, hot=hot)
        out = {key: val.clone() for key, val in self._finalize_graph(graph, cfg, tables, params).run().items()}
        out["paths"] = backtrace_paths(parents, trace, out["beam_src"])
        return out

    def _segment_graph(self, cfg: EngineConfig, seg: int, seg_fn, state: Dict[str, torch.Tensor],
                       seg_in: Any, n_frames: torch.Tensor, prm: torch.Tensor,
                       tables: Dict[str, Any], hot: Optional[Dict[str, Any]]) -> SegmentGraph:
        """The captured segment program of this decode's key, made on first use.

        The key: the engine configuration (its ``emit_paths`` aside, which
        only the finalize reads), the batch rows, the segment length, and
        the table and hotword objects whose tensors the graph reads (it
        holds them, so the ids stay theirs). The input widths are the
        configuration's (V, or the chunk width K). ``score_boundary`` is not
        in it: only the finalize reads it (a finalize graph's key,
        :meth:`_finalize_graph`). A stream's chunks (N = 1) share the key of
        a one-utterance batch decode of the same geometry. The last
        ``GRAPH_KEYS`` keys are kept, each with its finalize graphs; all
        share one memory pool, a new one whenever no captured graph is left
        (the cache emptied, or a capture failed).

        A row-sharded LM's decode (``ShardedCTCDecoder(shard_lm=True)``)
        has keys of its own through ``id(tables)``, and its graphs hold the
        probes' collectives. Every process of the group must then capture,
        replay and evict the same keys in the same order, or the
        collectives stop meeting their peers'. They do: every process
        passes the same global batch, pads it to the same step count (its
        longest row) and the same rows a process, and makes the same calls,
        so each process's cache sees the same keys in the same order.
        """
        key = (dataclasses.replace(cfg, emit_paths=None), n_frames.shape[0], seg, id(tables), id(hot))
        graph = self._graphs.get(key)
        if graph is not None:
            profiling.count("graph.hits")
            self._graphs.move_to_end(key)
            return graph
        profiling.count("graph.misses")
        if len(self._graphs) >= GRAPH_KEYS:
            self._graphs.popitem(last=False)
            profiling.count("graph.evictions")
        captured = any(g.graph is not None or any(f.graph is not None for f in g.finals.values())
                       for g in self._graphs.values())
        if not captured:  # a pool all of whose graphs are gone takes no further capture
            self._graph_pool = torch.cuda.graph_pool_handle()
        graph = SegmentGraph(seg_fn, state, seg_in, n_frames, prm, hot, self._graph_pool)
        self._graphs[key] = graph
        return graph

    def _finalize_graph(self, graph: SegmentGraph, cfg: EngineConfig, tables: Dict[str, Any],
                        params: np.ndarray, stream: Optional[Tuple[bool, bool]] = None) -> FinalizeGraph:
        """The captured finalize of ``graph``'s key for this call, made on first use.

        Its own key: ``emit_paths``, each member's ``score_boundary`` and,
        for a stream, ``(do_commit, is_end)`` (:func:`~pyctcdecode_torch.
        engine.finalize_program`).
        """
        key = (cfg.emit_paths, score_boundary_flags(cfg, params), stream)
        fin = graph.finals.get(key)
        if fin is not None:
            profiling.count("graph.hits")
            return fin
        profiling.count("graph.misses")
        fin = FinalizeGraph(finalize_program(cfg, tables, key[1], stream), graph)
        graph.finals[key] = fin
        return fin

    def _ready(self) -> Optional[torch.cuda.Event]:
        """An event recorded after the work enqueued so far (a launched decode's end); None off CUDA."""
        if self._device.type != "cuda":
            return None
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(self._device))
        return event

    def _fetch(self, out: Dict[str, torch.Tensor], n: int,
               ready: Optional[torch.cuda.Event] = None) -> Dict[str, np.ndarray]:
        """Copy the first ``n`` rows of every output to the host.

        On CUDA the copies go without blocking into views of one pinned
        buffer, which the decoder keeps and grows as needed, on a copy
        stream of the decoder's that first waits for ``ready`` (the event
        :meth:`_ready` recorded where the outputs' decode was launched; by
        default, recorded now). Then the host waits for an event recorded
        after the copies: for this decode and its copies only, not for work
        launched after ``ready`` (a later batch of
        :meth:`decode_beams_batches`). The arrays returned are views of the
        buffer: the next fetch overwrites them.
        """
        if self._device.type != "cuda":
            return {key: val[:n].numpy() for key, val in out.items()}
        if ready is None:
            ready = self._ready()
        sizes = {key: -(-val[:n].numel() * val.element_size() // 16) * 16 for key, val in out.items()}
        total = sum(sizes.values())
        if self._pinned is None or self._pinned.numel() < total:
            self._pinned = torch.empty(total, dtype=torch.uint8, pin_memory=True)
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(self._device)
        self._copy_stream.wait_event(ready)
        host, start = {}, 0
        with torch.cuda.stream(self._copy_stream):
            for key, val in out.items():
                rows = val[:n]
                nbytes = rows.numel() * rows.element_size()
                buf = self._pinned[start : start + nbytes].view(rows.dtype).view(rows.shape)
                buf.copy_(rows, non_blocking=True)
                host[key] = buf
                start += sizes[key]
            done = torch.cuda.Event()
            done.record(self._copy_stream)
        done.synchronize()
        return {key: buf.numpy() for key, buf in host.items()}

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
        """Decode one utterance on the device (a batch of one); returns ranked OutputBeams.

        ``max_tokens_per_frame``: ``None`` expands every vocabulary token
        per frame (always exact); an integer caps the per-frame top-K
        preselect (exact only when no frame admits more than K tokens at
        ``token_min_logp``); ``"auto"`` measures this call's admission and
        picks the smallest sufficient bucketed K. ``top_n`` limits text
        reconstruction to the best N beams (search is unaffected).
        ``blank_collapse`` drops blank-certain frames before decoding
        (exactness-preserving at this call's ``token_min_logp``; see
        :func:`~pyctcdecode_torch.utils.logits.blank_collapse`).
        """
        with profiling.call("batch"):
            handle = self._dispatch_batch(
                [np.asarray(logits)],
                beam_width=beam_width,
                beam_prune_logp=beam_prune_logp,
                token_min_logp=token_min_logp,
                prune_history=prune_history,
                hotwords=hotwords,
                hotword_weight=hotword_weight,
                max_tokens_per_frame=max_tokens_per_frame,
                batch_pad=1,
                top_n=top_n,
                blank_collapse=blank_collapse,
                lm_start_state=lm_start_state,
            )
            return self._collect_batch(handle)[0]

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

    # -- streaming API ---------------------------------------------------------
    def _get_stream_fns(self, beam_width: int, k: int, prune_history: bool, use_hotwords: bool):
        return make_stream_fns(self._engine_cfg(beam_width, k, prune_history, use_hotwords), self._tabs,
                               self._segment_frames_effective())

    def get_starting_state(
        self,
        beam_width: int = DEFAULT_BEAM_WIDTH,
        prune_history: bool = DEFAULT_PRUNE_BEAMS,
        max_tokens_per_frame: Optional[Union[int, str]] = None,
        lm_start_state: Optional[AbstractLMState] = None,
        hotwords_enabled: bool = False,
    ) -> DeviceStreamState:
        """Fresh streaming state on the device (ref decoder.py:669-679).

        The host engine's starting state is (beams, score caches); here it
        is one beam state of ``[1, B]`` planes on the device and an empty
        backpointer log. The decode geometry (beam width, token preselect,
        history pruning, hotword planes) is fixed at creation, as in the
        reference, whose compiled programs it shapes.
        """
        if max_tokens_per_frame == "auto":
            raise ValueError(
                "streaming decode geometry is fixed before any logits are "
                "seen; pass an integer max_tokens_per_frame (or None for "
                "the exact full-vocabulary preselect)"
            )
        v = len(self._labels)
        k = v if max_tokens_per_frame is None else min(int(max_tokens_per_frame), v)
        with profiling.call("stream.start") as root:
            init_fn, _, _ = self._get_stream_fns(beam_width, k, prune_history, hotwords_enabled)
            with torch.inference_mode():
                state = init_fn(self._start_ctx(lm_start_state))
            return DeviceStreamState(
                beam_state=state,
                chunks=[],
                processed_frames=0,
                beam_width=beam_width,
                k_tokens=k,
                prune_history=prune_history,
                use_hotwords=hotwords_enabled,
                call_id=-1 if root is None else root.call,
            )

    def _rewalk_hot(self, partials: Sequence[str], hot: Dict[str, Any]) -> Tuple[np.ndarray, np.ndarray]:
        """Each carried slot's partial word walked through a new hot trie, on the host.

        Returns the slots' hot nodes and packed bits, as the device walk
        would have left them.
        """
        nxt, dead = hot["next_host"], hot["dead"]
        nodes = np.zeros(len(partials), dtype=np.int64)
        bits = np.zeros(len(partials), dtype=np.int64)
        for slot, word in enumerate(partials):
            node, entry = 0, 0
            for ch in word:
                cid = self._tokens.char2id.get(ch)
                if cid is None:
                    node, entry = dead, dead
                    break
                entry = int(nxt[node, cid])
                node = entry & HOT_NODE_MASK
            nodes[slot] = node
            bits[slot] = entry & ~HOT_NODE_MASK
        return nodes, bits

    def _stream_graphs(self, seg: int, chunk_fn, ss: DeviceStreamState, logp: torch.Tensor,
                       params: np.ndarray, committed: bool, is_end: bool,
                       hot: Optional[Dict[str, Any]]) -> Tuple[Dict, Dict, torch.Tensor, torch.Tensor]:
        """One chunk of a stream through the captured programs of its key (the card's path).

        The stream's carried state goes into the static buffers of its
        key's N = 1 segment graph (:meth:`_segment_graph`, the cache that
        batch decodes use), the chunk's segments replay, then the finalize
        graph of ``(committed, is_end)`` (:meth:`_finalize_graph`). The
        ranked view and the new carried state (the committed state, or the
        segments' state) are copied out of the static buffers into tensors
        the stream owns, so another stream or a batch on this decoder may
        replay the graphs next. Returns ``(new state, ranked, parents,
        trace)``, the logs cut to the chunk's frames.
        """
        cfg = self._engine_cfg(ss.beam_width, ss.k_tokens, ss.prune_history, ss.use_hotwords)
        graphs: List[SegmentGraph] = []  # the key's graph, as chunk_fn looks it up

        def graph_for(seg_fn, state, seg_in, n_frames, prm) -> SegmentGraph:
            graphs.append(self._segment_graph(cfg, seg, seg_fn, state, seg_in, n_frames, prm, self._tabs, hot))
            return graphs[-1]

        state1, parents, trace = chunk_fn(ss.beam_state, logp, params, hot, graph_for=graph_for)
        fin = self._finalize_graph(graphs[-1], cfg, self._tabs, params, (committed, is_end)).run()
        ranked = {key: fin[key].clone() for key in ("src", "score", "logit")}
        if committed:
            state1 = {key[len(NEXT):]: val for key, val in fin.items() if key.startswith(NEXT)}
        return {key: val.clone() for key, val in state1.items()}, ranked, parents, trace

    def partial_decode_beams(
        self,
        stream_state: DeviceStreamState,
        logits_chunk: np.ndarray,
        beam_prune_logp: float = DEFAULT_PRUNE_LOGP,
        token_min_logp: float = DEFAULT_MIN_TOKEN_LOGP,
        hotwords: Optional[Iterable[str]] = None,
        hotword_weight: float = DEFAULT_HOTWORD_WEIGHT,
        force_next_word: bool = False,
        is_end: bool = False,
    ) -> List[LMBeam]:
        """Consume one chunk of logits; returns the ranked view of the current hypotheses.

        Device analog of ref ``decoder.py:681-728``: ``stream_state`` is
        updated in place (the beam planes stay on the device between
        calls). The returned :class:`LMBeam` list holds committed words in
        ``.text`` and the trailing partial in ``.partial_word``, unless
        ``force_next_word`` or ``is_end`` commits it; ``is_end`` also
        scores the end of the sentence. A commit folds the transcripts into
        per-slot prefixes and drops the backpointer log. Chunked decoding
        equals the full decode.
        """
        with profiling.call("chunk", stream_state.call_id) as root:
            if root is not None:
                stream_state.call_id = root.call
            profiling.stage("chunk.prep")
            logits_chunk = np.asarray(logits_chunk)
            if logits_chunk.ndim != 2 or logits_chunk.shape[1] != len(self._labels):
                raise ValueError(
                    f"Input logits of shape {logits_chunk.shape}, but vocabulary "
                    f"is size {len(self._labels)}"
                )
            # materialized once: a generator would be used up by the first pass
            hotwords = list(hotwords) if hotwords is not None else None
            ss = stream_state
            _, chunk_fn, finalize_fn = self._get_stream_fns(
                ss.beam_width, ss.k_tokens, ss.prune_history, ss.use_hotwords
            )
            seg = self._segment_frames_effective()
            if ss.use_hotwords:
                hot, weight = self._hot_tables(hotwords, hotword_weight)
                if hot is None:
                    hot, weight = self._empty_hot(), 0.0
                # a new hotword set invalidates the carried hot-trie nodes: walk
                # each carried slot's partial word through the new trie (the
                # reference rebuilds prefix membership from strings every call)
                new_sig = (tuple(sorted(hotwords)) if hotwords else (), float(weight))
                if ss.hot_sig is not None and new_sig != ss.hot_sig:
                    nodes, bits = self._rewalk_hot(ss.last_partials or [""] * ss.beam_width, hot)
                    ss.beam_state = dict(ss.beam_state)
                    ss.beam_state["h_node"] = torch.as_tensor(nodes, device=self._device)[None]
                    ss.beam_state["h_bits"] = torch.as_tensor(bits, device=self._device)[None]
                ss.hot_sig = new_sig
            else:
                if hotwords:
                    raise ValueError(
                        "stream state was created without hotword support; pass "
                        "hotwords_enabled=True to get_starting_state"
                    )
                hot, weight = None, 0.0
            params = self._params_vector(token_min_logp, beam_prune_logp, weight)
            t = logits_chunk.shape[0]
            logp = (normalize_batch([logits_chunk])[0] if t
                    else np.zeros((0, len(self._labels)), dtype=np.float32))
            committed = force_next_word or is_end
            profiling.stage("chunk.upload")
            with torch.inference_mode():
                logp_dev = torch.as_tensor(logp, device=self._device)[None]
                profiling.stage("chunk.enqueue")
                if seg and self._device.type == "cuda":
                    new_state, ranked, parents, trace = self._stream_graphs(
                        seg, chunk_fn, ss, logp_dev, params, committed, is_end, hot)
                else:
                    state1, parents, trace = chunk_fn(ss.beam_state, logp_dev, params, hot)
                    ranked, committed_state = finalize_fn(state1, params, committed, is_end, hot)
                    new_state = committed_state if committed else state1
                profiling.stage("chunk.fetch")
                host = self._fetch(dict(ranked, parents=parents, trace=trace), 1)
            if t:
                ss.chunks.append((host["parents"][0].copy(), host["trace"][0].copy(), ss.processed_frames))
            profiling.stage("chunk.backtrace")
            scores, logits_out = host["score"][0], host["logit"][0]
            n_live = int(np.cumprod(scores > DEAD_THRESH).sum())
            view_slots = host["src"][0][:n_live].astype(np.int64)
            toks, frame_ids, origins = _backtrace_chunks(ss.chunks, view_slots)
            profiling.stage("chunk.replay")
            frame_list = frame_ids.tolist()
            beams: List[LMBeam] = []
            rank_words: List[List[str]] = []  # per rank, the replay's own words (the fold's source)
            rank_spans: List[List[Tuple[int, int]]] = []
            for rank in range(n_live):
                row = toks[rank]
                words, spans, (partial, pframes) = replay_token_path(
                    row.tolist(), self._labels, self._alphabet.is_bpe, frame_ids=frame_list
                )
                if ss.prefix_words is not None:
                    # the folded committed prefix of this beam's origin slot
                    words = ss.prefix_words[origins[rank]] + words
                    spans = ss.prefix_spans[origins[rank]] + spans
                emitted = np.flatnonzero(row >= 0)
                last_label = self._labels[row[emitted[-1]]] if emitted.size else None
                if committed:
                    if partial:
                        words = words + [partial]
                        spans = spans + [pframes]
                    partial, pframes, last_label = "", NULL_FRAMES, None
                rank_words.append(words)
                rank_spans.append(spans)
                beams.append(LMBeam(
                    text=" ".join(words),
                    next_word="",
                    partial_word=partial,
                    last_char=last_label,
                    text_frames=spans,
                    partial_frames=pframes,
                    logit_score=float(logits_out[rank]),
                    lm_score=float(scores[rank]),
                ))
            _count_replay(rank_words)

            if committed:
                # the committed state's rows are in rank order: fold each rank's
                # transcript into its slot's prefix and drop the backpointer log,
                # so the next backtrace walks only the frames after this boundary
                ss.beam_state = new_state
                ss.prefix_words = rank_words + [[] for _ in range(ss.beam_width - n_live)]
                ss.prefix_spans = rank_spans + [[] for _ in range(ss.beam_width - n_live)]
                ss.chunks = []
                ss.last_partials = [""] * ss.beam_width
            else:
                ss.beam_state = new_state
                # partial words by CARRIED slot (rank r lives in slot src[r];
                # dead slots keep ""), for a hotword swap's rewalk next chunk
                partials = [""] * ss.beam_width
                for rank, slot in enumerate(view_slots.tolist()):
                    partials[slot] = beams[rank].partial_word
                ss.last_partials = partials
            ss.processed_frames += t
            return beams

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
        length_bucketing: Union[bool, int] = False,
        token_chunking: Union[None, bool, int] = None,
    ) -> List[List[OutputBeam]]:
        """Batched decode: all utterances in one ``[N, B]`` device program.

        Utterances are padded to the longest one; a padded frame freezes its
        utterance's state. The batch is padded to a multiple of
        ``batch_pad`` rows (the reference's shape-reuse rule, kept so both
        packages decode the same padded batch).

        ``length_bucketing`` (``True``, or a per-group row target; ``True``
        means 384) sorts the utterances by length into equal-count groups
        and launches one decode per group, all before any is collected, so a
        mixed-length batch stops paying the longest utterance's step count
        for every row. Results come back in input order; with the auto
        preselect each group measures its own K.

        ``blank_collapse`` drops blank-certain frames per utterance before
        decoding: exactness-preserving at this call's ``token_min_logp``
        (text, ranking, frame spans and, after the score offset is added
        back, scores match the full decode; see
        :func:`~pyctcdecode_torch.utils.logits.blank_collapse`).

        ``token_chunking`` (``True`` for width 5, or a chunk width) switches
        to token-timeline decoding, the serving configuration: the host
        splits each frame's exactly-admitted token set into chunks and the
        engine pools candidates across a frame's chunks, so a step's work
        follows the mean admitted count instead of the batch's worst frame.
        Output-exact for any width (see
        :func:`~pyctcdecode_torch.utils.logits.token_timeline`);
        ``max_tokens_per_frame`` is ignored on this path.

        ``hotwords`` boosts the given words and phrases by
        ``hotword_weight`` (ref ``language_model.py:115-189``), with or
        without an LM.

        ``collect_stats=True`` also accumulates per-utterance decode counters
        on the device (beams alive, candidates, merges, window and history
        prunes, commits, LM probe hits; :func:`~pyctcdecode_torch.engine.stats_fields`)
        and returns ``(results, stats)``, one ``{name: int}`` dict per
        utterance, in input order. The results are those of the call without
        it.
        """
        logits_list = self._without_pool_arg(logits_list, _pool_compat)
        dispatch_kw = dict(
            beam_width=beam_width,
            beam_prune_logp=beam_prune_logp,
            token_min_logp=token_min_logp,
            prune_history=prune_history,
            hotwords=hotwords,
            hotword_weight=hotword_weight,
            max_tokens_per_frame=max_tokens_per_frame,
            batch_pad=batch_pad,
            top_n=top_n,
            collect_stats=collect_stats,
            blank_collapse=blank_collapse,
            token_chunking=token_chunking,
        )
        with profiling.call("batch"):
            handles = self._launch_batch(logits_list, dispatch_kw, length_bucketing)
            return self._collect_bucketed(handles, len(logits_list), collect_stats)

    def _launch_batch(
        self,
        logits_list: Sequence[np.ndarray],
        dispatch_kw: Dict[str, Any],
        bucketing: Union[bool, int],
    ) -> List[Tuple[List[int], Optional[Dict[str, Any]]]]:
        """Launch one batch without waiting for it, bucketed by length if asked.

        With ``blank_collapse`` + bucketing the collapse runs batch-wide
        first, so the groups reflect the frame counts the device will
        actually step through, not the raw input lengths. Returns
        ``(indices, handle)`` pairs for :meth:`_collect_bucketed`.
        """
        profiling.stage("batch.prep")
        kw = dict(dispatch_kw)
        pre = None
        if bucketing and len(logits_list) > 1:
            if kw.get("blank_collapse"):
                pre = self._collapse_all(logits_list, kw["token_min_logp"])
                logits_list = pre[0]
                kw["blank_collapse"] = False
            target = 384 if bucketing is True else max(1, int(bucketing))
            groups = self._length_groups(logits_list, target_rows=target)
            if len(groups) > 1:
                return self._dispatch_bucketed(logits_list, groups, kw, pre)
            if pre is not None:
                kw["precollapsed"] = pre
        return [(
            list(range(len(logits_list))),
            self._dispatch_batch(logits_list, **kw),
        )]

    def _dispatch_bucketed(
        self,
        logits_list: Sequence[np.ndarray],
        groups: List[List[int]],
        dispatch_kw: Dict[str, Any],
        pre: Optional[Tuple[List[np.ndarray], List[np.ndarray], List[float]]] = None,
    ) -> List[Tuple[List[int], Optional[Dict[str, Any]]]]:
        """Launch one decode per length group; nothing is collected.

        ``pre`` carries batch-level blank-collapse output (collapsed
        log-probs, kept-frame ids, score offsets); each group receives its
        slice so the collapse isn't recomputed per group. Every group is
        padded to the same row count (the largest group's, rounded to the
        ``batch_pad`` grid), as the reference does, so both packages decode
        the same padded groups.
        """
        handles = []
        size = max(len(idx) for idx in groups)
        pad = max(int(dispatch_kw.get("batch_pad", 8)), 1)
        shared_pad = ((size + pad - 1) // pad) * pad
        for idx in groups:
            kw = dict(dispatch_kw, batch_pad=shared_pad)
            if pre is not None:
                kw["precollapsed"] = (
                    [pre[0][i] for i in idx],
                    [pre[1][i] for i in idx],
                    [pre[2][i] for i in idx],
                )
            handles.append((idx, self._dispatch_batch(
                [logits_list[i] for i in idx], **kw
            )))
        return handles

    def _collect_bucketed(
        self,
        handles: List[Tuple[List[int], Optional[Dict[str, Any]]]],
        n: int,
        collect_stats: bool = False,
    ) -> Any:
        """Wait for the launched groups; reassemble results (and stats) in input order."""
        results: List[Any] = [None] * n
        stats: List[Any] = [None] * n
        for idx, handle in handles:
            group_res, group_stats = self._collect_batch(handle, with_stats=True)
            for j, i in enumerate(idx):
                results[i] = group_res[j]
                if collect_stats:
                    stats[i] = group_stats[j]
        return (results, stats) if collect_stats else results

    @staticmethod
    def _length_groups(
        logits_list: Sequence[np.ndarray], target_rows: int = 384
    ) -> List[List[int]]:
        """Balanced length bucketing: equal-count groups of sorted lengths.

        Equal group sizes mean every group pads to the same row count and
        no tiny straggler group is left with a poor share of the device.
        ``target_rows`` is the row count aimed at per group.
        """
        lens = [max(m.shape[0], 1) for m in logits_list]
        order = sorted(range(len(lens)), key=lens.__getitem__)
        n = len(lens)
        n_groups = max(1, -(-n // target_rows))
        size = -(-n // n_groups)
        return [order[i : i + size] for i in range(0, n, size)]

    def _collapse_all(
        self, logits_list: Sequence[np.ndarray], token_min_logp: float
    ) -> Tuple[List[np.ndarray], List[np.ndarray], List[float]]:
        """Normalize and blank-collapse every utterance in a batch.

        Returns (collapsed log-prob matrices, kept original frame indices,
        per-utterance score offsets to restore full-decode scores).
        """
        return normalize_collapse_batch(logits_list, self._blank_id, token_min_logp)

    def _dispatch_batch(
        self,
        logits_list: Sequence[np.ndarray],
        beam_width: int,
        beam_prune_logp: float,
        token_min_logp: float,
        prune_history: bool,
        hotwords: Optional[Iterable[str]],
        hotword_weight: float,
        max_tokens_per_frame: Optional[Union[int, str]],
        batch_pad: int,
        top_n: Optional[int],
        collect_stats: bool = False,
        blank_collapse: bool = False,
        token_chunking: Union[None, bool, int] = None,
        precollapsed: Optional[
            Tuple[List[np.ndarray], List[np.ndarray], List[float]]
        ] = None,
        lm_start_state: Optional[AbstractLMState] = None,
        row_block: Optional[Tuple[int, int]] = None,
        tabs: Optional[Dict[str, Any]] = None,
    ) -> Optional[Dict[str, Any]]:
        """Normalize, upload and launch one batch; returns a result handle.

        The launch does not wait for the device, so a caller can prepare the
        next batch while this one runs (see :meth:`decode_beams_batches`).
        The handle holds the decode's outputs as device tensors.
        ``precollapsed`` supplies already-normalized, blank-collapsed
        matrices (from :meth:`_collapse_all`, computed batch-wide before
        length bucketing). ``lm_start_state`` (the single-utterance call's)
        seeds every row's LM context on the dense path.

        ``row_block=(start, count)`` launches only rows ``[start, start +
        count)`` of the padded batch, after the host prep of the whole batch
        (so the step count and an ``"auto"`` K are the whole batch's), over
        the device tables ``tabs``: one process's share of a sharded decode
        (:class:`~pyctcdecode_torch.parallel.ShardedCTCDecoder`).
        """
        if not logits_list:
            return None
        profiling.stage("batch.prep")
        hot, hot_weight = self._hot_tables(hotwords, hotword_weight)
        v = len(self._labels)
        n = len(logits_list)
        n_pad = ((n + batch_pad - 1) // batch_pad) * batch_pad
        for mat in logits_list:
            if mat.ndim != 2 or mat.shape[1] != v:
                raise ValueError(
                    f"Input logits of shape {mat.shape}, but vocabulary is size {v}"
                )
        frame_ids_list: Optional[List[np.ndarray]] = None
        offsets: Optional[List[float]] = None
        mats: Optional[List[np.ndarray]] = None
        if precollapsed is not None:
            mats, frame_ids_list, offsets = precollapsed
        elif blank_collapse:
            mats, frame_ids_list, offsets = self._collapse_all(logits_list, token_min_logp)
        if mats is None:
            mats = normalize_batch(logits_list)
        if token_chunking:
            return self._dispatch_timeline(
                mats, frame_ids_list, offsets,
                beam_width=beam_width, beam_prune_logp=beam_prune_logp,
                token_min_logp=token_min_logp, prune_history=prune_history,
                k_chunk=5 if token_chunking is True else int(token_chunking),
                n_pad=n_pad, top_n=top_n, hot=hot, hot_weight=hot_weight,
                collect_stats=collect_stats, row_block=row_block, tabs=tabs,
            )
        lens = [m.shape[0] for m in mats]
        t_max = max(max(lens), 1)
        logp = np.zeros((n_pad, t_max, v), dtype=np.float32)
        for i, mat in enumerate(mats):
            logp[i, : lens[i]] = mat
        n_frames = np.zeros(n_pad, dtype=np.int64)
        n_frames[:n] = lens
        valid = np.arange(t_max)[None, :] < n_frames[:, None]
        counts = np.where(valid, (logp >= token_min_logp).sum(-1), 1)
        k = self._pick_k(max_tokens_per_frame, counts, v)
        (logp, n_frames), n, frame_ids_list, offsets = _block(
            row_block, n, (logp, n_frames), frame_ids_list, offsets)
        out = self._launch(
            logp, n_frames, k, beam_width, beam_prune_logp, token_min_logp,
            prune_history, top_n, lm_start_state, hot, hot_weight,
            collect_stats=collect_stats, tabs=tabs,
        )
        return self._handle(out, t_max, n, top_n, frame_ids_list, offsets, collect_stats)

    def _dispatch_timeline(
        self,
        mats: List[np.ndarray],
        frame_ids_list: Optional[List[np.ndarray]],
        offsets: Optional[List[float]],
        *,
        beam_width: int,
        beam_prune_logp: float,
        token_min_logp: float,
        prune_history: bool,
        k_chunk: int,
        n_pad: int,
        top_n: Optional[int],
        hot: Optional[Dict[str, Any]],
        hot_weight: float,
        collect_stats: bool = False,
        row_block: Optional[Tuple[int, int]] = None,
        tabs: Optional[Dict[str, Any]] = None,
    ) -> Dict[str, Any]:
        """Launch one batch of normalized matrices through the token-timeline engine.

        The host splits every frame's exactly-admitted token set into
        ``k_chunk``-wide chunks
        (:func:`~pyctcdecode_torch.utils.logits.token_timeline`); the device
        steps through the chunk timeline with a carried candidate pool, so a
        step's work follows the mean admitted count, not the batch's worst
        frame. Output-exact for any ``k_chunk``. ``frame_ids_list`` (blank
        collapse) composes with the timeline's own step-to-frame map, so the
        handle's frame ids are original frame indices per virtual step.
        ``row_block`` and ``tabs`` as for :meth:`_dispatch_batch`.
        """
        n = len(mats)
        tls, vlens = token_timeline_batch(mats, token_min_logp, k_chunk)
        lens = [int(x) for x in vlens]
        t_max = max(max(lens), 1)
        toks = np.full((n_pad, t_max, k_chunk), -1, dtype=np.int32)
        tlogp = np.zeros((n_pad, t_max, k_chunk), dtype=np.float32)
        fin = np.zeros((n_pad, t_max), dtype=np.int8)
        step_frames = []  # original frame of every virtual step
        for i, (tk, tp, fi, _, fids) in enumerate(tls):
            toks[i, : lens[i]] = tk
            tlogp[i, : lens[i]] = tp
            fin[i, : lens[i]] = fi
            step_frames.append(
                np.asarray(frame_ids_list[i])[fids] if frame_ids_list is not None
                else fids.astype(np.int64)
            )
        n_frames = np.zeros(n_pad, dtype=np.int64)
        n_frames[:n] = lens
        (toks, tlogp, fin, n_frames), n, step_frames, offsets = _block(
            row_block, n, (toks, tlogp, fin, n_frames), step_frames, offsets)
        out = self._launch(
            (toks, tlogp, fin), n_frames, k_chunk, beam_width, beam_prune_logp,
            token_min_logp, prune_history, top_n, None, hot, hot_weight, token_timeline=True,
            collect_stats=collect_stats, tabs=tabs,
        )
        return self._handle(out, t_max, n, top_n, step_frames, offsets, collect_stats)

    def _handle(self, out: Dict[str, torch.Tensor], steps: int, n: int, top_n: Optional[int],
                frame_ids: Optional[List[np.ndarray]], offsets: Optional[List[float]],
                collect_stats: bool) -> Dict[str, Any]:
        """A launched batch's handle: device outputs and what the collect needs."""
        handle = {"out": out, "steps": steps, "n": n, "top_n": top_n,
                  "frame_ids": frame_ids, "offsets": offsets, "ready": self._ready()}
        if collect_stats:  # the names depend on the members only
            handle["stats_names"] = stats_fields(self._engine_cfg(1, 1, False, False))
        return handle

    def _collect_batch(self, handle: Optional[Dict[str, Any]], with_stats: bool = False) -> Any:
        """Wait for a launched batch, copy its outputs to the host and build
        its OutputBeam lists; ``with_stats`` returns ``(results, stats)``, the
        stats one ``{name: int}`` dict per utterance where the batch collected
        them, else None.

        The engine backtraces on the device, so the host replays one token
        path per (utterance, rank) row. For a char alphabet (multi-character
        labels included) one :func:`replay_token_paths_batch` pass covers
        every row; no path emits a ``-2`` force-commit marker (a stream folds
        its commits on the host, :meth:`partial_decode_beams`). A BPE alphabet replays row by row through
        :func:`replay_token_path`, which knows the piece and break rules, and
        the trailing partial word is appended (finalization semantics).
        """
        if handle is None:
            return ([], None) if with_stats else []
        profiling.stage("batch.fetch")
        host = self._fetch(handle["out"], handle["n"], handle["ready"])
        profiling.stage("batch.replay")
        n = handle["n"]
        stats = None
        if "stats_names" in handle:
            stats = [dict(zip(handle["stats_names"], row)) for row in host["stats"].tolist()]
        paths = host["paths"]  # [n, R, T]
        lm_score = host["lm_score"]
        logit = host["logit"]
        limit = paths.shape[1]
        if handle["top_n"] is not None:
            limit = min(limit, handle["top_n"])
        live = np.cumprod(lm_score[:, :limit] > -1.0e29, axis=1).astype(bool)
        ui, ri = np.nonzero(live)  # utterance-major, rank ascending
        results: List[List[OutputBeam]] = [[] for _ in range(n)]
        if ui.size == 0:
            return (results, stats) if with_stats else results
        toks_flat = paths[ui, ri]  # [rows, T]
        frame_ids_list = handle["frame_ids"]
        fid = None
        if frame_ids_list is not None:
            per_utt = np.zeros((n, toks_flat.shape[1]), dtype=np.int64)
            for u, fi in enumerate(frame_ids_list):
                per_utt[u, : len(fi)] = fi
            fid = per_utt[ui]
        if self._alphabet.is_bpe:
            pairs = [self._replay_bpe(row, None if fid is None else fid[j])
                     for j, row in enumerate(toks_flat)]
        else:
            space_id = self._labels.index(" ") if " " in self._labels else -100
            pairs = replay_token_paths_batch(
                toks_flat, self._labels, self._blank_id, space_id, frame_ids=fid
            )
        offsets = handle["offsets"]
        for row, (u, r) in enumerate(zip(ui.tolist(), ri.tolist())):
            words, frames = pairs[row]
            off = float(offsets[u]) if offsets is not None else 0.0
            last_state: Optional[AbstractLMState] = None
            if self._lm_members:
                states = []
                for i in range(len(self._lm_members)):
                    n_ctx = int(host[f"ctx_len{i}"][u, r])
                    ctx = host[f"ctx{i}"][u, r]
                    states.append(NGramLMState(
                        tuple(int(w) for w in ctx[len(ctx) - n_ctx:]) if n_ctx else ()
                    ))
                last_state = states[0] if len(states) == 1 else MultiLMState(states)
            results[u].append(
                OutputBeam(
                    text=" ".join(words),
                    last_lm_state=last_state,
                    text_frames=list(zip(words, frames)),
                    logit_score=float(logit[u, r]) + off,
                    lm_score=float(lm_score[u, r]) + off,
                )
            )
        _count_replay(words for words, _ in pairs)
        return (results, stats) if with_stats else results

    def _replay_bpe(self, toks: np.ndarray,
                    frame_ids: Optional[np.ndarray]) -> Tuple[List[str], List[Tuple[int, int]]]:
        """One BPE token path's words and frame spans, the trailing partial word included."""
        words, frames, (partial, pframes) = replay_token_path(
            toks.tolist(), self._labels, True,
            frame_ids=None if frame_ids is None else frame_ids.tolist(),
        )
        if partial:
            words.append(partial)
            frames.append(pframes)
        return words, frames

    def decode_beams_batches(
        self,
        batches: Iterable[Sequence[np.ndarray]],
        pipeline_depth: int = 1,
        **kwargs: Any,
    ) -> Iterable[List[List[OutputBeam]]]:
        """Pipelined decoding of a stream of batches (the serving path).

        Keeps ``pipeline_depth`` batches launched: while the device runs
        batch ``i``, the host prepares and launches the next batches, and
        builds the outputs of earlier ones. Accepts the keyword arguments of
        :meth:`decode_beams_batch` (``length_bucketing`` included, which
        splits each batch into per-group decodes) except ``collect_stats``;
        yields one result list per batch, in order.
        """
        pipeline_depth = max(int(pipeline_depth), 1)
        pending: List[Tuple[List[Tuple[List[int], Optional[Dict[str, Any]]]], int, Optional[profiling.Span]]] = []
        defaults = dict(
            beam_width=kwargs.pop("beam_width", DEFAULT_BEAM_WIDTH),
            beam_prune_logp=kwargs.pop("beam_prune_logp", DEFAULT_PRUNE_LOGP),
            token_min_logp=kwargs.pop("token_min_logp", DEFAULT_MIN_TOKEN_LOGP),
            prune_history=kwargs.pop("prune_history", DEFAULT_PRUNE_BEAMS),
            hotwords=kwargs.pop("hotwords", None),
            hotword_weight=kwargs.pop("hotword_weight", DEFAULT_HOTWORD_WEIGHT),
            max_tokens_per_frame=kwargs.pop("max_tokens_per_frame", None),
            batch_pad=kwargs.pop("batch_pad", 8),
            top_n=kwargs.pop("top_n", None),
            collect_stats=False,
            blank_collapse=kwargs.pop("blank_collapse", False),
            token_chunking=kwargs.pop("token_chunking", None),
        )
        bucketing = kwargs.pop("length_bucketing", False)
        if kwargs.pop("collect_stats", False):
            raise ValueError(
                "collect_stats is not supported on the pipelined "
                "decode_beams_batches path; use decode_beams_batch"
            )
        if kwargs:
            raise TypeError(f"unknown decode arguments: {sorted(kwargs)}")
        for logits_list in batches:
            # a batch's root span covers its launch here and its collect later (``profiling.resume``)
            with profiling.call("batch") as root:
                handles = self._launch_batch(logits_list, defaults, bucketing)
            pending.append((handles, len(logits_list), root))
            if len(pending) > pipeline_depth:
                yield self._collect_pending(pending.pop(0))
        while pending:
            yield self._collect_pending(pending.pop(0))

    def _collect_pending(self, pending: Tuple[Any, int, Optional[profiling.Span]]) -> List[List[OutputBeam]]:
        """Collect one batch that :meth:`decode_beams_batches` launched, under its root span."""
        handles, n, root = pending
        with profiling.resume(root):
            return self._collect_bucketed(handles, n)

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
        length_bucketing: Union[bool, int] = False,
        token_chunking: Union[None, bool, int] = None,
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

    # -- serialization (the host engine's directory layout) -------------------
    def save_to_dir(self, filepath: str) -> None:
        """Write alphabet.json (+ language_model/ when present) to a directory."""
        alphabet_path = os.path.join(filepath, BeamSearchDecoderCTC._ALPHABET_SERIALIZED_FILENAME)
        with open(alphabet_path, "w") as fh:
            fh.write(self._alphabet.dumps())
        if self._lm is None:
            logger.info("no language model attached; serializing the alphabet only")
        else:
            lm_path = os.path.join(filepath, BeamSearchDecoderCTC._LANGUAGE_MODEL_SERIALIZED_DIRECTORY)
            os.makedirs(lm_path)
            logger.info("writing the language model under %s", lm_path)
            self._lm.save_to_dir(lm_path)

    @staticmethod
    def parse_directory_contents(filepath: str) -> Dict[str, Optional[str]]:
        """Validate a serialized-decoder directory layout (the host engine's)."""
        return BeamSearchDecoderCTC.parse_directory_contents(filepath)

    @classmethod
    def load_from_dir(
        cls,
        filepath: str,
        unigram_encoding: Optional[str] = None,
        *,
        device: Union[None, str, torch.device] = None,
    ) -> "TorchBeamSearchDecoderCTC":
        """Load a serialized decoder directory onto the device engine.

        ``device`` as for the constructor: ``None`` means CUDA and raises
        without a GPU; ``device="cpu"`` runs the plain versions.
        """
        _resolve_device(device)  # refuse before reading a possibly large model
        filenames = cls.parse_directory_contents(filepath)
        with open(filenames["alphabet"], "r") as fh:  # type: ignore[arg-type]
            alphabet = Alphabet.loads(fh.read())
        language_model: Optional[LanguageModel] = None
        if filenames["language_model"] is not None:
            language_model = LanguageModel.load_from_dir(
                filenames["language_model"], unigram_encoding=unigram_encoding
            )
        return cls(alphabet, language_model=language_model, device=device)

    @classmethod
    def load_from_hf_hub(
        cls,
        model_id: str,
        cache_dir: Optional[str] = None,
        *,
        device: Union[None, str, torch.device] = None,
        **kwargs: Any,
    ) -> "TorchBeamSearchDecoderCTC":
        """Load a decoder directory from the HuggingFace Hub (or its cache).

        ``kwargs`` go to ``huggingface_hub.snapshot_download`` (for example
        ``local_files_only=True``); ``device`` to :meth:`load_from_dir`.
        """
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
        return cls.load_from_dir(cached_directory, device=device)
