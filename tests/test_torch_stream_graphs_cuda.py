"""Streams on the card through captured CUDA graphs, against the eager stream.

On CUDA ``partial_decode_beams`` loads the stream's carried state into its
key's N = 1 segment graph, replays the chunk's segments (the logits padded
to whole segments of 16 steps, the padded steps inactive), then the
finalize graph of ``(commit, is_end)``, and copies the view and the new
state out. A ``with_options(segment_frames=0)`` clone runs the same chunk
eagerly, step by step. Both run the same kernels on the same inputs in the
same order, so every view (words, partial words, spans, scores) and every
carried state plane must be equal to the bit (tolerance 0).

Also here: two streams interleaved chunk by chunk on one decoder equal each
stream alone; ``reset_params`` between chunks reaches the captured graphs;
a capture error in the finalize graph raises and leaves no count behind; a
batch collect waits for its own batch only.

Every test here needs an NVIDIA GPU and skips without one. The module
imports neither JAX nor the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_stream_graphs_cuda.py
"""
import time

import numpy as np
import pytest
import torch

import pyctcdecode_torch as P
from pyctcdecode_torch import engine
from pyctcdecode_torch.constants import DEFAULT_HOTWORD_WEIGHT, DEFAULT_MIN_TOKEN_LOGP, DEFAULT_PRUNE_LOGP
from pyctcdecode_torch.models.ngram import open_ngram_file
from pyctcdecode_torch.ops import backtrace as tb
from pyctcdecode_torch.ops import commit as tc
from pyctcdecode_torch.ops import gather as tg
from pyctcdecode_torch.ops import merge as tm

from .helpers import SAMPLE_LABELS
from .torch_cases import (
    ARPA,
    ARPA_2GRAM,
    LM_WORDS,
    UNIGRAMS,
    assert_same_views,
    piece_logits,
    piece_vocabulary,
    word_logits,
)

WRAPPERS = (tm.expand_merge_prune, tm.merge_prune, tg.gather_rows, tg.probe_rows, tb.backtrace_paths,
            tc.commit_words)
CUTS = [0, 1, 8, 8, 33, 45]  # chunks of 1, 7, 0, 25 and 12 frames


def _cuda() -> None:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: graphs and kernels have no CPU mode")


def _lm(tmp_path, name="a", text=ARPA, **kw):
    path = tmp_path / f"{name}.arpa"
    path.write_text(text)
    return P.LanguageModel(open_ngram_file(str(path)), UNIGRAMS, **kw)


def _states_equal(want, got):
    assert set(got) == set(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        assert torch.equal(got[key], want[key]), key


def _stream(decoder, mat, cuts=CUTS, force_at=None, hot_calls=None, start_kw=None, between=None):
    """Views, carried states and launch counts of one stream over ``mat`` cut at ``cuts``."""
    start_kw = dict(beam_width=16, prune_history=True, **(start_kw or {}))
    state = decoder.get_starting_state(hotwords_enabled=hot_calls is not None, **start_kw)
    views, states = [], []
    before = [fn.launches for fn in WRAPPERS]
    n = len(cuts) - 1
    for i, (a, b) in enumerate(zip(cuts[:-1], cuts[1:])):
        if between is not None:
            between(i)
        kw = {} if hot_calls is None else dict(hotwords=hot_calls[i], hotword_weight=6.0)
        views.append(decoder.partial_decode_beams(state, mat[a:b], force_next_word=(i == force_at),
                                                  is_end=(i == n - 1), **kw))
        states.append({key: val.clone() for key, val in state.beam_state.items()})
    torch.cuda.synchronize()
    return views, states, [fn.launches - c for fn, c in zip(WRAPPERS, before)]


def _assert_graphs_equal_eager(dec, mat, cuts=CUTS, **kw):
    eager = dec.with_options(segment_frames=0)
    want_views, want_states, eager_used = _stream(eager, mat, cuts, **kw)
    for _ in range(2):  # the captures, then every chunk a replay
        views, states, graph_used = _stream(dec, mat, cuts, **kw)
        for w, g in zip(want_views, views):
            assert_same_views(w, g, tol=0.0)
        for w, g in zip(want_states, states):
            _states_equal(w, g)
    assert dec._graphs and all(g.graph is not None for g in dec._graphs.values())
    chunks = len(cuts) - 1
    padded = sum(-(-(b - a) // 16) * 16 for a, b in zip(cuts[:-1], cuts[1:]))
    assert eager_used[0] == cuts[-1] and graph_used[0] == padded  # one step a frame, padded to segments
    assert eager_used[1] == graph_used[1] == chunks  # one finalize a chunk
    assert eager_used[4] == graph_used[4] == 0  # the stream backtraces on the host
    return want_views, eager_used, graph_used


@pytest.mark.cuda
def test_char_stream_graphs_equal_eager(tmp_path):
    """One member, chunks of 1, 7, 0, 25 and 12 frames, a forced commit mid-stream and without."""
    _cuda()
    dec = P.TorchBeamSearchDecoderCTC(P.Alphabet.build_alphabet(SAMPLE_LABELS), _lm(tmp_path))
    assert dec._segment_frames_effective() == 16
    mat = word_logits(9, 45)
    for force_at in (None, 3):
        views, eager_used, graph_used = _assert_graphs_equal_eager(dec, mat, force_at=force_at)
        # per step one trie fetch and one word commit; per finalize two probes (last word, </s>)
        assert eager_used[2:4] == [45, 2 * 5] and graph_used[2] == graph_used[0]
        assert eager_used[5] == 45 and graph_used[5] == graph_used[0]
    full = dec.decode_beams(mat, beam_width=16, prune_history=True)
    assert [b.text for b in full] == [v.text for v in views[-1]]
    # stream keys share the cache with batch keys: the full decode above is the stream's N = 1 key
    assert len(dec._graphs) == 1
    assert len(next(iter(dec._graphs.values())).finals) == 4  # stream (no commit, commit, end), batch


@pytest.mark.cuda
def test_hot2lm_stream_with_a_hotword_swap_graphs_equal_eager(tmp_path):
    """Two members (one scores ``</s>``) and hotwords, the set swapped mid-stream: a new key."""
    _cuda()
    lm = P.MultiLanguageModel([_lm(tmp_path), _lm(tmp_path, "b", ARPA_2GRAM, alpha=0.3, beta=2.0,
                                                  score_boundary=False)])
    dec = P.TorchBeamSearchDecoderCTC(P.Alphabet.build_alphabet(SAMPLE_LABELS), lm)
    mat = word_logits(11, 48)
    cuts = [0, 10, 21, 33, 48]
    hot_calls = [["bugs"], ["bugs", "gun"], ["bunny sun"], None]
    _assert_graphs_equal_eager(dec, mat, cuts, hot_calls=hot_calls)
    assert len(dec._graphs) == 4  # one key a hotword set (None: the empty trie)


@pytest.mark.cuda
def test_bpe_stream_graphs_equal_eager(tmp_path):
    """A piece vocabulary (labels up to 5 chars, ``▁⁇▁`` mid-utterance), a forced commit."""
    _cuda()
    alphabet = P.Alphabet.build_alphabet(piece_vocabulary(LM_WORDS))
    dec = P.TorchBeamSearchDecoderCTC(alphabet, _lm(tmp_path))
    mat = piece_logits(6, alphabet.labels, 6)
    cuts = [0, 7, 8, mat.shape[0]]
    _assert_graphs_equal_eager(dec, mat, cuts, force_at=1)


@pytest.mark.cuda
def test_interleaved_streams_equal_each_stream_alone(tmp_path):
    """Two streams, one decoder, one graph key: chunk by chunk in turns, each state copied in and out."""
    _cuda()
    dec = P.TorchBeamSearchDecoderCTC(P.Alphabet.build_alphabet(SAMPLE_LABELS), _lm(tmp_path))
    mats = [word_logits(9, 45), word_logits(10, 40)]
    alone = [_stream(dec, m)[:2] for m in mats]
    states = [dec.get_starting_state(beam_width=16, prune_history=True) for _ in mats]
    views = [[], []]
    for i, (a, b) in enumerate(zip(CUTS[:-1], CUTS[1:])):
        for j, m in enumerate(mats):
            views[j].append(dec.partial_decode_beams(states[j], m[a:b], is_end=(i == len(CUTS) - 2)))
            _states_equal(alone[j][1][i], states[j].beam_state)
    for j in range(2):
        for w, g in zip(alone[j][0], views[j]):
            assert_same_views(w, g, tol=0.0)
    assert len(dec._graphs) == 1


@pytest.mark.cuda
def test_reset_params_between_chunks_reaches_the_captured_graphs(tmp_path):
    """alpha, beta, the unk offset and score_boundary changed after the captures, mid-stream."""
    _cuda()
    dec = P.TorchBeamSearchDecoderCTC(P.Alphabet.build_alphabet(SAMPLE_LABELS), _lm(tmp_path))
    eager = dec.with_options(segment_frames=0)
    mat = word_logits(9, 45)
    plain_views, _, _ = _stream(dec, mat)  # captures every graph of the key
    knobs = dict(alpha=2.5, beta=-1.0, unk_score_offset=-3.0, score_boundary=False)

    def retune(d):
        return lambda i: d.reset_params(**knobs) if i == 2 else None

    want, want_states, _ = _stream(eager, mat, between=retune(eager))
    got, got_states, _ = _stream(dec, mat, between=retune(dec))
    for w, g in zip(want, got):
        assert_same_views(w, g, tol=0.0)
    for w, g in zip(want_states, got_states):
        _states_equal(w, g)
    assert [v.lm_score for v in got[-1]] != [v.lm_score for v in plain_views[-1]]


@pytest.mark.cuda
def test_a_finalize_capture_error_raises(tmp_path, monkeypatch):
    """A host sync inside the finalize makes its capture fail: the chunk raises, nothing runs
    eagerly instead, and the launches counted under the failed capture are taken back."""
    _cuda()
    dec = P.TorchBeamSearchDecoderCTC(P.Alphabet.build_alphabet(SAMPLE_LABELS), _lm(tmp_path))
    finalize = engine._stream_finalize

    def syncing_finalize(cfg, lms, hot, prm, state, *flags):
        state["logit"].max().item()  # a device-to-host read: not allowed while a stream captures
        return finalize(cfg, lms, hot, prm, state, *flags)

    body, at_capture = engine.FinalizeGraph._body, []

    def watched_body(graph):
        if torch.cuda.is_current_stream_capturing():
            at_capture.append([fn.launches for fn in WRAPPERS])
        body(graph)

    monkeypatch.setattr(engine, "_stream_finalize", syncing_finalize)
    monkeypatch.setattr(engine.FinalizeGraph, "_body", watched_body)
    state = dec.get_starting_state(beam_width=16)
    with pytest.raises(RuntimeError):
        dec.partial_decode_beams(state, word_logits(9, 45)[:20])
    torch.cuda.synchronize()
    assert len(at_capture) == 1
    assert [fn.launches for fn in WRAPPERS] == at_capture[0]
    segment = next(iter(dec._graphs.values()))
    assert segment.graph is not None and all(f.graph is None for f in segment.finals.values())


@pytest.mark.cuda
def test_a_collect_waits_for_its_own_batch_only(tmp_path):
    """``_fetch`` waits on an event after its own copies: collecting batch 1 returns while a much
    longer batch 2, launched after it, still runs (a stream synchronize would wait for both)."""
    _cuda()
    dec = P.TorchBeamSearchDecoderCTC(P.Alphabet.build_alphabet(SAMPLE_LABELS), _lm(tmp_path))
    short = [word_logits(21, 45), word_logits(22, 17)]
    rng = np.random.RandomState(0)
    long = [np.concatenate([word_logits(int(s), 45) for s in rng.randint(0, 1000, 60)]) for _ in range(8)]
    kw = dict(beam_width=100, prune_history=True, top_n=1)
    defaults = dict(beam_prune_logp=DEFAULT_PRUNE_LOGP, token_min_logp=DEFAULT_MIN_TOKEN_LOGP, hotwords=None,
                    hotword_weight=DEFAULT_HOTWORD_WEIGHT, max_tokens_per_frame=None, batch_pad=8, collect_stats=False, blank_collapse=False,
                    token_chunking=None, **kw)
    want = dec.decode_beams_batch(short, **kw)
    dec.decode_beams_batch([m[:64] for m in long], **kw)  # the long batch's keys, captured
    first = dec._launch_batch(short, defaults, False)
    second = dec._launch_batch(long, defaults, False)
    t0 = time.perf_counter()
    got = dec._collect_bucketed(first, len(short))
    collect_s = time.perf_counter() - t0
    still_running = not torch.cuda.current_stream().query()
    t1 = time.perf_counter()
    dec._collect_bucketed(second, len(long))
    assert still_running, f"the collect of batch 1 ({collect_s:.3f} s) waited for batch 2"
    assert time.perf_counter() - t1 > collect_s
    for w, g in zip(want, got):
        assert [b.text for b in w] == [b.text for b in g]
        assert [b.lm_score for b in w] == [b.lm_score for b in g]
