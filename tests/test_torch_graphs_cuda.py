"""Segment programs on the card: captured CUDA graphs against the eager frame loop.

A decoder with ``segment_frames > 0`` (16 by default on CUDA) runs each
segment of a batch decode as one replay of a captured CUDA graph; with
``segment_frames=0`` it runs the eager loop. The two run the same kernels
on the same inputs in the same order, so their results must be equal to
the bit: texts, ``text_frames``, LM states and scores (tolerance 0). The
launch counters must count the kernels the replays run, as the eager loop
counts its own (plus the padded steps of the last segment).

``ShardedCTCDecoder(shard_lm=True)`` runs the same way, its probes' NCCL
collectives captured inside the graphs: over a one-process NCCL group it
must equal its eager column (a wrapped decoder made with
``segment_frames=0``) and the unsharded graph decode to the bit.

Every test here needs an NVIDIA GPU and skips without one. The module
imports neither JAX nor the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_graphs_cuda.py
"""
import pytest
import torch

import pyctcdecode_torch as P
from pyctcdecode_torch import engine
from pyctcdecode_torch.models.ngram import open_ngram_file
from pyctcdecode_torch.ops import backtrace as tb
from pyctcdecode_torch.ops import commit as tc
from pyctcdecode_torch.ops import gather as tg
from pyctcdecode_torch.ops import merge as tm
from pyctcdecode_torch.ops import replay as tr
from pyctcdecode_torch.torch_decoder import GRAPH_KEYS
from pyctcdecode_torch.utils import profiling

from .helpers import SAMPLE_LABELS
from .torch_cases import (
    ARPA,
    ARPA_2GRAM,
    LM_WORDS,
    UNIGRAMS,
    assert_same_beams,
    piece_logits,
    piece_vocabulary,
    word_logits,
)

BEAM = 16
BATCH = [word_logits(21, 45), word_logits(22, 17), word_logits(23, 38)]  # 45 steps: 3 segments of 16
WRAPPERS = (tm.expand_merge_prune, tm.merge_prune, tg.gather_rows, tg.probe_rows, tb.backtrace_paths,
            tc.commit_words)


def _cuda() -> None:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: graphs and kernels have no CPU mode")


def _lm(tmp_path, name="a", text=ARPA, **kw):
    path = tmp_path / f"{name}.arpa"
    path.write_text(text)
    return P.LanguageModel(open_ngram_file(str(path)), UNIGRAMS, **kw)


def _counted(decoder, batch, **kw):
    """``decode_beams_batch`` and the launches each wrapper counted in it."""
    before = [fn.launches for fn in WRAPPERS]
    out = decoder.decode_beams_batch(batch, **kw)
    torch.cuda.synchronize()
    return out, [fn.launches - n for fn, n in zip(WRAPPERS, before)]


def _assert_bit_equal(want, got):
    assert len(got) == len(want)
    for w, g in zip(want, got):
        assert_same_beams(w, g, tol=0.0)


def _assert_graphs_equal_eager(graphed, batch, **kw):
    """The graph decode against the eager decode of a clone: results to the bit, and the launches."""
    eager = graphed.with_options(segment_frames=0)
    want, eager_used = _counted(eager, batch, **kw)
    got, graph_used = _counted(graphed, batch, **kw)
    _assert_bit_equal(want, got)
    assert graphed._graphs and all(g.graph is not None for g in graphed._graphs.values())
    # again: every segment of this decode is a replay of a graph captured above
    again, again_used = _counted(graphed, batch, **kw)
    _assert_bit_equal(want, again)
    assert again_used == graph_used
    return eager_used, graph_used


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 2, 4, None])
def test_dense_graph_decode_equals_eager_at_every_cluster_size(tmp_path, k):
    """K = 1, 2, 4 and 8 make ``expand_merge_prune`` pick clusters of 1, 2, 4 and 8 blocks."""
    _cuda()
    dec = P.TorchBeamSearchDecoderCTC(P.Alphabet.build_alphabet(SAMPLE_LABELS), _lm(tmp_path))
    assert dec._segment_frames_effective() == 16
    kw = dict(beam_width=BEAM, prune_history=True, max_tokens_per_frame=k)
    eager_used, graph_used = _assert_graphs_equal_eager(dec, BATCH, **kw)
    # per step one merge kernel, one trie fetch and one word commit (its probes
    # in-kernel); the graph decode pads 45 steps to 48; one finalize: one merge,
    # two probes (last word, </s>); one backtrace of the whole logs
    assert eager_used == [45, 1, 45, 2, 1, 45]
    assert graph_used == [48, 1, 48, 2, 1, 48]


@pytest.mark.cuda
def test_a_captured_dense_decode_replays_the_winners_once_a_step(tmp_path):
    """One ``replay_winners`` launch a launched step, as many as ``expand_merge_prune``'s, eager and
    captured, and the tracer's ``launches.replay_winners`` counts them; the same beams to the bit."""
    _cuda()
    dec = P.TorchBeamSearchDecoderCTC(P.Alphabet.build_alphabet(SAMPLE_LABELS), _lm(tmp_path))
    eager = dec.with_options(segment_frames=0)
    kw = dict(beam_width=BEAM, prune_history=True)

    def run(decoder):
        with profiling.tracing() as trace:
            out = decoder.decode_beams_batch(BATCH, **kw)
            torch.cuda.synchronize()
        counters = trace.counters()
        return out, [counters[f"launches.{fn.__name__}"] for fn in (tm.expand_merge_prune, tr.replay_winners)]

    want, eager_used = run(eager)
    got, graph_used = run(dec)  # the first segment eager, then its capture, then replays
    _assert_bit_equal(want, got)
    again, again_used = run(dec)  # replays only
    _assert_bit_equal(want, again)
    assert eager_used == [45, 45]  # the longest utterance's steps
    assert graph_used == again_used == [48, 48]  # padded to whole segments of 16


@pytest.mark.cuda
@pytest.mark.parametrize("members", [1, 2])
def test_a_captured_dense_segment_commits_once_a_padded_step(tmp_path, members):
    """One ``commit_words`` launch a launched step for every member, eager and captured, as the
    tracer's ``launches.commit_words`` counts them; the step probes no table through ``probe_rows``
    (the finalize's two probes a member scoring </s>, one a member that does not); the same beams to the bit."""
    _cuda()
    lm = _lm(tmp_path)
    if members == 2:
        lm = P.MultiLanguageModel([lm, _lm(tmp_path, "b", ARPA_2GRAM, alpha=0.3, beta=2.0, score_boundary=False)])
    dec = P.TorchBeamSearchDecoderCTC(P.Alphabet.build_alphabet(SAMPLE_LABELS), lm)
    eager = dec.with_options(segment_frames=0)
    kw = dict(beam_width=BEAM, prune_history=True)
    names = [f"launches.{fn.__name__}" for fn in (tm.expand_merge_prune, tc.commit_words, tg.probe_rows)]

    def run(decoder):
        with profiling.tracing() as trace:
            out = decoder.decode_beams_batch(BATCH, **kw)
            torch.cuda.synchronize()
        counters = trace.counters()
        return out, [counters[name] for name in names]

    want, eager_used = run(eager)
    got, graph_used = run(dec)  # the first segment eager, then its capture, then replays
    _assert_bit_equal(want, got)
    again, again_used = run(dec)  # replays only
    _assert_bit_equal(want, again)
    probes = 2 if members == 1 else 3
    assert eager_used == [45, 45, probes]
    assert graph_used == again_used == [48, 48, probes]  # padded to whole segments of 16


@pytest.mark.cuda
def test_timeline_graph_decode_equals_eager(tmp_path):
    """The serving options: chunks, blank collapse, two length groups (one graph key, two decodes)."""
    _cuda()
    dec = P.TorchBeamSearchDecoderCTC(P.Alphabet.build_alphabet(SAMPLE_LABELS), _lm(tmp_path))
    for chunk in (2, 5):
        kw = dict(beam_width=BEAM, prune_history=True, token_chunking=chunk, blank_collapse=True,
                  length_bucketing=2, top_n=2)
        eager_used, graph_used = _assert_graphs_equal_eager(dec, BATCH, **kw)
        assert graph_used[1] == eager_used[1] == 2  # one finalize a group
        assert graph_used[4] == eager_used[4] == 2  # and one backtrace
        assert graph_used[0] >= eager_used[0]


@pytest.mark.cuda
def test_two_members_with_hotwords_graph_decode_equals_eager(tmp_path):
    """Two members (one scores ``</s>``) and hotwords, dense and serving; a new hotword set is a new key."""
    _cuda()
    lm = P.MultiLanguageModel([_lm(tmp_path), _lm(tmp_path, "b", ARPA_2GRAM, alpha=0.3, beta=2.0,
                                                  score_boundary=False)])
    dec = P.TorchBeamSearchDecoderCTC(P.Alphabet.build_alphabet(SAMPLE_LABELS), lm)
    for hotwords in (["bugs bunny", "sun"], ["guns", "nun"]):
        for extra in ({}, dict(token_chunking=3, blank_collapse=True, length_bucketing=2)):
            kw = dict(beam_width=BEAM, prune_history=True, hotwords=hotwords, hotword_weight=8.0, **extra)
            _assert_graphs_equal_eager(dec, BATCH, **kw)
    assert len(dec._graphs) == 4


@pytest.mark.cuda
def test_bpe_graph_decode_equals_eager(tmp_path):
    """A piece vocabulary (labels up to 5 chars, ``▁⁇▁`` mid-utterance), dense and serving."""
    _cuda()
    alphabet = P.Alphabet.build_alphabet(piece_vocabulary(LM_WORDS))
    dec = P.TorchBeamSearchDecoderCTC(alphabet, _lm(tmp_path))
    batch = [piece_logits(seed, alphabet.labels, 8) for seed in range(3)]
    for kw in (dict(beam_width=BEAM), dict(beam_width=BEAM, token_chunking=3, blank_collapse=True,
                                           length_bucketing=2, hotwords=["guns", "sunny bun"])):
        _assert_graphs_equal_eager(dec, batch, prune_history=True, **kw)


@pytest.mark.cuda
def test_reset_params_after_capture_takes_effect(tmp_path):
    """A captured graph reads alpha, beta, the unk offset and the prunes at every replay."""
    _cuda()
    dec = P.TorchBeamSearchDecoderCTC(P.Alphabet.build_alphabet(SAMPLE_LABELS), _lm(tmp_path))
    kw = dict(beam_width=BEAM, prune_history=True)
    before = dec.decode_beams_batch(BATCH, **kw)
    assert dec._graphs
    dec.reset_params(alpha=2.5, beta=-1.0, unk_score_offset=-3.0, score_boundary=False)
    eager = dec.with_options(segment_frames=0)
    for call_kw in (kw, dict(kw, beam_prune_logp=-4.0, token_min_logp=-3.0)):
        got = dec.decode_beams_batch(BATCH, **call_kw)
        _assert_bit_equal(eager.decode_beams_batch(BATCH, **call_kw), got)
    assert [b[0].lm_score for b in got] != [b[0].lm_score for b in before]
    assert len(dec._graphs) == 1  # one capture served every call


@pytest.mark.cuda
def test_pipelined_batches_equal_serial(tmp_path):
    """``decode_beams_batches`` launches batch i + 1 before it fetches batch i, on the same graph."""
    _cuda()
    dec = P.TorchBeamSearchDecoderCTC(P.Alphabet.build_alphabet(SAMPLE_LABELS), _lm(tmp_path))
    batches = [BATCH, BATCH[::-1], [word_logits(24, 40), word_logits(25, 33), word_logits(26, 20)]]
    for kw in (dict(beam_width=BEAM), dict(beam_width=BEAM, token_chunking=True, blank_collapse=True)):
        serial = [dec.decode_beams_batch(b, prune_history=True, **kw) for b in batches]
        piped = list(dec.decode_beams_batches(batches, pipeline_depth=2, prune_history=True, **kw))
        for want, got in zip(serial, piped):
            _assert_bit_equal(want, got)


@pytest.mark.cuda
def test_graphs_capture_again_after_the_cache_empties_or_evicts(tmp_path):
    """A cleared cache (parked tables) takes a new memory pool; the key past ``GRAPH_KEYS`` evicts the oldest."""
    _cuda()
    dec = P.TorchBeamSearchDecoderCTC(P.Alphabet.build_alphabet(SAMPLE_LABELS), _lm(tmp_path))
    eager = dec.with_options(segment_frames=0)
    want = eager.decode_beams_batch(BATCH, beam_width=BEAM)
    for _ in range(2):
        _assert_bit_equal(want, dec.decode_beams_batch(BATCH, beam_width=BEAM))
        dec._graphs.clear()
    limit = GRAPH_KEYS
    rows = BATCH * (limit // len(BATCH) + 1)
    with profiling.tracing() as tr:
        for n in range(1, limit + 2):  # batch_pad=1: one key a row count
            got = dec.decode_beams_batch(rows[:n], beam_width=BEAM, batch_pad=1)
    assert len(dec._graphs) == limit and tr.counters()["graph.evictions"] == 1
    _assert_bit_equal(eager.decode_beams_batch(rows[: limit + 1], beam_width=BEAM, batch_pad=1), got)
    one = dict(beam_width=BEAM, batch_pad=1)
    _assert_bit_equal(eager.decode_beams_batch(rows[:1], **one), dec.decode_beams_batch(rows[:1], **one))
    assert len(dec._graphs) == limit  # N = 1 was evicted, is captured again, and evicts N = 2


@pytest.mark.cuda
def test_fast_topk_graph_decode_equals_exact_ranking(tmp_path):
    """``fast_topk`` under graphs: the exact ranking's results on these cases (no boundary ties)."""
    _cuda()
    dec = P.TorchBeamSearchDecoderCTC(P.Alphabet.build_alphabet(SAMPLE_LABELS), _lm(tmp_path))
    fast = dec.with_options(fast_topk=True)
    for kw in (dict(beam_width=BEAM), dict(beam_width=BEAM, token_chunking=True, blank_collapse=True)):
        want = dec.decode_beams_batch(BATCH, prune_history=True, **kw)
        got = fast.decode_beams_batch(BATCH, prune_history=True, **kw)
        for w, g in zip(want, got):
            assert [b.text for b in g] == [b.text for b in w]
            assert_same_beams(w, g)


@pytest.mark.cuda
def test_a_capture_error_raises(tmp_path, monkeypatch):
    """A host sync inside the segment makes the capture fail: the decode raises, nothing runs eagerly
    instead, and the launches counted under the failed capture are taken back."""
    _cuda()
    dec = P.TorchBeamSearchDecoderCTC(P.Alphabet.build_alphabet(SAMPLE_LABELS), _lm(tmp_path))
    replay = engine.replay_winners

    def syncing_replay(state, *args):
        state["logit"].max().item()  # a device-to-host read: not allowed while a stream captures
        return replay(state, *args)

    body, at_capture = engine.SegmentGraph._body, []

    def watched_body(graph):
        if torch.cuda.is_current_stream_capturing():
            at_capture.append([fn.launches for fn in WRAPPERS])
        body(graph)

    monkeypatch.setattr(engine, "replay_winners", syncing_replay)
    monkeypatch.setattr(engine.SegmentGraph, "_body", watched_body)
    with pytest.raises(RuntimeError):
        dec.decode_beams_batch(BATCH, beam_width=BEAM)
    torch.cuda.synchronize()
    # the failed capture launched nothing, so it leaves no count behind
    assert len(at_capture) == 1
    assert [fn.launches for fn in WRAPPERS] == at_capture[0]


@pytest.fixture
def nccl_mesh():
    """A one-process NCCL group on 127.0.0.1 (a free port) and its mesh; destroyed after the test."""
    import socket

    import torch.distributed as dist

    from pyctcdecode_torch.parallel import make_data_mesh
    from pyctcdecode_torch.parallel.launch import initialize_from_env

    _cuda()
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    assert initialize_from_env(coordinator=f"127.0.0.1:{port}", num_processes=1, process_id=0)
    try:
        yield make_data_mesh()
    finally:
        dist.destroy_process_group()


def _captures(monkeypatch) -> list:
    """A list that grows by one at every capture, segment or finalize graph."""
    made, capture = [], engine._Captured._capture

    def counted(program):
        made.append(type(program).__name__)
        capture(program)

    monkeypatch.setattr(engine._Captured, "_capture", counted)
    return made


@pytest.mark.cuda
@pytest.mark.parametrize("options", ["dense", "serving"])
def test_sharded_graph_decode_equals_eager_and_unsharded(tmp_path, nccl_mesh, monkeypatch, options):
    """World size 1 over NCCL, ``collect_stats`` on: graphs = the eager sharded column = the unsharded graphs.

    The launches are the unsharded graph decode's, the finalize's two probes
    included, except the word commit: over the row-sharded tables it is the
    PyTorch composition, one collective probe a step, where the unsharded
    decoder launches ``commit_words``; a second call replays every graph and
    captures none.
    """
    from pyctcdecode_torch.parallel import ShardedCTCDecoder

    dec = P.TorchBeamSearchDecoderCTC(P.Alphabet.build_alphabet(SAMPLE_LABELS), _lm(tmp_path))
    sharded = ShardedCTCDecoder(dec, mesh=nccl_mesh, shard_lm=True)
    eager = ShardedCTCDecoder(dec.with_options(segment_frames=0), mesh=nccl_mesh, shard_lm=True)
    kw = dict(beam_width=BEAM, prune_history=True, collect_stats=True)
    if options == "serving":
        kw.update(token_chunking=3, blank_collapse=True)
    (plain, plain_stats), plain_used = _counted(dec, BATCH, **kw)
    (want, want_stats), eager_used = _counted(eager, BATCH, **kw)
    made = _captures(monkeypatch)
    (got, got_stats), graph_used = _counted(sharded, BATCH, **kw)
    _assert_bit_equal(want, got)
    _assert_bit_equal(plain, got)
    assert got_stats == want_stats == plain_stats
    steps = graph_used[0]
    # the unsharded graph decode's launches, but its word commit in the composition over the
    # collective probe: one probe a step in place of the commit kernel
    assert graph_used[:3] + graph_used[4:5] == plain_used[:3] + plain_used[4:5]
    assert graph_used[5] == eager_used[5] == 0 and plain_used[5] == steps
    assert graph_used[3] == steps + plain_used[3]
    assert steps % 16 == 0 and steps >= eager_used[0]
    assert graph_used[3] - steps == eager_used[3] - eager_used[0] == 2  # the finalize's probes: last word, </s>
    keys = [key for key in dec._graphs if key[3] == id(sharded._tabs)]
    assert len(keys) == 1 and len(dec._graphs) == 2  # the sharded key beside the unsharded one
    graph = dec._graphs[keys[0]]
    assert graph.graph is not None and all(f.graph is not None for f in graph.finals.values())
    assert made == ["SegmentGraph", "FinalizeGraph"]
    held = (graph.graph, [f.graph for f in graph.finals.values()])
    (again, again_stats), again_used = _counted(sharded, BATCH, **kw)
    _assert_bit_equal(want, again)
    assert again_stats == want_stats and again_used == graph_used
    assert made == ["SegmentGraph", "FinalizeGraph"]  # replays only
    assert (graph.graph, [f.graph for f in graph.finals.values()]) == held


@pytest.mark.cuda
def test_a_capture_error_in_the_collective_probe_raises(tmp_path, nccl_mesh, monkeypatch):
    """A host sync inside ``probe_rows_sharded`` during a capture: the decode raises and nothing reruns eagerly."""
    from pyctcdecode_torch.models import device_tables
    from pyctcdecode_torch.parallel import ShardedCTCDecoder

    dec = P.TorchBeamSearchDecoderCTC(P.Alphabet.build_alphabet(SAMPLE_LABELS), _lm(tmp_path))
    sharded = ShardedCTCDecoder(dec, mesh=nccl_mesh, shard_lm=True)
    probe, calls = device_tables.probe_rows_sharded, []

    def syncing_probe(shard, full, *args):
        capturing = torch.cuda.is_current_stream_capturing()
        calls.append(capturing)
        if capturing:
            full.max().item()  # a device-to-host read: not allowed while a stream captures
        return probe(shard, full, *args)

    monkeypatch.setattr(device_tables, "probe_rows_sharded", syncing_probe)
    with pytest.raises(RuntimeError):
        sharded.decode_beams_batch(BATCH, beam_width=BEAM)
    torch.cuda.synchronize()
    # the eager first run of the first segment (16 steps), then the failed capture's first probe: no rerun
    assert calls == [False] * 16 + [True]

