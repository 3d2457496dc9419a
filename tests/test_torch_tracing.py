"""The host tracer (``pyctcdecode_torch.utils.profiling.tracing``): spans and counters of the port's calls.

Off by default: nothing is recorded, and a trace closed records no more.
On, every public call has one root span (``build``, ``batch``,
``stream.start``, ``chunk``) with a call id of its own (a stream's chunks
take the id of its ``get_starting_state``), and its stages follow one
another under it in the order the work runs, each inside the root. The
step counters equal what the shapes give, and the outputs with tracing on
equal those with it off, to the bit. The CPU decoders here run the eager
loop, and with ``segment_frames`` the segmented one that the card replays
as graphs; the ``cuda`` test holds the graph cache's spans and counters.

The module imports neither JAX nor the JAX package, so its ``cuda`` test
runs on the card with ``python -m pytest --noconftest -m cuda
tests/test_torch_tracing.py``.
"""
import numpy as np
import pytest
import torch

import pyctcdecode_torch as P
from pyctcdecode_torch.models.ngram import open_ngram_file
from pyctcdecode_torch.ops import kernel_wrappers
from pyctcdecode_torch.utils import profiling

from .helpers import SAMPLE_LABELS
from .torch_cases import ARPA, UNIGRAMS, assert_same_beams, assert_same_views, word_logits
from .torch_cases import one_torch_thread  # noqa: F401  (autouse fixture)

BEAM = 8
BATCH = [word_logits(31, 45), word_logits(32, 17), word_logits(33, 38)]
BATCH_STAGES = ["batch.prep", "batch.upload", "batch.enqueue", "batch.fetch", "batch.replay"]
CHUNK_STAGES = ["chunk.prep", "chunk.upload", "chunk.enqueue", "chunk.fetch", "chunk.backtrace", "chunk.replay"]
BUILD_STAGES = ["build.read_lm", "build.unigrams", "build.language_model", "build.device_lm", "build.upload"]


@pytest.fixture(scope="module")
def arpa_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("lm") / "bb.arpa"
    path.write_text(ARPA)
    return str(path)


@pytest.fixture(scope="module")
def decoder(arpa_path):
    alphabet = P.Alphabet.build_alphabet(SAMPLE_LABELS)
    return P.TorchBeamSearchDecoderCTC(alphabet, P.LanguageModel(open_ngram_file(arpa_path), UNIGRAMS),
                                       device="cpu")


def _roots(spans, name):
    return [s for s in spans if s.name == name and s.parent < 0]


def _children(spans, root):
    return [s for s in spans if s.parent == root.index]


def _assert_tiled(spans, root, names):
    """``root``'s children are ``names`` in order, one after another inside it, with its call id."""
    kids = _children(spans, root)
    assert [s.name for s in kids] == names
    assert all(s.call == root.call and s.end_ns is not None for s in kids)
    assert root.start_ns <= kids[0].start_ns and kids[-1].end_ns <= root.end_ns
    for a, b in zip(kids, kids[1:]):
        assert a.end_ns <= b.start_ns


def test_tracing_is_off_by_default_and_records_nothing_after_it_closes(decoder):
    assert profiling.TRACER is None
    decoder.decode_beams_batch(BATCH[:1], beam_width=BEAM)
    with profiling.tracing() as tr:
        assert profiling.TRACER is tr
    assert profiling.TRACER is None
    decoder.decode_beams_batch(BATCH[:1], beam_width=BEAM)
    state = decoder.get_starting_state(beam_width=BEAM)
    decoder.partial_decode_beams(state, BATCH[0][:10], is_end=True)
    spans, counters = tr.drain()
    assert spans == [] and all(n == 0 for n in counters.values())
    assert state.call_id == -1


def test_build_records_its_stages_under_one_root(arpa_path):
    with profiling.tracing() as tr:
        P.build_ctcdecoder(SAMPLE_LABELS, arpa_path, device="cpu")
        P.build_ctcdecoder(SAMPLE_LABELS, arpa_path, device="cpu")
    spans, _ = tr.drain()
    roots = _roots(spans, "build")
    assert len(roots) == 2 and roots[0].call != roots[1].call
    for root in roots:
        _assert_tiled(spans, root, BUILD_STAGES)


@pytest.mark.parametrize("mode,kw,stages", [
    ("dense", {}, BATCH_STAGES),
    ("timeline", dict(token_chunking=True, blank_collapse=True), BATCH_STAGES),
    ("bucketed", dict(length_bucketing=2), BATCH_STAGES[:3] * 2 + BATCH_STAGES[3:] * 2),
])
def test_batch_call_records_its_stages_under_one_root(decoder, mode, kw, stages):
    with profiling.tracing() as tr:
        decoder.decode_beams_batch(BATCH, beam_width=BEAM, **kw)
        decoder.decode_batch(BATCH, beam_width=BEAM, **kw)
    spans, _ = tr.drain()
    roots = _roots(spans, "batch")
    assert len(roots) == 2 and roots[0].call != roots[1].call
    assert len(spans) == 2 * (1 + len(stages))  # decode_batch's inner decode_beams_batch opens no root of its own
    for root in roots:
        _assert_tiled(spans, root, stages)


def test_single_decodes_and_pipelined_batches_have_one_root_each(decoder):
    with profiling.tracing() as tr:
        decoder.decode(BATCH[0], beam_width=BEAM)
        decoder.decode_beams(BATCH[1], beam_width=BEAM)
        list(decoder.decode_beams_batches([BATCH, BATCH[:2], BATCH[1:]], pipeline_depth=1, beam_width=BEAM))
    spans, _ = tr.drain()
    roots = _roots(spans, "batch")
    assert len(roots) == 5 and len({r.call for r in roots}) == 5
    for root in roots:
        _assert_tiled(spans, root, BATCH_STAGES)
    # the second batch was launched before the first was collected
    first, second = roots[2], roots[3]
    assert _children(spans, second)[0].start_ns < _children(spans, first)[-2].start_ns


def test_stream_chunks_share_their_stream_id(decoder):
    mat = word_logits(41, 60)
    with profiling.tracing() as tr:
        a = decoder.get_starting_state(beam_width=BEAM)
        b = decoder.get_starting_state(beam_width=BEAM)
        for i in range(3):
            decoder.partial_decode_beams(a, mat[20 * i : 20 * (i + 1)], force_next_word=i == 1, is_end=i == 2)
        decoder.partial_decode_beams(b, mat[:25])
    spans, _ = tr.drain()
    starts, chunks = _roots(spans, "stream.start"), _roots(spans, "chunk")
    assert len(starts) == 2 and [a.call_id, b.call_id] == [s.call for s in starts] and a.call_id != b.call_id
    assert [c.call for c in chunks] == [a.call_id] * 3 + [b.call_id]
    for chunk in chunks:
        _assert_tiled(spans, chunk, CHUNK_STAGES)


def test_a_stream_started_untraced_takes_an_id_at_its_first_traced_chunk(decoder):
    state = decoder.get_starting_state(beam_width=BEAM)
    with profiling.tracing() as tr:
        decoder.partial_decode_beams(state, BATCH[0][:20])
        decoder.partial_decode_beams(state, BATCH[0][20:], is_end=True)
    chunks = _roots(tr.drain()[0], "chunk")
    assert state.call_id >= 0 and [c.call for c in chunks] == [state.call_id] * 2


@pytest.mark.parametrize("seg", [0, 16])
def test_step_counters_count_what_the_shapes_give(decoder, seg):
    dec = decoder.with_options(segment_frames=seg)
    lens = [m.shape[0] for m in BATCH]
    with profiling.tracing() as tr:
        dec.decode_beams_batch(BATCH, beam_width=BEAM)  # padded to 8 rows
        _, batch = tr.drain()
        state = dec.get_starting_state(beam_width=BEAM)
        dec.partial_decode_beams(state, word_logits(42, 25))
        dec.partial_decode_beams(state, word_logits(43, 7), is_end=True)
        _, stream = tr.drain()
    t_pad = -(-max(lens) // seg) * seg if seg else max(lens)
    assert batch["steps.active"] == sum(lens) and batch["steps.launched"] == 8 * t_pad
    assert stream["steps.active"] == 25 + 7
    assert stream["steps.launched"] == (32 + 16 if seg else 25 + 7)


def test_counters_take_in_the_kernel_wrappers_launches(decoder):
    """``launches.<wrapper>``: what each wrapper's own counter added since the trace began or was drained."""
    wrappers = kernel_wrappers()
    with profiling.tracing() as tr:
        before = [fn.launches for fn in wrappers]
        decoder.decode_beams_batch(BATCH, beam_width=BEAM)
        first = tr.counters()
        added = {f"launches.{fn.__name__}": fn.launches - n for fn, n in zip(wrappers, before)}
        _, drained = tr.drain()
        decoder.decode_beams_batch(BATCH, beam_width=BEAM)
        second = tr.counters()
    assert {key: first[key] for key in added} == added  # kernels count on the card only: 0 each here
    assert first == drained and second == first


@pytest.mark.parametrize("kw", [{}, dict(token_chunking=True, blank_collapse=True), dict(length_bucketing=2)])
def test_batch_outputs_are_the_same_with_tracing_on(decoder, kw):
    want = decoder.decode_beams_batch(BATCH, beam_width=BEAM, **kw)
    with profiling.tracing():
        got = decoder.decode_beams_batch(BATCH, beam_width=BEAM, **kw)
    for w, g in zip(want, got):
        assert_same_beams(w, g, tol=0.0)


def test_stream_views_are_the_same_with_tracing_on(decoder):
    mat = word_logits(44, 60)

    def views():
        state = decoder.with_options(segment_frames=16).get_starting_state(beam_width=BEAM)
        dec = decoder.with_options(segment_frames=16)
        return [dec.partial_decode_beams(state, mat[20 * i : 20 * (i + 1)], force_next_word=i == 1, is_end=i == 2)
                for i in range(3)]

    want = views()
    with profiling.tracing():
        got = views()
    for w, g in zip(want, got):
        assert_same_views(w, g, tol=0.0)


def test_a_failed_call_closes_its_spans(decoder):
    with profiling.tracing() as tr:
        with pytest.raises(ValueError):
            decoder.decode_beams_batch([np.zeros((5, 3), dtype=np.float32)], beam_width=BEAM)
        decoder.decode_beams_batch(BATCH[:1], beam_width=BEAM)
    spans, _ = tr.drain()
    roots = _roots(spans, "batch")
    assert len(roots) == 2 and all(s.end_ns is not None for s in spans)
    assert [s.name for s in _children(spans, roots[0])] == ["batch.prep"]
    _assert_tiled(spans, roots[1], BATCH_STAGES)


@pytest.mark.cuda
def test_graph_cache_spans_and_counters(arpa_path):
    """Captures as ``graph.capture`` spans inside the enqueue; lookups, captures and evictions as counters."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: graphs have no CPU mode")
    from pyctcdecode_torch.torch_decoder import GRAPH_KEYS

    dec = P.TorchBeamSearchDecoderCTC(P.Alphabet.build_alphabet(SAMPLE_LABELS),
                                      P.LanguageModel(open_ngram_file(arpa_path), UNIGRAMS))
    with profiling.tracing() as tr:
        dec.decode_beams_batch(BATCH, beam_width=BEAM)
        spans, first = tr.drain()
        dec.decode_beams_batch(BATCH, beam_width=BEAM)
        again, second = tr.drain()
    captures = [s for s in spans if s.name == "graph.capture"]
    assert [s.note for s in captures] == ["segment", "finalize"]
    enqueue = next(s for s in spans if s.name == "batch.enqueue")
    assert all(s.parent == enqueue.index and s.call == enqueue.call for s in captures)
    assert first["graph.captures"] == 2 and first["graph.misses"] == 2 and first.get("graph.hits", 0) == 0
    assert second.get("graph.captures", 0) == 0 and second["graph.hits"] == 2
    assert not [s for s in again if s.name == "graph.capture"]
    rows = BATCH * (GRAPH_KEYS // len(BATCH) + 1)
    with profiling.tracing() as tr:
        for n in range(1, GRAPH_KEYS + 2):  # batch_pad=1: one key a row count
            dec.decode_beams_batch(rows[:n], beam_width=BEAM, batch_pad=1)
    # the 8 rows of the first calls are one of the row counts: 1 + GRAPH_KEYS keys for a cache of GRAPH_KEYS
    assert len(dec._graphs) == GRAPH_KEYS and tr.counters()["graph.evictions"] == 1
