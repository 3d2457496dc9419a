"""The stream run in segments, held against the JAX package chunk by chunk.

On the card a stream's chunk runs as segments of ``segment_frames`` steps,
each a replay of a captured CUDA graph, the chunk's logits padded with
zeros to whole segments (the padded steps are inactive), and the
backpointer logs cut back to the chunk's frames
(``tests/test_torch_stream_graphs_cuda.py``). Here the same segmented
chunk runs eagerly: ``with_options(segment_frames=S)`` on a
``device="cpu"`` decoder, for S = 1, 4 and 16, against the JAX
``TPUBeamSearchDecoderCTC``'s device stream (``get_starting_state`` /
``partial_decode_beams``, which pads each chunk to a bucket of 64 frames
with inactive steps). After every call the ranked views must agree (texts,
partial words, frame spans and last labels identical; scores within 1e-4,
both engines score in float32), and so must the carried beam states at
live slots (integer planes exact).

The segmented stream is also held against the port's own eager stream
(``segment_frames=0``, one step a frame, no padding) to the bit: views,
every carried state plane, and the host copies of the cut logs. Chunk
lengths 1, 7 and 25 are no multiple of 4 or 16, and one chunk is empty.
"""
import numpy as np
import pytest
import torch

import pyctcdecode_torch as P
from pyctcdecode_torch.engine import make_stream_fns
from pyctcdecode_torch.models.ngram import open_ngram_file
from pyctcdecode_tpu import Alphabet as JAlphabet
from pyctcdecode_tpu import LanguageModel as JLanguageModel
from pyctcdecode_tpu import MultiLanguageModel as JMultiLanguageModel
from pyctcdecode_tpu import TPUBeamSearchDecoderCTC
from pyctcdecode_tpu.models.ngram import NGramModel as JNGramModel

from .helpers import SAMPLE_LABELS
from .torch_cases import (
    ARPA,
    ARPA_2GRAM,
    LM_WORDS,
    UNIGRAMS,
    assert_same_stream_state,
    assert_same_views,
    conformer_width,
    piece_logits,
    piece_vocabulary,
    word_logits,
)
from .torch_cases import one_torch_thread  # noqa: F401  (autouse fixture)

SEGMENTS = [1, 4, 16]
WIDE = conformer_width(piece_vocabulary(LM_WORDS))  # V = 129
MEMBER_B = dict(alpha=0.3, beta=2.0, unk_score_offset=-6.0, score_boundary=False)


@pytest.fixture(scope="module")
def decoders(tmp_path_factory):
    """(JAX, torch eager) decoder pairs by kind, built on first use."""
    root = tmp_path_factory.mktemp("lm")
    paths = {}
    for name, text in (("3", ARPA), ("2", ARPA_2GRAM)):
        paths[name] = str(root / f"bb{name}.arpa")
        with open(paths[name], "w") as fh:
            fh.write(text)
    cache = {}

    def lm_pair(order, **kw):
        return (JLanguageModel(JNGramModel.from_file(paths[order]), UNIGRAMS, **kw),
                P.LanguageModel(open_ngram_file(paths[order]), UNIGRAMS, **kw))

    def get(kind):
        if kind not in cache:
            labels = WIDE if kind == "wide" else SAMPLE_LABELS
            if kind == "none":
                jlm = plm = None
            elif kind == "two":
                (ja, pa), (jb, pb) = lm_pair("3"), lm_pair("2", **MEMBER_B)
                jlm, plm = JMultiLanguageModel([ja, jb]), P.MultiLanguageModel([pa, pb])
            else:
                jlm, plm = lm_pair("3")
            cache[kind] = (
                TPUBeamSearchDecoderCTC(JAlphabet.build_alphabet(labels), jlm),
                P.TorchBeamSearchDecoderCTC(P.Alphabet.build_alphabet(labels), plm, device="cpu",
                                            segment_frames=0),
            )
        return cache[kind]

    return get


def _calls(n, force_at=None, **kw):
    return [dict(kw, force_next_word=(i == force_at), is_end=(i == n - 1)) for i in range(n)]


def _case(name):
    """(decoder kind, logits, cuts, start kwargs, per-call kwargs)."""
    cuts = [0, 1, 8, 8, 33, 45]  # chunks of 1, 7, 0, 25 and 12 frames
    if name == "no_lm":
        return "none", word_logits(7, 45), cuts, dict(beam_width=8), _calls(5)
    if name == "lm":
        return "lm", word_logits(8, 45), cuts, dict(beam_width=8, prune_history=True), _calls(5)
    if name == "lm_force_next_word":
        return "lm", word_logits(9, 45), cuts, dict(beam_width=8), _calls(5, force_at=3)
    if name == "two_members_hotword_swap":
        calls = _calls(5)
        for kw, hot in zip(calls, (["bugs"], ["bugs"], ["bugs", "gun"], ["bunny sun"], ["bunny sun"])):
            kw.update(hotwords=hot, hotword_weight=6.0)
        return "two", word_logits(11, 45), cuts, dict(beam_width=8, hotwords_enabled=True), calls
    if name == "bpe_wide":
        labels = P.Alphabet.build_alphabet(WIDE).labels
        mat = piece_logits(12, labels, 6)
        return "wide", mat, [0, 1, 8, 8, 33, mat.shape[0]], dict(beam_width=8), _calls(5, force_at=2)
    if name == "beam_25":
        return "lm", word_logits(10, 45), cuts, dict(beam_width=25), _calls(5)
    raise KeyError(name)


CASES = ["no_lm", "lm", "lm_force_next_word", "two_members_hotword_swap", "bpe_wide", "beam_25"]


def _logs(state):
    return [(p.copy(), t.copy(), o) for p, t, o in state.chunks]


def _run(dec, mat, cuts, start_kw, calls):
    """One stream: its views, carried states and backpointer logs after every call."""
    state = dec.get_starting_state(**start_kw)
    out = []
    for (a, b), kw in zip(zip(cuts[:-1], cuts[1:]), calls):
        view = dec.partial_decode_beams(state, mat[a:b], **kw)
        out.append((view, {k: v.clone() for k, v in state.beam_state.items()}, _logs(state), state))
    return out


@pytest.mark.parametrize("seg", SEGMENTS)
@pytest.mark.parametrize("name", CASES)
def test_segmented_stream_matches_jax_chunk_by_chunk(decoders, name, seg):
    kind, mat, cuts, start_kw, calls = _case(name)
    jdec, eager = decoders(kind)
    segmented = eager.with_options(segment_frames=seg)
    assert segmented._segment_frames_effective() == seg
    js = jdec.get_starting_state(**start_kw)
    got = _run(segmented, mat, cuts, start_kw, calls)
    want = _run(eager, mat, cuts, start_kw, calls)
    for (a, b), kw, (view, state, logs, _), (e_view, e_state, e_logs, _) in zip(
            zip(cuts[:-1], cuts[1:]), calls, got, want):
        j_view = jdec.partial_decode_beams(js, mat[a:b], **kw)
        assert_same_views(j_view, view)
        assert_same_stream_state(js.beam_state, state)
        # the padded steps change nothing: the eager stream's views, state and logs to the bit
        assert_same_views(e_view, view, tol=0.0)
        assert set(state) == set(e_state)
        for key in state:
            assert torch.equal(state[key], e_state[key]), key
        assert len(logs) == len(e_logs)
        for (p, t, o), (ep, et, eo) in zip(logs, e_logs):
            assert o == eo and p.dtype == ep.dtype and t.dtype == et.dtype
            np.testing.assert_array_equal(p, ep)
            np.testing.assert_array_equal(t, et)
    assert got[-1][3].processed_frames == cuts[-1]
    assert got[-1][3].chunks == []  # the end commits


def test_padded_segment_steps_are_inactive():
    """A chunk of 5 frames in segments of 16: the 11 padded steps leave the state as the 5 steps do."""
    dec = P.TorchBeamSearchDecoderCTC(P.Alphabet.build_alphabet(SAMPLE_LABELS), device="cpu")
    cfg = dec._engine_cfg(8, len(SAMPLE_LABELS), True, False)
    params = dec._params_vector(-5.0, -10.0)
    logp = torch.log_softmax(torch.as_tensor(word_logits(3, 5)), dim=-1)[None]
    init_fn, eager_chunk, _ = make_stream_fns(cfg, dec._tabs)
    _, seg_chunk, _ = make_stream_fns(cfg, dec._tabs, 16)
    want = eager_chunk(init_fn(()), logp, params)
    got = seg_chunk(init_fn(()), logp, params)
    for key in want[0]:
        assert torch.equal(got[0][key], want[0][key]), key
    assert got[1].shape == want[1].shape == (1, 5, 8)
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
