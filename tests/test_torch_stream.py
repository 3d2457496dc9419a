"""Streaming on the port's device engine, held against the JAX package chunk by chunk.

``TorchBeamSearchDecoderCTC(device="cpu")`` against the JAX
``TPUBeamSearchDecoderCTC``: the same stream settings, the same inline ARPA
models and the same logits made with numpy from seeds, cut into the same
chunks. After every ``partial_decode_beams`` call the ranked views must
agree (texts, partial words, frame spans and last labels identical; scores
within 1e-4, both engines score in float32), and so must the carried beam
states at live slots (hash lanes bit-equal after masking to 32 bits, the
other integer planes equal, ``logit``, ``fused`` and the backoffs within
1e-4). The cases cover no LM, one LM, two members, hotwords swapped between
chunks, a BPE alphabet with ``▁⁇▁`` at a chunk's end, ``force_next_word``
mid-stream, empty chunks, and a dev-other utterance at beam 100.

The port is also held against itself: the chunked stream equals its full
decode, at beam 200 too, where the parent planes are 16-bit.

The JAX engine compiles one program per stream geometry, so the cases share
a few beam widths.
"""
import numpy as np
import pytest

import pyctcdecode_torch as P
from pyctcdecode_torch.engine import make_stream_fns
from pyctcdecode_torch.models import device_tables as tdt
from pyctcdecode_torch.models.ngram import open_ngram_file
from pyctcdecode_torch.ops.tokens import build_token_arrays
from pyctcdecode_torch.torch_decoder import _backtrace_chunks
from pyctcdecode_tpu import Alphabet as JAlphabet
from pyctcdecode_tpu import LanguageModel as JLanguageModel
from pyctcdecode_tpu import MultiLanguageModel as JMultiLanguageModel
from pyctcdecode_tpu import TPUBeamSearchDecoderCTC
from pyctcdecode_tpu.models import device_tables as jdt
from pyctcdecode_tpu.models.ngram import NGramModel as JNGramModel
from pyctcdecode_tpu.ops.tokens import build_token_arrays as jbuild_token_arrays
from pyctcdecode_tpu.tpu_decoder import _backtrace_chunks as jbacktrace_chunks

from .helpers import SAMPLE_LABELS, TEST_UNIGRAMS
from .torch_cases import (
    ARPA,
    ARPA_2GRAM,
    LM_WORDS,
    UNIGRAMS,
    assert_same_stream_state,
    assert_same_views,
    piece_logits,
    piece_vocabulary,
    word_logits,
)
from .torch_cases import one_torch_thread  # noqa: F401  (autouse fixture)

PIECES = piece_vocabulary(LM_WORDS)
MEMBER_B = dict(alpha=0.3, beta=2.0, unk_score_offset=-6.0, score_boundary=False)


@pytest.fixture(scope="module")
def arpas(tmp_path_factory):
    root = tmp_path_factory.mktemp("lm")
    paths = {}
    for name, text in (("3", ARPA), ("2", ARPA_2GRAM)):
        paths[name] = str(root / f"bb{name}.arpa")
        with open(paths[name], "w") as fh:
            fh.write(text)
    return paths


@pytest.fixture(scope="module")
def decoders(arpas):
    """(JAX, torch) decoder pairs by kind, built on first use."""
    cache = {}

    def lm_pair(order, unigrams=UNIGRAMS, **kw):
        return (JLanguageModel(JNGramModel.from_file(arpas[order]), unigrams, **kw),
                P.LanguageModel(open_ngram_file(arpas[order]), unigrams, **kw))

    def get(kind):
        if kind not in cache:
            labels = PIECES if kind == "pieces" else SAMPLE_LABELS
            if kind == "none":
                jlm = plm = None
            elif kind == "two":
                (ja, pa), (jb, pb) = lm_pair("3"), lm_pair("2", **MEMBER_B)
                jlm, plm = JMultiLanguageModel([ja, jb]), P.MultiLanguageModel([pa, pb])
            elif kind == "dev_other":
                jlm, plm = lm_pair("3", TEST_UNIGRAMS, alpha=0.6, beta=1.0)
            else:
                jlm, plm = lm_pair("3")
            cache[kind] = (
                TPUBeamSearchDecoderCTC(JAlphabet.build_alphabet(labels), jlm),
                P.TorchBeamSearchDecoderCTC(P.Alphabet.build_alphabet(labels), plm, device="cpu"),
            )
        return cache[kind]

    return get


def _chunks(mat, cuts):
    return [mat[a:b] for a, b in zip(cuts[:-1], cuts[1:])]


def run_streams(jdec, pdec, chunks, start_kw, call_kws):
    """Both streams over ``chunks``, views and carried states compared after every call."""
    js, ps = jdec.get_starting_state(**start_kw), pdec.get_starting_state(**start_kw)
    views, forced = [], []
    for chunk, kw in zip(chunks, call_kws):
        jv = jdec.partial_decode_beams(js, chunk, **kw)
        pv = pdec.partial_decode_beams(ps, chunk, **kw)
        assert_same_views(jv, pv)
        assert_same_stream_state(js.beam_state, ps.beam_state)
        views.append(pv)
        # live carried beams whose next token must start a word (after ▁⁇▁)
        forced.append(int((ps.beam_state["force"] & (ps.beam_state["logit"] > -1e29)).sum()))
    return views, forced, ps


def _calls(n, force_at=None, **kw):
    return [dict(kw, force_next_word=(i == force_at), is_end=(i == n - 1)) for i in range(n)]


def _unknown_piece_end(mat, labels):
    """The frame after the first run of ``▁⁇▁`` in ``mat``'s best path."""
    path, unk = mat.argmax(axis=1), labels.index("▁⁇▁")
    at = int(np.flatnonzero(path == unk)[0])
    while at + 1 < len(path) and path[at + 1] == unk:
        at += 1
    return at + 1


def _dev_other_utterance():
    from pyctcdecode_tpu.evaluation import DEV_OTHER_DIFFICULTY, synthesize_corpus

    corpus = synthesize_corpus(
        SAMPLE_LABELS, TEST_UNIGRAMS, n_utterances=2, seed=17,
        **dict(DEV_OTHER_DIFFICULTY, words_per_utterance=(4, 8)),
    )
    return max(corpus.logits, key=len)


def _case(name):
    """(decoder kind, chunks, start kwargs, per-call kwargs, whether the stream equals a full decode)."""
    if name == "no_lm":
        return "none", _chunks(word_logits(7, 40), [0, 7, 16, 29, 40]), dict(beam_width=8), _calls(4), True
    if name == "lm_empty_chunks":
        chunks = _chunks(word_logits(8, 40), [0, 0, 9, 9, 22, 40])
        return "lm", chunks, dict(beam_width=8, prune_history=True), _calls(5), True
    if name == "lm_force_next_word":
        chunks = _chunks(word_logits(9, 45), [0, 11, 23, 45])
        return "lm", chunks, dict(beam_width=8), _calls(3, force_at=1), False
    if name == "two_members_top_k":
        chunks = _chunks(word_logits(10, 40), [0, 13, 27, 40])
        return "two", chunks, dict(beam_width=8, max_tokens_per_frame=5), _calls(3), True
    if name == "hotword_swap":
        chunks = _chunks(word_logits(11, 48), [0, 10, 21, 33, 48])
        calls = _calls(4)
        for kw, hot in zip(calls, (["bugs"], ["bugs", "gun"], ["bunny sun"], None)):
            kw.update(hotwords=hot, hotword_weight=6.0)
        return "lm", chunks, dict(beam_width=8, prune_history=True, hotwords_enabled=True), calls, False
    if name in ("pieces_unknown_piece", "pieces_unknown_piece_force"):
        labels = P.Alphabet.build_alphabet(PIECES).labels
        mat = piece_logits(6, labels, 5)
        cut = _unknown_piece_end(mat, labels)
        chunks = _chunks(mat, [0, cut, mat.shape[0]])
        force = name.endswith("force")
        return "pieces", chunks, dict(beam_width=8), _calls(2, force_at=0 if force else None), not force
    if name == "dev_other_beam_100":
        mat = _dev_other_utterance()
        cuts = list(range(0, mat.shape[0], 25)) + [mat.shape[0]]
        calls = _calls(len(cuts) - 1, beam_prune_logp=-60.0, token_min_logp=-12.0)
        return "dev_other", _chunks(mat, cuts), dict(beam_width=100), calls, True
    raise KeyError(name)


CASES = ["no_lm", "lm_empty_chunks", "lm_force_next_word", "two_members_top_k", "hotword_swap",
         "pieces_unknown_piece", "pieces_unknown_piece_force", "dev_other_beam_100"]


@pytest.mark.parametrize("name", CASES)
def test_stream_matches_jax_chunk_by_chunk(decoders, name):
    kind, chunks, start_kw, calls, whole = _case(name)
    jdec, pdec = decoders(kind)
    views, forced, state = run_streams(jdec, pdec, chunks, start_kw, calls)
    if whole:
        # chunked == the port's own full decode of the utterance
        call = {k: v for k, v in calls[-1].items() if k not in ("force_next_word", "is_end")}
        full = pdec.decode_beams(np.concatenate(chunks), **start_kw, **call)
        assert len(full) == len(views[-1])
        for f, c in zip(full, views[-1]):
            assert (f.text, [wf[1] for wf in f.text_frames]) == (c.text, c.text_frames)
            assert abs(f.lm_score - c.lm_score) <= 1e-4 and abs(f.logit_score - c.logit_score) <= 1e-4
    if name == "pieces_unknown_piece":
        # live beams ended the first chunk right after the right-bounded piece
        assert forced[0] > 0
    if name == "pieces_unknown_piece_force":
        assert forced[0] == 0  # the commit clears the forced break
    if name == "lm_empty_chunks":
        assert views[0] and all(v.text == "" and v.partial_word == "" for v in views[0])
        assert [v.text for v in views[2]] == [v.text for v in views[1]]
    assert state.processed_frames == sum(c.shape[0] for c in chunks)


def test_force_commit_folds_the_backpointer_log(decoders):
    """A commit folds the transcripts into per-slot prefixes and drops the chunk log."""
    _, pdec = decoders("lm")
    mat = word_logits(9, 45)
    state = pdec.get_starting_state(beam_width=8)
    pdec.partial_decode_beams(state, mat[:11])
    assert len(state.chunks) == 1 and state.prefix_words is None
    view = pdec.partial_decode_beams(state, mat[11:23], force_next_word=True)
    assert state.chunks == [] and state.prefix_words is not None
    assert [" ".join(w) for w in state.prefix_words[: len(view)]] == [v.text for v in view]
    assert all(v.partial_word == "" and v.last_char is None for v in view)
    assert int(state.beam_state["p_len"].abs().sum()) == 0
    dead = state.beam_state["logit"][0] <= -1e29
    assert bool((state.beam_state["last_tok"][0][dead] <= -2).all())


@pytest.mark.parametrize("beam_width", [25, 200])
def test_stream_equals_full_decode_in_the_port(decoders, beam_width):
    """Beam 200 takes 16-bit parents (the 8-bit planes hold 127 slots)."""
    _, pdec = decoders("dev_other")
    mat = _dev_other_utterance()
    kw = dict(beam_prune_logp=-60.0, token_min_logp=-12.0)
    state = pdec.get_starting_state(beam_width=beam_width)
    chunks = _chunks(mat, list(range(0, mat.shape[0], 17)) + [mat.shape[0]])
    for i, chunk in enumerate(chunks):
        view = pdec.partial_decode_beams(state, chunk, is_end=(i == len(chunks) - 1), **kw)
    assert state.chunks == []  # the end commits
    full = pdec.decode_beams(mat, beam_width=beam_width, **kw)
    assert len(full) == len(view)
    if beam_width == 200:
        assert len(view) > 127
    for f, c in zip(full, view):
        assert f.text == c.text and [wf[1] for wf in f.text_frames] == c.text_frames
        assert abs(f.lm_score - c.lm_score) <= 1e-4


@pytest.mark.parametrize("seed", range(3))
def test_backtrace_of_all_ranks_matches_the_reference_walk(seed):
    """One vectorized walk over every start slot equals the reference's walk slot by slot."""
    rng = np.random.RandomState(seed)
    b, offset, chunks = 12, 0, []
    for tc in rng.randint(0, 9, size=4):
        chunks.append((rng.randint(0, b, (tc, b)).astype(np.int8),
                       rng.randint(-1, 8, (tc, b)).astype(np.int8), offset))
        offset += int(tc)
    slots = rng.permutation(b)[:7]
    toks, frames, origins = _backtrace_chunks(chunks, slots)
    for r, slot in enumerate(slots):
        want_toks, want_frames, want_origin = jbacktrace_chunks(chunks, int(slot))
        np.testing.assert_array_equal(toks[r], want_toks)
        np.testing.assert_array_equal(frames, want_frames)
        assert origins[r] == want_origin


def test_empty_hotword_tables_match_jax():
    for labels in (SAMPLE_LABELS, PIECES):
        want = jdt.empty_hotword_tables(jbuild_token_arrays(JAlphabet.build_alphabet(labels)))
        got = tdt.empty_hotword_tables(build_token_arrays(P.Alphabet.build_alphabet(labels)))
        assert set(got) == set(want)
        for key in want:
            np.testing.assert_array_equal(got[key], want[key])


def test_stream_rejects_what_the_reference_rejects(decoders):
    _, pdec = decoders("none")
    with pytest.raises(ValueError, match="max_tokens_per_frame"):
        pdec.get_starting_state(max_tokens_per_frame="auto")
    state = pdec.get_starting_state(beam_width=4)
    with pytest.raises(ValueError, match="hotwords_enabled"):
        pdec.partial_decode_beams(state, word_logits(3, 5), hotwords=["bugs"])
    with pytest.raises(ValueError, match="vocabulary"):
        pdec.partial_decode_beams(state, np.zeros((3, 5), dtype=np.float32))
    with pytest.raises(ValueError, match="token_timeline"):
        make_stream_fns(pdec._engine_cfg(4, 8, False, False, token_timeline=True), pdec._tabs)
