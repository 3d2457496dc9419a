"""The port's host oracle ``BeamSearchDecoderCTC``, held against the JAX package's, exactly.

Both are the same framework-free code over numpy float64 log-probs, on the
two packages' copies of the ARPA runtime, ``LanguageModel``,
``MultiLanguageModel`` and ``HotwordScorer``: the same inline ARPA models
and the same logits made with numpy from seeds must give equal beams, to
the last bit of every score. Cases: char and BPE alphabets, no LM, one LM,
two members, hotwords, ``decode_beams`` / ``decode`` / the batch calls, and
the streaming pair (``get_starting_state`` / ``partial_decode_beams``) with
a mid-stream ``force_next_word`` and a hotword swap.

Then the port's device stream is held against the port's host stream,
chunk by chunk: words, partial words and spans identical, scores within
2e-3 (float32 on the device, float64 on the host; the tolerance of the JAX
package's own device-against-host stream tests).
"""
import dataclasses

import numpy as np
import pytest

import pyctcdecode_torch as P
from pyctcdecode_torch.decoder import Beam
from pyctcdecode_torch.models.ngram import open_ngram_file
from pyctcdecode_tpu import Alphabet as JAlphabet
from pyctcdecode_tpu import BeamSearchDecoderCTC as JBeamSearchDecoderCTC
from pyctcdecode_tpu import LanguageModel as JLanguageModel
from pyctcdecode_tpu import MultiLanguageModel as JMultiLanguageModel
from pyctcdecode_tpu.decoder import Beam as JBeam
from pyctcdecode_tpu.models.hotwords import HotwordScorer as JHotwordScorer
from pyctcdecode_tpu.models.ngram import NGramModel as JNGramModel

from .helpers import SAMPLE_LABELS, TEST_LOGITS, MockContext, MockPool
from .torch_cases import (
    ARPA,
    ARPA_2GRAM,
    BPE_LABELS,
    LM_WORDS,
    UNIGRAMS,
    assert_same_views,
    piece_logits,
    piece_vocabulary,
    state_contexts,
    word_logits,
)
from .torch_cases import one_torch_thread  # noqa: F401  (autouse fixture)

PIECES = piece_vocabulary(LM_WORDS)
MEMBER_B = dict(alpha=0.3, beta=2.0, unk_score_offset=-6.0, score_boundary=False)
HOST_TOL = 2e-3  # float32 device against float64 host


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
def hosts(arpas):
    """(JAX, port) host decoder pairs by (labels, LM kind)."""
    labels = {"char": SAMPLE_LABELS, "bpe": BPE_LABELS, "pieces": PIECES}

    def lm_pair(order, **kw):
        return (JLanguageModel(JNGramModel.from_file(arpas[order]), UNIGRAMS, **kw),
                P.LanguageModel(open_ngram_file(arpas[order]), UNIGRAMS, **kw))

    def get(alphabet, lm):
        if lm == "none":
            jlm = plm = None
        elif lm == "two":
            (ja, pa), (jb, pb) = lm_pair("3"), lm_pair("2", **MEMBER_B)
            jlm, plm = JMultiLanguageModel([ja, jb]), P.MultiLanguageModel([pa, pb])
        else:
            jlm, plm = lm_pair("3")
        return (JBeamSearchDecoderCTC(JAlphabet.build_alphabet(labels[alphabet]), jlm),
                P.BeamSearchDecoderCTC(P.Alphabet.build_alphabet(labels[alphabet]), plm))

    yield get
    JBeamSearchDecoderCTC.clear_class_models()
    P.BeamSearchDecoderCTC.clear_class_models()


def assert_equal_output_beams(want, got):
    """Ranked OutputBeam lists, every field equal (scores to the bit, LM states by context)."""
    assert len(got) == len(want) > 0
    for wb, gb in zip(want, got):
        assert (gb.text, gb.text_frames) == (wb.text, wb.text_frames)
        assert (gb.logit_score, gb.lm_score) == (wb.logit_score, wb.lm_score)
        assert state_contexts(gb.last_lm_state) == state_contexts(wb.last_lm_state)


def assert_equal_lm_beams(want, got):
    assert len(got) == len(want) > 0
    for wb, gb in zip(want, got):
        assert dataclasses.astuple(gb) == dataclasses.astuple(wb)


def _logits(alphabet, seed):
    if alphabet == "char":
        return word_logits(seed, 36)
    if alphabet == "bpe":  # the JAX package's BPE fuzz: random logits
        return np.random.RandomState(13 + seed).randn(24, len(BPE_LABELS)) * 2.0
    return piece_logits(seed, P.Alphabet.build_alphabet(PIECES).labels, 5)


DECODE_CASES = [
    ("char", "none", {}),
    ("char", "lm", {}),
    ("char", "lm", dict(prune_history=True, beam_prune_logp=-6.0)),
    ("char", "lm", dict(hotwords=["bugs", "sunny bun"], hotword_weight=7.0)),
    ("char", "two", dict(prune_history=True)),
    ("char", "two", dict(hotwords=["gun"], token_min_logp=-3.0)),
    ("bpe", "lm", {}),
    ("pieces", "none", dict(hotwords=["buns"])),
    ("pieces", "lm", dict(prune_history=True)),
    ("pieces", "two", {}),
]


@pytest.mark.parametrize("alphabet,lm,kw", DECODE_CASES)
@pytest.mark.parametrize("seed", [0, 1])
def test_decode_beams_equals_jax_host(hosts, alphabet, lm, kw, seed):
    jdec, pdec = hosts(alphabet, lm)
    mat = _logits(alphabet, seed)
    assert_equal_output_beams(jdec.decode_beams(mat, beam_width=16, **kw),
                              pdec.decode_beams(mat, beam_width=16, **kw))
    kw = {k: v for k, v in kw.items() if k != "prune_history"}  # decode prunes history itself
    assert pdec.decode(mat, beam_width=16, **kw) == jdec.decode(mat, beam_width=16, **kw)


def test_batch_calls_equal_jax_host(hosts):
    jdec, pdec = hosts("char", "lm")
    mats = [word_logits(s, 20 + 3 * s) for s in range(4)] + [TEST_LOGITS]
    for pool_ctx in (None, MockContext()):
        pool = None if pool_ctx is None else MockPool(pool_ctx)
        want = jdec.decode_beams_batch(None, mats, beam_width=12)
        got = pdec.decode_beams_batch(pool, mats, beam_width=12)
        for w, g in zip(want, got):
            # beams from a pool carry no LM state (process-safe copies)
            assert_equal_output_beams([dataclasses.replace(b, last_lm_state=None) for b in w] if pool
                                      else w, g)
        assert pool is None or pool.map_has_run
        assert pdec.decode_batch(pool, mats, beam_width=12) == jdec.decode_batch(None, mats, beam_width=12)


def host_stream(dec, beam_cls, scorer_cls, chunks, calls, **kw):
    """One host stream over ``chunks``: the views after every call."""
    beams, lm_cache, p_cache = dec.get_starting_state()
    offset, views = 0, []
    for chunk, call in zip(chunks, calls):
        call = dict(call)
        hot = call.pop("hotwords", None)
        weight = call.pop("hotword_weight", 10.0)
        scorer = scorer_cls.build_scorer(hot, weight=weight) if hot else None
        out = dec.partial_decode_beams(chunk, lm_cache, p_cache, beams, offset, hotword_scorer=scorer,
                                       **kw, **call)
        beams = [beam_cls.from_lm_beam(b) for b in out]
        offset += chunk.shape[0]
        views.append(out)
    return views


STREAM_CASES = {
    "char_lm_force": ("char", "lm", [0, 9, 20, 36], 1, None, {}),
    "char_two_hot_swap": ("char", "two", [0, 8, 17, 27, 36], None,
                          [["bugs"], ["bugs", "gun"], ["bunny sun"], None], dict(prune_history=True)),
    # the same unigram set written anew each chunk: the device walks its carried
    # partial words through the new trie, and the scores must not move
    "char_two_hot_rewritten": ("char", "two", [0, 8, 17, 27, 36], None,
                               [["bugs sun", "gun"], ["gun", "sun", "bugs"], ["  bugs", "gun sun"],
                                ["sun gun bugs"]], dict(prune_history=True)),
    "char_none": ("char", "none", [0, 12, 36], None, None, {}),
    "pieces_lm_force": ("pieces", "lm", [0, 5, 10, 100], 0, None, {}),
}


def _stream_inputs(case, seed):
    alphabet, lm, cuts, force_at, hot, kw = STREAM_CASES[case]
    mat = _logits(alphabet, seed)
    cuts = [min(c, mat.shape[0]) for c in cuts]
    chunks = [mat[a:b] for a, b in zip(cuts[:-1], cuts[1:])]
    calls = [dict(force_next_word=(i == force_at), is_end=(i == len(chunks) - 1)) for i in range(len(chunks))]
    for call, words in zip(calls, hot or []):
        call.update(hotwords=words, hotword_weight=6.0)
    return alphabet, lm, chunks, calls, kw


@pytest.mark.parametrize("case", sorted(STREAM_CASES))
@pytest.mark.parametrize("seed", [2, 3])
def test_streaming_pair_equals_jax_host(hosts, case, seed):
    alphabet, lm, chunks, calls, kw = _stream_inputs(case, seed)
    jdec, pdec = hosts(alphabet, lm)
    want = host_stream(jdec, JBeam, JHotwordScorer, chunks, calls, beam_width=16, **kw)
    got = host_stream(pdec, Beam, P.HotwordScorer, chunks, calls, beam_width=16, **kw)
    for w, g in zip(want, got):
        assert_equal_lm_beams(w, g)


# A new hotword set mid-stream is left out here: the device scores each word
# with the set of the chunk that commits it, while the reference's score
# caches keep what a text or partial word scored when first seen (PARITY.md,
# "Known divergences"); the JAX device engine shows the same difference
# against its host oracle. test_torch_stream holds the port to JAX there.
@pytest.mark.parametrize("case", sorted(set(STREAM_CASES) - {"char_two_hot_swap"}))
def test_device_stream_equals_host_stream_in_the_port(hosts, case):
    alphabet, lm, chunks, calls, kw = _stream_inputs(case, 4)
    _, host = hosts(alphabet, lm)
    device = P.TorchBeamSearchDecoderCTC(host._alphabet, host._language_model, device="cpu")
    want = host_stream(host, Beam, P.HotwordScorer, chunks, calls, beam_width=16, **kw)
    state = device.get_starting_state(beam_width=16, hotwords_enabled=True, **kw)
    for w, chunk, call in zip(want, chunks, calls):
        assert_same_views(w, device.partial_decode_beams(state, chunk, **call), tol=HOST_TOL)


def test_build_ctcdecoder_host_engine_and_exports(arpas):
    dec = P.build_ctcdecoder(SAMPLE_LABELS, arpas["3"], UNIGRAMS, engine="host")
    assert type(dec) is P.BeamSearchDecoderCTC
    assert isinstance(dec._language_model, P.LanguageModel)
    assert dec.decode(TEST_LOGITS) == "bugs bunny"
    assert type(P.build_ctcdecoder(SAMPLE_LABELS, engine="host")) is P.BeamSearchDecoderCTC
    with pytest.raises(TypeError, match="torch engine only"):
        P.build_ctcdecoder(SAMPLE_LABELS, engine="host", device="cpu")
    with pytest.raises(ValueError, match="engine must be one of"):
        P.build_ctcdecoder(SAMPLE_LABELS, engine="auto")
    for name in ("BeamSearchDecoderCTC", "Beam", "LMBeam", "OutputBeam", "NGramModel",
                 "AbstractLanguageModel", "AbstractLMState"):
        assert name in P.__all__ and getattr(P, name).__module__.startswith("pyctcdecode_torch.")
    assert issubclass(P.LanguageModel, P.AbstractLanguageModel)
    assert issubclass(P.MultiLMState, P.AbstractLMState)
    assert P.NGramModel is type(open_ngram_file(arpas["3"], backend="python"))
    assert type(dec._language_model.ngram_model) is type(open_ngram_file(arpas["3"]))
    dec.cleanup()


def test_serialization_waits_for_the_language_model(tmp_path):
    """The host engine's serialization is ported: a round trip with and without the LM."""
    arpa = tmp_path / "bb3.arpa"
    arpa.write_text(ARPA)
    for name, lm in (("plain", None), ("lm", P.LanguageModel(open_ngram_file(str(arpa)), UNIGRAMS))):
        dec = P.BeamSearchDecoderCTC(P.Alphabet.build_alphabet(SAMPLE_LABELS), lm)
        out = tmp_path / name
        out.mkdir()
        dec.save_to_dir(str(out))
        parsed = P.BeamSearchDecoderCTC.parse_directory_contents(str(out))
        assert parsed["alphabet"] == str(out / "alphabet.json")
        assert (parsed["language_model"] is None) == (lm is None)
        loaded = P.BeamSearchDecoderCTC.load_from_dir(str(out))
        assert loaded.decode_beams(TEST_LOGITS) == dec.decode_beams(TEST_LOGITS)
        assert loaded.decode(TEST_LOGITS) == ("bunny bunny" if lm is None else "bugs bunny")
        loaded.cleanup()
        dec.cleanup()
