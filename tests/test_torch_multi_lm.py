"""``MultiLanguageModel`` in the port, held against the JAX package.

``MultiLanguageModel`` and ``MultiLMState`` are copies: the same members must
give the same orders, scores, errors and states. The decodes run
``TorchBeamSearchDecoderCTC(device="cpu")`` against the JAX
``TPUBeamSearchDecoderCTC`` on the same alphabet, the same inline ARPA models
(a 3-gram, and the same model cut to a 2-gram) and the same logits made with
numpy from seeds: texts, ``text_frames`` and ``last_lm_state`` (a
``MultiLMState``) identical, scores within 1e-4 (both engines score in
float32).
"""
import numpy as np
import pytest

import pyctcdecode_torch as P
from pyctcdecode_torch.models.base import MultiLMState, NGramLMState
from pyctcdecode_torch.models.ngram import open_ngram_file
from pyctcdecode_tpu import Alphabet as JAlphabet
from pyctcdecode_tpu import LanguageModel as JLanguageModel
from pyctcdecode_tpu import MultiLanguageModel as JMultiLanguageModel
from pyctcdecode_tpu import TPUBeamSearchDecoderCTC
from pyctcdecode_tpu.models.base import MultiLMState as JMultiLMState
from pyctcdecode_tpu.models.ngram import NGramModel as JNGramModel

from .helpers import SAMPLE_LABELS, TEST_LOGITS
from .torch_cases import ARPA, ARPA_2GRAM, UNIGRAMS, assert_same_beams, state_contexts, word_logits
from .torch_cases import one_torch_thread  # noqa: F401  (autouse fixture)

# the mixed members of the JAX package's own multi-LM test
MEMBER_A = dict(alpha=0.8, beta=0.5, unk_score_offset=-2.0)
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


def _pair(arpas, members):
    """(JAX, torch) LanguageModel pairs: ``members`` is a list of (order, fusion settings)."""
    jlms = [JLanguageModel(JNGramModel.from_file(arpas[o]), UNIGRAMS, **kw) for o, kw in members]
    plms = [P.LanguageModel(open_ngram_file(arpas[o]), UNIGRAMS, **kw) for o, kw in members]
    return jlms, plms


def _decoders(arpas, members):
    jlms, plms = _pair(arpas, members)
    ja = JAlphabet.build_alphabet(SAMPLE_LABELS)
    pa = P.Alphabet.build_alphabet(SAMPLE_LABELS)
    return (TPUBeamSearchDecoderCTC(ja, JMultiLanguageModel(jlms)),
            P.TorchBeamSearchDecoderCTC(pa, P.MultiLanguageModel(plms), device="cpu"))


@pytest.fixture(scope="module")
def mixed(arpas):
    """The 3-gram and the 2-gram with different fusion settings, both engines."""
    return _decoders(arpas, [("3", MEMBER_A), ("2", MEMBER_B)])


def test_multi_language_model_matches_jax(arpas):
    jlms, plms = _pair(arpas, [("3", MEMBER_A), ("2", MEMBER_B)])
    for bad in ([], plms[:1]):
        with pytest.raises(ValueError, match="two or more"):
            P.MultiLanguageModel(bad)
    with pytest.raises(ValueError, match="two or more"):
        JMultiLanguageModel(jlms[:1])
    jm, pm = JMultiLanguageModel(jlms), P.MultiLanguageModel(plms)
    assert pm.order == jm.order == 3
    assert state_contexts(pm.get_start_state()) == state_contexts(jm.get_start_state())
    for token in ("", "b", "bu", "bugsy", "xxxxxxxx", "sunn"):
        assert pm.score_partial_token(token) == jm.score_partial_token(token)
    jstate, pstate = jm.get_start_state(), pm.get_start_state()
    for i, word in enumerate(["bugs", "bunny", "guns", "zzz", "sunny"]):
        last = i == 4
        jscore, jstate = jm.score(jstate, word, is_last_word=last)
        pscore, pstate = pm.score(pstate, word, is_last_word=last)
        assert pscore == pytest.approx(jscore, abs=1e-9)
        assert isinstance(pstate, MultiLMState) and isinstance(jstate, JMultiLMState)
        assert state_contexts(pstate) == state_contexts(jstate)
    with pytest.raises(AssertionError, match="MultiLMState"):
        pm.score(NGramLMState(()), "bugs")
    with pytest.raises(AssertionError, match="member states"):
        pm.score(MultiLMState([NGramLMState(())]), "bugs")
    # reset_params forwards to every member (the JAX package's divergence from the reference)
    pm.reset_params(alpha=0.25)
    jm.reset_params(alpha=0.25)
    assert [m.alpha for m in plms] == [m.alpha for m in jlms] == [0.25, 0.25]


def test_multi_lm_state_equality_and_hash():
    a = MultiLMState([NGramLMState((1, 2)), NGramLMState((3,))])
    b = MultiLMState([NGramLMState((1, 2)), NGramLMState((3,))])
    c = MultiLMState([NGramLMState((1, 2)), NGramLMState(())])
    assert a == b and hash(a) == hash(b)
    assert a != c and a != NGramLMState((1, 2))
    assert len({a, b, c}) == 2
    assert repr(a) == repr(JMultiLMState([_jstate((1, 2)), _jstate((3,))]))


def _jstate(ctx):
    from pyctcdecode_tpu.models.base import NGramLMState as JNGramLMState

    return JNGramLMState(ctx)


def test_duplicate_members_equal_the_single_lm(arpas):
    """``MultiLanguageModel([lm, lm])`` decodes as ``lm`` alone (ref test_decoder.py:386-401)."""
    members = [("3", dict(alpha=1.0, unk_score_offset=0.0))] * 2
    _, plms = _pair(arpas, members)
    pa = P.Alphabet.build_alphabet(SAMPLE_LABELS)
    single = P.TorchBeamSearchDecoderCTC(pa, plms[0], device="cpu")
    multi = P.TorchBeamSearchDecoderCTC(pa, P.MultiLanguageModel(plms), device="cpu")
    for logits in (TEST_LOGITS, word_logits(20, 33)):
        sb = single.decode_beams(logits, beam_width=16)
        mb = multi.decode_beams(logits, beam_width=16)
        assert [b.text for b in mb] == [b.text for b in sb]
        for s, m in zip(sb, mb):
            assert abs(s.lm_score - m.lm_score) <= 1e-4
            assert len(m.last_lm_state.states) == 2
            assert m.last_lm_state.states[0] == s.last_lm_state


@pytest.mark.parametrize("seed", range(3))
def test_mixed_members_dense_match_jax(mixed, seed):
    """A 3-gram beside a 2-gram, other fusion settings, on fuzzed matrices."""
    jdec, pdec = mixed
    rng = np.random.RandomState(23 + seed)
    logits = (rng.randn(rng.randint(4, 30), len(SAMPLE_LABELS)) * 2.0).astype(np.float32)
    kw = dict(beam_width=6)
    got = pdec.decode_beams(logits, **kw)
    assert_same_beams(jdec.decode_beams(logits, **kw), got)
    assert isinstance(got[0].last_lm_state, MultiLMState)


@pytest.mark.parametrize("width", [2, 5])
def test_mixed_members_timeline_match_jax(mixed, width):
    jdec, pdec = mixed
    batch = [word_logits(30, 27), word_logits(31, 11), word_logits(32, 38)]
    kw = dict(beam_width=8, prune_history=True, token_chunking=width, blank_collapse=True,
              length_bucketing=2)
    jres, pres = jdec.decode_beams_batch(batch, **kw), pdec.decode_beams_batch(batch, **kw)
    for jb, pb in zip(jres, pres):
        assert_same_beams(jb, pb)
    dense = pdec.decode_beams_batch(batch, beam_width=8, prune_history=True)
    for db, pb in zip(dense, pres):
        assert_same_beams(db, pb)


def test_start_state_chaining_and_the_wrong_count(mixed):
    jdec, pdec = mixed
    first, second = word_logits(5, 21), word_logits(6, 19)
    kw = dict(beam_width=8)
    jb, pb = jdec.decode_beams(first, **kw), pdec.decode_beams(first, **kw)
    assert_same_beams(jb, pb)
    jstate, pstate = jb[0].last_lm_state, pb[0].last_lm_state
    assert isinstance(pstate, MultiLMState) and any(s.context for s in pstate.states)
    assert_same_beams(
        jdec.decode_beams(second, lm_start_state=jstate, **kw),
        pdec.decode_beams(second, lm_start_state=pstate, **kw),
    )
    with pytest.raises(AssertionError, match="Number of states"):
        pdec.decode_beams(second, lm_start_state=MultiLMState(pstate.states[:1]), **kw)
    with pytest.raises(AssertionError, match="NGramLMState"):
        pdec.decode_beams(second, lm_start_state=MultiLMState([pstate, pstate]), **kw)


def test_nested_multi_language_model_is_refused(arpas):
    _, plms = _pair(arpas, [("3", {}), ("2", {})])
    nested = P.MultiLanguageModel([P.MultiLanguageModel(plms), plms[0]])
    with pytest.raises(NotImplementedError, match="nested"):
        P.TorchBeamSearchDecoderCTC(P.Alphabet.build_alphabet(SAMPLE_LABELS), nested, device="cpu")


@pytest.mark.parametrize("options", [dict(), dict(token_chunking=2, blank_collapse=True, length_bucketing=2)])
def test_hotwords_and_two_members_match_jax(mixed, options):
    """The slice as a whole: hotwords with two members, dense and through the serving call."""
    jdec, pdec = mixed
    batch = [word_logits(40, 35), word_logits(41, 14), word_logits(42, 26)]
    batch[0][4:12, -1] += 14.0  # a blank run for the collapse
    kw = dict(beam_width=8, prune_history=True, hotwords=["bugs bunny", "sun", "yyy"],
              hotword_weight=8.0, **options)
    jres, pres = jdec.decode_beams_batch(batch, **kw), pdec.decode_beams_batch(batch, **kw)
    for jb, pb in zip(jres, pres):
        assert_same_beams(jb, pb)
        assert isinstance(pb[0].last_lm_state, MultiLMState)
    texts = pdec.decode_batch(batch, beam_width=8, hotwords=kw["hotwords"], hotword_weight=8.0, **options)
    assert texts == [b[0].text for b in pres]
