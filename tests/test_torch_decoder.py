"""TorchBeamSearchDecoderCTC(device="cpu") vs the JAX TPUBeamSearchDecoderCTC.

Same alphabet, same ARPA (built inline), same logits made with numpy from a
seed; both engines score in float32. Texts, ``text_frames`` and
``last_lm_state`` must be identical; ``logit_score`` / ``lm_score`` within
1e-4 (the group logsumexp and exp/log round differently in the two
frameworks; scores accumulate over up to 40 frames).
"""
import os

import numpy as np
import pytest
import torch

import pyctcdecode_torch as P
from pyctcdecode_torch.models.ngram import open_ngram_file
from pyctcdecode_tpu import Alphabet as JAlphabet
from pyctcdecode_tpu import LanguageModel as JLanguageModel
from pyctcdecode_tpu import TPUBeamSearchDecoderCTC
from pyctcdecode_tpu.models.binfmt import write_binary
from pyctcdecode_tpu.models.ngram import NGramModel as JNGramModel
from pyctcdecode_tpu.models.ngram import read_arpa
from .helpers import SAMPLE_LABELS, TEST_LOGITS
from .torch_cases import ARPA, UNIGRAMS, assert_same_beams, word_logits
from .torch_cases import one_torch_thread  # noqa: F401  (autouse fixture)


@pytest.fixture(scope="module")
def arpa_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("lm") / "bb3.arpa")
    with open(path, "w") as fh:
        fh.write(ARPA)
    return path


@pytest.fixture(scope="module")
def decoders(arpa_path):
    """(JAX, torch) decoder pairs without and with the LM."""
    ja = JAlphabet.build_alphabet(SAMPLE_LABELS)
    pa = P.Alphabet.build_alphabet(SAMPLE_LABELS)
    jlm = JLanguageModel(JNGramModel.from_file(arpa_path), UNIGRAMS)
    plm = P.LanguageModel(open_ngram_file(arpa_path), UNIGRAMS)
    return {
        "none": (TPUBeamSearchDecoderCTC(ja), P.TorchBeamSearchDecoderCTC(pa, device="cpu")),
        "lm": (
            TPUBeamSearchDecoderCTC(ja, jlm),
            P.TorchBeamSearchDecoderCTC(pa, plm, device="cpu"),
        ),
    }


@pytest.mark.parametrize(
    "lm,beam,k,prune_history,top_n,seed",
    [
        ("none", 8, None, False, None, 0),
        ("lm", 16, None, False, None, 1),
        ("lm", 12, 3, True, None, 2),
        ("lm", 10, "auto", False, 3, 3),
        ("none", 5, "auto", True, 2, 4),
    ],
)
def test_decode_beams_matches_jax(decoders, lm, beam, k, prune_history, top_n, seed):
    jdec, pdec = decoders[lm]
    logits = word_logits(seed, 37)
    kw = dict(beam_width=beam, max_tokens_per_frame=k, prune_history=prune_history, top_n=top_n)
    assert_same_beams(jdec.decode_beams(logits, **kw), pdec.decode_beams(logits, **kw))


def test_reference_fixture_and_decode(decoders):
    """The bugs/bunny matrix: LM flips word one; ``decode`` agrees too."""
    jdec, pdec = decoders["lm"]
    kw = dict(beam_width=8)
    assert_same_beams(jdec.decode_beams(TEST_LOGITS, **kw), pdec.decode_beams(TEST_LOGITS, **kw))
    assert pdec.decode(TEST_LOGITS, beam_width=8) == jdec.decode(TEST_LOGITS, beam_width=8)


def test_lm_start_state_chaining(decoders):
    jdec, pdec = decoders["lm"]
    first, second = word_logits(5, 21), word_logits(6, 19)
    kw = dict(beam_width=8)
    jb = jdec.decode_beams(first, **kw)
    pb = pdec.decode_beams(first, **kw)
    assert_same_beams(jb, pb)
    jstate = jb[0].last_lm_state
    pstate = pb[0].last_lm_state
    assert jstate.context and pstate.context == jstate.context
    assert_same_beams(
        jdec.decode_beams(second, lm_start_state=jstate, **kw),
        pdec.decode_beams(second, lm_start_state=pstate, **kw),
    )


def test_decode_batch_mixed_lengths(decoders):
    jdec, pdec = decoders["lm"]
    batch = [word_logits(7, 31), word_logits(8, 12), word_logits(9, 40)]
    kw = dict(beam_width=6, prune_history=True)
    jres = jdec.decode_beams_batch(batch, **kw)
    pres = pdec.decode_beams_batch(batch, **kw)
    assert len(pres) == 3
    for jb, pb in zip(jres, pres):
        assert_same_beams(jb, pb)
    # the reference's leading-pool convention and the top-1 convenience API
    assert pdec.decode_batch(None, batch, beam_width=6) == jdec.decode_batch(batch, beam_width=6)


def test_reset_params_retunes_without_rebuild(decoders):
    jdec, pdec = decoders["lm"]
    logits = word_logits(10, 25)
    try:
        jdec.reset_params(alpha=0.9, beta=0.5)
        pdec.reset_params(alpha=0.9, beta=0.5)
        assert_same_beams(
            jdec.decode_beams(logits, beam_width=8), pdec.decode_beams(logits, beam_width=8)
        )
    finally:
        jdec.reset_params(alpha=0.5, beta=1.5)
        pdec.reset_params(alpha=0.5, beta=1.5)


@pytest.mark.parametrize(
    "option",
    [
        dict(hotwords=["bugs"]),
        dict(blank_collapse=True),
        dict(length_bucketing=True),
        dict(token_chunking=5),
        dict(collect_stats=True),
    ],
)
def test_unported_options_raise(decoders, option):
    """Every option is ported: the serving options, hotwords and the decode counters decode as the reference."""
    jdec, pdec = decoders["none"]
    name = next(iter(option))
    if name == "collect_stats":
        batch = [word_logits(0, 5)]
        pres, pstats = pdec.decode_beams_batch(batch, beam_width=4, **option)
        jres, jstats = jdec.decode_beams_batch(batch, beam_width=4, **option)
        assert pstats == jstats and pstats[0]["frames"] == 5
        assert_same_beams(jres[0], pres[0])
        return
    batch = [word_logits(0, 5), word_logits(1, 9)]
    jres = jdec.decode_beams_batch(batch, beam_width=4, **option)
    pres = pdec.decode_beams_batch(batch, beam_width=4, **option)
    assert len(pres) == len(batch)
    for jb, pb in zip(jres, pres):
        assert_same_beams(jb, pb)


def test_unported_engines_and_formats_raise(arpa_path, tmp_path):
    # the host engine is ported (tests/test_torch_host_decoder.py); it takes no device
    assert type(P.build_ctcdecoder(SAMPLE_LABELS, engine="host")) is P.BeamSearchDecoderCTC
    with pytest.raises(TypeError, match="torch engine only"):
        P.build_ctcdecoder(SAMPLE_LABELS, engine="host", device="cpu")
    # a BPE alphabet is ported (tests/test_torch_bpe.py): it builds and decodes on the CPU
    bpe = P.TorchBeamSearchDecoderCTC(P.Alphabet.build_alphabet(["▁a", "▁b", "c", ""]), device="cpu")
    assert bpe.decode(np.eye(4, dtype=np.float32)[[0, 2, 3, 1]] * 5.0, beam_width=4) == "ac b"
    # the compiled .ctclm format is ported (tests/test_torch_kenlm.py): one the JAX package wrote
    ctclm = os.path.join(tmp_path, "model.ctclm")
    write_binary(read_arpa(arpa_path), ctclm)
    from_ctclm = P.build_ctcdecoder(SAMPLE_LABELS, ctclm, device="cpu")
    assert type(from_ctclm.language_model.ngram_model) is P.NGramModel
    assert from_ctclm.decode(TEST_LOGITS, beam_width=8) == "bugs bunny"
    dec = P.build_ctcdecoder(SAMPLE_LABELS, arpa_path, device="cpu")
    assert dec.device == torch.device("cpu")
    assert dec.decode(TEST_LOGITS, beam_width=8) == "bugs bunny"
    # streaming is ported (tests/test_torch_stream.py)
    state = dec.get_starting_state(beam_width=8)
    assert dec.partial_decode_beams(state, TEST_LOGITS, is_end=True)[0].text == "bugs bunny"
    # hotwords are ported (tests/test_torch_hotwords.py); a nested ensemble still raises
    assert dec.decode(TEST_LOGITS, beam_width=8, hotwords=["bugs"]) == "bugs bunny"
    nested = P.MultiLanguageModel([P.MultiLanguageModel([dec.language_model] * 2), dec.language_model])
    with pytest.raises(NotImplementedError, match="nested"):
        P.TorchBeamSearchDecoderCTC(P.Alphabet.build_alphabet(SAMPLE_LABELS), nested, device="cpu")
