"""Hotword boosting in the port, held against the JAX package.

``HotwordScorer`` and ``build_hotword_tables`` are copies: the same inputs
must give the same scores and bit-equal tables. The decodes run
``TorchBeamSearchDecoderCTC(device="cpu")`` against the JAX
``TPUBeamSearchDecoderCTC`` on the same alphabet, the same inline ARPA and the
same logits made with numpy from seeds: texts, ``text_frames`` and
``last_lm_state`` identical, scores within 1e-4 (both engines score in
float32).

The JAX engine compiles one program per shape, so the decode cases share a
few beam widths and frame counts.
"""
import numpy as np
import pytest

import pyctcdecode_torch as P
from pyctcdecode_torch.models import device_tables as tdt
from pyctcdecode_torch.models.hotwords import HotwordScorer
from pyctcdecode_torch.models.ngram import open_ngram_file
from pyctcdecode_torch.ops.tokens import build_token_arrays
from pyctcdecode_tpu import Alphabet as JAlphabet
from pyctcdecode_tpu import LanguageModel as JLanguageModel
from pyctcdecode_tpu import TPUBeamSearchDecoderCTC
from pyctcdecode_tpu.models import device_tables as jdt
from pyctcdecode_tpu.models.hotwords import HotwordScorer as JHotwordScorer
from pyctcdecode_tpu.models.ngram import NGramModel as JNGramModel
from pyctcdecode_tpu.ops.tokens import build_token_arrays as jbuild_token_arrays

from .helpers import LIBRI_LABELS, SAMPLE_LABELS, TEST_LOGITS
from .torch_cases import ARPA, UNIGRAMS, assert_same_beams, word_logits
from .torch_cases import one_torch_thread  # noqa: F401  (autouse fixture)

HOTWORD_SETS = [
    ["bugs"],
    ["bugs bunny", "sun"],
    ["  sunny  ", "", "   ", "gun guns"],  # blank entries and padding drop out
    ["bug's", "b-u-n", "nun!"],  # punctuation stays part of the word
    [],
    None,
]
TEXTS = ["", "bugs", "bugs bunny", "the sun and sunny", " bug's  nun! ", "gun guns guns", "b-u-n"]
PARTIALS = ["", "b", "bu", "bug", "bugs", "bugsy", "s", "sun", "x", "n", "gu", "guns", "bug'", "b-"]


@pytest.mark.parametrize("hotwords", HOTWORD_SETS)
@pytest.mark.parametrize("weight", [10.0, 2.5])
def test_hotword_scorer_matches_jax(hotwords, weight):
    want = JHotwordScorer.build_scorer(hotwords, weight=weight)
    got = HotwordScorer.build_scorer(hotwords, weight=weight)
    assert got.unigrams == want.unigrams
    assert got.weight == want.weight
    for text in TEXTS:
        assert got.score(text) == want.score(text)
    for token in PARTIALS:
        assert got.score_partial_token(token) == want.score_partial_token(token)
        assert (token in got) == (token in want)


@pytest.mark.parametrize("seed", range(4))
def test_hotword_scorer_fuzz_matches_jax(seed):
    """Random phrases over a small alphabet, random texts and partials."""
    rng = np.random.RandomState(seed)
    letters = list("abn s'")

    def word(lo, hi):
        return "".join(rng.choice(letters, size=rng.randint(lo, hi)))

    phrases = [word(0, 9) for _ in range(rng.randint(1, 7))]
    weight = float(rng.uniform(0.5, 20.0))
    want = JHotwordScorer.build_scorer(phrases, weight=weight)
    got = HotwordScorer.build_scorer(phrases, weight=weight)
    assert got.unigrams == want.unigrams
    for _ in range(50):
        text, token = word(0, 20), word(0, 7).replace(" ", "")
        assert got.score(text) == want.score(text)
        assert got.score_partial_token(token) == want.score_partial_token(token)


@pytest.mark.parametrize(
    "labels,unigrams",
    [
        (SAMPLE_LABELS, ["bugs"]),
        (SAMPLE_LABELS, ["bugs", "bunny", "sun", "gun"]),  # pads past 8 nodes
        (SAMPLE_LABELS, ["bugz", "bun"]),  # "z" is not in the alphabet: the word drops out
        (SAMPLE_LABELS, []),
        (LIBRI_LABELS + [""], ["i", "remember", "doubt", "achieve", "will", "willow", "a"]),
    ],
)
def test_build_hotword_tables_bit_equal(labels, unigrams):
    ptok = build_token_arrays(P.Alphabet.build_alphabet(labels))
    jtok = jbuild_token_arrays(JAlphabet.build_alphabet(labels))
    got = tdt.build_hotword_tables(unigrams, ptok.char2id, ptok)
    want = jdt.build_hotword_tables(unigrams, jtok.char2id, jtok)
    assert set(got) == set(want) == {"next", "seed", "dead"}
    for key in ("next", "seed"):
        assert got[key].dtype == want[key].dtype
        np.testing.assert_array_equal(got[key], want[key])
    assert int(got["dead"]) == int(want["dead"])
    n_pad = got["next"].shape[0]
    assert n_pad >= 8 and n_pad & (n_pad - 1) == 0
    # padded rows hold the packed dead entry
    dead_row = got["next"][int(got["dead"])]
    assert (got["next"][int(got["dead"]):] == dead_row[0]).all()
    if len(unigrams) == 4:
        assert n_pad > 8
    for name in ("HOT_NODE_MASK", "HOT_MINCOMP_SHIFT", "HOT_MINCOMP_MAX", "HOT_WORD_BIT"):
        assert getattr(tdt, name) == getattr(jdt, name)


@pytest.fixture(scope="module")
def decoders(tmp_path_factory):
    """(JAX, torch) decoder pairs without and with the LM."""
    path = str(tmp_path_factory.mktemp("lm") / "bb3.arpa")
    with open(path, "w") as fh:
        fh.write(ARPA)
    ja = JAlphabet.build_alphabet(SAMPLE_LABELS)
    pa = P.Alphabet.build_alphabet(SAMPLE_LABELS)
    jlm = JLanguageModel(JNGramModel.from_file(path), UNIGRAMS)
    plm = P.LanguageModel(open_ngram_file(path), UNIGRAMS)
    return {
        "none": (TPUBeamSearchDecoderCTC(ja), P.TorchBeamSearchDecoderCTC(pa, device="cpu")),
        "lm": (
            TPUBeamSearchDecoderCTC(ja, jlm),
            P.TorchBeamSearchDecoderCTC(pa, plm, device="cpu"),
        ),
    }


@pytest.mark.parametrize(
    "lm,beam,hotwords,weight,seed",
    [
        ("none", 8, ["bugs"], 10.0, 0),
        ("none", 8, ["bun", "sunny gun"], 4.0, 1),
        ("lm", 16, ["bugs", "bunny"], 10.0, 2),
        ("lm", 16, ["guns", "nun", "xyz"], 7.0, 3),  # "guns" is no unigram; "xyz" cannot be spelt
        ("lm", 5, ["sun"], 25.0, 4),
    ],
)
def test_decode_beams_with_hotwords_matches_jax(decoders, lm, beam, hotwords, weight, seed):
    jdec, pdec = decoders[lm]
    logits = word_logits(seed, 37)
    kw = dict(beam_width=beam, hotwords=hotwords, hotword_weight=weight)
    got = pdec.decode_beams(logits, **kw)
    assert_same_beams(jdec.decode_beams(logits, **kw), got)
    # the boost reaches the scores: without hotwords the ranking scores differ
    plain = pdec.decode_beams(logits, beam_width=beam)
    assert [b.lm_score for b in plain] != [b.lm_score for b in got]


@pytest.mark.parametrize("lm", ["none", "lm"])
def test_hotwords_on_the_reference_fixture(decoders, lm):
    """A heavy "bugs" on the bugs/bunny matrix; without the LM it turns the first word."""
    jdec, pdec = decoders[lm]
    kw = dict(beam_width=16, hotwords=["bugs"], hotword_weight=25.0)
    assert_same_beams(jdec.decode_beams(TEST_LOGITS, **kw), pdec.decode_beams(TEST_LOGITS, **kw))
    text = pdec.decode(TEST_LOGITS, **kw)
    assert text == jdec.decode(TEST_LOGITS, **kw) == "bugs bunny"
    if lm == "none":
        assert pdec.decode(TEST_LOGITS, beam_width=16) == "bunny bunny"


BATCH = [word_logits(7, 31), word_logits(8, 12), word_logits(9, 40)]
BATCH[2][5:15, -1] += 14.0  # a blank run for the collapse


@pytest.mark.parametrize(
    "lm,options",
    [
        ("lm", dict()),
        ("lm", dict(token_chunking=2, blank_collapse=True, length_bucketing=2)),
        ("lm", dict(token_chunking=5, blank_collapse=True, length_bucketing=2)),
        ("none", dict(token_chunking=2, blank_collapse=True, length_bucketing=2)),
        ("none", dict(blank_collapse=True)),
    ],
)
def test_batch_with_hotwords_matches_jax(decoders, lm, options):
    """The dense call and the serving call on a 3-utterance mixed-length batch."""
    jdec, pdec = decoders[lm]
    kw = dict(beam_width=8, prune_history=True, hotwords=["bugs bunny", "gun"],
              hotword_weight=6.0, **options)
    jres = jdec.decode_beams_batch(BATCH, **kw)
    pres = pdec.decode_beams_batch(BATCH, **kw)
    assert len(pres) == len(BATCH)
    for jb, pb in zip(jres, pres):
        assert_same_beams(jb, pb)
    # the timeline is output-exact: the serving call equals the dense call
    dense = pdec.decode_beams_batch(BATCH, beam_width=8, prune_history=True,
                                    hotwords=["bugs bunny", "gun"], hotword_weight=6.0)
    for db, pb in zip(dense, pres):
        assert_same_beams(db, pb)


def test_pipelined_batches_with_hotwords(decoders):
    """``decode_beams_batches`` passes hotwords to every batch."""
    jdec, pdec = decoders["lm"]
    stream = [BATCH, BATCH[:2]]
    kw = dict(beam_width=8, prune_history=True, token_chunking=2, blank_collapse=True,
              hotwords=["sunny"], hotword_weight=5.0)
    jres = list(jdec.decode_beams_batches(stream, **kw))
    pres = list(pdec.decode_beams_batches(stream, **kw))
    for jr, pr in zip(jres, pres):
        assert len(jr) == len(pr)
        for jb, pb in zip(jr, pr):
            assert_same_beams(jb, pb)
    assert pdec.decode_batch(BATCH, beam_width=8, hotwords=["sunny"], hotword_weight=5.0) == \
        jdec.decode_batch(BATCH, beam_width=8, hotwords=["sunny"], hotword_weight=5.0)


def test_hotword_tables_are_cached_per_unigram_set(decoders):
    _, pdec = decoders["none"]
    pdec._hot_cache.clear()
    hot, weight = pdec._hot_tables(["bugs bunny"], 3.0)
    again, _ = pdec._hot_tables(["bunny", " bugs "], 4.0)  # the same unigram set
    assert again is hot and weight == 3.0
    assert pdec._hot_tables([" "], 3.0) == (None, 0.0)
    for i in range(9):
        pdec._hot_tables([f"b{'u' * i}"], 1.0)
    assert len(pdec._hot_cache) == 8
    assert ("bugs", "bunny") not in pdec._hot_cache  # the oldest set left first
