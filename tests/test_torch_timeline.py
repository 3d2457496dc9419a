"""The serving decode: token timeline, blank collapse, length bucketing, pipelined batches.

``TorchBeamSearchDecoderCTC(device="cpu")`` against the JAX
``TPUBeamSearchDecoderCTC`` on the same alphabet, the same inline ARPA and the
same logits made with numpy from seeds. Texts, ``text_frames`` and
``last_lm_state`` must be identical; scores within 1e-4 (both engines score
in float32; the group logsumexp and exp/log round differently in the two
frameworks). The port is also held against itself: the timeline decode is
output-exact for every chunk width, so it must equal the dense decode.

The JAX engine compiles one program per shape, so the cases share one batch
and one beam width.
"""
import pytest

import pyctcdecode_torch as P
from pyctcdecode_torch.models.ngram import open_ngram_file
from pyctcdecode_tpu import Alphabet as JAlphabet
from pyctcdecode_tpu import LanguageModel as JLanguageModel
from pyctcdecode_tpu import TPUBeamSearchDecoderCTC
from pyctcdecode_tpu.models.ngram import NGramModel as JNGramModel

from .helpers import SAMPLE_LABELS
from .torch_cases import ARPA, UNIGRAMS, assert_same_beams, word_logits
from .torch_cases import one_torch_thread  # noqa: F401  (autouse fixture)

BEAM = 8


def _with_blank_run(mat, lo, hi):
    """``mat`` with frames ``lo:hi`` made blank-certain (the collapse drops all but the first)."""
    mat = mat.copy()
    mat[lo:hi, -1] += 14.0
    return mat


BATCH = [
    word_logits(7, 31),
    word_logits(8, 12),
    _with_blank_run(word_logits(9, 40), 5, 15),
    _with_blank_run(word_logits(10, 25), 18, 25),
]
LONG_BATCH = BATCH + [word_logits(11, 160)]


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


def assert_same_batch(want, got):
    assert len(got) == len(want)
    for wb, gb in zip(want, got):
        assert_same_beams(wb, gb)


@pytest.mark.parametrize(
    "lm,batch,options",
    [
        ("lm", BATCH, dict(token_chunking=2)),
        ("lm", BATCH, dict(token_chunking=4)),
        ("lm", BATCH, dict(token_chunking=True)),
        ("none", BATCH, dict(token_chunking=4)),
        ("lm", BATCH, dict(token_chunking=True, blank_collapse=True)),
        ("lm", BATCH, dict(blank_collapse=True)),
        ("lm", BATCH, dict(token_chunking=True, length_bucketing=True)),
        ("lm", LONG_BATCH, dict(token_chunking=True, blank_collapse=True, length_bucketing=3)),
        ("lm", LONG_BATCH, dict(max_tokens_per_frame="auto", length_bucketing=3)),
        ("lm", BATCH, dict(token_chunking=True, top_n=2, prune_history=False)),
        ("lm", BATCH, dict(token_chunking=True, token_min_logp=-2.0, beam_prune_logp=-6.0)),
    ],
)
def test_serving_decode_matches_jax(decoders, lm, batch, options):
    jdec, pdec = decoders[lm]
    kw = dict(dict(beam_width=BEAM, prune_history=True), **options)
    assert_same_batch(jdec.decode_beams_batch(batch, **kw), pdec.decode_beams_batch(batch, **kw))


def test_bucketing_splits_into_groups(decoders):
    """The row target of 3 makes two length groups out of five utterances."""
    _, pdec = decoders["lm"]
    groups = pdec._length_groups(LONG_BATCH, target_rows=3)
    assert [len(g) for g in groups] == [3, 2]
    assert groups[-1][-1] == 4  # the 160-frame utterance closes the last group
    handles = pdec._launch_batch(
        LONG_BATCH,
        dict(beam_width=BEAM, beam_prune_logp=-10.0, token_min_logp=-5.0, prune_history=True,
             hotwords=None, hotword_weight=10.0, max_tokens_per_frame=None, batch_pad=8,
             top_n=1, collect_stats=False, blank_collapse=False, token_chunking=True),
        3,
    )
    assert len(handles) == 2
    kept = pdec._collapse_all(BATCH, -5.0)[1]
    assert [len(k) for k in kept] == [31, 12, 31, 19]  # the blank runs keep their first frame
    assert handles[0][1]["steps"] < handles[1][1]["steps"]  # each group pads to its own longest
    assert len(pdec._collect_bucketed(handles, len(LONG_BATCH))) == len(LONG_BATCH)


@pytest.mark.parametrize("lm", ["lm", "none"])
def test_single_utterance_blank_collapse_matches_jax(decoders, lm):
    jdec, pdec = decoders[lm]
    logits = _with_blank_run(word_logits(12, 37), 10, 20)
    kw = dict(beam_width=BEAM, blank_collapse=True)
    jb, pb = jdec.decode_beams(logits, **kw), pdec.decode_beams(logits, **kw)
    assert_same_beams(jb, pb)
    # frames stay in original indices and scores get the dropped frames back
    assert_same_beams(pdec.decode_beams(logits, beam_width=BEAM), pb)
    assert pdec.decode(logits, beam_width=BEAM, blank_collapse=True) == jdec.decode(
        logits, beam_width=BEAM, blank_collapse=True
    )


@pytest.mark.parametrize("depth", [1, 2])
def test_decode_beams_batches_matches_jax(decoders, depth):
    jdec, pdec = decoders["lm"]
    stream = [BATCH, BATCH[:2], [], BATCH[1:]]
    kw = dict(pipeline_depth=depth, beam_width=BEAM, prune_history=True, token_chunking=True,
              blank_collapse=True)
    jres = list(jdec.decode_beams_batches(stream, **kw))
    pres = list(pdec.decode_beams_batches(stream, **kw))
    assert [len(r) for r in pres] == [4, 2, 0, 3]
    for jr, pr in zip(jres, pres):
        assert_same_batch(jr, pr)
    # batch by batch the generator gives decode_beams_batch's results
    del kw["pipeline_depth"]
    assert_same_batch(pdec.decode_beams_batch(BATCH, **kw), pres[0])


@pytest.mark.parametrize("which", ["jax", "torch"])
def test_decode_beams_batches_rejects_what_the_reference_rejects(decoders, which):
    dec = decoders["none"][0 if which == "jax" else 1]
    with pytest.raises(ValueError, match="collect_stats"):
        next(iter(dec.decode_beams_batches([BATCH], collect_stats=True)))
    with pytest.raises(TypeError, match="beam_wdith"):
        next(iter(dec.decode_beams_batches([BATCH], beam_wdith=4)))


@pytest.mark.parametrize("width", [1, 2, 3, 4, 5, 8, 11])
@pytest.mark.parametrize("lm", ["lm", "none"])
def test_timeline_equals_dense_in_the_port(decoders, lm, width):
    """Output-exact for any chunk width (wider than the vocabulary too)."""
    _, pdec = decoders[lm]
    kw = dict(beam_width=BEAM, prune_history=True)
    dense = pdec.decode_beams_batch(BATCH, **kw)
    assert_same_batch(dense, pdec.decode_beams_batch(BATCH, token_chunking=width, **kw))
    assert_same_batch(
        dense,
        pdec.decode_beams_batch(BATCH, token_chunking=width, blank_collapse=True,
                                length_bucketing=2, **kw),
    )


def test_dev_other_auto_k_collapse_bucketing_matches_jax_engine(tmp_path):
    """The dev-other parity configuration of ``test_device_fuzz`` through both engines.

    Six synthetic dev-other-difficulty utterances (seed 17), beam 25, the
    auto preselect, then blank collapse, then length bucketing, with an
    inline 3-gram over the test unigrams at alpha 0.6, beta 1.0. The JAX
    package holds this configuration against its host decoder; here the two
    device engines are held against each other.
    """
    from pyctcdecode_tpu.evaluation import DEV_OTHER_DIFFICULTY, synthesize_corpus

    from .helpers import TEST_UNIGRAMS

    path = str(tmp_path / "bb3.arpa")
    with open(path, "w") as fh:
        fh.write(ARPA)
    jlm = JLanguageModel(JNGramModel.from_file(path), TEST_UNIGRAMS, alpha=0.6, beta=1.0)
    plm = P.LanguageModel(open_ngram_file(path), TEST_UNIGRAMS, alpha=0.6, beta=1.0)
    jdec = TPUBeamSearchDecoderCTC(JAlphabet.build_alphabet(SAMPLE_LABELS), jlm)
    pdec = P.TorchBeamSearchDecoderCTC(P.Alphabet.build_alphabet(SAMPLE_LABELS), plm, device="cpu")
    corpus = synthesize_corpus(
        SAMPLE_LABELS, TEST_UNIGRAMS, n_utterances=6, seed=17,
        **dict(DEV_OTHER_DIFFICULTY, words_per_utterance=(4, 8)),
    )
    for options in (
        dict(),
        dict(blank_collapse=True),
        dict(blank_collapse=True, length_bucketing=True),
        dict(blank_collapse=True, length_bucketing=3),
    ):
        kw = dict(beam_width=25, max_tokens_per_frame="auto", top_n=3, **options)
        assert_same_batch(
            jdec.decode_beams_batch(corpus.logits, **kw),
            pdec.decode_beams_batch(corpus.logits, **kw),
        )
