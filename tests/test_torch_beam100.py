"""The port's batch decode at the north star's beam (100, and 200), held against the JAX engine.

``TorchBeamSearchDecoderCTC(device="cpu")`` against the JAX
``TPUBeamSearchDecoderCTC`` on the same inputs: texts, ``text_frames`` and
``last_lm_state`` identical for every beam returned, scores within 1e-4 (both
engines score in float32). The prune windows are wide (``beam_prune_logp``
-60 on chars with ``token_min_logp`` -12, -40 on pieces), so that up to the
whole beam survives and every rank is compared. Beam 200 takes 16-bit
parent planes (the 8-bit planes hold 127 slots).
"""
import pytest

import pyctcdecode_torch as P
from pyctcdecode_torch.models.ngram import open_ngram_file
from pyctcdecode_tpu import Alphabet as JAlphabet
from pyctcdecode_tpu import LanguageModel as JLanguageModel
from pyctcdecode_tpu import MultiLanguageModel as JMultiLanguageModel
from pyctcdecode_tpu import TPUBeamSearchDecoderCTC
from pyctcdecode_tpu.models.ngram import NGramModel as JNGramModel

from .helpers import SAMPLE_LABELS, TEST_UNIGRAMS
from .torch_cases import ARPA, ARPA_2GRAM, LM_WORDS, UNIGRAMS, assert_same_beams, piece_logits, piece_vocabulary
from .torch_cases import one_torch_thread  # noqa: F401  (autouse fixture)

CHAR_KW = dict(beam_prune_logp=-60.0, token_min_logp=-12.0, prune_history=True)
PIECE_KW = dict(beam_prune_logp=-40.0, prune_history=True)
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
def dev_other(arpas):
    """The dev-other corpus of ``test_torch_timeline`` and its (JAX, torch) decoders."""
    from pyctcdecode_tpu.evaluation import DEV_OTHER_DIFFICULTY, synthesize_corpus

    jlm = JLanguageModel(JNGramModel.from_file(arpas["3"]), TEST_UNIGRAMS, alpha=0.6, beta=1.0)
    plm = P.LanguageModel(open_ngram_file(arpas["3"]), TEST_UNIGRAMS, alpha=0.6, beta=1.0)
    corpus = synthesize_corpus(
        SAMPLE_LABELS, TEST_UNIGRAMS, n_utterances=6, seed=17,
        **dict(DEV_OTHER_DIFFICULTY, words_per_utterance=(4, 8)),
    )
    return (TPUBeamSearchDecoderCTC(JAlphabet.build_alphabet(SAMPLE_LABELS), jlm),
            P.TorchBeamSearchDecoderCTC(P.Alphabet.build_alphabet(SAMPLE_LABELS), plm, device="cpu"),
            corpus.logits)


def assert_same_batch(want, got):
    assert len(got) == len(want)
    for wb, gb in zip(want, got):
        assert_same_beams(wb, gb)


@pytest.mark.parametrize("options", [
    dict(),
    dict(token_chunking=True, blank_collapse=True),
], ids=["dense", "serving"])
def test_dev_other_at_beam_100_matches_jax(dev_other, options):
    jdec, pdec, logits = dev_other
    kw = dict(beam_width=100, **CHAR_KW, **options)
    want = jdec.decode_beams_batch(logits, **kw)
    assert max(len(b) for b in want) > 80  # the window keeps most of the beam
    assert_same_batch(want, pdec.decode_beams_batch(logits, **kw))


def test_dev_other_at_beam_200_matches_jax(dev_other):
    jdec, pdec, logits = dev_other
    kw = dict(beam_width=200, **CHAR_KW)
    want = jdec.decode_beams_batch(logits[:3], **kw)
    assert max(len(b) for b in want) > 127  # ranks past the 8-bit parent range
    assert_same_batch(want, pdec.decode_beams_batch(logits[:3], **kw))


def test_pieces_two_members_hotwords_at_beam_100_match_jax(arpas):
    """The 48-column piece vocabulary, a 3-gram + 2-gram ``MultiLanguageModel`` and hotwords."""
    pieces = piece_vocabulary(LM_WORDS)
    members = [(arpas["3"], {}), (arpas["2"], MEMBER_B)]
    jlm = JMultiLanguageModel([JLanguageModel(JNGramModel.from_file(a), UNIGRAMS, **kw) for a, kw in members])
    plm = P.MultiLanguageModel([P.LanguageModel(open_ngram_file(a), UNIGRAMS, **kw) for a, kw in members])
    jdec = TPUBeamSearchDecoderCTC(JAlphabet.build_alphabet(pieces), jlm)
    pdec = P.TorchBeamSearchDecoderCTC(P.Alphabet.build_alphabet(pieces), plm, device="cpu")
    labels = pdec._alphabet.labels
    batch = [piece_logits(seed, labels, 4 + seed % 3) for seed in range(4)]
    kw = dict(beam_width=100, hotwords=["bunny", "sun guns"], hotword_weight=8.0, **PIECE_KW)
    want = jdec.decode_beams_batch(batch, **kw)
    assert max(len(b) for b in want) > 50
    assert_same_batch(want, pdec.decode_beams_batch(batch, **kw))
