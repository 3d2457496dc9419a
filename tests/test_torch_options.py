"""Engine options in the port: ``build_ctcdecoder(**engine_options)``, ``with_options``, ``fast_topk``.

The JAX package's ``tests/test_api.py`` (``TestEngineOptions``) on the port.
The port takes ``fast_topk`` and ranks exactly either way (the exact ranking
meets the option's contract), so its decodes with ``fast_topk=True`` are
held against the JAX engine's ``fast_topk`` and against the exact ranking. The same inputs (numpy, seeded) go through
``TorchBeamSearchDecoderCTC(device="cpu")`` and the JAX
``TPUBeamSearchDecoderCTC``: texts, ``text_frames`` and ``last_lm_state``
identical, scores within 1e-4 (both engines score in float32). These cases
have no exact-score tie across the top-B boundary, where the two rankings
may keep different equal-scoring candidates.
"""
import numpy as np
import pytest
import torch

import pyctcdecode_torch as P
from pyctcdecode_torch.engine import _top_b
from pyctcdecode_torch.models.ngram import open_ngram_file
from pyctcdecode_tpu import Alphabet as JAlphabet
from pyctcdecode_tpu import LanguageModel as JLanguageModel
from pyctcdecode_tpu import TPUBeamSearchDecoderCTC
from pyctcdecode_tpu.models.ngram import NGramModel as JNGramModel

from .helpers import SAMPLE_LABELS
from .torch_cases import ARPA, ARPA_2GRAM, UNIGRAMS, assert_same_beams, word_logits
from .torch_cases import one_torch_thread  # noqa: F401  (autouse fixture)

BEAM = 8
BATCH = [word_logits(31, 29), word_logits(32, 14), word_logits(33, 36)]
TINY = """\\data\\
ngram 1=5

\\1-grams:
-10\t<unk>\t0
-2\t<s>\t-0.5
-2\t</s>\t0
-1.0\tab\t-0.4
-1.2\tba\t-0.4

\\end\\
"""


@pytest.fixture(scope="module")
def arpa(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("lm") / "bb3.arpa")
    with open(path, "w") as fh:
        fh.write(ARPA)
    return path


@pytest.fixture(scope="module")
def pairs(arpa):
    """(JAX, torch) decoders with the LM, each with ``fast_topk`` off and on."""
    jlm = JLanguageModel(JNGramModel.from_file(arpa), UNIGRAMS)
    plm = P.LanguageModel(open_ngram_file(arpa), UNIGRAMS)
    ja, pa = JAlphabet.build_alphabet(SAMPLE_LABELS), P.Alphabet.build_alphabet(SAMPLE_LABELS)
    exact = P.TorchBeamSearchDecoderCTC(pa, plm, device="cpu")
    return {
        "exact": (TPUBeamSearchDecoderCTC(ja, jlm), exact),
        "fast": (TPUBeamSearchDecoderCTC(ja, jlm, fast_topk=True), exact.with_options(fast_topk=True)),
    }


def test_options_forward_to_the_device_engine():
    dec = P.build_ctcdecoder([" ", "a", "b", ""], engine="torch", device="cpu", fast_topk=True,
                             segment_frames=8)
    assert isinstance(dec, P.TorchBeamSearchDecoderCTC)
    assert dec._segment_frames == 8
    assert dec._segment_frames_effective() == 8


def test_options_rejected_on_the_host_engine():
    with pytest.raises(TypeError, match="fast_topk.*device engine"):
        P.build_ctcdecoder([" ", "a", "b", ""], engine="host", fast_topk=True)
    with pytest.raises(TypeError, match="segment_frames.*device engine"):
        P.build_ctcdecoder([" ", "a", "b", ""], engine="host", segment_frames=4)


def test_unknown_or_bad_options_raise():
    dec = P.build_ctcdecoder([" ", "a", "b", ""], device="cpu")
    with pytest.raises(ValueError, match="unknown engine option"):
        dec.with_options(beam_width=4)
    with pytest.raises(ValueError, match="segment_frames"):
        dec.with_options(segment_frames=-1)
    with pytest.raises(TypeError):
        P.build_ctcdecoder([" ", "a", "b", ""], device="cpu", collect_stats=True)


def test_segment_frames_default_is_the_eager_loop_on_the_cpu():
    dec = P.build_ctcdecoder([" ", "a", "b", ""], device="cpu")
    assert dec._segment_frames is None
    assert dec._segment_frames_effective() == 0


def test_with_options_clone_shares_tables_and_decodes_equal():
    dec = P.build_ctcdecoder([" ", "a", "b", ""], device="cpu")
    clone = dec.with_options(fast_topk=True, segment_frames=3)
    assert clone._segment_frames == 3 and dec._segment_frames is None
    assert clone._tabs is dec._tabs  # no table upload
    assert clone._device_lm is dec._device_lm
    assert clone._graphs is not dec._graphs and not clone._graphs  # graphs are per decoder
    logits = np.random.RandomState(0).randn(40, 4).astype(np.float32) * 3.0
    assert dec.decode(logits) == clone.decode(logits)


def test_with_options_clone_has_independent_lm_knobs(tmp_path):
    arpa = str(tmp_path / "tiny.arpa")
    with open(arpa, "w") as fh:
        fh.write(TINY)
    dec = P.build_ctcdecoder([" ", "a", "b", ""], kenlm_model_path=arpa, device="cpu")
    clone = dec.with_options(fast_topk=True)
    assert clone._tabs is dec._tabs
    assert clone._lm is not dec._lm
    clone.reset_params(alpha=0.123)
    assert clone._lm_members[0].alpha == 0.123
    assert dec._lm_members[0].alpha != 0.123
    dec.reset_params(alpha=0.9)
    assert clone._lm_members[0].alpha == 0.123
    # the parameter vector each decode uploads is its own decoder's
    assert clone._params_vector(-5.0, -10.0)[3] == np.float32(0.123)
    assert dec._params_vector(-5.0, -10.0)[3] == np.float32(0.9)


def test_with_options_clone_of_two_members_retunes_alone(arpa, tmp_path):
    two = tmp_path / "bb2.arpa"
    two.write_text(ARPA_2GRAM)
    lm = P.MultiLanguageModel([P.LanguageModel(open_ngram_file(arpa), UNIGRAMS),
                               P.LanguageModel(open_ngram_file(str(two)), UNIGRAMS, alpha=0.3)])
    dec = P.TorchBeamSearchDecoderCTC(P.Alphabet.build_alphabet(SAMPLE_LABELS), lm, device="cpu")
    clone = dec.with_options(segment_frames=4)
    assert clone._lm._language_models == clone._lm_members
    clone.reset_params(beta=3.0)
    assert [m.beta for m in clone._lm_members] == [3.0, 3.0]
    assert [m.beta for m in dec._lm_members] != [3.0, 3.0]
    kw = dict(beam_width=BEAM, hotwords=["bunny"])
    want = dec.decode_beams_batch(BATCH, **kw)
    dec.reset_params(beta=3.0)  # the original now carries the clone's knobs
    got = clone.decode_beams_batch(BATCH, **kw)
    again = dec.decode_beams_batch(BATCH, **kw)
    assert [b[0].lm_score for b in want] != [b[0].lm_score for b in got]
    for w, g in zip(again, got):
        assert_same_beams(w, g, tol=0.0)


@pytest.mark.parametrize("b", [1, 5, 37])
def test_fast_ranking_is_the_exact_ranking_without_boundary_ties(b):
    """JAX's ``fast_topk`` ranking (``approx_max_k`` at recall 1.0 and a two-key
    re-sort) on scores with ties inside the set and none across its boundary:
    the port's exact ranking, which serves ``fast_topk``, gives the same set
    in the same order."""
    import jax
    import jax.numpy as jnp

    rng = np.random.RandomState(b)
    scores = -np.stack([rng.permutation(90) for _ in range(6)]).astype(np.float32)  # distinct, <= 0
    for row in scores:  # the top b in pairs of equal scores, all above the rest
        top = rng.choice(87, size=b, replace=False)
        row[top] = 100.0 + np.arange(b) // 2
    scores[:, -3:] = -1.0e30  # DEAD candidates
    vals, idx = jax.lax.approx_max_k(jnp.asarray(scores), b, recall_target=1.0)
    _, idx, vals = jax.lax.sort((-vals, idx.astype(jnp.int32), vals), num_keys=2)
    got = _top_b(torch.as_tensor(scores), b)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(vals))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(idx))


CASES = {
    "dense": {},
    "dense, top_n 3": dict(top_n=3),
    "dense, hotwords": dict(hotwords=["bunny", "gun"], hotword_weight=5.0),
    "timeline, chunks of 2": dict(token_chunking=2),
    "timeline, collapse, bucketing": dict(token_chunking=True, blank_collapse=True, length_bucketing=2),
}


@pytest.mark.parametrize("case", list(CASES))
def test_fast_topk_matches_jax_fast_topk(pairs, case):
    jdec, pdec = pairs["fast"]
    kw = dict(beam_width=BEAM, **CASES[case])
    got = pdec.decode_beams_batch(BATCH, **kw)
    for w, g in zip(jdec.decode_beams_batch(BATCH, **kw), got):
        assert_same_beams(w, g)


@pytest.mark.parametrize("case", list(CASES))
def test_fast_topk_equals_the_exact_ranking(pairs, case):
    """On these cases ``fast_topk`` keeps the exact ranking's beams (and the segmented path too)."""
    _, exact = pairs["exact"]
    _, fast = pairs["fast"]
    kw = dict(beam_width=BEAM, **CASES[case])
    want = exact.decode_beams_batch(BATCH, **kw)
    for dec in (fast, fast.with_options(segment_frames=5)):
        for w, g in zip(want, dec.decode_beams_batch(BATCH, **kw)):
            assert_same_beams(w, g)
