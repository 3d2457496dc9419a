"""The port's corpus evaluation harness and ``utils`` exports against the JAX package's.

``tests/test_eval.py``'s ``TestCorpusEvaluation`` cases run on the port, on
the CPU (``device="cpu"``), at a small size: 12 utterances, beam 24, the
37-word inline 2-gram of that file. The same corpus and ARPA go through
both packages:

- a synthesized corpus (the default settings and both difficulty presets)
  equals JAX's, array for array;
- ``evaluate_corpus`` on the host oracle with and without the LM gives
  JAX's WERs and hypotheses, and its report keeps JAX's keys;
- ``compare_engines`` (host oracle against the device decoder) gives JAX's
  host and device hypotheses and WERs, with and without the device-only
  options, which the host oracle drops;
- ``character_error_rate`` equals JAX's on random string pairs;
- ``normalize_to_logp_torch`` is within 1e-6 of ``normalize_to_logp_jnp``
  on probabilities, logits and log-probs, under ``"auto"`` and each forced
  ``assume``.
"""
import numpy as np
import pytest
import torch

import pyctcdecode_torch as P
from pyctcdecode_torch import evaluation as ev

from .test_eval import LIBRI_LABELS, VOCAB, _write_arpa
from .torch_cases import one_torch_thread  # noqa: F401  (autouse fixture)

N_UTTS = 12
BEAM = 24
DEVICE_KW = dict(max_tokens_per_frame="auto", blank_collapse=True, token_chunking=3)


@pytest.fixture(scope="module")
def arpa(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("eval") / "lm.arpa")
    _write_arpa(path, VOCAB)
    return path


@pytest.fixture(scope="module")
def corpus():
    return ev.synthesize_corpus(LIBRI_LABELS, VOCAB, n_utterances=N_UTTS, seed=7, noise=1.5)


@pytest.mark.parametrize("preset", ["default", "DEV_OTHER_DIFFICULTY", "FIXTURE_DIFFICULTY"])
def test_synthesized_corpus_equals_jax(preset):
    from pyctcdecode_tpu import evaluation as jev

    settings = {} if preset == "default" else getattr(ev, preset)
    if preset != "default":
        assert settings == getattr(jev, preset)
    ours = ev.synthesize_corpus(LIBRI_LABELS, VOCAB, n_utterances=N_UTTS, seed=3, **settings)
    theirs = jev.synthesize_corpus(LIBRI_LABELS, VOCAB, n_utterances=N_UTTS, seed=3, **settings)
    assert ours.references == theirs.references and ours.labels == theirs.labels
    assert ours.audio_seconds == theirs.audio_seconds and len(ours) == len(theirs)
    for a, b in zip(ours.logits, theirs.logits):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_host_oracle_wer_equals_jax_and_the_lm_helps(arpa):
    """``TestCorpusEvaluation.test_greedyish_wer_beats_chance_and_lm_helps`` on the port, against JAX's."""
    from pyctcdecode_tpu import BeamSearchDecoderCTC as JBeamSearchDecoderCTC
    from pyctcdecode_tpu import build_ctcdecoder as j_build
    from pyctcdecode_tpu import evaluation as jev

    corpus = ev.synthesize_corpus(LIBRI_LABELS, VOCAB, n_utterances=N_UTTS, seed=1, noise=1.6)
    reports = {}
    try:
        for name, build, evaluate in (("port", P.build_ctcdecoder, ev.evaluate_corpus),
                                      ("jax", j_build, jev.evaluate_corpus)):
            no_lm = build(LIBRI_LABELS, engine="host")
            with_lm = build(LIBRI_LABELS, arpa, alpha=0.6, engine="host")
            reports[name] = [evaluate(dec, corpus, beam_width=BEAM, warmup=False) for dec in (no_lm, with_lm)]
    finally:
        P.BeamSearchDecoderCTC.clear_class_models()
        JBeamSearchDecoderCTC.clear_class_models()
    for ours, theirs in zip(reports["port"], reports["jax"]):
        assert set(ours) == set(theirs)
        assert ours["hypotheses"] == theirs["hypotheses"] and ours["wer"] == theirs["wer"]
        assert ours["audio_seconds"] == theirs["audio_seconds"] and ours["n_utterances"] == N_UTTS
    r0, r1 = reports["port"]
    assert r0["wer"] < 0.9
    assert r1["wer"] <= r0["wer"]  # shallow fusion with the word-list LM repairs noisy spellings


@pytest.mark.parametrize("options", ["plain", "device_only"])
def test_compare_engines_equals_jax(arpa, corpus, options):
    """``TestCorpusEvaluation.test_engine_parity_on_corpus`` on the port, against JAX's ``compare_engines``.

    ``device_only`` passes ``max_tokens_per_frame="auto"``, ``blank_collapse``
    and token chunks of 3: the device decoders take them, the host oracles
    drop them (``_DEVICE_ONLY_KWARGS``).
    """
    from pyctcdecode_tpu import BeamSearchDecoderCTC as JBeamSearchDecoderCTC
    from pyctcdecode_tpu import build_ctcdecoder as j_build
    from pyctcdecode_tpu import evaluation as jev

    kw = DEVICE_KW if options == "device_only" else {}
    assert ev._DEVICE_ONLY_KWARGS == jev._DEVICE_ONLY_KWARGS
    try:
        ours = ev.compare_engines(
            P.build_ctcdecoder(LIBRI_LABELS, arpa, alpha=0.6, engine="host"),
            P.build_ctcdecoder(LIBRI_LABELS, arpa, alpha=0.6, device="cpu"),
            corpus, beam_width=BEAM, **kw,
        )
        theirs = jev.compare_engines(
            j_build(LIBRI_LABELS, arpa, alpha=0.6, engine="host"),
            j_build(LIBRI_LABELS, arpa, alpha=0.6, engine="tpu"),
            corpus, beam_width=BEAM, **kw,
        )
    finally:
        P.BeamSearchDecoderCTC.clear_class_models()
        JBeamSearchDecoderCTC.clear_class_models()
    assert set(ours) == set(theirs)
    for side in ("host", "device"):
        assert set(ours[side]) == set(theirs[side])
        assert ours[side]["wer"] == theirs[side]["wer"]
        assert ours[f"{side}_hypotheses"] == theirs[f"{side}_hypotheses"]
    assert ours["top1_agreement"] == theirs["top1_agreement"] >= 0.99
    assert ours["wer_delta"] == theirs["wer_delta"]


def test_evaluate_corpus_on_the_device_decoder_keeps_its_keys(arpa, corpus):
    """With its warm-up batch, on the device decoder: JAX's report keys, and the decode's own transcripts."""
    dec = P.build_ctcdecoder(LIBRI_LABELS, arpa, alpha=0.6, device="cpu")
    small = ev.Corpus(corpus.references[:4], corpus.logits[:4], corpus.labels)
    report = ev.evaluate_corpus(dec, small, beam_width=BEAM)
    assert set(report) == {"wer", "audio_seconds", "wall_seconds", "audio_sec_per_sec",
                           "n_utterances", "beam_width", "hypotheses"}
    assert report["hypotheses"] == dec.decode_batch(small.logits, beam_width=BEAM)
    assert report["wer"] == P.utils.word_error_rate(small.references, report["hypotheses"])
    assert report["n_utterances"] == 4 and report["beam_width"] == BEAM
    assert report["audio_sec_per_sec"] > 0


def test_character_error_rate_equals_jax():
    from pyctcdecode_tpu.utils import character_error_rate as j_cer

    rng = np.random.RandomState(5)
    letters = list("ab cd'")
    refs = ["".join(rng.choice(letters, size=rng.randint(1, 30))) for _ in range(40)]
    hyps = ["".join(rng.choice(letters, size=rng.randint(0, 30))) for _ in range(40)]
    hyps[:5] = refs[:5]
    assert P.utils.character_error_rate(refs, hyps) == j_cer(refs, hyps)
    assert P.utils.character_error_rate(refs[:5], hyps[:5]) == 0.0


def test_utils_exports_the_jax_names():
    import pyctcdecode_tpu.utils as jutils

    want = {"normalize_to_logp_torch" if name == "normalize_to_logp_jnp" else name for name in jutils.__all__}
    assert set(P.utils.__all__) == want
    assert all(callable(getattr(P.utils, name)) for name in P.utils.__all__)


def _inputs(kind: str) -> np.ndarray:
    rng = np.random.RandomState({"probs": 0, "logits": 1, "logp": 2}[kind])
    x = (rng.randn(3, 40, 29) * 3.0).astype(np.float32)
    if kind == "logits":
        return x
    logp = x - np.log(np.exp(x.astype(np.float64)).sum(-1, keepdims=True))
    return (np.exp(logp) if kind == "probs" else logp).astype(np.float32)


@pytest.mark.parametrize("assume", ["auto", "probs", "logits", "logp"])
@pytest.mark.parametrize("kind", ["probs", "logits", "logp"])
def test_normalize_to_logp_torch_matches_jnp(kind, assume):
    """Within 1e-6, absolute and relative (an f32 unit in the last place at 16-32 is 1.9e-6)."""
    import jax.numpy as jnp

    from pyctcdecode_tpu.utils import normalize_to_logp_jnp

    x = _inputs(kind)
    want = np.asarray(normalize_to_logp_jnp(jnp.asarray(x), assume=assume))
    got = P.utils.normalize_to_logp_torch(torch.as_tensor(x), assume=assume)
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    if assume == "auto":  # the sniff takes the domain the host normalization takes
        np.testing.assert_allclose(got.numpy()[0], P.utils.normalize_to_logp(x[0]), rtol=1e-6, atol=1e-6)
