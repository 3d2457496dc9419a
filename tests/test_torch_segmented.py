"""Segmented batch decode (``segment_frames``) in the port, held against the JAX package.

The port's segmented decode (``engine.make_segment_decode_fns``: segments of
``segment_frames`` steps from a frame offset that is device data, the
parameter vector as device data, inputs padded to whole segments) runs
eagerly on the CPU; on the card each segment is a captured CUDA graph
(``tests/test_torch_graphs_cuda.py``). The same inputs, made with numpy
from seeds, go through ``TorchBeamSearchDecoderCTC(device="cpu",
segment_frames=S)`` for S = 1, 4 and 16 and through the JAX
``TPUBeamSearchDecoderCTC`` with ``segment_frames=0`` (its ``lax.scan``
program, which the JAX package pins bit for bit to its own segmented path),
and in one case with JAX's own ``segment_frames=4``. Texts,
``text_frames`` and ``last_lm_state`` identical; scores within 1e-4 (both
engines score in float32). The port's segmented decode must also equal its
own eager loop to the bit. Batches are ragged, and no length is a multiple
of a segment.
"""
import numpy as np
import pytest

import pyctcdecode_torch as P
from pyctcdecode_torch.engine import make_segment_decode_fns
from pyctcdecode_torch.models.ngram import open_ngram_file
from pyctcdecode_tpu import Alphabet as JAlphabet
from pyctcdecode_tpu import LanguageModel as JLanguageModel
from pyctcdecode_tpu import TPUBeamSearchDecoderCTC
from pyctcdecode_tpu.models.language_model import MultiLanguageModel as JMultiLanguageModel
from pyctcdecode_tpu.models.ngram import NGramModel as JNGramModel

from .helpers import SAMPLE_LABELS
from .torch_cases import (
    ARPA,
    ARPA_2GRAM,
    LM_WORDS,
    UNIGRAMS,
    assert_same_beams,
    piece_logits,
    piece_vocabulary,
    word_logits,
)
from .torch_cases import one_torch_thread  # noqa: F401  (autouse fixture)

BEAM = 8
BATCH = [word_logits(7, 31), word_logits(8, 13), word_logits(9, 39), word_logits(10, 22)]
BATCH[2][5:15, -1] += 14.0  # a blank run: the collapse drops all but its first frame
PIECES = piece_vocabulary(LM_WORDS)
SEGMENTS = [1, 4, 16]


@pytest.fixture(scope="module")
def decoders(tmp_path_factory):
    """(JAX, torch) decoder pairs by name, built on first use; the torch one with the eager loop."""
    root = tmp_path_factory.mktemp("lm")
    paths = {}
    for name, text in (("3", ARPA), ("2", ARPA_2GRAM)):
        paths[name] = str(root / f"bb{name}.arpa")
        with open(paths[name], "w") as fh:
            fh.write(text)
    cache = {}

    def get(name):
        if name not in cache:
            labels = PIECES if name == "bpe" else SAMPLE_LABELS
            ja, pa = JAlphabet.build_alphabet(labels), P.Alphabet.build_alphabet(labels)
            if name == "none":
                jlm = plm = None
            elif name == "two":
                kw = dict(alpha=0.3, beta=2.0, score_boundary=False)
                jlm = JMultiLanguageModel([JLanguageModel(JNGramModel.from_file(paths["3"]), UNIGRAMS),
                                           JLanguageModel(JNGramModel.from_file(paths["2"]), UNIGRAMS, **kw)])
                plm = P.MultiLanguageModel([P.LanguageModel(open_ngram_file(paths["3"]), UNIGRAMS),
                                            P.LanguageModel(open_ngram_file(paths["2"]), UNIGRAMS, **kw)])
            else:
                jlm = JLanguageModel(JNGramModel.from_file(paths["3"]), UNIGRAMS)
                plm = P.LanguageModel(open_ngram_file(paths["3"]), UNIGRAMS)
            cache[name] = (TPUBeamSearchDecoderCTC(ja, jlm, segment_frames=0),
                           P.TorchBeamSearchDecoderCTC(pa, plm, device="cpu", segment_frames=0))
        return cache[name]

    return get


@pytest.fixture(scope="module")
def jax_results():
    """Each case's JAX decode, run once for every segment size of the port."""
    return {}


def _bpe_batch():
    labels = P.Alphabet.build_alphabet(PIECES).labels
    return [piece_logits(s, labels, n) for s, n in ((0, 5), (1, 3), (2, 6))]


CASES = {
    "dense, no LM": ("none", {}),
    "dense, one LM": ("lm", {}),
    "dense, top_n 2, no history prune": ("lm", dict(top_n=2, prune_history=False)),
    "dense, hotwords": ("lm", dict(hotwords=["bunny", "gun"], hotword_weight=5.0)),
    "dense, two members, hotwords": ("two", dict(hotwords=["sunny bun"], top_n=3)),
    "dense, stats": ("lm", dict(collect_stats=True)),
    "timeline, chunks of 2": ("lm", dict(token_chunking=2)),
    "timeline, chunks of 5, collapse, bucketing": (
        "lm", dict(token_chunking=5, blank_collapse=True, length_bucketing=2)),
    "timeline, two members, stats": ("two", dict(token_chunking=2, collect_stats=True)),
    "bpe, dense": ("bpe", {}),
}


def _assert_same(want, got, stats, tol):
    if stats:
        (want, want_stats), (got, got_stats) = want, got
        assert got_stats == want_stats
    assert len(got) == len(want)
    for w, g in zip(want, got):
        assert_same_beams(w, g, tol=tol)


@pytest.mark.parametrize("seg", SEGMENTS)
@pytest.mark.parametrize("case", list(CASES))
def test_segmented_decode_matches_jax(decoders, jax_results, case, seg):
    name, kw = CASES[case]
    jdec, pdec = decoders(name)
    batch = _bpe_batch() if name == "bpe" else BATCH
    kw = dict(beam_width=BEAM, **kw)
    if case not in jax_results:
        jax_results[case] = jdec.decode_beams_batch(batch, **kw)
    segmented = pdec.with_options(segment_frames=seg)
    assert segmented._segment_frames_effective() == seg
    got = segmented.decode_beams_batch(batch, **kw)
    stats = kw.get("collect_stats", False)
    _assert_same(jax_results[case], got, stats, tol=1e-4)
    _assert_same(pdec.decode_beams_batch(batch, **kw), got, stats, tol=0.0)  # the eager loop, to the bit


def test_segmented_decode_matches_jax_segmented(decoders):
    """Against the JAX package's own segment programs (``segment_frames=4``)."""
    jdec, pdec = decoders("lm")
    jseg = TPUBeamSearchDecoderCTC(jdec._alphabet, jdec._lm, segment_frames=4)
    kw = dict(beam_width=BEAM, top_n=2, hotwords=["bunny"], hotword_weight=5.0)
    want = jseg.decode_beams_batch(BATCH, **kw)
    _assert_same(want, pdec.with_options(segment_frames=4).decode_beams_batch(BATCH, **kw), False, 1e-4)


def test_single_utterance_calls_run_segmented(decoders):
    """``decode_beams`` / ``decode`` are batches of one: the segmented path gives the eager results."""
    jdec, pdec = decoders("lm")
    seg = pdec.with_options(segment_frames=4)
    mat = word_logits(12, 37)
    assert_same_beams(pdec.decode_beams(mat, beam_width=BEAM), seg.decode_beams(mat, beam_width=BEAM), tol=0.0)
    assert seg.decode(mat, beam_width=BEAM) == jdec.decode(mat, beam_width=BEAM)


def test_segment_functions_pad_inactive_steps(decoders):
    """``seg_fn`` past a row's length leaves its state as it is and emits -1; the paths hold -1 there."""
    import torch

    _, pdec = decoders("lm")
    cfg = pdec._engine_cfg(BEAM, 8, True, False)
    init_fn, seg_fn, fin_fn = make_segment_decode_fns(cfg, pdec._tabs, 4)
    logp = torch.as_tensor(np.log(np.full((2, 8, 8), 1 / 8, dtype=np.float32)))
    n_frames = torch.tensor([3, 8])
    params = pdec._params_vector(-5.0, -10.0)
    state = init_fn(pdec._start_ctx(None), 2)
    logs = []
    for s in range(2):
        state, (par, tok) = seg_fn(state, logp[:, 4 * s : 4 * s + 4], 4 * s, n_frames, torch.as_tensor(params))
        logs.append((par, tok))
    parents = torch.cat([p for p, _ in logs], dim=1)
    trace = torch.cat([t for _, t in logs], dim=1)
    assert parents.shape == (2, 8, BEAM) and trace.dtype == torch.int8
    assert (trace[0, 3:] == -1).all() and (parents[0, 3:] == torch.arange(BEAM)).all()
    assert (trace[1] != -1).any(dim=1).all()
    out = fin_fn(state, params, parents, trace)
    assert (out["paths"][0, :, 3:] == -1).all()
    assert set(out) == {"beam_src", "logit", "lm_score", "paths", "ctx0", "ctx_len0"}
