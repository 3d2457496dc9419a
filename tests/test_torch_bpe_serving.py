"""BPE on the port's serving decode, with hotwords and a MultiLanguageModel, against the JAX package.

``TorchBeamSearchDecoderCTC(device="cpu")`` against the JAX
``TPUBeamSearchDecoderCTC`` on a 48-column piece vocabulary grown from the
inline ARPA's words (labels up to ``▁`` + 4 letters; ``▁⁇▁`` mid-utterance),
the same ARPA (and the same model cut to a 2-gram) and the same logits made
with numpy from seeds: texts, ``text_frames`` and ``last_lm_state``
identical, scores within 1e-4 (both engines score in float32). The timeline
decode resolves a pool winner's characters by token id, and under the blank
collapse the per-row replay maps positions to original frames: both show
only in the outputs, so every case compares whole beam lists.

The JAX engine compiles one program per shape, so the cases share one batch
and one beam width.
"""
import pytest
import torch

import pyctcdecode_torch as P
from pyctcdecode_torch.models.ngram import open_ngram_file
from pyctcdecode_tpu import Alphabet as JAlphabet
from pyctcdecode_tpu import LanguageModel as JLanguageModel
from pyctcdecode_tpu import MultiLanguageModel as JMultiLanguageModel
from pyctcdecode_tpu import TPUBeamSearchDecoderCTC
from pyctcdecode_tpu.models.ngram import NGramModel as JNGramModel

from .torch_cases import (
    ARPA,
    ARPA_2GRAM,
    BPE_LABELS,
    LM_WORDS,
    UNIGRAMS,
    assert_same_beams,
    piece_logits,
    piece_vocabulary,
)
from .torch_cases import one_torch_thread  # noqa: F401  (autouse fixture)

PIECES = piece_vocabulary(LM_WORDS)
BEAM = 12
MEMBER_B = dict(alpha=0.3, beta=2.0, unk_score_offset=-6.0, score_boundary=False)


def _with_blank_run(mat, lo, hi):
    """``mat`` with frames ``lo:hi`` made blank-certain (the collapse drops all but the first)."""
    mat = mat.copy()
    mat[lo:hi, -1] += 14.0
    return mat


def _batch(labels):
    return [
        piece_logits(20, labels, 6),
        piece_logits(21, labels, 3),
        _with_blank_run(piece_logits(22, labels, 6), 4, 10),
        piece_logits(23, labels, 4, False),
        _with_blank_run(piece_logits(24, labels, 5), 12, 18),
    ]


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
    """(JAX, torch) decoder pairs on the piece vocabulary: no LM, the 3-gram, 3-gram + 2-gram."""
    ja = JAlphabet.build_alphabet(PIECES)
    pa = P.Alphabet.build_alphabet(PIECES)

    def lms(order, **kw):
        return (JLanguageModel(JNGramModel.from_file(arpas[order]), UNIGRAMS, **kw),
                P.LanguageModel(open_ngram_file(arpas[order]), UNIGRAMS, **kw))

    (j3, p3), (j3b, p3b), (j2, p2) = lms("3"), lms("3"), lms("2", **MEMBER_B)
    return {
        "none": (TPUBeamSearchDecoderCTC(ja), P.TorchBeamSearchDecoderCTC(pa, device="cpu")),
        "lm": (TPUBeamSearchDecoderCTC(ja, j3), P.TorchBeamSearchDecoderCTC(pa, p3, device="cpu")),
        "multi": (TPUBeamSearchDecoderCTC(ja, JMultiLanguageModel([j3b, j2])),
                  P.TorchBeamSearchDecoderCTC(pa, P.MultiLanguageModel([p3b, p2]), device="cpu")),
    }


@pytest.fixture(scope="module")
def batch(decoders):
    return _batch(decoders["lm"][1]._alphabet.labels)


def assert_same_batch(want, got):
    assert len(got) == len(want)
    for wb, gb in zip(want, got):
        assert_same_beams(wb, gb)


@pytest.mark.parametrize(
    "lm,options",
    [
        ("lm", dict()),
        ("lm", dict(token_chunking=2)),
        ("lm", dict(token_chunking=5)),
        ("none", dict(token_chunking=5, blank_collapse=True)),
        ("lm", dict(blank_collapse=True)),
        ("lm", dict(token_chunking=True, blank_collapse=True, length_bucketing=3)),
        ("lm", dict(max_tokens_per_frame="auto", length_bucketing=3)),
        ("lm", dict(token_chunking=2, top_n=2, prune_history=False)),
        ("multi", dict()),
        ("multi", dict(token_chunking=5, blank_collapse=True, length_bucketing=3)),
    ],
)
def test_serving_decode_matches_jax(decoders, batch, lm, options):
    jdec, pdec = decoders[lm]
    kw = dict(dict(beam_width=BEAM, prune_history=True), **options)
    assert_same_batch(jdec.decode_beams_batch(batch, **kw), pdec.decode_beams_batch(batch, **kw))


@pytest.mark.parametrize(
    "lm,hotwords,options",
    [
        ("lm", ["guns", "sunny bun"], dict()),
        ("none", ["bunny", "nun"], dict(token_chunking=5)),
        ("multi", ["guns", "sunny bun", "bugsy"], dict(token_chunking=2, blank_collapse=True)),
    ],
)
def test_hotwords_match_jax(decoders, batch, lm, hotwords, options):
    jdec, pdec = decoders[lm]
    kw = dict(beam_width=BEAM, prune_history=True, hotwords=hotwords, hotword_weight=6.0, **options)
    assert_same_batch(jdec.decode_beams_batch(batch, **kw), pdec.decode_beams_batch(batch, **kw))


def test_pipelined_batches_match_jax(decoders, batch):
    """``decode_beams_batches`` at depth 2 over three batches (the same lengths: one JAX program)."""
    jdec, pdec = decoders["lm"]
    stream = [batch, batch[::-1], batch[1:] + batch[:1]]
    kw = dict(beam_width=BEAM, token_chunking=5, blank_collapse=True, length_bucketing=3)
    want = list(jdec.decode_beams_batches(stream, pipeline_depth=2, **kw))
    got = list(pdec.decode_beams_batches(stream, pipeline_depth=2, **kw))
    assert len(got) == len(want) == 3
    for wb, gb in zip(want, got):
        assert_same_batch(wb, gb)


def test_build_ctcdecoder_takes_piece_labels(arpas, batch):
    """``▁``- and ``##``-style labels build through the factory; CUDA by default, no fallback."""
    for labels in (PIECES, ["bug", "bun", "##ny", "##s", "##g", "##un", "<unk>", ""]):
        dec = P.build_ctcdecoder(labels, arpas["3"], device="cpu")
        assert dec._alphabet.is_bpe and dec.device.type == "cpu"
    assert dec._alphabet.labels == BPE_LABELS
    dec = P.build_ctcdecoder(PIECES, arpas["3"], device="cpu")
    assert dec.decode_batch(batch, beam_width=BEAM) == dec.decode_batch(
        batch, beam_width=BEAM, token_chunking=True, blank_collapse=True
    )
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            P.build_ctcdecoder(PIECES, arpas["3"])
