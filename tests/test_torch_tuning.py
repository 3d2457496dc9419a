"""``grid_search_alpha_beta`` and ``profile_call`` in the port.

The sweep is a copy of the JAX package's: on the same inputs it must pick
the same best point and give the same WER at every grid point, for the
device decoder (``device="cpu"``) and for the host engine (whose
``decode_batch`` takes a pool first). ``profile_call`` on the CPU traces
the CPU operators: its report's sums must add up, and a trace its
``complete`` check rejects is taken again.
"""
import numpy as np
import pytest

import pyctcdecode_torch as P
from pyctcdecode_torch.models.ngram import open_ngram_file
from pyctcdecode_torch.utils.profiling import TraceReport, profile_call
from pyctcdecode_torch.utils.tuning import GridPoint, _needs_pool, grid_search_alpha_beta
from pyctcdecode_tpu import Alphabet as JAlphabet
from pyctcdecode_tpu import BeamSearchDecoderCTC as JBeamSearchDecoderCTC
from pyctcdecode_tpu import LanguageModel as JLanguageModel
from pyctcdecode_tpu import TPUBeamSearchDecoderCTC
from pyctcdecode_tpu.models.ngram import NGramModel as JNGramModel
from pyctcdecode_tpu.utils.tuning import grid_search_alpha_beta as j_grid_search_alpha_beta

from .helpers import SAMPLE_LABELS, TEST_LOGITS, TEST_PROBS
from .torch_cases import ARPA, UNIGRAMS, word_logits
from .torch_cases import one_torch_thread  # noqa: F401  (autouse fixture)

GRID = dict(alphas=(0.0, 1.0), betas=(0.0, 1.5), beam_width=16)
LOGITS = [np.asarray(TEST_PROBS), np.asarray(TEST_LOGITS), word_logits(3, 20)]
REFS = ["bugs bunny", "bugs bunny", "bunny sun"]


@pytest.fixture(scope="module")
def arpa(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("lm") / "bb3.arpa")
    with open(path, "w") as fh:
        fh.write(ARPA)
    return path


def _lms(arpa):
    return (JLanguageModel(JNGramModel.from_file(arpa), UNIGRAMS, unk_score_offset=0.0),
            P.LanguageModel(open_ngram_file(arpa), UNIGRAMS, unk_score_offset=0.0))


def test_sweep_on_the_device_decoder_equals_jax(arpa):
    jlm, plm = _lms(arpa)
    jdec = TPUBeamSearchDecoderCTC(JAlphabet.build_alphabet(SAMPLE_LABELS), jlm)
    pdec = P.TorchBeamSearchDecoderCTC(P.Alphabet.build_alphabet(SAMPLE_LABELS), plm, device="cpu")
    assert not _needs_pool(pdec)
    j_best, j_grid = j_grid_search_alpha_beta(jdec, LOGITS, REFS, **GRID)
    best, grid = grid_search_alpha_beta(pdec, LOGITS, REFS, **GRID)
    assert [(g.alpha, g.beta, g.wer) for g in grid] == [(g.alpha, g.beta, g.wer) for g in j_grid]
    assert (best.alpha, best.beta, best.wer) == (j_best.alpha, j_best.beta, j_best.wer)
    assert isinstance(best, GridPoint) and len(grid) == 4
    assert best.alpha == 1.0 and best.wer < max(g.wer for g in grid)
    assert (plm.alpha, plm.beta) == (0.5, 1.5)  # restored after the sweep


def test_sweep_on_the_host_engine_equals_jax(arpa):
    jlm, plm = _lms(arpa)
    jhost = JBeamSearchDecoderCTC(JAlphabet.build_alphabet(SAMPLE_LABELS), jlm)
    phost = P.BeamSearchDecoderCTC(P.Alphabet.build_alphabet(SAMPLE_LABELS), plm)
    try:
        assert _needs_pool(phost)
        kw = dict(GRID, betas=(1.5,))
        j_best, j_grid = j_grid_search_alpha_beta(jhost, LOGITS[:2], REFS[:2], **kw)
        best, grid = grid_search_alpha_beta(phost, LOGITS[:2], REFS[:2], **kw)
        assert [(g.alpha, g.beta, g.wer) for g in grid] == [(g.alpha, g.beta, g.wer) for g in j_grid]
        assert (best.alpha, best.wer) == (j_best.alpha, j_best.wer) == (1.0, 0.0)
    finally:
        jhost.cleanup()
        phost.cleanup()


def test_profile_call_on_the_cpu_adds_up(arpa):
    _, plm = _lms(arpa)
    pdec = P.TorchBeamSearchDecoderCTC(P.Alphabet.build_alphabet(SAMPLE_LABELS), plm, device="cpu")
    report = profile_call(lambda: pdec.decode_batch(LOGITS, beam_width=8))
    assert isinstance(report, TraceReport) and report.plane == "cpu"
    assert report.ops and report.launches == sum(op.count for op in report.ops) > 0
    assert sum(op.total_ms for op in report.ops) == pytest.approx(report.summed_ms)
    assert sum(op.share for op in report.ops) == pytest.approx(1.0)
    assert 0 < report.busy_ms <= report.summed_ms + 1e-9
    buckets = {"sort": ("sort",), "gather": ("gather", "index")}
    grouped = report.grouped(buckets)
    assert set(grouped) == {"sort", "gather", "other"}
    assert sum(grouped.values()) == pytest.approx(report.summed_ms)
    assert grouped["sort"] > 0 and grouped["gather"] > 0
    assert "plane: cpu" in report.table(top=5)


def test_profile_call_retakes_a_trace_its_check_rejects():
    """``complete`` sees each report; a rejected trace is taken again, and ``tries`` rejections raise."""
    import torch

    calls, seen = [], []

    def fn():
        calls.append(1)
        torch.ones(8).cumsum(0)

    def second_only(report):
        seen.append(report.launches)
        return len(seen) == 2

    report = profile_call(fn, tries=3, complete=second_only)
    assert len(calls) == len(seen) == 2 and report.launches == seen[-1] > 0
    with pytest.raises(RuntimeError, match="no complete trace in 1 tries"):
        profile_call(fn, tries=1, complete=lambda report: False)
