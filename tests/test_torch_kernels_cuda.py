"""The port on the card: CUDA kernels vs plain versions, GPU decode vs CPU decode.

Every test here needs an NVIDIA GPU and skips without one. The module
imports neither JAX nor the JAX package, so on the GPU machine it runs
without the suite's JAX configuration:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py
"""
import numpy as np
import pytest
import torch

import pyctcdecode_torch as P
from pyctcdecode_torch.models.ngram import open_ngram_file
from pyctcdecode_torch.ops import merge as tm

from .helpers import SAMPLE_LABELS
from .torch_cases import (
    ARPA,
    UNIGRAMS,
    assert_outputs,
    expand_inputs,
    merge_inputs,
    torch_merge_args,
    torch_planes,
    word_logits,
)


def _cuda() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_kernels_match_plain_versions():
    """Each kernel against its plain version on the same card inputs."""
    dev = _cuda()
    kl, kh, valid, logit, extra, prune = merge_inputs(np.random.RandomState(6), 4, 7, 100)
    args = [a.to(dev) for a in torch_merge_args(kl, kh, valid, logit, extra, prune)]
    got = tm.merge_prune(*args)
    torch.cuda.synchronize()
    assert_outputs([g.cpu() for g in got], [w.cpu() for w in tm.merge_prune_ref(*args)])
    for lmax, is_bpe in ((1, False), (3, True)):
        beam, tok, cids, pscore, prune = expand_inputs(np.random.RandomState(7), 4, 9, 100, lmax)
        eargs = (
            {key: val.to(dev) for key, val in torch_planes(beam).items()},
            {key: val.to(dev) for key, val in torch_planes(tok).items()},
            torch.as_tensor(cids).to(dev), torch.as_tensor(pscore).to(dev),
            torch.as_tensor(prune).to(dev), is_bpe,
        )
        got = tm.expand_merge_prune(*eargs)
        torch.cuda.synchronize()
        assert_outputs(
            [g.cpu() for g in got], [w.cpu() for w in tm.expand_merge_prune_ref(*eargs)]
        )


@pytest.mark.cuda
def test_gpu_decode_matches_cpu_decode(tmp_path):
    """The whole engine on CUDA (kernels) vs on the CPU (plain versions)."""
    _cuda()
    path = str(tmp_path / "bb3.arpa")
    with open(path, "w") as fh:
        fh.write(ARPA)
    alphabet = P.Alphabet.build_alphabet(SAMPLE_LABELS)
    lm = P.LanguageModel(open_ngram_file(path), UNIGRAMS)
    gpu = P.TorchBeamSearchDecoderCTC(alphabet, lm)
    cpu = P.TorchBeamSearchDecoderCTC(alphabet, lm, device="cpu")
    batch = [word_logits(11, 33), word_logits(12, 17), word_logits(13, 40)]
    expand_before = tm.expand_merge_prune.launches
    merge_before = tm.merge_prune.launches
    got = gpu.decode_beams_batch(batch, beam_width=16, prune_history=True)
    assert tm.expand_merge_prune.launches - expand_before == 40  # one per frame step
    assert tm.merge_prune.launches - merge_before == 1
    want = cpu.decode_beams_batch(batch, beam_width=16, prune_history=True)
    for g_beams, c_beams in zip(got, want):
        assert len(g_beams) == len(c_beams) > 0
        for g, c in zip(g_beams, c_beams):
            assert g.text == c.text
            assert g.text_frames == c.text_frames
            assert g.last_lm_state == c.last_lm_state
            assert abs(g.logit_score - c.logit_score) <= 1e-4
            assert abs(g.lm_score - c.lm_score) <= 1e-4
