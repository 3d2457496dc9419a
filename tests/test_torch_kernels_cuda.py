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
from pyctcdecode_torch.ops import gather as tg
from pyctcdecode_torch.ops import merge as tm

from .helpers import SAMPLE_LABELS
from .torch_cases import (
    ARPA,
    DEAD,
    UNIGRAMS,
    assert_outputs,
    assert_same_beams,
    chunk_token_planes,
    expand_inputs,
    merge_inputs,
    torch_merge_args,
    torch_planes,
    word_logits,
)


def assert_same_batch(want, got):
    assert len(got) == len(want)
    for wb, gb in zip(want, got):
        assert_same_beams(wb, gb)


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
def test_cuda_chunk_step_with_the_window_off():
    """Per-utterance chunk token planes with empty slots, ``prune = -inf``, a dead utterance."""
    dev = _cuda()
    rng = np.random.RandomState(8)
    beam, tok, cids, pscore, _ = expand_inputs(rng, 4, 5, 100, 1)
    tok = chunk_token_planes(rng, tok, 29)
    beam["logit"][-1] = DEAD
    eargs = (
        {key: val.to(dev) for key, val in torch_planes(beam).items()},
        {key: val.to(dev) for key, val in torch_planes(tok).items()},
        torch.as_tensor(cids).to(dev), torch.as_tensor(pscore).to(dev),
        torch.full((4,), float("-inf"), device=dev), False,
    )
    got = [g.cpu() for g in tm.expand_merge_prune(*eargs)]
    torch.cuda.synchronize()
    want = [w.cpu() for w in tm.expand_merge_prune_ref(*eargs)]
    assert not torch.isnan(got[0]).any()
    assert torch.equal(got[0] > -1e29, want[0] > -1e29)  # no window: the live sets are equal
    assert_outputs([g[:-1] for g in got], [w[:-1] for w in want])
    assert bool((got[0][-1] == DEAD).all())


@pytest.mark.cuda
@pytest.mark.parametrize(
    "rows,width,idx_shape",
    [(4096, 64, (1000,)), (512, 128, (7, 33)), (64, 4, (1,)), (1000, 24, (3, 5, 11))],
)
def test_gather_rows_kernel_matches_plain_version(rows, width, idx_shape):
    """The gather kernel is bit-exact, with repeated indices and ragged counts."""
    dev = _cuda()
    rng = np.random.RandomState(rows + width)
    table = torch.as_tensor(rng.randint(-(1 << 31), 1 << 31, (rows, width)).astype(np.int32)).to(dev)
    idx = rng.randint(0, rows, idx_shape)
    idx.reshape(-1)[: idx.size // 2] = idx.reshape(-1)[0]  # heavy repeats
    idx = torch.as_tensor(idx.astype(np.int64)).to(dev)
    before = tg.gather_rows.launches
    got = tg.gather_rows(table, idx)
    torch.cuda.synchronize()
    assert tg.gather_rows.launches == before + 1
    assert got.shape == (*idx_shape, width) and got.dtype == torch.int32
    assert torch.equal(got, tg.gather_rows_ref(table, idx))


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
    # the serving call: chunks, collapse, two length groups; 3 gathers per step (3-gram)
    kw = dict(beam_width=16, prune_history=True, token_chunking=3, blank_collapse=True,
              length_bucketing=2)
    expand_before = tm.expand_merge_prune.launches
    merge_before = tm.merge_prune.launches
    gather_before = tg.gather_rows.launches
    got = gpu.decode_beams_batch(batch, **kw)
    steps = tm.expand_merge_prune.launches - expand_before
    assert tm.merge_prune.launches - merge_before == 2  # one finalize per group
    assert tg.gather_rows.launches - gather_before == 3 * steps + 2 * 4
    assert_same_batch(cpu.decode_beams_batch(batch, **kw), got)
    assert_same_batch(want, got)  # and the dense decode's results
