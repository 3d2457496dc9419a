"""wav2vec2-base-960h's 32 labels on the card: the LM's ``<s>`` / ``</s>`` as decoded words.

Captured graphs equal the eager loop to the bit, batch and stream, and the
card decodes the ``</s>`` and ``<s>`` paths as the port's host engine does
(the CPU cases, held to the JAX package too, are in ``test_torch_w2v2``).
Every test needs an NVIDIA GPU and skips without one. The module imports
neither JAX nor the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_w2v2_cuda.py
"""
import pytest
import torch

import pyctcdecode_torch as P

from .torch_cases import assert_same_beams, assert_same_views
from .w2v2_cases import (
    ARPA,
    BEAM,
    PATHS,
    W2V2_LABELS,
    chunks_of,
    device_stream,
    host_stream,
    path_logits,
    random_logits,
)


def _cuda() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: graphs and kernels have no CPU mode")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    path = tmp_path_factory.mktemp("lm") / "markers.arpa"
    path.write_text(ARPA)
    yield P.build_ctcdecoder(W2V2_LABELS, str(path), engine="host")
    P.BeamSearchDecoderCTC.clear_class_models()


@pytest.mark.cuda
def test_cuda_graphs_equal_the_eager_loop_on_the_w2v2_labels(host):
    _cuda()
    dec = P.TorchBeamSearchDecoderCTC(host._alphabet, host._language_model)
    eager = dec.with_options(segment_frames=0)
    mats = [random_logits(200 + i, t) for i, t in enumerate((60, 23, 41))] + \
        [path_logits(W2V2_LABELS, PATHS[case]) for case in ("eos_mid", "bos_first")]
    for w, g in zip(eager.decode_beams_batch(mats, beam_width=BEAM), dec.decode_beams_batch(mats, beam_width=BEAM)):
        assert_same_beams(w, g, tol=0.0)
    for mat in mats[::2]:
        chunks = chunks_of(mat, 9)
        for w, g in zip(device_stream(eager, chunks), device_stream(dec, chunks)):
            assert_same_views(w, g, tol=0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["eos_mid", "eos_end", "bos_first", "markers_run_on"])
def test_cuda_decodes_the_markers_as_the_host_engine(host, case):
    _cuda()
    dec = P.TorchBeamSearchDecoderCTC(host._alphabet, host._language_model)
    mat = path_logits(W2V2_LABELS, PATHS[case], seed=7)
    want = host.decode_beams(mat, beam_width=BEAM)
    assert_same_beams(want, dec.decode_beams_batch([mat], beam_width=BEAM)[0])
    chunks = chunks_of(mat, 3)
    for w, g in zip(host_stream(host, chunks), device_stream(dec, chunks)):
        assert_same_views(w, g)
