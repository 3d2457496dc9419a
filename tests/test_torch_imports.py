"""The port stands alone: no JAX, nothing of pyctcdecode_tpu; CUDA unless asked."""
import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHECK = """
import sys
import pyctcdecode_torch
import pyctcdecode_torch.engine, pyctcdecode_torch.evaluation, pyctcdecode_torch.ops.merge
import pyctcdecode_torch.csrc.build
bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'pyctcdecode_tpu'))
assert not bad, bad
print('clean')
"""


def test_import_pulls_in_no_jax_and_no_reference_package():
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run(
        [sys.executable, "-c", _CHECK], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert "clean" in out.stdout


def test_no_source_file_names_jax_or_the_reference_package():
    root = os.path.join(REPO, "pyctcdecode_torch")
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for dirpath, _, files in os.walk(root):
        paths += [os.path.join(dirpath, name) for name in files if name.endswith((".py", ".cu"))]
    offenders = []
    for path in paths:
        with open(path, encoding="utf-8") as fh:
            text = fh.read()
        for needle in ("import jax", "from jax", "pyctcdecode_tpu"):
            if needle in text:
                offenders.append(f"{os.path.relpath(path, REPO)}: {needle}")
    assert not offenders, offenders


def test_default_device_is_cuda_and_never_falls_back():
    import pyctcdecode_torch as P

    alphabet = P.Alphabet.build_alphabet([" ", "a", "b", ""])
    if torch.cuda.is_available():
        assert P.TorchBeamSearchDecoderCTC(alphabet).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        P.TorchBeamSearchDecoderCTC(alphabet)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        P.build_ctcdecoder([" ", "a", "b", ""])
    assert P.TorchBeamSearchDecoderCTC(alphabet, device="cpu").device.type == "cpu"
