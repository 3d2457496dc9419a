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
import pyctcdecode_torch.ops.gather, pyctcdecode_torch.utils.logits, pyctcdecode_torch.torch_decoder
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


def test_every_new_module_is_in_the_source_scan():
    """The scan above walks the package: the gather wrapper, its source and the build module are in it."""
    root = os.path.join(REPO, "pyctcdecode_torch")
    for rel in ("ops/gather.py", "csrc/gather.cu", "csrc/build.py", "utils/logits.py"):
        assert os.path.isfile(os.path.join(root, rel)), rel


@pytest.mark.parametrize("wrapper", ["gather_rows", "merge_prune"])
def test_kernel_wrappers_never_run_the_plain_version_off_the_cpu(wrapper, monkeypatch):
    """A tensor that is not on the CPU launches the kernel or raises.

    Without a GPU a ``meta`` tensor stands for the device request: the
    wrapper must refuse it, not answer with the plain version. Where the
    request is for CUDA and there is no CUDA, the tensor cannot even be made.
    """
    from pyctcdecode_torch.ops import gather, merge

    def plain_version_ran(*args, **kwargs):
        raise AssertionError("the plain version ran for a tensor that is not on the CPU")

    monkeypatch.setattr(gather, "gather_rows_ref", plain_version_ran)
    monkeypatch.setattr(merge, "merge_prune_ref", plain_version_ran)
    meta = torch.device("meta")
    with pytest.raises(ValueError, match="CUDA tensors"):
        if wrapper == "gather_rows":
            gather.gather_rows(
                torch.zeros((8, 64), dtype=torch.int32, device=meta),
                torch.zeros((3,), dtype=torch.int64, device=meta),
            )
        else:
            i64 = torch.zeros((1, 1, 4), dtype=torch.int64, device=meta)
            f32 = torch.zeros((1, 1, 4), dtype=torch.float32, device=meta)
            merge.merge_prune(i64, i64, i64.to(torch.int32), f32, f32,
                              torch.zeros((1,), dtype=torch.float32, device=meta))
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            gather.gather_rows(
                torch.zeros((8, 64), dtype=torch.int32, device="cuda"),
                torch.zeros((3,), dtype=torch.int64, device="cuda"),
            )
