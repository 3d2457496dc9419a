"""The port stands alone: no JAX, nothing of pyctcdecode_tpu; CUDA unless asked."""
import os
import subprocess
import sys

import pytest
import torch

from .torch_cases import one_torch_thread  # noqa: F401  (autouse fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHECK = """
import sys
import pyctcdecode_torch
import pyctcdecode_torch.engine, pyctcdecode_torch.evaluation, pyctcdecode_torch.ops.merge, pyctcdecode_torch.ops.backtrace
import pyctcdecode_torch.ops.gather, pyctcdecode_torch.utils.logits, pyctcdecode_torch.torch_decoder
import pyctcdecode_torch.csrc.build
import pyctcdecode_torch.models.kenlm_bin, pyctcdecode_torch.models.kenlm_trie, pyctcdecode_torch.models.binfmt
import pyctcdecode_torch.models.native, pyctcdecode_torch.csrc.native, pyctcdecode_torch.parallel
import pyctcdecode_torch.parallel.batch, pyctcdecode_torch.parallel.launch
import pyctcdecode_torch.utils.profiling, pyctcdecode_torch.utils.tuning
from pyctcdecode_torch.evaluation import FIXTURE_DIFFICULTY, compare_engines, evaluate_corpus, _decode_all
from pyctcdecode_torch.utils import CharTrie, character_error_rate, normalize_to_logp_torch

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


def _port_sources():
    """Every source file of the port: the package, ``chip_smoke.py`` and ``scripts/torch_*.py``."""
    root = os.path.join(REPO, "pyctcdecode_torch")
    paths = [os.path.join(REPO, "chip_smoke.py")]
    scripts = os.path.join(REPO, "scripts")
    paths += [os.path.join(scripts, name) for name in sorted(os.listdir(scripts))
              if name.startswith("torch_") and name.endswith(".py")]
    for dirpath, _, files in os.walk(root):
        paths += [os.path.join(dirpath, name) for name in files if name.endswith((".py", ".cu", ".cpp"))]
    return paths


def test_no_source_file_names_jax_or_the_reference_package():
    offenders = []
    for path in _port_sources():
        with open(path, encoding="utf-8") as fh:
            text = fh.read()
        for needle in ("import jax", "from jax", "pyctcdecode_tpu"):
            if needle in text:
                offenders.append(f"{os.path.relpath(path, REPO)}: {needle}")
    assert not offenders, offenders


def _two_member_lm(tmp_path):
    import pyctcdecode_torch as P
    from pyctcdecode_torch.models.ngram import open_ngram_file

    from .torch_cases import ARPA, ARPA_2GRAM, UNIGRAMS

    members = []
    for name, text in (("a", ARPA), ("b", ARPA_2GRAM)):
        path = tmp_path / f"{name}.arpa"
        path.write_text(text)
        members.append(P.LanguageModel(open_ngram_file(str(path)), UNIGRAMS))
    return P.MultiLanguageModel(members)


def test_default_device_is_cuda_and_never_falls_back(tmp_path):
    """Without an LM and with a two-member MultiLanguageModel."""
    import pyctcdecode_torch as P

    from .helpers import SAMPLE_LABELS

    alphabet = P.Alphabet.build_alphabet(SAMPLE_LABELS)
    for model in (None, _two_member_lm(tmp_path)):
        if torch.cuda.is_available():
            dec = P.TorchBeamSearchDecoderCTC(alphabet, model)
            assert dec.device.type == "cuda"
            assert all(tabs["trie_rows"].is_cuda for tabs in dec._tabs["lms"])
            continue
        with pytest.raises(RuntimeError, match="device='cpu'"):
            P.TorchBeamSearchDecoderCTC(alphabet, model)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            P.build_ctcdecoder(SAMPLE_LABELS)
        dec = P.TorchBeamSearchDecoderCTC(alphabet, model, device="cpu")
        assert dec.device.type == "cpu"
        assert all(t.device.type == "cpu" for t in dec._tabs["tok"].values())
        assert len(dec._tabs["lms"]) == (0 if model is None else 2)
        for tabs in dec._tabs["lms"]:
            assert tabs["trie_rows"].device.type == "cpu"
            assert all(tab["bucket"].device.type == "cpu" for tab in tabs["fp"])


def test_every_new_module_is_in_the_source_scan():
    """The scan above walks the package and the port's scripts: each of these is in it."""
    scanned = {os.path.relpath(path, REPO) for path in _port_sources()}
    for rel in ("pyctcdecode_torch/ops/gather.py", "pyctcdecode_torch/csrc/gather.cu",
                "pyctcdecode_torch/csrc/build.py", "pyctcdecode_torch/utils/logits.py",
                "pyctcdecode_torch/models/hotwords.py",
                "pyctcdecode_torch/models/kenlm_bin.py", "pyctcdecode_torch/models/kenlm_trie.py",
                "pyctcdecode_torch/models/binfmt.py", "chip_smoke.py",
                "pyctcdecode_torch/csrc/ctclm.cpp", "pyctcdecode_torch/csrc/native.py",
                "pyctcdecode_torch/models/native.py", "pyctcdecode_torch/parallel/__init__.py",
                "pyctcdecode_torch/parallel/batch.py", "pyctcdecode_torch/parallel/launch.py",
                "pyctcdecode_torch/utils/profiling.py", "pyctcdecode_torch/utils/tuning.py",
                "pyctcdecode_torch/ops/backtrace.py", "pyctcdecode_torch/csrc/backtrace.cu",
                "pyctcdecode_torch/ops/walk.py", "pyctcdecode_torch/csrc/walk.cu",
                "pyctcdecode_torch/evaluation.py", "pyctcdecode_torch/utils/__init__.py",
                "pyctcdecode_torch/utils/metrics.py", "scripts/torch_eval_corpus.py",
                "scripts/torch_sharded_ranks.py"):
        assert rel in scanned, rel


@pytest.mark.parametrize("wrapper", ["gather_rows", "merge_prune", "backtrace_paths", "walk_partial"])
def test_kernel_wrappers_never_run_the_plain_version_off_the_cpu(wrapper, monkeypatch):
    """A tensor that is not on the CPU launches the kernel or raises.

    Without a GPU a ``meta`` tensor stands for the device request: the
    wrapper must refuse it, not answer with the plain version. Where the
    request is for CUDA and there is no CUDA, the tensor cannot even be made.
    """
    from pyctcdecode_torch.ops import backtrace, gather, merge, walk

    def plain_version_ran(*args, **kwargs):
        raise AssertionError("the plain version ran for a tensor that is not on the CPU")

    monkeypatch.setattr(gather, "gather_rows_ref", plain_version_ran)
    monkeypatch.setattr(merge, "merge_prune_ref", plain_version_ran)
    monkeypatch.setattr(backtrace, "backtrace_paths_ref", plain_version_ran)
    monkeypatch.setattr(walk, "walk_partial_ref", plain_version_ran)
    meta = torch.device("meta")
    with pytest.raises(ValueError, match="CUDA tensors"):
        if wrapper == "backtrace_paths":
            log = torch.zeros((1, 3, 4), dtype=torch.int8, device=meta)
            backtrace.backtrace_paths(log, log, torch.zeros((1, 2), dtype=torch.int64, device=meta))
        elif wrapper == "walk_partial":
            i64 = torch.zeros((1, 4), dtype=torch.int64, device=meta)
            state = {"last_tok": i64, "p_len": i64, "force": i64.to(torch.bool)}
            tok = {key: torch.zeros((5,), dtype=torch.int64, device=meta) for key in ("kind", "piece_len", "raw_len")}
            tok["raw_chars"] = torch.zeros((5, 2), dtype=torch.int64, device=meta)
            walk.walk_partial([], None, {"lm": []}, state, torch.zeros((1, 5), dtype=torch.int64, device=meta), tok,
                              [], False)
        elif wrapper == "gather_rows":
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


def test_host_oracle_and_stream_modules_stand_alone():
    """The copied host oracle and the stream code import nothing of JAX or the reference package."""
    check = _CHECK.replace(
        "import pyctcdecode_torch.csrc.build",
        "import pyctcdecode_torch.csrc.build, pyctcdecode_torch.decoder\n"
        "from pyctcdecode_torch.engine import make_stream_fns\n"
        "from pyctcdecode_torch.torch_decoder import DeviceStreamState, _backtrace_chunks\n"
        "from pyctcdecode_torch import BeamSearchDecoderCTC, Beam, LMBeam, OutputBeam, NGramModel",
    )
    assert check != _CHECK
    out = subprocess.run(
        [sys.executable, "-c", check], cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert "clean" in out.stdout
    scanned = {os.path.relpath(path, REPO) for path in _port_sources()}
    assert {"pyctcdecode_torch/decoder.py", "pyctcdecode_torch/engine.py",
            "pyctcdecode_torch/torch_decoder.py"} <= scanned


def test_streaming_and_the_host_engine_no_longer_raise():
    import numpy as np

    import pyctcdecode_torch as P

    from .helpers import SAMPLE_LABELS, TEST_LOGITS

    dec = P.build_ctcdecoder(SAMPLE_LABELS, device="cpu")
    state = dec.get_starting_state(beam_width=4)
    assert isinstance(state, P.torch_decoder.DeviceStreamState)
    view = dec.partial_decode_beams(state, np.asarray(TEST_LOGITS), is_end=True)
    assert view[0].text == "bunny bunny"
    host = P.build_ctcdecoder(SAMPLE_LABELS, engine="host")
    assert host.decode(TEST_LOGITS) == "bunny bunny"
    host.cleanup()
