"""Whole runs on the CPU at a tiny size: sound runs judged correct, planted faults judged not correct.

Each test drives :func:`cardbench.harness.runner.run_cell` past the look
for a chip (``device="cpu"``), over a tiny copy of a real configuration and
mix (``tiny.py``), with every answer judged. The faults break the timed
path underneath: an answer that does not advance (a stale one), half of a
batch answered with the other half's answers, a token altered in an
answer, a stream whose state does not advance. The cells run on one chip,
so there is no exchange between chips to leave out. A tiny ensemble cell
(two LM members, the calls with hotwords) runs correct too, and is not
correct with the program called without the hotwords or with member B's
weights swapped.
"""
import dataclasses
import json
import os
import subprocess
import sys

import pytest

from cardbench.harness import manifest, runner
from cardbench.tests.tiny import HOT, tiny_bench

import pyctcdecode_torch as P

SEED = 3_000_000_017  # above 32 signed bits, as the driver's seeds may be


def run(tmp_path, monkeypatch, alphabet="char", kind="batch", seconds=1.0, trace=False, ensemble=False):
    bench = tiny_bench(tmp_path, monkeypatch, alphabet, kind, ensemble)
    mix = manifest.mix("mix")
    mix["check"] = 1000  # judge every answer
    (tmp_path / "traffic" / "mix.json").write_text(json.dumps(mix))
    return runner.run_cell(bench, "tiny.mix", SEED, seconds, trace, "cpu", cache_dir=tmp_path / ".cache")


@pytest.mark.parametrize("alphabet,kind", [("char", "batch"), ("bpe", "batch"), ("char", "stream")])
def test_sound_run_is_correct(tmp_path, monkeypatch, alphabet, kind):
    result = run(tmp_path, monkeypatch, alphabet, kind)
    assert result["correct"], result["compared"]
    assert result["attempted"] > 0 and result["failed"] == 0
    assert list(result)[-1] == "compared"
    names = {m["name"] for m in manifest.manifest()["end_to_end"]}
    assert set(result["metrics"]) <= names and "setup_s" in result["metrics"]


def test_traced_run_reports_per_layer_metrics(tmp_path, monkeypatch):
    result = run(tmp_path, monkeypatch, "char", "stream", trace=True)
    assert result["correct"]
    assert "lm_build_s" in result["metrics"] and "chunk_service_p50_ms.stream" in result["metrics"]
    assert "breakdown" in result and "window_s" in result["device"]


def _stale_batch(monkeypatch):
    real, last = P.TorchBeamSearchDecoderCTC.decode_beams_batch, {}

    def stale(self, batch, **kw):
        out = real(self, batch, **kw)
        prev = last.get("out", out)
        last["out"] = out
        return prev

    monkeypatch.setattr(P.TorchBeamSearchDecoderCTC, "decode_beams_batch", stale)


def _half_batch(monkeypatch):
    real = P.TorchBeamSearchDecoderCTC.decode_beams_batch

    def half(self, batch, **kw):
        n = (len(batch) + 1) // 2
        out = real(self, batch[:n], **kw)
        return out + out[: len(batch) - n]

    monkeypatch.setattr(P.TorchBeamSearchDecoderCTC, "decode_beams_batch", half)


def _altered_batch(monkeypatch):
    real = P.TorchBeamSearchDecoderCTC.decode_beams_batch

    def altered(self, batch, **kw):
        out = real(self, batch, **kw)
        top = out[0][0]
        out[0][0] = dataclasses.replace(top, text=top.text + "x")
        return out

    monkeypatch.setattr(P.TorchBeamSearchDecoderCTC, "decode_beams_batch", altered)


def _stale_stream(monkeypatch):
    real, last = P.TorchBeamSearchDecoderCTC.partial_decode_beams, {}

    def stale(self, state, chunk, **kw):
        if id(state) in last and not kw.get("is_end"):
            return last[id(state)]  # the chunk is not consumed: the state stays as it was
        view = real(self, state, chunk, **kw)
        last[id(state)] = view
        return view

    monkeypatch.setattr(P.TorchBeamSearchDecoderCTC, "partial_decode_beams", stale)


def _altered_stream(monkeypatch):
    real = P.TorchBeamSearchDecoderCTC.partial_decode_beams

    def altered(self, state, chunk, **kw):
        view = real(self, state, chunk, **kw)
        view[0] = dataclasses.replace(view[0], partial_word=view[0].partial_word + "x")
        return view

    monkeypatch.setattr(P.TorchBeamSearchDecoderCTC, "partial_decode_beams", altered)


@pytest.mark.parametrize("kind,fault", [
    ("batch", _stale_batch), ("batch", _half_batch), ("batch", _altered_batch),
    ("stream", _stale_stream), ("stream", _altered_stream),
])
def test_planted_fault_is_not_correct(tmp_path, monkeypatch, kind, fault):
    fault(monkeypatch)
    result = run(tmp_path, monkeypatch, "char", kind, seconds=1.5)
    assert not result["correct"], result["compared"]


@pytest.mark.parametrize("kind", ["batch", "stream"])
def test_ensemble_with_hotwords_run_is_correct(tmp_path, monkeypatch, kind):
    calls = []
    for name in ("decode_beams_batch", "partial_decode_beams", "get_starting_state"):
        real = getattr(P.TorchBeamSearchDecoderCTC, name)

        def seen(self, *args, _real=real, _name=name, **kw):
            calls.append((_name, kw))
            return _real(self, *args, **kw)

        monkeypatch.setattr(P.TorchBeamSearchDecoderCTC, name, seen)
    result = run(tmp_path, monkeypatch, "char", kind, ensemble=True)
    assert result["correct"], result["compared"]
    assert result["attempted"] > 0 and result["failed"] == 0
    decodes = [kw for name, kw in calls if name != "get_starting_state"]
    assert decodes and all(kw["hotwords"] == HOT["hotwords"] and kw["hotword_weight"] == HOT["hotword_weight"]
                           for kw in decodes)
    assert all(kw.get("hotwords_enabled") for name, kw in calls if name == "get_starting_state")


def _without_hotwords(monkeypatch):
    for name in ("decode_beams_batch", "partial_decode_beams"):
        real = getattr(P.TorchBeamSearchDecoderCTC, name)

        def bare(self, *args, _real=real, **kw):
            kw.pop("hotwords", None)
            kw.pop("hotword_weight", None)
            return _real(self, *args, **kw)

        monkeypatch.setattr(P.TorchBeamSearchDecoderCTC, name, bare)


def _member_b_weights_swapped(monkeypatch):
    real = P.MultiLanguageModel.__init__

    def swapped(self, language_models):
        real(self, language_models)
        b = self._language_models[1]
        b.alpha, b.beta = b.beta, b.alpha

    monkeypatch.setattr(P.MultiLanguageModel, "__init__", swapped)


@pytest.mark.parametrize("kind", ["batch", "stream"])
@pytest.mark.parametrize("fault", [_without_hotwords, _member_b_weights_swapped])
def test_planted_ensemble_fault_is_not_correct(tmp_path, monkeypatch, kind, fault):
    fault(monkeypatch)
    result = run(tmp_path, monkeypatch, "char", kind, seconds=1.5, ensemble=True)
    assert not result["correct"], result["compared"]


def test_command_gives_no_result_without_cuda(tmp_path):
    root = manifest.ROOT
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, str(root / "cardbench" / "run.py"), "--workload",
                           "quartznet-char-3gram.dense32", "--seed", "1", "--seconds", "1", "--trace", "0"],
                          cwd=root, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


@pytest.mark.cuda
def test_a_short_run_on_the_card(tmp_path):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    root = manifest.ROOT
    proc = subprocess.run([sys.executable, str(root / "cardbench" / "run.py"), "--workload",
                           "quartznet-char-3gram.dense32", "--seed", "5", "--seconds", "2", "--trace", "0"],
                          cwd=root, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"


def test_a_failed_call_is_no_work_and_the_run_not_correct(tmp_path, monkeypatch):
    real, calls = P.TorchBeamSearchDecoderCTC.decode_beams_batch, []

    def flaky(self, batch, **kw):
        calls.append(1)
        if len(calls) % 2 == 0:
            raise RuntimeError("planted failure")
        return real(self, batch, **kw)

    monkeypatch.setattr(P.TorchBeamSearchDecoderCTC, "decode_beams_batch", flaky)
    bench = tiny_bench(tmp_path, monkeypatch)
    cell = runner.Cell(bench, "tiny.mix", "cpu", cache_dir=tmp_path / ".cache")
    loop, pool = cell.loop(SEED, runner.Spans())
    window = loop.run(1.0)
    answered = [c["frames"] for c in window["calls"]]
    assert 0 in answered and max(answered) == sum(m.shape[0] for m in pool[0])
    result = runner.run_cell(bench, "tiny.mix", SEED, 1.0, False, "cpu", cache_dir=tmp_path / ".cache")
    assert result["failed"] > 0 and not result["correct"]
