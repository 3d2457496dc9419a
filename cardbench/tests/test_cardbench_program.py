"""The program's spans in a run: the readers of the metrics they feed, the idle gaps they name, the tool.

``harness/program.py`` holds the program's spans and counters as a run's
``rec["program"]``; the readers of ``metrics/`` that read them return None
on a record without them (a run of a program without the tracer, or with
it off). ``trace.summarize`` given the program's spans after the harness's
names a gap by the innermost span open at its middle and leaves a gap under
no program span as it was. ``cardbench/spans.py`` runs a cell with the
tracer on: every metric of the cell's kind reads a value, the stages tile
the calls and the step counter equals the harness's own count.
"""
import pytest

from cardbench import spans as tool
from cardbench.harness import manifest, program, runner, trace
from cardbench.tests.tiny import tiny_bench

SEED = 3_000_000_019
BATCH_METRICS = ("lm_read_s", "lm_tables_s", "host_prep_ms.batch", "host_replay_ms.batch", "step_fill.batch")
STREAM_METRICS = ("lm_read_s", "lm_tables_s", "chunk_prep_ms.stream", "chunk_replay_ms.stream", "step_fill.stream")


def _span(name, start, end, index, parent=-1, call=0):
    return dict(name=name, start=start, end=end, index=index, parent=parent, call=call, note="")


def _record(kind="batch"):
    root, stages = ("batch", ("prep", "upload", "enqueue", "fetch", "replay")) if kind == "batch" else \
        ("chunk", ("prep", "upload", "enqueue", "fetch", "backtrace", "replay"))
    window, index = [], 0
    for call, t0 in enumerate((10.0, 11.0, 12.0)):
        window.append(_span(root, t0, t0 + 0.5, index, call=call))
        for i, stage in enumerate(stages):  # the stage i lasts (i + 1) ms, the call's number of ms more
            a = t0 + 0.01 * i
            window.append(_span(f"{root}.{stage}", a, a + (i + 1 + call) * 1e-3, index + 1 + i, index, call))
        index += 1 + len(stages)
    build = [_span("build", 0.0, 9.0, 100)] + [
        _span(f"build.{name}", float(i), float(i) + 1.5, 101 + i, 100)
        for i, name in enumerate(("read_lm", "unigrams", "language_model", "device_lm", "upload"))]
    return dict(kind=kind, program=dict(
        setup=dict(spans=build, counters={}),
        window=dict(spans=window, counters={"steps.active": 380, "steps.launched": 500}),
        traced=dict(spans=[], counters={})))


def test_readers_of_the_program_spans():
    read = manifest.reader
    rec = _record("batch")
    assert read("lm_read_s")(rec) == pytest.approx(3.0) and read("lm_tables_s")(rec) == pytest.approx(3.0)
    assert read("host_prep_ms.batch")(rec) == pytest.approx(5.0)  # the calls' prep + upload: 3, 5, 7 ms
    assert read("host_replay_ms.batch")(rec) == pytest.approx(6.0)  # 5, 6, 7 ms
    assert read("step_fill.batch")(rec) == pytest.approx(0.76)
    assert read("step_fill.stream")(rec) is None and read("chunk_prep_ms.stream")(rec) is None
    rec = _record("stream")
    assert read("chunk_prep_ms.stream")(rec) == pytest.approx(5.0)
    assert read("chunk_replay_ms.stream")(rec) == pytest.approx(13.0)  # backtrace + replay: 11, 13, 15 ms
    assert read("step_fill.stream")(rec) == pytest.approx(0.76)
    assert read("host_replay_ms.batch")(rec) is None


@pytest.mark.parametrize("kind", ["batch", "stream"])
def test_readers_read_nothing_without_the_program_spans(kind):
    rec = dict(kind=kind, lm_build_s=1.0)
    for name in tool.PROGRAM_METRICS:
        assert manifest.reader(name)(rec) is None, name


def test_gaps_are_named_by_the_innermost_program_span():
    rows = [("k", 1.0, 2.0), ("k", 3.0, 4.0), ("k", 5.0, 5.5), ("k", 6.0, 7.0)]
    harness = [(trace.WINDOW, 0.0, 8.0), ("decode_beams_batch", 0.5, 6.5), ("prep", 6.5, 7.5)]
    spans = [_span("batch", 0.6, 6.4, 0), _span("batch.prep", 0.6, 2.5, 1, 0), _span("batch.enqueue", 2.5, 4.5, 2, 0),
             _span("graph.capture", 2.2, 4.4, 3, 2), _span("batch.replay", 4.5, 6.4, 4, 0)]
    named = program.ranges(dict(spans=spans), 0.0, harness)
    assert [name for name, _, _ in named] == [
        "decode_beams_batch/batch", "decode_beams_batch/batch.prep", "decode_beams_batch/batch.enqueue",
        "decode_beams_batch/batch.replay", "decode_beams_batch/graph.capture"]  # outermost first
    plain = dict(trace.summarize(rows, harness)["idle_gaps"])
    gaps = dict(trace.summarize(rows, harness + named)["idle_gaps"])
    # gaps: [0,1] (middle 0.5) at the call's edge, [2,3] in the capture, [4,5] in the replay, [5.5,6] in the
    # replay, [7,8] under no span of either
    assert gaps == pytest.approx({"decode_beams_batch >=20us": 1.0, "decode_beams_batch/graph.capture >=20us": 1.0,
                                  "decode_beams_batch/batch.replay >=20us": 1.5, "harness >=20us": 1.0})
    assert plain == pytest.approx({"decode_beams_batch >=20us": 3.5, "harness >=20us": 1.0})
    assert tool.bare_share(list(gaps.items()), "batch") == pytest.approx(1.0 / 3.5)


def test_a_benchmark_run_leaves_the_program_tracer_off(tmp_path, monkeypatch):
    from pyctcdecode_torch.utils import profiling

    made = []
    monkeypatch.setattr(profiling.Trace, "__init__", lambda self: made.append(self))
    bench = tiny_bench(tmp_path, monkeypatch, "char", "batch")
    result = runner.run_cell(bench, "tiny.mix", SEED, 0.5, False, "cpu", cache_dir=tmp_path / ".cache")
    assert result["correct"] and not made and profiling.TRACER is None


@pytest.mark.parametrize("kind,names", [("batch", BATCH_METRICS), ("stream", STREAM_METRICS)])
def test_a_traced_benchmark_run_reads_the_program_spans(tmp_path, monkeypatch, kind, names):
    """With ``--trace 1`` the tracer is on from the build to the traced stretch's end, and off after it."""
    from pyctcdecode_torch.utils import profiling

    bench = tiny_bench(tmp_path, monkeypatch, "char", kind)
    result = runner.run_cell(bench, "tiny.mix", SEED, 0.5, True, "cpu", cache_dir=tmp_path / ".cache")
    assert result["correct"] and profiling.TRACER is None
    assert all(result["metrics"].get(name) is not None for name in names), result["metrics"]
    assert not set(tool.PROGRAM_METRICS) - set(names) & set(result["metrics"])
    if kind == "batch":  # the traced call covers the traced window's middle, where the CPU's one gap lies
        gaps = [name for name, _ in result["breakdown"]["idle_gaps"]]
        assert any(name.startswith("decode_beams_batch/batch.") for name in gaps), gaps


def test_ensemble_build_has_no_lm_read_or_tables_span(tmp_path, monkeypatch):
    """An ensemble's members are read outside ``build_ctcdecoder``: the build's reader metrics read nothing."""
    bench = tiny_bench(tmp_path, monkeypatch, "char", "batch", ensemble=True)
    result = runner.run_cell(bench, "tiny.mix", SEED, 0.5, True, "cpu", cache_dir=tmp_path / ".cache")
    assert result["correct"], result["compared"]
    assert "lm_read_s" not in result["metrics"] and "lm_tables_s" not in result["metrics"]
    assert result["metrics"]["host_prep_ms.batch"]["value"] > 0 and result["metrics"]["lm_build_s"]["value"] > 0


@pytest.mark.parametrize("kind,names", [("batch", BATCH_METRICS), ("stream", STREAM_METRICS)])
def test_the_tool_reads_every_metric_of_the_cell(tmp_path, monkeypatch, kind, names):
    from pyctcdecode_torch.utils import profiling

    bench = tiny_bench(tmp_path, monkeypatch, "char", kind)
    out = tool.run(bench, "tiny.mix", SEED, 0.5, "cpu", cost_calls=2, cost_s=0.5, cache_dir=tmp_path / ".cache")
    assert profiling.TRACER is None
    assert all(out["metrics"].get(name) is not None for name in names), out["metrics"]
    assert not set(tool.PROGRAM_METRICS) - set(names) & set(out["metrics"])
    tiles = out["tiling"]
    assert 0.98 <= tiles["stages_over_call"]["least"] <= tiles["root_over_call"]["most"] <= 1.0
    assert out["steps"]["active"] == out["steps"]["needed"] > 0
    assert {"build.read_lm", "build.unigrams", "build.language_model", "build.device_lm",
            "build.upload"} <= set(out["setup_spans"])
    assert out["cost"]["on"]["n"] and out["cost"]["off"]["n"] and out["cost"]["sites_us"]["on"] > 0
    assert out.get("same_outputs", True)
