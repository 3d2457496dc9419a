"""BENCHMARK.json against the naming rules, and the lookup by name that lets a later change add files only."""
import json
import time

import pytest

from cardbench.harness import manifest, runner
from cardbench.harness.loops import Spans
from cardbench.tests.tiny import tiny_bench

ALLOWED_KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source", "workloads"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves", "workloads"},
}


def test_manifest_follows_the_rules():
    bench = manifest.manifest()
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert manifest.problems(bench) == []
    for section, keys in ALLOWED_KEYS.items():
        for entry in bench[section]:
            assert set(entry) <= keys, entry
    e2e = {m["name"] for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        assert m["moves"] in e2e and m["better"] in ("lower", "higher") and "\n" not in m["layer"]
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    names = [x["name"] for s in ("configs", "workloads", "end_to_end", "per_layer") for x in bench[s]]
    assert len(names) == len(set(names))
    for w in bench["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
        cell_metrics = [m for m in bench["end_to_end"] if "workloads" not in m or w["name"] in m["workloads"]]
        assert "setup_s" in {m["name"] for m in cell_metrics} and len(cell_metrics) >= 2
        assert manifest.metrics_of(bench, "per_layer", w["name"])


def test_every_cell_has_its_files_and_limits():
    bench = manifest.manifest()
    for w in bench["workloads"]:
        cfg = manifest.config(bench, w["config"])
        assert {"labels", "frame_s", "search", "corpus", "assumed", "reduced"} <= set(cfg)
        assert manifest.config_problems(w["config"], cfg) == []
        assert manifest.module("generators", manifest.mix(w["traffic"])["generator"]).make
        assert all(manifest.module("lms", recipe["kind"]).files for recipe, _ in manifest.lm_members(cfg))
        assert set(manifest.limits(w["name"])) == {"missing", "top_gap", "score_err"}


def test_a_new_mix_and_metric_are_found_by_name(tmp_path, monkeypatch):
    """What a later change adds (a mix, a cell, a per-layer metric) is found by the lookup run.py uses."""
    bench = tiny_bench(tmp_path, monkeypatch)
    (tmp_path / "traffic" / "later.json").write_text(json.dumps(dict(manifest.mix("mix"), rows=2)))
    (tmp_path / "limits" / "tiny.later.json").write_text(json.dumps(manifest.limits("tiny.mix")))
    metrics = tmp_path / "more_metrics"
    metrics.mkdir()
    for f in (manifest.BENCH_DIR / "metrics").iterdir():
        (metrics / f.name).write_text(f.read_text())
    (metrics / "calls.later.py").write_text("def read(rec):\n    return float(len(rec['spans']))\n")
    (tmp_path / "metrics").unlink()
    (tmp_path / "metrics").symlink_to(metrics)
    bench["workloads"].append(dict(name="tiny.later", config="tiny", traffic="later", chips=1, why="later"))
    bench["per_layer"].append(dict(name="calls.later", unit="spans", better="lower", source="program_span",
                                   layer="harness", moves="setup_s", workloads=["tiny.later"]))
    assert manifest.problems(bench) == []
    result = runner.run_cell(bench, "tiny.later", 7, 0.5, True, "cpu", cache_dir=tmp_path / ".cache")
    assert result["correct"] and result["metrics"]["calls.later"]["value"] > 0


BURSTY = '''"""bursty: streams whose chunks come two at a time, a burst every two periods."""
from cardbench.harness.traffic import frame_counts, seeded, utterances


def bursts(period):
    k = 0
    while True:
        yield (k // 2) * 2 * period
        k += 1


def make(mix, seed, ctx):
    counts = frame_counts(mix["frames"], mix["utterances"])
    period = mix["chunk_s"]
    streams = []
    for s in range(mix["streams"]):
        rng = seeded(seed, 5, s)
        streams.append(dict(utterances=utterances(rng, counts, ctx), due=bursts(period)))
    return dict(kind="stream", chunk_frames=int(round(period / ctx.frame_s)), streams=streams)
'''


def test_a_new_arrival_law_is_new_files_only(tmp_path, monkeypatch):
    """A mix with an arrival law of its own: a generator file and a mix file, and nothing edited."""
    bench = tiny_bench(tmp_path, monkeypatch, kind="stream")
    generators = tmp_path / "more_generators"
    generators.mkdir()
    for f in (manifest.BENCH_DIR / "generators").iterdir():
        if f.suffix == ".py":
            (generators / f.name).write_text(f.read_text())
    (generators / "bursty.py").write_text(BURSTY)
    (tmp_path / "generators").unlink()
    (tmp_path / "generators").symlink_to(generators)
    mix = dict(manifest.mix("mix"), generator="bursty", check=1000)
    (tmp_path / "traffic" / "bursty.json").write_text(json.dumps(mix))
    (tmp_path / "limits" / "tiny.bursty.json").write_text(json.dumps(manifest.limits("tiny.mix")))
    bench["workloads"].append(dict(name="tiny.bursty", config="tiny", traffic="bursty", chips=1, why="bursts"))
    assert manifest.problems(bench) == []

    cell = runner.Cell(bench, "tiny.bursty", "cpu", cache_dir=tmp_path / ".cache")
    loop, _ = cell.loop(5, Spans())
    loop.open()
    t0 = time.perf_counter()
    loop.schedule(t0)
    served = loop.serve_until(t0 + 1.2)
    assert [round(c["due"] - t0, 6) for c in served] == [0.0] * 4 + [1.0] * 4  # two streams, bursts of two

    result = runner.run_cell(bench, "tiny.bursty", 7, 1.5, False, "cpu", cache_dir=tmp_path / ".cache")
    assert result["correct"] and result["attempted"] >= 8 and "chunk_p95_ms" in result["metrics"]


def test_an_lm_kind_without_its_file_is_refused(tmp_path, monkeypatch):
    bench = tiny_bench(tmp_path, monkeypatch)
    cfg = manifest.load_json(tmp_path / "configs" / "tiny.json")
    cfg["lm"]["kind"] = "kenlm_binary"
    (tmp_path / "configs" / "tiny.json").write_text(json.dumps(cfg))
    assert any("LM kind" in p for p in manifest.problems(bench))
    with pytest.raises(ValueError, match="unknown LM kind"):
        runner.lm_files(cfg["lm"], tmp_path / ".cache")
    with pytest.raises(ValueError, match="unknown LM kind"):
        runner.Cell(bench, "tiny.mix", "cpu", cache_dir=tmp_path / ".cache")


def test_the_lm_files_are_keyed_by_the_whole_recipe(tmp_path, monkeypatch):
    tiny_bench(tmp_path, monkeypatch)
    recipe = dict(kind="parity_3gram", order=3, n_vocab=300, n_bigrams=400, n_trigrams=300, seed=7)
    a = runner.lm_files(recipe, tmp_path / ".cache")
    b = runner.lm_files(dict(recipe, seed=8), tmp_path / ".cache")
    assert a["arpa"] != b["arpa"] and a["load"] == a["arpa"] and a["arpa"].read_bytes() != b["arpa"].read_bytes()
    assert runner.lm_files(recipe, tmp_path / ".cache") == a


def test_an_ensemble_configuration_is_checked():
    """An ensemble gives ``members`` (two or more, each an LM recipe and exactly the fusion settings) in place of
    ``lm`` and ``decoder``."""
    cfg = manifest.config(manifest.manifest(), "quartznet-char-3gram")
    assert manifest.config_problems("one", cfg) == []
    assert manifest.lm_members(cfg) == [(cfg["lm"], cfg["decoder"])]
    weights = dict(alpha=0.3, beta=2.0, unk_score_offset=-6.0, lm_score_boundary=False)
    members = [dict(lm=cfg["lm"], decoder=cfg["decoder"]), dict(lm=dict(cfg["lm"], n_bigrams=750000), decoder=weights)]
    two = {k: v for k, v in cfg.items() if k not in ("lm", "decoder")}
    assert manifest.config_problems("two", dict(two, members=members)) == []
    assert [w for _, w in manifest.lm_members(dict(two, members=members))] == [cfg["decoder"], weights]
    bad = {
        "both": dict(cfg, members=members),
        "neither": two,
        "one member": dict(two, members=members[:1]),
        "own settings": dict(two, members=members, decoder=cfg["decoder"]),
        "settings": dict(two, members=[members[0], dict(lm=members[1]["lm"], decoder=dict(weights, segment_frames=8))]),
        "kind": dict(two, members=[members[0], dict(members[1], lm=dict(cfg["lm"], kind="no_such_kind"))]),
        "keys": dict(two, members=[members[0], dict(members[1], hotwords=["a"])]),
    }
    for name, c in bad.items():
        assert manifest.config_problems(name, c), name
