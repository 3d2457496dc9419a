"""Finding a run's pieces by name: the cell in ``BENCHMARK.json``, its configuration, mix, limits and readers.

Everything that belongs to one configuration, one traffic mix, one cell's
limits or one per-layer metric sits in a file of its own, named after it:

* ``cardbench/configs/<config>.json`` (the file its entry names), whose
  ``lm.kind`` names ``cardbench/lms/<kind>.py`` (a ``files`` function that
  writes the LM's files once); an ensemble's file gives ``members`` in
  place of ``lm`` and ``decoder`` (:func:`lm_members`);
* ``cardbench/traffic/<traffic>.json``, whose ``generator`` names
  ``cardbench/generators/<generator>.py`` (a ``make`` function: the
  utterances and the arrival law);
* ``cardbench/limits/<cell>.json``;
* ``cardbench/metrics/<metric>.py`` (a ``read(record)`` function);

so a later change adds a configuration, an LM kind, a mix, an arrival law,
a cell or a metric by adding files and entries, and edits none.
"""
from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


FUSION_KEYS = ("alpha", "beta", "unk_score_offset", "lm_score_boundary")  # an ensemble member's ``decoder``


def load_json(path: Path) -> Dict:
    with open(path, "r", encoding="utf-8") as fh:
        return json.load(fh)


def manifest() -> Dict:
    return load_json(ROOT / "BENCHMARK.json")


def cell(bench: Dict, name: str) -> Dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload named {name!r} in BENCHMARK.json")


def config(bench: Dict, name: str) -> Dict:
    """The configuration ``name``, from the file its ``BENCHMARK.json`` entry names."""
    for c in bench["configs"]:
        if c["name"] == name:
            return load_json(ROOT / c["file"])
    raise KeyError(f"no configuration named {name!r} in BENCHMARK.json")


def lm_members(cfg: Dict) -> List[Tuple[Dict, Dict]]:
    """A configuration's LMs as ``(recipe, fusion settings)`` pairs: one, or an ensemble's members in order.

    A single LM is the configuration's ``lm`` recipe with its ``decoder``
    settings (``build_ctcdecoder``'s keyword arguments). An ensemble is a
    ``members`` list of two or more ``{"lm": <recipe>, "decoder": {...}}``,
    each ``decoder`` holding exactly :data:`FUSION_KEYS`.
    """
    if "members" in cfg:
        return [(m["lm"], m["decoder"]) for m in cfg["members"]]
    return [(cfg["lm"], cfg["decoder"])]


def config_problems(name: str, cfg: Dict) -> List[str]:
    """What in the configuration ``cfg`` breaks the single-LM or the ensemble layout."""
    if ("members" in cfg) == ("lm" in cfg):
        return [f"config {name}: give either lm (with decoder) or members"]
    out = []
    if "members" in cfg:
        if "decoder" in cfg:
            out.append(f"config {name}: an ensemble's settings are its members' decoder, not its own")
        if not isinstance(cfg["members"], list) or len(cfg["members"]) < 2:
            return out + [f"config {name}: members must list two or more LMs"]
        for i, m in enumerate(cfg["members"]):
            if set(m) != {"lm", "decoder"}:
                out.append(f"config {name}: member {i} must hold exactly lm and decoder")
            elif sorted(m["decoder"]) != sorted(FUSION_KEYS):
                out.append(f"config {name}: member {i}'s decoder must hold exactly {', '.join(FUSION_KEYS)}")
    elif "decoder" not in cfg:
        out.append(f"config {name}: no decoder settings")
    if out:
        return out
    for recipe, _ in lm_members(cfg):
        if not (BENCH_DIR / "lms" / f"{recipe.get('kind')}.py").is_file():
            out.append(f"config {name}: no LM kind file for {recipe.get('kind')!r}")
    return out


def mix(name: str) -> Dict:
    return load_json(BENCH_DIR / "traffic" / f"{name}.json")


def limits(cell_name: str) -> Dict[str, float]:
    return load_json(BENCH_DIR / "limits" / f"{cell_name}.json")


def module(folder: str, name: str):
    """The module ``cardbench/<folder>/<name>.py``; ``LookupError`` where there is none."""
    path = BENCH_DIR / folder / f"{name}.py"
    if not NAME_RE.match(name) or not path.is_file():
        raise LookupError(f"no {folder}/{name}.py under {BENCH_DIR}")
    spec = importlib.util.spec_from_file_location(f"cardbench_{folder}_{name.replace('.', '_').replace('-', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str) -> Callable[[Dict], Optional[float]]:
    """The ``read`` function of ``cardbench/metrics/<metric>.py``."""
    return module("metrics", metric).read


def metrics_of(bench: Dict, section: str, cell_name: str) -> List[Dict]:
    """The metrics of ``section`` (``end_to_end`` or ``per_layer``) that ``cell_name`` reports."""
    return [m for m in bench[section] if "workloads" not in m or cell_name in m["workloads"]]


def problems(bench: Dict) -> List[str]:
    """What in ``bench`` breaks the naming rules or names a file that is not there."""
    out = []
    for section in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in bench[section]:
            if not NAME_RE.match(entry["name"]):
                out.append(f"{section}: bad name {entry['name']!r}")
            if "unit" in entry and not UNIT_RE.match(entry["unit"]):
                out.append(f"{section}: bad unit {entry['unit']!r}")
    for c in bench["configs"]:
        if not (ROOT / c["file"]).is_file():
            out.append(f"config file {c['file']} is missing")
        else:
            out.extend(config_problems(c["name"], load_json(ROOT / c["file"])))
        for key in c["reduced"]:
            if not NAME_RE.match(key):
                out.append(f"config {c['name']}: bad reduced key {key!r}")
    for w in bench["workloads"]:
        for name in (w["config"], w["traffic"]):
            if not NAME_RE.match(name):
                out.append(f"workload {w['name']}: bad name {name!r}")
        if not (BENCH_DIR / "traffic" / f"{w['traffic']}.json").is_file():
            out.append(f"workload {w['name']}: no traffic file for {w['traffic']!r}")
        elif not (BENCH_DIR / "generators" / f"{mix(w['traffic'])['generator']}.py").is_file():
            out.append(f"workload {w['name']}: no generator for {w['traffic']!r}")
        if not (BENCH_DIR / "limits" / f"{w['name']}.json").is_file():
            out.append(f"workload {w['name']}: no limits file")
    for m in bench["per_layer"]:
        if not (BENCH_DIR / "metrics" / f"{m['name']}.py").is_file():
            out.append(f"per-layer metric {m['name']}: no reader")
    return out
