"""A tiny copy of a cell for CPU tests: the real configuration and mix, cut to a size a test can hold."""
from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Dict

from cardbench.harness import manifest

CONFIGS = {"char": "quartznet-char-3gram", "bpe": "conformer-bpe128-3gram"}
MIXES = {
    "batch": dict(generator="batch", rows=3, frames=[40, 70], pool=2, decode={}, check=4, trace_calls=1),
    "stream": dict(generator="stream", streams=2, utterances=2, frames=[40, 70], chunk_s=0.5, check=2, trace_s=0.3),
}
LM = dict(n_vocab=3000, n_bigrams=4000, n_trigrams=3000)
LIMITS = dict(missing=0.0, top_gap=0.01, score_err=0.01)
BEAM = 8
# an ensemble of two: the tiny LM, and the same seed's at half the bigrams and trigrams; their fusion
# settings are the mixed members of the port's own MultiLanguageModel tests (tests/test_torch_multi_lm.py)
LM_HALF = dict(LM, n_bigrams=2000, n_trigrams=1500)
MEMBERS = [dict(alpha=0.8, beta=0.5, unk_score_offset=-2.0, lm_score_boundary=True),
           dict(alpha=0.3, beta=2.0, unk_score_offset=-6.0, lm_score_boundary=False)]
# transcript words, a phrase of two, and a string no LM knows
HOT = dict(hotwords=["have", "good deal", "remember", "mind", "achieve", "doubt", "qzxvj"], hotword_weight=6.0)


def tiny_bench(tmp: Path, monkeypatch, alphabet: str = "char", kind: str = "batch", ensemble: bool = False) -> Dict:
    """A manifest with one cell ``tiny.mix`` over files under ``tmp``; ``manifest.BENCH_DIR`` points there.

    ``ensemble``: two LM members (:data:`MEMBERS`) in place of the one, and
    the mix's calls with hotwords (:data:`HOT`).
    """
    for sub in ("traffic", "limits", "configs"):
        (tmp / sub).mkdir(parents=True, exist_ok=True)
    for sub in ("metrics", "generators", "lms"):
        if not (tmp / sub).exists():
            os.symlink(manifest.BENCH_DIR / sub, tmp / sub)
    cfg = manifest.load_json(manifest.BENCH_DIR / "configs" / f"{CONFIGS[alphabet]}.json")
    cfg["lm"].update(LM)
    cfg["search"]["beam_width"] = BEAM
    mix = dict(MIXES[kind])
    if ensemble:
        cfg["members"] = [dict(lm=dict(cfg["lm"], **lm), decoder=w) for lm, w in zip((LM, LM_HALF), MEMBERS)]
        del cfg["lm"], cfg["decoder"]
        cfg["corpus"]["words"] = 30  # so that the transcript's words, the hotwords among them, are spoken often
        mix["decode"] = dict(HOT)
    (tmp / "configs" / "tiny.json").write_text(json.dumps(cfg))
    (tmp / "traffic" / "mix.json").write_text(json.dumps(mix))
    (tmp / "limits" / "tiny.mix.json").write_text(json.dumps(LIMITS))
    bench = manifest.manifest()
    bench["configs"] = [dict(name="tiny", source="test", file=str(tmp / "configs" / "tiny.json"), reduced=[],
                             why="test")]
    bench["workloads"] = [dict(name="tiny.mix", config="tiny", traffic="mix", chips=1, why="test")]
    for m in bench["end_to_end"] + bench["per_layer"]:
        m.pop("workloads", None)
    monkeypatch.setattr(manifest, "BENCH_DIR", tmp)
    return bench
