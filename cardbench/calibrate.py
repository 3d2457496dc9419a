"""Readings for a cell's correctness limits: the program's and the lower-precision control's, over seeds.

    python3 cardbench/calibrate.py --workload <cell> --seeds 1,2,3 [--control 3] [--out FILE]

One process builds the cell's decoder once. For each seed it makes the
seed's traffic, drives the program at the cell's own load (a few batch
calls, or the streams until the mix's utterances have finished), samples
the answers as a run does, and compares them with the float64 reference:
the program's readings. For the first ``--control`` seeds it also puts the
reference computed in bfloat16 in the program's place and compares that:
the control's readings, which a limit has to reject. A limit is set
between the two (``cardbench/limits/<cell>.json``). Prints one JSON line a
seed.

Where the program's top beam of an answer is not the reference's
(``top_gap`` above 0), the line also lists, under ``mismatches``, the two
top texts, and the top text of a second witness: the program's host
engine (``engine="host"``, float64 on one core) decoding the whole
utterance, against the reference's decode of it.
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from cardbench.harness import judge, manifest  # noqa: E402
from cardbench.harness.loops import Spans  # noqa: E402
from cardbench.harness.runner import Cell, log  # noqa: E402

MAX_WITNESSED = 4  # mismatching answers a seed decodes again with the host engine

STREAM_SECONDS = 12.0  # long enough for every stream to finish its first utterance (at most 10.8 s)


def readings(cell: Cell, seed: int, control: bool) -> dict:
    loop, inputs = cell.loop(seed, Spans())
    if cell.kind == "batch":
        rows = cell.mix["rows"]
        for _ in range(max(2, -(-cell.mix["check"] // rows) + 1)):
            loop.call()
    else:
        loop.open()
        t0 = time.perf_counter()
        loop.schedule(t0)
        loop.serve_until(t0 + STREAM_SECONDS)
    _, failed, answers = cell.answers(loop)
    ref = cell.reference("f64")
    out = dict(seed=seed, failed=failed, answers=len(answers), program=cell.judge(answers, inputs, ref))
    if out["program"]["top_gap"] > 0:
        out["mismatches"] = mismatches(cell, answers, inputs, ref)
    if control:
        low = cell.reference("bf16")
        t0 = time.perf_counter()
        keys = [key for key, _ in answers]
        want = {key: cell.reference_answer(ref, inputs, key) for key in set(keys)}
        got = [(key, cell.reference_answer(low, inputs, key)) for key in keys]
        out["control"] = judge.compare(cell.pairs(got, want))
        log(f"control judged in {time.perf_counter() - t0:.1f} s")
    return out


def _top(beams) -> str:
    return beams[0]["text"] + ("|" + beams[0]["partial"] if beams and "partial" in beams[0] else "") if beams else ""


def mismatches(cell: Cell, answers, inputs, ref) -> list:
    """The answers whose top beam differs from the reference's: both top texts, and the host engine's."""
    s = cell.search
    host = None
    out = []
    for key, ans in answers:
        want = cell.reference_answer(ref, inputs, key)
        got = cell.pairs([(key, judge.program_output(ans, cell.words()) if cell.kind == "batch"
                           else [judge.program_view(v) if v else None for v in ans])], {key: want})
        bad = [(g, w) for g, w in got if g and judge.compare([(g, w)])["top_gap"] > 0]
        if not bad or len(out) >= MAX_WITNESSED:
            continue
        if host is None:
            host = cell.build(engine="host")
        a, b = key
        utt = inputs[a][b] if cell.kind == "batch" else inputs[a][b % len(inputs[a])]
        kw = dict(beam_width=s["beam_width"], beam_prune_logp=s["beam_prune_logp"],
                  token_min_logp=s["token_min_logp"], **cell.hot)
        h = judge.program_output(host.decode_beams(utt, **kw), cell.words())
        r = ref.decode(utt, beam_width=s["beam_width"], prune_logp=s["beam_prune_logp"],
                       token_min_logp=s["token_min_logp"])
        out.append(dict(key=list(key), views=len(got), bad_views=len(bad), program_top=_top(bad[0][0]),
                        reference_top=_top(bad[0][1]), host_whole=h[0]["text"], reference_whole=r[0]["text"],
                        host_lm=h[0]["lm"], reference_lm=r[0]["lm"]))
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True, help="comma-separated")
    parser.add_argument("--control", type=int, default=3, help="seeds that also read the control")
    parser.add_argument("--out", default=None, help="also write the lines to this file")
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        log("no CUDA device")
        return 2
    cell = Cell(manifest.manifest(), args.workload, "cuda")
    lines = []
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        line = json.dumps(dict(cell=args.workload, **readings(cell, seed, i < args.control)))
        print(line, flush=True)
        lines.append(line)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as fh:
            fh.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
