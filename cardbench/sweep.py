"""The stream cell's knee: chunk latency against the number of live streams, in one process.

    python3 cardbench/sweep.py --workload <stream cell> --streams 8,16,24 --seconds 12 --seed 1

For each stream count the cell's mix is served for ``--seconds`` with that
many streams (everything else as the mix says). A line each: the chunks
due, the median and 95th percentile of due-to-return latency, and how late
the last quarter of the chunks started against the first quarter (a
backlog that grows shows as a rising lateness). The knee is the highest
count whose backlog does not grow and whose 95th percentile stays under
the real-time limit of one chunk period.
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from cardbench.harness import manifest  # noqa: E402
from cardbench.harness.loops import Spans, percentile  # noqa: E402
from cardbench.harness.runner import Cell, log  # noqa: E402


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--streams", required=True, help="comma-separated stream counts")
    parser.add_argument("--seconds", type=float, default=12.0)
    parser.add_argument("--seed", type=int, default=1)
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        log("no CUDA device")
        return 2
    cell = Cell(manifest.manifest(), args.workload, "cuda")
    base = dict(cell.mix)
    for n in (int(s) for s in args.streams.split(",")):
        cell.mix = dict(base, streams=n)
        loop, _ = cell.loop(args.seed, Spans())
        loop.open()
        t0 = time.perf_counter()
        loop.schedule(t0)
        served = loop.serve_until(t0 + args.seconds)
        lat = [(c["end"] - c["due"]) * 1e3 for c in served]
        late = [(c["start"] - c["due"]) * 1e3 for c in served]
        q = max(1, len(late) // 4)
        print(json.dumps(dict(
            streams=n, chunks=len(served), failed=sum(c["failed"] for c in served),
            p50_ms=percentile(lat, 50), p95_ms=percentile(lat, 95), max_ms=max(lat),
            service_p50_ms=percentile([(c["end"] - c["start"]) * 1e3 for c in served], 50),
            late_first_quarter_ms=sum(late[:q]) / q, late_last_quarter_ms=sum(late[-q:]) / q,
            period_ms=cell.mix["chunk_s"] * 1e3)), flush=True)
        del loop
    return 0


if __name__ == "__main__":
    sys.exit(main())
