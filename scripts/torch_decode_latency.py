"""Batch latency of the PyTorch port's dense and serving decodes on one GPU.

Times what ``chip_smoke.py`` times for its two paths and nothing else, so
that two checkouts of the repository can be compared on one card inside one
job: run it from the root of each checkout in turns (parent, change, change,
parent) and compare the lines it prints.

    python3 scripts/torch_decode_latency.py --arpa build/parity_3gram.arpa --tag change

The parity-scale 3-gram is written to ``--arpa`` from a seed when the file is
missing (point every checkout at one file to write it once). The batch: 32
synthetic dev-other utterances, beam 100; dense: every token at every frame;
serving: token chunks of 5, blank collapse, length groups of 16. Prints one
JSON line: the card, steps, latencies (s) of ``--repeats`` decodes after one
warm-up each, their medians, host ms per step, and the launch counts of the
package's kernel wrappers in one decode.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.getcwd())

LABELS = [" "] + list("abcdefghijklmnopqrstuvwxyz") + ["'", ""]
SERVING = dict(token_chunking=True, blank_collapse=True, length_bucketing=16)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--arpa", required=True, help="the parity 3-gram (written when missing)")
    parser.add_argument("--tag", default="", help="a name for this checkout in the output")
    parser.add_argument("--repeats", type=int, default=3)
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_decode_latency: no CUDA device", file=sys.stderr)
        return 2
    import pyctcdecode_torch as P
    from pyctcdecode_torch.evaluation import (
        DEV_OTHER_DIFFICULTY,
        LM_VOCAB,
        TRANSCRIPT,
        make_parity_arpa,
        parity_vocab,
        synthesize_corpus,
    )
    from pyctcdecode_torch.ops import gather, merge

    if os.path.exists(args.arpa):
        vocab = parity_vocab(np.random.RandomState(7), LM_VOCAB)
    else:
        os.makedirs(os.path.dirname(os.path.abspath(args.arpa)), exist_ok=True)
        tmp = f"{args.arpa}.tmp{os.getpid()}"
        vocab = make_parity_arpa(tmp)
        os.replace(tmp, args.arpa)
    decoder = P.build_ctcdecoder(LABELS, args.arpa)
    rng = np.random.RandomState(11)
    words = [vocab[i] for i in rng.randint(0, len(vocab), 6000)] + TRANSCRIPT.split()
    corpus = synthesize_corpus(LABELS, words, n_utterances=32, seed=3, **DEV_OTHER_DIFFICULTY)
    logits = corpus.logits
    wrappers = {name: getattr(mod, name) for mod in (merge, gather)
                for name in ("merge_prune", "expand_merge_prune", "gather_rows", "probe_rows")
                if hasattr(mod, name)}

    out = {"tag": args.tag, "audio_s": corpus.audio_seconds}
    texts = {}
    for path, kw in (("dense", dict(max_tokens_per_frame=None)), ("serving", SERVING)):
        texts[path] = decoder.decode_batch(logits, beam_width=100, **kw)  # warm-up, builds the kernels
        for fn in wrappers.values():
            fn.launches = 0
        times = []
        for _ in range(args.repeats):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            decoder.decode_batch(logits, beam_width=100, **kw)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        launches = {name: fn.launches // args.repeats for name, fn in wrappers.items()}
        steps = launches["expand_merge_prune"]
        out[path] = {"steps": steps, "latencies_s": times, "median_s": statistics.median(times),
                     "host_ms_per_step": statistics.median(times) / steps * 1e3, "launches": launches}
    out["same_texts"] = texts["dense"] == texts["serving"]
    out["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
