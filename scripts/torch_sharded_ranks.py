"""A ``shard_lm`` decode over several processes, one a device: graphs against eager and the unsharded decoder.

Spawns ``--ranks`` processes of this script, one a card (NCCL; with
``--device cpu``, gloo on the CPU), each bringing the group up from the
``PYCTC_*`` variables on 127.0.0.1. Every process builds the decoder over the
3-gram ``--arpa`` (the parity-scale one, written from seed 7 when missing;
``--small`` writes a small one of the same shape), synthesizes the same
dev-other utterances (seed 3) and decodes them at ``--beam``, dense and with
the serving options (chunks, blank collapse), ``collect_stats`` on, three ways:

- ``ShardedCTCDecoder(shard_lm=True)`` over the decoder: on the card its
  segment and finalize graphs, the NCCL collectives captured inside (on the
  CPU: segments of 4 steps through ``with_options(segment_frames=4)``, run
  eagerly with the gloo collectives); a first call (with the captures) and a
  warm one (replays only);
- the same over ``decoder.with_options(segment_frames=0)``: the eager loop;
- the decoder alone, unsharded: every process decodes the whole batch.

Each process checks that the three agree to the bit (texts, frames, LM
states, scores and counters) and writes its record; the parent checks that
every process got the same global results and prints one JSON line: the
card, and per process its latencies, launch counts and peak device memory.
A disagreement, a failed process or one that outlives ``--timeout`` makes
it exit non-zero.

    python3 scripts/torch_sharded_ranks.py --ranks 4
    python3 scripts/torch_sharded_ranks.py --ranks 4 --device cpu --small --utts 4 --beam 8
"""
from __future__ import annotations

import argparse
import datetime
import json
import os
import pickle
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

LABELS = [" "] + list("abcdefghijklmnopqrstuvwxyz") + ["'", ""]
SMALL_LM = dict(n_vocab=3000, n_bigrams=30000, n_trigrams=20000)
SERVING = dict(token_chunking=True, blank_collapse=True)


def _plain(results) -> list:
    """Ranked beam lists as plain data: (text, text_frames, LM context, logit_score, lm_score)."""
    return [[(b.text, b.text_frames, getattr(b.last_lm_state, "context", None), b.logit_score, b.lm_score)
             for b in beams] for beams in results]


def _launches() -> dict:
    from pyctcdecode_torch.ops import backtrace, commit, gather, merge

    fns = (merge.expand_merge_prune, merge.merge_prune, gather.gather_rows, gather.probe_rows,
           backtrace.backtrace_paths, commit.commit_words)
    return {fn.__name__: fn.launches for fn in fns}


def _as_composition(launches: dict) -> dict:
    """Launches with each ``commit_words`` launch counted as the one collective ``probe_rows`` call
    of the PyTorch composition that commits words over row-sharded tables (one member)."""
    out = dict(launches)
    out["probe_rows"] += out.pop("commit_words")
    return out


def _rank(args) -> None:
    """One process of the group: the three decodes of each path, checked, pickled to ``args.out``."""
    import torch
    import torch.distributed as dist

    import pyctcdecode_torch as P
    from pyctcdecode_torch.evaluation import DEV_OTHER_DIFFICULTY, synthesize_corpus
    from pyctcdecode_torch.models.ngram import load_unigram_set_from_arpa
    from pyctcdecode_torch.parallel import ShardedCTCDecoder, make_data_mesh
    from pyctcdecode_torch.parallel.launch import initialize_from_env

    on_card = args.device != "cpu"
    assert initialize_from_env(device=args.device)
    rank = dist.get_rank()
    device = torch.device("cuda", torch.cuda.current_device()) if on_card else torch.device("cpu")
    decoder = P.build_ctcdecoder(LABELS, args.arpa, device=device)
    mesh = make_data_mesh(device=device)
    sharded = ShardedCTCDecoder(decoder if on_card else decoder.with_options(segment_frames=4), mesh=mesh,
                                shard_lm=True)
    eager = ShardedCTCDecoder(decoder.with_options(segment_frames=0), mesh=mesh, shard_lm=True)
    vocab = sorted(load_unigram_set_from_arpa(args.arpa))
    rng = np.random.RandomState(11)
    words = [vocab[i] for i in rng.randint(0, len(vocab), 6000)]
    logits = synthesize_corpus(LABELS, words, n_utterances=args.utts, seed=3, **DEV_OTHER_DIFFICULTY).logits
    eager.decode_beams_batch([logits[0][:8]], beam_width=args.beam)  # NCCL makes its communicator here

    def timed(dec, kw):
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        before = _launches()
        t0 = time.perf_counter()
        results, stats = dec.decode_beams_batch(logits, **kw)
        latency = time.perf_counter() - t0
        launches = {name: n - before[name] for name, n in _launches().items()}
        peak = torch.cuda.max_memory_allocated() / 1e9 if on_card else None
        return (_plain(results), stats), dict(latency_s=latency, launches=launches, peak_device_gb=peak)

    out = {"rank": rank, "paths": {}}
    for path, extra in (("dense", {}), ("serving", SERVING)):
        kw = dict(beam_width=args.beam, prune_history=True, top_n=1, collect_stats=True, **extra)
        want, plain_rec = timed(decoder, kw)
        got, first = timed(sharded, kw)
        again, warm = timed(sharded, kw)
        slow, eager_rec = timed(eager, kw)
        for name, other in (("graphs", got), ("graphs warm", again), ("eager", slow)):
            if other != want:
                raise SystemExit(f"rank {rank}, {path}: the sharded decode ({name}) differs from the unsharded one")
        if (first["launches"] != warm["launches"] or first["launches"]["commit_words"]
                or first["launches"] != _as_composition(plain_rec["launches"]) | {"commit_words": 0}):
            raise SystemExit(f"rank {rank}, {path}: launches {first['launches']}, warm {warm['launches']}, "
                             f"unsharded {plain_rec['launches']}")
        out["paths"][path] = dict(results=want, first=first, warm=warm, eager=eager_rec, unsharded=plain_rec)
    if on_card:
        keys = [key for key in decoder._graphs if key[3] == id(sharded._tabs)]
        out["sharded_keys"] = len(keys)
        for key in keys:  # their graphs replay the group's collectives: they go before the group
            del decoder._graphs[key]
        torch.cuda.synchronize()
    with open(args.out, "wb") as fh:
        pickle.dump(out, fh)
    dist.destroy_process_group()


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--ranks", type=int, default=4)
    parser.add_argument("--device", default=None, help="cpu for gloo on the CPU (default: one card a process)")
    parser.add_argument("--arpa", default="build/parity_3gram.arpa", help="the 3-gram (written when missing)")
    parser.add_argument("--small", action="store_true", help="write a small 3-gram of the same shape")
    parser.add_argument("--utts", type=int, default=32)
    parser.add_argument("--beam", type=int, default=100)
    parser.add_argument("--timeout", type=float, default=600.0, help="seconds each process may take")
    parser.add_argument("--out", default=None, help=argparse.SUPPRESS)  # a process of the group
    args = parser.parse_args()
    if args.out is not None:
        _rank(args)
        return 0

    import torch

    if args.device != "cpu" and torch.cuda.device_count() < args.ranks:
        print(f"torch_sharded_ranks: {args.ranks} processes need as many cards; "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    from pyctcdecode_torch.evaluation import make_parity_arpa

    if not os.path.exists(args.arpa):
        os.makedirs(os.path.dirname(os.path.abspath(args.arpa)), exist_ok=True)
        tmp = f"{args.arpa}.tmp{os.getpid()}"
        make_parity_arpa(tmp, **(SMALL_LM if args.small else {}))
        os.replace(tmp, args.arpa)
    if args.device != "cpu":
        from pyctcdecode_torch.csrc.build import build

        build()  # once, before the processes load the kernels
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as td:
        procs = []
        for rank in range(args.ranks):
            env = dict(os.environ, PYCTC_COORDINATOR=f"127.0.0.1:{port}", PYCTC_NUM_PROCESSES=str(args.ranks),
                       PYCTC_PROCESS_ID=str(rank), TORCH_NCCL_ASYNC_ERROR_HANDLING="1")
            cmd = [sys.executable, os.path.abspath(__file__), "--out", os.path.join(td, f"{rank}.pkl"),
                   "--arpa", args.arpa, "--utts", str(args.utts), "--beam", str(args.beam)]
            if args.device:
                cmd += ["--device", args.device]
            procs.append(subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
        logs, failed = [], False
        try:
            for p in procs:
                logs.append(p.communicate(timeout=args.timeout)[0].decode(errors="replace"))
                failed |= p.returncode != 0
        except subprocess.TimeoutExpired:
            failed = True
        finally:
            for p in procs:
                p.kill()
                p.wait()
        if failed:
            for rank, text in enumerate(logs):
                print(f"--- process {rank}\n{text[-4000:]}", file=sys.stderr)
            print("torch_sharded_ranks: a process failed or timed out", file=sys.stderr)
            return 1
        parts = []
        for rank in range(args.ranks):
            with open(os.path.join(td, f"{rank}.pkl"), "rb") as fh:
                parts.append(pickle.load(fh))
    for path in parts[0]["paths"]:
        if any(part["paths"][path]["results"] != parts[0]["paths"][path]["results"] for part in parts[1:]):
            print(f"torch_sharded_ranks: {path}: the processes' global results differ", file=sys.stderr)
            return 1
    card = None
    if args.device != "cpu":
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, check=True).stdout.strip().splitlines()
    report = {
        "ranks": args.ranks, "device": args.device or "cuda", "utterances": args.utts, "beam": args.beam,
        "equal": True, "card": card, "seconds": time.perf_counter() - t0,
        "at": datetime.datetime.now(datetime.timezone.utc).isoformat(timespec="seconds"),
        "processes": [{"rank": part["rank"], "sharded_keys": part.get("sharded_keys"),
                       **{path: {col: rec[col] for col in ("first", "warm", "eager", "unsharded")}
                          for path, rec in part["paths"].items()}} for part in parts],
    }
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
