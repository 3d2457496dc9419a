"""Corpus WER, throughput and engine parity of the PyTorch port.

Decodes a synthetic corpus at a given beam width with an n-gram LM and
prints one JSON report: WER and decoded audio-seconds per wall-second of the
host oracle and the device decoder, and their top-1 agreement. With no
``--arpa`` a small 2-gram and its corpus are generated from ``--seed``; with
one, the corpus is drawn from the model's unigrams.

    python scripts/torch_eval_corpus.py --n 128 --beam 100 [--arpa lm.arpa]
    python scripts/torch_eval_corpus.py --engine device        # the card alone
    python scripts/torch_eval_corpus.py --device cpu --n 8     # no card

The device decoder runs on CUDA unless ``--device`` (or ``--cpu``) names
another device; without a card the default raises.
"""
import argparse
import json
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

LIBRI_LABELS = [" "] + list("abcdefghijklmnopqrstuvwxyz") + ["'"] + [""]


def _synth_arpa(path: str, n_words: int, seed: int) -> list:
    """Small synthetic 2-gram over random words (for LM-on decoding)."""
    rng = np.random.RandomState(seed)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    vocab = set()
    while len(vocab) < n_words:
        vocab.add("".join(rng.choice(letters, size=rng.randint(3, 9))))
    vocab = sorted(vocab)
    with open(path, "w") as fh:
        fh.write("\\data\\\n")
        fh.write(f"ngram 1={len(vocab) + 3}\n")
        fh.write(f"ngram 2={len(vocab)}\n\n")
        fh.write("\\1-grams:\n")
        fh.write("-10\t<unk>\t0\n-2\t<s>\t-0.5\n-2\t</s>\t0\n")
        for w in vocab:
            fh.write(f"-2.5\t{w}\t-0.5\n")
        fh.write("\n\\2-grams:\n")
        for i, w in enumerate(vocab):
            fh.write(f"-1.0\t{w} {vocab[(i + 1) % len(vocab)]}\n")
        fh.write("\n\\end\\\n")
    return vocab


def _k_value(text: str):
    """argparse type for --k: an integer or the literal 'auto'."""
    if text == "auto":
        return text
    try:
        return int(text)
    except ValueError:
        raise argparse.ArgumentTypeError(f"expected an integer or 'auto', got {text!r}") from None


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=128, help="utterances")
    ap.add_argument("--beam", type=int, default=100)
    ap.add_argument("--alpha", type=float, default=0.5)
    ap.add_argument("--beta", type=float, default=1.5)
    ap.add_argument("--k", type=_k_value, default=None,
                    help="device token preselect: an integer or 'auto' (measured exact)")
    ap.add_argument("--arpa", default=None, help="n-gram LM (synthesized if absent)")
    ap.add_argument("--vocab-words", type=int, default=2000)
    ap.add_argument("--difficulty", choices=["legacy", "dev-other", "fixture"], default="legacy",
                    help="corpus difficulty preset (calibrations in evaluation.py); "
                    "'legacy' keeps this script's noisier generator settings")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--engine", choices=["both", "host", "device"], default="both",
                    help="'both' also reports parity")
    ap.add_argument("--device", default=None,
                    help="the device decoder's device (default: CUDA, raising without a card)")
    ap.add_argument("--cpu", action="store_true", help="the same as --device cpu")
    ap.add_argument("--blank-collapse", action="store_true", dest="blank_collapse",
                    help="drop blank-certain frames (device engine only; exactness-preserving "
                    "at the decode token_min_logp)")
    ap.add_argument("--token-chunking", type=int, default=None, dest="token_chunking", metavar="K",
                    help="token-timeline decoding with K-wide chunks (device engine only; "
                    "exact admission: the serving configuration)")
    args = ap.parse_args()
    if args.blank_collapse and args.engine != "device":
        ap.error("--blank-collapse requires --engine device")
    if args.token_chunking and args.engine not in ("device", "both"):
        ap.error("--token-chunking requires the device engine")
    if args.cpu and args.device not in (None, "cpu"):
        ap.error("--cpu and --device name different devices")
    device = "cpu" if args.cpu else args.device

    from pyctcdecode_torch import build_ctcdecoder
    from pyctcdecode_torch.evaluation import (
        DEV_OTHER_DIFFICULTY,
        FIXTURE_DIFFICULTY,
        compare_engines,
        evaluate_corpus,
        synthesize_corpus,
    )
    from pyctcdecode_torch.models.ngram import load_unigram_set_from_arpa

    with tempfile.TemporaryDirectory() as td:
        arpa = args.arpa
        if arpa is None:
            arpa = os.path.join(td, "eval.arpa")
            vocab = _synth_arpa(arpa, args.vocab_words, args.seed)
        else:
            vocab = sorted(load_unigram_set_from_arpa(arpa))
        difficulty = {"legacy": {}, "dev-other": DEV_OTHER_DIFFICULTY, "fixture": FIXTURE_DIFFICULTY}
        corpus = synthesize_corpus(LIBRI_LABELS, vocab, n_utterances=args.n, seed=args.seed,
                                   **difficulty[args.difficulty])
        kwargs = {}
        if args.k is not None:
            kwargs["max_tokens_per_frame"] = args.k
        if args.blank_collapse:
            kwargs["blank_collapse"] = True
        if args.token_chunking:
            kwargs["token_chunking"] = args.token_chunking
        build = dict(alpha=args.alpha, beta=args.beta)
        if args.engine == "both":
            host = build_ctcdecoder(LIBRI_LABELS, arpa, engine="host", **build)
            dev = build_ctcdecoder(LIBRI_LABELS, arpa, device=device, **build)
            report = compare_engines(host, dev, corpus, args.beam, **kwargs)
            report.pop("host_hypotheses")
            report.pop("device_hypotheses")
            host.cleanup()
        else:
            if args.engine == "host":
                dec = build_ctcdecoder(LIBRI_LABELS, arpa, engine="host", **build)
                kwargs.pop("max_tokens_per_frame", None)
            else:
                dec = build_ctcdecoder(LIBRI_LABELS, arpa, device=device, **build)
            report = evaluate_corpus(dec, corpus, args.beam, **kwargs)
            report.pop("hypotheses")
            report["engine"] = args.engine
    print(json.dumps(report))


if __name__ == "__main__":
    main()
