"""Corpus evaluation: synthetic data, corpus WER and throughput, and engine parity.

Environments without audio data or network access still need realistic
decoding work, and users need one call that reports what they pay for:

* :func:`synthesize_corpus` builds a reproducible noisy CTC corpus
  (reference transcripts plus frame-level logit matrices), at a difficulty
  preset (``DEV_OTHER_DIFFICULTY``, ``FIXTURE_DIFFICULTY``) or its own
  settings.
* :func:`make_parity_arpa` writes a 3-gram ARPA with the shape statistics
  of the pruned LibriSpeech 3-gram (200k-word vocabulary, 1.5M bigrams,
  1.1M trigrams).
* :func:`evaluate_corpus` decodes a corpus on either engine (the host
  oracle :class:`~pyctcdecode_torch.decoder.BeamSearchDecoderCTC` or
  :class:`~pyctcdecode_torch.torch_decoder.TorchBeamSearchDecoderCTC`) and
  reports corpus WER and decoded audio-seconds per wall-second, after a
  warm-up batch that takes the card's graph captures.
* :func:`compare_engines` runs the host oracle and the device decoder on
  the same corpus at matched parameters: both WERs, top-1 agreement and
  the throughput ratio.

Both data makers use fixed seeds, so every run sees the same data. CLI:
``python scripts/torch_eval_corpus.py --help``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .utils.metrics import word_error_rate

FRAME_SEC = 0.02  # Wav2Vec2 / QuartzNet CTC frame stride

# :func:`synthesize_corpus` difficulty presets calibrated against the
# reference's artifacts (decode cost is strongly data-dependent, so pinning
# difficulty is what makes corpus timings comparable):
# * ``DEV_OTHER_DIFFICULTY`` — greedy argmax decoding scores ~10% WER,
#   matching the reference's published greedy WER on LibriSpeech dev-other,
#   its benchmark split (10.08%, ref 03_eval_performance.ipynb cell 25).
# * ``FIXTURE_DIFFICULTY`` — matches the reference's real Wav2Vec2 test
#   fixture ``libri_logits.json`` (1.13 mean admitted tokens a frame at the
#   default -5.0 threshold, 39% blank-certain frames).
DEV_OTHER_DIFFICULTY: Dict[str, object] = dict(
    words_per_utterance=(14, 20),
    frames_per_char=(1, 2),
    blank_frames=(1, 2),
    peak=8.0,
    noise=1.7,
    blank_peak=12.5,
)
FIXTURE_DIFFICULTY: Dict[str, object] = dict(
    words_per_utterance=(14, 20),
    frames_per_char=(1, 2),
    blank_frames=(1, 2),
    peak=8.0,
    noise=0.8,
    blank_peak=11.0,
)


@dataclasses.dataclass
class Corpus:
    """Reference transcripts plus per-utterance logit matrices."""

    references: List[str]
    logits: List[np.ndarray]
    labels: List[str]

    @property
    def audio_seconds(self) -> float:
        return sum(m.shape[0] for m in self.logits) * FRAME_SEC

    def __len__(self) -> int:
        return len(self.references)


def synthesize_corpus(
    labels: Sequence[str],
    vocabulary: Sequence[str],
    n_utterances: int = 128,
    words_per_utterance: Tuple[int, int] = (4, 12),
    frames_per_char: Tuple[int, int] = (1, 3),
    blank_rate: float = 0.25,
    noise: float = 1.5,
    peak: float = 6.0,
    seed: int = 0,
    blank_frames: Optional[Tuple[int, int]] = None,
    blank_peak: Optional[float] = None,
) -> Corpus:
    """Generate a reproducible noisy CTC corpus over a char alphabet.

    Each utterance samples words from ``vocabulary``, renders the character
    sequence to frames (each char held 1-3 frames, blanks sprinkled
    between), and emits raw logits = ``peak``·one-hot + N(0, ``noise``) so
    greedy decoding makes occasional character errors that a language model
    can repair — the same shape of workload the reference's LibriSpeech
    evaluation exercises.

    Real CTC acoustic models emit blank on roughly half of all frames and
    are extremely confident about them (the reference's Wav2Vec2 fixture:
    47% blank-argmax frames, 39% with p(blank) > 0.999). The defaults keep
    the original sparser-blank behavior; to mimic real emission statistics
    pass ``blank_frames=(lo, hi)`` (a run of that many blank frames after
    every character, replacing the ``blank_rate`` coin flip) and
    ``blank_peak`` (a larger one-hot peak on blank frames so silence is
    near-certain, as in real models).
    """
    char2id = {c: i for i, c in enumerate(labels)}
    if "" not in char2id:
        raise ValueError(
            "synthesize_corpus needs a char alphabet with a '' CTC blank"
        )
    blank_id = char2id[""]
    if " " not in char2id:
        raise ValueError("synthesize_corpus needs a char alphabet with ' '")
    rng = np.random.RandomState(seed)
    vocab = [w for w in vocabulary if all(ch in char2id for ch in w)]
    if not vocab:
        raise ValueError("no vocabulary word is spellable with these labels")
    refs: List[str] = []
    mats: List[np.ndarray] = []
    lo, hi = words_per_utterance
    flo, fhi = frames_per_char
    b_peak = peak if blank_peak is None else blank_peak
    for _ in range(n_utterances):
        words = [vocab[rng.randint(len(vocab))] for _ in range(rng.randint(lo, hi + 1))]
        refs.append(" ".join(words))
        ids: List[int] = []
        for ch in " ".join(words):
            ids.extend([char2id[ch]] * rng.randint(flo, fhi + 1))
            if blank_frames is not None:
                ids.extend([blank_id] * rng.randint(blank_frames[0], blank_frames[1] + 1))
            elif rng.rand() < blank_rate:
                ids.append(blank_id)
        arr = np.asarray(ids)
        mat = rng.randn(len(ids), len(labels)).astype(np.float32) * noise
        mat[np.arange(len(ids)), arr] += peak
        if b_peak != peak:
            mat[arr == blank_id, blank_id] += b_peak - peak
        mats.append(mat)
    return Corpus(references=refs, logits=mats, labels=list(labels))


# decode options only the device decoder takes; the host oracle decodes without them
_DEVICE_ONLY_KWARGS = (
    "max_tokens_per_frame",
    "blank_collapse",
    "length_bucketing",
    "token_chunking",
)


def _decode_all(decoder, corpus: Corpus, beam_width: int, **kwargs) -> List[str]:
    """Batch top-1 transcripts on either engine (the host oracle's ``decode_batch`` takes a pool first)."""
    from .decoder import BeamSearchDecoderCTC

    if isinstance(decoder, BeamSearchDecoderCTC):
        kwargs = {k: v for k, v in kwargs.items() if k not in _DEVICE_ONLY_KWARGS}
        return decoder.decode_batch(None, corpus.logits, beam_width=beam_width, **kwargs)
    return decoder.decode_batch(corpus.logits, beam_width=beam_width, **kwargs)


def evaluate_corpus(
    decoder: "object",
    corpus: Corpus,
    beam_width: int = 100,
    warmup: bool = True,
    **decode_kwargs: "object",
) -> Dict:
    """Decode a corpus and report its WER and decoded audio-seconds per wall-second.

    ``warmup`` decodes the first utterance first, untimed, so that the
    card's one-time work (kernel builds, graph captures) is not billed to
    throughput (the reference times warm decoding too, ref
    03_eval_performance.ipynb cells 29-30). The timed decode is the whole
    corpus in one ``decode_batch`` call, which waits for its results.
    """
    if warmup:
        _decode_all(decoder, Corpus(corpus.references[:1], corpus.logits[:1], corpus.labels),
                    beam_width, **decode_kwargs)
    t0 = time.perf_counter()
    hyps = _decode_all(decoder, corpus, beam_width, **decode_kwargs)
    wall = time.perf_counter() - t0
    return {
        "wer": word_error_rate(corpus.references, hyps),
        "audio_seconds": round(corpus.audio_seconds, 2),
        "wall_seconds": round(wall, 4),
        "audio_sec_per_sec": round(corpus.audio_seconds / wall, 2),
        "n_utterances": len(corpus),
        "beam_width": beam_width,
        "hypotheses": hyps,
    }


def compare_engines(
    host_decoder: "object",
    device_decoder: "object",
    corpus: Corpus,
    beam_width: int = 100,
    **decode_kwargs: "object",
) -> Dict:
    """Decode the same corpus on the host oracle and the device decoder at matched parameters.

    Returns both :func:`evaluate_corpus` reports (without hypotheses), the
    fraction of utterances whose top-1 transcripts agree exactly (the
    device's f32 score accumulation can flip exact ties the host's f64
    keeps, see PARITY.md), the WER difference, the throughput ratio, and
    both engines' hypotheses.
    """
    host = evaluate_corpus(host_decoder, corpus, beam_width, **decode_kwargs)
    dev = evaluate_corpus(device_decoder, corpus, beam_width, **decode_kwargs)
    agree = sum(h == d for h, d in zip(host["hypotheses"], dev["hypotheses"])) / len(corpus)
    return {
        "host": {k: v for k, v in host.items() if k != "hypotheses"},
        "device": {k: v for k, v in dev.items() if k != "hypotheses"},
        "top1_agreement": round(agree, 4),
        "wer_delta": round(dev["wer"] - host["wer"], 6),
        "speedup": round(host["wall_seconds"] / dev["wall_seconds"], 2),
        "host_hypotheses": host["hypotheses"],
        "device_hypotheses": dev["hypotheses"],
    }


# parity-scale 3-gram (shape statistics of the pruned LibriSpeech 3-gram)
LM_VOCAB = 200_000
LM_BIGRAMS = 1_500_000
LM_TRIGRAMS = 1_100_000
TRANSCRIPT = (
    "i have a good deal of will you remember and what i have set my mind upon "
    "no doubt i shall some day achieve"
)


def parity_vocab(rng: np.random.RandomState, n: int) -> List[str]:
    """``n`` sorted words: the transcript's plus random 2-11 letter strings."""
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    vocab = set(TRANSCRIPT.split())
    lens = rng.randint(2, 12, size=n + 20000)
    i = 0
    while len(vocab) < n:
        vocab.add("".join(rng.choice(letters, size=lens[i % len(lens)])))
        i += 1
    return sorted(vocab)


def _write_grams(fh, arr_words, probs, backoffs=None) -> None:
    lines = []
    for i in range(len(arr_words)):
        row = f"{probs[i]}\t{arr_words[i]}"
        if backoffs is not None:
            row += f"\t{backoffs[i]}"
        lines.append(row + "\n")
        if len(lines) >= 100_000:
            fh.writelines(lines)
            lines = []
    fh.writelines(lines)


def make_parity_arpa(
    path: str,
    n_vocab: int = LM_VOCAB,
    n_bigrams: int = LM_BIGRAMS,
    n_trigrams: int = LM_TRIGRAMS,
    seed: int = 7,
) -> List[str]:
    """Write the parity-scale 3-gram ARPA to ``path``; return its vocabulary.

    At the default sizes the file is ~84 MB and takes ~10 s to write. The
    vocabulary comes back so callers can draw corpus words from it without
    parsing the file.
    """
    rng = np.random.RandomState(seed)
    vocab = parity_vocab(rng, n_vocab)
    words = TRANSCRIPT.split()
    n_v = len(vocab)
    bi = rng.randint(0, n_v, size=(n_bigrams, 2))
    tri = rng.randint(0, n_v, size=(n_trigrams, 3))
    with open(path, "w") as fh:
        fh.write("\\data\\\n")
        fh.write(f"ngram 1={n_v + 3}\n")
        fh.write(f"ngram 2={n_bigrams + len(words) - 1}\n")
        fh.write(f"ngram 3={n_trigrams + len(words) - 2}\n\n")
        fh.write("\\1-grams:\n")
        fh.write("-10\t<unk>\t0\n-2.5\t<s>\t-0.6\n-2.5\t</s>\t0\n")
        p1 = np.round(rng.uniform(-6.0, -2.5, size=n_v), 3)
        b1 = np.round(rng.uniform(-1.2, -0.1, size=n_v), 3)
        _write_grams(fh, vocab, p1, b1)
        fh.write("\n\\2-grams:\n")
        for a, b in zip(words[:-1], words[1:]):
            fh.write(f"-0.4\t{a} {b}\t-0.3\n")
        pairs = [f"{vocab[i]} {vocab[j]}" for i, j in bi]
        p2 = np.round(rng.uniform(-4.0, -0.5, size=n_bigrams), 3)
        b2 = np.round(rng.uniform(-1.0, -0.05, size=n_bigrams), 3)
        _write_grams(fh, pairs, p2, b2)
        fh.write("\n\\3-grams:\n")
        for a, b, c in zip(words[:-2], words[1:-1], words[2:]):
            fh.write(f"-0.3\t{a} {b} {c}\n")
        tris = [f"{vocab[i]} {vocab[j]} {vocab[k]}" for i, j, k in tri]
        p3 = np.round(rng.uniform(-3.0, -0.3, size=n_trigrams), 3)
        _write_grams(fh, tris, p3)
        fh.write("\n\\end\\\n")
    return vocab
