"""Frozen data makers: label sets, the parity-scale 3-gram, and noisy CTC utterances.

These are copies of the program's own generators, frozen here so that a
change to the program cannot change the benchmark's inputs:

* :func:`parity_vocab` and :func:`write_parity_arpa` copy
  ``pyctcdecode_torch.evaluation.parity_vocab`` / ``make_parity_arpa``: a
  3-gram ARPA with the shape of LibriSpeech's ``3-gram.pruned.1e-7.arpa``
  (200k words, 1.5M bigrams, 1.1M trigrams at the default sizes);
* :func:`bpe_vocabulary` and :func:`split_pieces` copy ``chip_smoke.py``'s
  128-piece vocabulary grown from the LM's words (the width of NeMo's
  English Conformer-CTC tokenizer) and its greedy longest-match split;
* :func:`render_utterance` is the noise model of
  ``evaluation.synthesize_corpus`` (a ``peak`` one-hot plus N(0, ``noise``)
  a frame, each emission held 1-2 frames and followed by 1-2 blank frames
  at a larger ``blank_peak``), with the dev-other settings
  :data:`DEV_OTHER_DIFFICULTY`, fitted to a fixed frame count.

The digests in ``cardbench/tests/test_cardbench_data.py`` pin their output.
"""
from __future__ import annotations

from collections import Counter
from typing import Dict, List, Sequence, Tuple

import numpy as np

# 28 characters plus the CTC blank, the layout of pyctcdecode's LibriSpeech logits fixture (for tests)
LIBRI_LABELS = [" "] + list("abcdefghijklmnopqrstuvwxyz") + ["'", ""]

# greedy WER ~10%, the reference's published greedy WER on LibriSpeech dev-other
DEV_OTHER_DIFFICULTY: Dict[str, object] = dict(
    frames_per_char=(1, 2),
    blank_frames=(1, 2),
    peak=8.0,
    noise=1.7,
    blank_peak=12.5,
)

TRANSCRIPT = (
    "i have a good deal of will you remember and what i have set my mind upon "
    "no doubt i shall some day achieve"
)

# multi-letter pieces by length, word-initial and inner each (128 pieces in all)
BPE_QUOTA = {2: 13, 3: 12, 4: 12}


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


def _write_grams(fh, words: Sequence[str], probs, backoffs=None) -> None:
    lines = []
    for i in range(len(words)):
        row = f"{probs[i]}\t{words[i]}"
        if backoffs is not None:
            row += f"\t{backoffs[i]}"
        lines.append(row + "\n")
        if len(lines) >= 100_000:
            fh.writelines(lines)
            lines = []
    fh.writelines(lines)


def write_parity_arpa(path: str, n_vocab: int, n_bigrams: int, n_trigrams: int, seed: int) -> List[str]:
    """Write the parity-scale 3-gram ARPA to ``path``; return its vocabulary."""
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


def bpe_vocabulary(words: Sequence[str]) -> List[str]:
    """128 raw piece labels grown from ``words`` (the alphabet appends the blank).

    ``<unk>`` and ``▁``; the 26 letters and the 26 ``▁``-letter pieces; for
    each length of 2-4 letters, the ``BPE_QUOTA`` most frequent
    word-initial substrings of ``words``, ``▁``-prefixed, and as many of the
    most frequent inner ones (ties broken by the string).
    """
    first = {n: Counter() for n in BPE_QUOTA}
    inner = {n: Counter() for n in BPE_QUOTA}
    for word in words:
        for n in BPE_QUOTA:
            for i in range(len(word) - n + 1):
                (first if i == 0 else inner)[n][word[i : i + n]] += 1

    def top(counts, m):
        return sorted(counts, key=lambda piece: (-counts[piece], piece))[:m]

    letters = list("abcdefghijklmnopqrstuvwxyz")
    multi: List[str] = []
    for n, m in BPE_QUOTA.items():
        multi += ["▁" + piece for piece in top(first[n], m)] + top(inner[n], m)
    return ["<unk>", "▁"] + letters + ["▁" + c for c in letters] + multi


def split_pieces(word: str, index: Dict[str, int]) -> List[int]:
    """Greedy longest-match piece ids of ``word``, the first piece ``▁``-prefixed."""
    ids, i = [], 0
    while i < len(word):
        for n in range(min(4, len(word) - i), 0, -1):
            piece = ("▁" if i == 0 else "") + word[i : i + n]
            if piece in index:
                ids.append(index[piece])
                i += n
                break
        else:
            raise ValueError(f"{word!r} cannot be split into the vocabulary's pieces")
    return ids


def emissions(words: Sequence[str], labels: Sequence[str], is_bpe: bool) -> List[List[int]]:
    """Each word's emitted label ids: its pieces (BPE), or its letters and a space after it (char)."""
    index = {lab: i for i, lab in enumerate(labels)}
    if is_bpe:
        return [split_pieces(w, index) for w in words]
    return [[index[ch] for ch in w] + [index[" "]] for w in words]


def render_utterance(
    rng: np.random.RandomState,
    vocab: Sequence[str],
    labels: Sequence[str],
    is_bpe: bool,
    frames: int,
    difficulty: Dict[str, object] = DEV_OTHER_DIFFICULTY,
) -> Tuple[str, np.ndarray]:
    """One utterance of exactly ``frames`` frames: its transcript and raw float32 logits.

    Words are drawn from ``vocab`` and rendered as long as the next one
    still fits; the frames left over are blank frames (trailing silence).
    Every emission holds ``frames_per_char`` frames and is followed by
    ``blank_frames`` blank frames; raw logits are ``peak`` one-hot plus
    N(0, ``noise``), blank frames ``blank_peak``.
    """
    d = difficulty
    blank = list(labels).index("")
    flo, fhi = d["frames_per_char"]
    blo, bhi = d["blank_frames"]
    ids: List[int] = []
    words: List[str] = []
    while True:
        word = vocab[rng.randint(len(vocab))]
        run: List[int] = []
        for piece in emissions([word], labels, is_bpe)[0]:
            run += [piece] * rng.randint(flo, fhi + 1)
            run += [blank] * rng.randint(blo, bhi + 1)
        if len(ids) + len(run) > frames:
            break
        ids += run
        words.append(word)
    ids += [blank] * (frames - len(ids))
    arr = np.asarray(ids)
    mat = rng.randn(frames, len(labels)).astype(np.float32) * np.float32(d["noise"])
    mat[np.arange(frames), arr] += np.float32(d["peak"])
    mat[arr == blank, blank] += np.float32(d["blank_peak"] - d["peak"])
    return " ".join(words), mat
