"""Compiled binary n-gram format (``.ctclm``).

ARPA text parsing is slow for production-size LMs, so the JAX reference
package defines its own compiled format, and this module is a copy of its
reader and writer (a file written by either package loads in the other): a
single ``numpy``-backed container holding the vocabulary and flat per-order
id/score arrays, loading with O(file) mmap-able reads instead of text
parsing. This plays the role KenLM's ``.bin`` files play
for the reference (ref ``language_model.py:422-427`` accepts
``.arpa/.bin/.binary``); actual KenLM PROBING binaries are handled by
``models/kenlm_bin.py`` (``open_ngram_file`` dispatches on the file magic),
this format is for models parsed or built by these packages.
"""
from __future__ import annotations

import json
from typing import Dict, List, Tuple

import numpy as np

from .ngram import NGramTables, UNK_WORD

MAGIC = b"CTCLM001"


def write_binary(tables: NGramTables, path: str) -> None:
    """Serialize :class:`NGramTables` to a ``.ctclm`` file."""
    # vocabulary in id order
    id2word = [""] * len(tables.vocab)
    for word, wid in tables.vocab.items():
        id2word[wid] = word
    payload: Dict[str, np.ndarray] = {}
    meta = {"order": tables.order, "counts": []}
    for n, table in enumerate(tables.ngrams, start=1):
        count = len(table)
        meta["counts"].append(count)
        ids = np.empty((count, n), dtype=np.int32)
        probs = np.empty((count,), dtype=np.float32)
        backoffs = np.empty((count,), dtype=np.float32)
        for row, (key, (p, b)) in enumerate(table.items()):
            ids[row] = key
            probs[row] = p
            backoffs[row] = b
        payload[f"ids{n}"] = ids
        payload[f"probs{n}"] = probs
        payload[f"backoffs{n}"] = backoffs
    payload["meta"] = np.frombuffer(json.dumps(meta).encode("utf-8"), dtype=np.uint8)
    payload["vocab"] = np.frombuffer("\n".join(id2word).encode("utf-8"), dtype=np.uint8)
    with open(path, "wb") as fh:
        fh.write(MAGIC)
        np.savez(fh, **payload)


def read_binary(path: str) -> NGramTables:
    """Load a ``.ctclm`` file back into :class:`NGramTables`."""
    with open(path, "rb") as fh:
        magic = fh.read(len(MAGIC))
        if magic != MAGIC:
            raise ValueError(
                f"{path!r} is not a pyctcdecode_torch compiled LM (found magic "
                f"{magic!r}). KenLM PROBING binaries load via "
                "models.kenlm_bin (open_ngram_file dispatches on the file "
                "magic); other formats convert from the ARPA with "
                "`pyctcdecode_torch.models.binfmt.compile_arpa`."
            )
        data = np.load(fh, allow_pickle=False)
        meta = json.loads(bytes(data["meta"]).decode("utf-8"))
        words = bytes(data["vocab"]).decode("utf-8").split("\n")
        vocab = {w: i for i, w in enumerate(words)}
        if UNK_WORD not in vocab:
            raise ValueError(f"Compiled LM {path!r} is missing {UNK_WORD}.")
        ngrams: List[Dict[Tuple[int, ...], Tuple[np.float32, np.float32]]] = []
        for n in range(1, meta["order"] + 1):
            ids = data[f"ids{n}"]
            probs = data[f"probs{n}"]
            backoffs = data[f"backoffs{n}"]
            table: Dict[Tuple[int, ...], Tuple[np.float32, np.float32]] = {}
            for row in range(ids.shape[0]):
                table[tuple(int(v) for v in ids[row])] = (probs[row], backoffs[row])
            ngrams.append(table)
    return NGramTables(order=meta["order"], vocab=vocab, ngrams=ngrams, path=path)


def compile_arpa(arpa_path: str, out_path: str) -> None:
    """Compile an ARPA text LM into the binary ``.ctclm`` format."""
    from .ngram import read_arpa

    write_binary(read_arpa(arpa_path), out_path)
