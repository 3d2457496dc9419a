"""Shared cases for wav2vec2-base-960h's 32 labels: an LM with ``<s>`` / ``</s>`` n-grams, logits, streams.

Imports numpy, torch and the port only, so the card tests
(``test_torch_w2v2_cuda``) can use it on a machine without JAX.
"""
import numpy as np

import pyctcdecode_torch as P
from cardbench.harness import judge
from pyctcdecode_torch.decoder import Beam

from .torch_cases import SCORE_TOL

# the tokenizer's 32 outputs in its order: <pad> the blank, | the word delimiter
W2V2_LABELS = ["<pad>", "<s>", "</s>", "<unk>", "|", "e", "t", "a", "o", "n", "i", "h", "s", "r", "d", "l",
               "u", "m", "w", "c", "f", "g", "y", "p", "b", "v", "k", "'", "x", "j", "q", "z"]
QUARTZNET_LABELS = [" "] + list("abcdefghijklmnopqrstuvwxyz") + ["'"]
# a char alphabet that spells the markers letter by letter: partial words such as "</" come up
SPELLED_LABELS = ["", " ", "<", "/", ">", "b", "u", "g", "s", "n", "y"]
BEAM = 16

# A 3-gram whose n-grams run through the markers (</s> <s>, </s> sun, bugs </s> <s>, ...). <s> keeps
# the -99 log-prob it has in real models; </s> and <s> are unigram lines with a backoff, so both are
# known words and their prefixes known prefixes, except where a test gives its own unigram list.
ARPA = """\\data\\
ngram 1=12
ngram 2=12
ngram 3=5

\\1-grams:
-1.6\t<unk>\t0
-99\t<s>\t-0.6
-1.3\t</s>\t-0.2
-0.8\tbugs\t-0.3
-0.9\tbunny\t-0.4
-1.4\tbun\t-0.2
-1.1\tsun\t-0.35
-1.2\tsunny\t-0.3
-1.7\tgun\t-0.1
-2.0\tnun\t0
-1.5\tit's\t-0.2
-1.8\tjazz\t-0.1

\\2-grams:
-0.3\t<s> bugs\t-0.2
-0.6\t<s> bunny\t-0.1
-0.2\tbugs bunny\t-0.3
-0.5\tbunny </s>\t-0.1
-0.7\tbugs </s>\t-0.15
-0.9\t</s> <s>\t-0.2
-1.0\t</s> sun\t-0.1
-0.4\tsunny bun\t-0.2
-0.8\tsun <s>\t0
-0.6\t<s> </s>\t0
-1.1\tit's jazz\t0
-0.9\tjazz </s>\t0

\\3-grams:
-0.1\t<s> bugs bunny
-0.2\tbugs bunny </s>
-0.3\tbugs </s> <s>
-0.25\t</s> <s> bugs
-0.4\tbunny </s> sun

\\end\\
"""
# the words alone: </s> and <s> are then unknown words, and "<", "</" no known prefix
WORDS_ONLY = ["bugs", "bunny", "bun", "sun", "sunny", "gun", "nun", "it's", "jazz"]

PATHS = {
    "eos_mid": "bugs </s> sun",
    "eos_end": "bugs bunny </s>",
    "bos_first": "<s> bugs bunny",
    "markers_run_on": "</s> <s> bugs </s>",
    "unk": "bugs ⁇ sunny",
    "eos_glued": "bugs</s> it's jazz",
}


def columns(labels):
    return P.Alphabet.build_alphabet(labels).labels


def path_logits(labels, text, seed=0, peak=12.0):
    """Noisy logits peaked on ``text``'s labels, a blank after each (multi-char labels taken whole).

    At the default peak no other label comes within ``token_min_logp`` of a frame's best, so the path
    is the one beam (its ``<s>`` words too, whose -99 log-prob would lose to any rival); at a peak of 6
    other labels come in and compete.
    """
    cols = columns(labels)
    index = {lab: i for i, lab in enumerate(cols)}
    units = sorted((lab for lab in cols if lab), key=len, reverse=True)
    path = []
    rest = text
    while rest:
        lab = next(u for u in units if rest.startswith(u))
        path += [index[lab], index[""]]
        rest = rest[len(lab):]
    rng = np.random.RandomState(seed)
    mat = rng.randn(len(path), len(cols)).astype(np.float32) * 0.5
    mat[np.arange(len(path)), path] += peak
    return mat


def random_logits(seed, t, labels=W2V2_LABELS):
    """Seeded logits over a random path of blanks, spaces, the markers, ``⁇`` and the LM's letters."""
    cols = columns(labels)
    favoured = [i for i, lab in enumerate(cols) if lab in ("", " ", "<s>", "</s>", "⁇") or lab in "bugsnyitj'az"]
    rng = np.random.RandomState(1000 + seed)
    path = rng.choice(favoured + [cols.index("")] * 3, size=t)
    mat = rng.randn(t, len(cols)).astype(np.float32) * 1.3
    mat[np.arange(t), path] += 3.0
    return mat


def chunks_of(mat, size):
    return [mat[a : a + size] for a in range(0, mat.shape[0], size)]


def host_stream(host, chunks, beam_cls=Beam):
    """A host engine's views over ``chunks``, the last one ending the utterance (``beam_cls``: its Beam)."""
    beams, lm_cache, p_cache = host.get_starting_state()
    offset, views = 0, []
    for i, chunk in enumerate(chunks):
        out = host.partial_decode_beams(chunk, lm_cache, p_cache, beams, offset, beam_width=BEAM,
                                        is_end=i == len(chunks) - 1)
        beams = [beam_cls.from_lm_beam(b) for b in out]
        offset += chunk.shape[0]
        views.append(out)
    return views


def device_stream(dev, chunks):
    state = dev.get_starting_state(beam_width=BEAM)
    return [dev.partial_decode_beams(state, chunk, is_end=i == len(chunks) - 1) for i, chunk in enumerate(chunks)]


def assert_same_as_reference(want, got, words, tol=SCORE_TOL):
    """The reference's ranked beams against the program's: texts, word frames, LM states; scores within tol."""
    got = judge.program_output(got, words)
    assert len(got) == len(want) > 0
    for w, g in zip(want, got):
        assert (g["text"], g["frames"], g["state"]) == (w["text"], [(a, tuple(f)) for a, f in w["frames"]],
                                                        w["state"])
        assert abs(g["logit"] - w["logit"]) <= tol and abs(g["lm"] - w["lm"]) <= tol


def assert_same_reference_views(want, got, tol=SCORE_TOL):
    want, got = judge.reference_view(want), judge.program_view(got)
    assert len(got) == len(want) > 0
    for w, g in zip(want, got):
        assert {k: v for k, v in g.items() if k not in ("logit", "lm")} == \
            {k: v for k, v in w.items() if k not in ("logit", "lm")}
        assert abs(g["logit"] - w["logit"]) <= tol and abs(g["lm"] - w["lm"]) <= tol
