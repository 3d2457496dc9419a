"""Shared cases for the port's tests: merge-kernel inputs, a tiny 3-gram, beam checks, two fixtures.

Imports numpy, torch and the port only (no JAX), so the card tests (``test_torch_kernels_cuda``)
can use it on a machine without JAX. A test module that imports a fixture by name
(``from .torch_cases import one_torch_thread``) runs all its tests under it.
"""
import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

ATOL = 1e-5
DEAD = -1.0e30
# both engines score in float32; the group logsumexp and exp/log round
# differently in the two frameworks and scores accumulate over the frames
SCORE_TOL = 1e-4

# A self-authored 3-gram over words spellable with the bugs/bunny alphabet
# (" bgnsuy"), with backoff paths at every order and a non-unigram vocab word.
ARPA = """\\data\\
ngram 1=12
ngram 2=9
ngram 3=4

\\1-grams:
-1.6\t<unk>\t0
-99\t<s>\t-0.6
-1.3\t</s>\t0
-0.8\tbugs\t-0.3
-0.9\tbunny\t-0.4
-1.4\tbun\t-0.2
-1.5\tbuns\t-0.25
-1.1\tsun\t-0.35
-1.2\tsunny\t-0.3
-1.7\tgun\t-0.1
-1.9\tguns\t-0.15
-2.0\tnun\t0

\\2-grams:
-0.3\t<s> bugs\t-0.2
-0.6\t<s> bunny\t-0.1
-0.2\tbugs bunny\t-0.3
-0.9\tbunny bunny\t0
-0.5\tbunny </s>\t0
-0.7\tbugs </s>\t0
-0.4\tsunny bun\t-0.2
-0.8\tsun guns\t0
-0.6\tbun buns\t0

\\3-grams:
-0.1\t<s> bugs bunny
-0.2\tbugs bunny </s>
-0.3\tsunny bun buns
-0.25\t<s> bunny bunny

\\end\\
"""
UNIGRAMS = ["bugs", "bunny", "bun", "buns", "sun", "sunny", "gun", "nun"]  # "guns" left out

# The same model cut to a 2-gram (its 3-grams dropped): a second member of
# another order for MultiLanguageModel cases.
ARPA_2GRAM = ARPA.replace("ngram 3=4\n", "").split("\\3-grams:")[0] + "\\end\\\n"


def merge_inputs(rng, n, k, b):
    kl = rng.randint(0, 5, size=(n, k, b)).astype(np.uint32)
    kh = kl * np.uint32(2654435761)
    valid = rng.rand(n, k, b) < 0.7
    logit = np.where(valid, rng.randn(n, k, b), DEAD).astype(np.float32)
    extra = rng.randn(n, k, b).astype(np.float32)
    prune = np.full(n, -1.5, dtype=np.float32)
    return kl, kh, valid, logit, extra, prune


def assert_outputs(got, want):
    score, merged, src = (x.numpy() for x in got)
    w_score, w_merged, w_src = (np.asarray(x) for x in want)
    np.testing.assert_allclose(score, w_score, atol=ATOL, rtol=0)
    finite = np.isfinite(w_merged)
    np.testing.assert_array_equal(np.isfinite(merged), finite)
    np.testing.assert_allclose(merged[finite], w_merged[finite], atol=ATOL, rtol=0)
    live = w_score > -1e29
    assert live.any()
    np.testing.assert_array_equal(src[live], w_src[live])


def torch_merge_args(kl, kh, valid, logit, extra, prune):
    return (
        torch.as_tensor(kl.astype(np.int64)), torch.as_tensor(kh.astype(np.int64)),
        torch.as_tensor(valid.astype(np.int32)), torch.as_tensor(logit),
        torch.as_tensor(extra), torch.as_tensor(prune),
    )


def expand_inputs(rng, n, k, b, lmax):
    """Random parents/tokens with small hash ranges so candidates collide."""
    beam = {
        "text_lo": rng.randint(0, 3, (n, b)).astype(np.uint32),
        "text_hi": rng.randint(0, 3, (n, b)).astype(np.uint32),
        "cm_text_lo": rng.randint(0, 3, (n, b)).astype(np.uint32),
        "cm_text_hi": rng.randint(0, 3, (n, b)).astype(np.uint32),
        "p_lo": rng.randint(0, 3, (n, b)).astype(np.uint32),
        "p_hi": rng.randint(0, 3, (n, b)).astype(np.uint32),
        "force": rng.randint(0, 2, (n, b)).astype(np.int32),
        "fused": rng.randn(n, b).astype(np.float32),
        "wfused": rng.randn(n, b).astype(np.float32),
        "logit": np.where(rng.rand(n, b) < 0.8, rng.randn(n, b) - 2.0, DEAD).astype(np.float32),
        "last_tok": rng.randint(-3, k, (n, b)).astype(np.int32),
    }
    tok = {
        "tok": np.tile(np.arange(k, dtype=np.int32), (n, 1)),
        "blank": (rng.rand(n, k) < 0.2).astype(np.int32),
        "boundary": (rng.rand(n, k) < 0.3).astype(np.int32),
        "right": (rng.rand(n, k) < 0.3).astype(np.int32),
        "seed_lo": rng.randint(0, 3, (n, k)).astype(np.uint32),
        "seed_hi": rng.randint(0, 3, (n, k)).astype(np.uint32),
        "tok_logp": (-rng.rand(n, k) * 4).astype(np.float32),
        "admit": (rng.rand(n, k) < 0.8).astype(np.int32),
    }
    cids = rng.randint(-1, 30, (lmax, n, k)).astype(np.int32)
    pscore = (rng.randn(n, k, b) * 0.5).astype(np.float32)
    prune = np.full(n, -3.0, dtype=np.float32)
    return beam, tok, cids, pscore, prune


def chunk_token_planes(rng, tok, vocab):
    """``tok`` planes as one timeline chunk: per-row-distinct ids, ``-1`` holes clamped.

    Each utterance's chunk holds different, ascending token ids drawn from
    ``vocab`` and ends in a random number of empty slots; an empty slot
    carries id 0 for lookups and is not admitted, as the engine feeds it.
    """
    n, k = tok["tok"].shape
    ids = np.stack([np.sort(rng.choice(vocab, size=k, replace=False)) for _ in range(n)])
    holes = np.arange(k)[None, :] >= rng.randint(1, k + 1, size=(n, 1))
    holes[0] = False  # one full chunk
    out = dict(tok)
    out["tok"] = np.where(holes, 0, ids).astype(np.int32)
    out["admit"] = (~holes).astype(np.int32)
    return out


def torch_planes(planes):
    return {
        name: torch.as_tensor(arr.astype(np.int64) if arr.dtype == np.uint32 else arr)
        for name, arr in planes.items()
    }


def word_logits(seed, t):
    """Noisy peaked logits over the 8-label bugs/bunny alphabet (a word-like path)."""
    rng = np.random.RandomState(seed)
    path = rng.choice([1, 2, 3, 4, 5, 6, 0, 7, 7], size=t)
    mat = rng.randn(t, 8).astype(np.float32) * 1.3
    mat[np.arange(t), path] += 3.0
    return mat


def state_contexts(state):
    """An LM state as plain data: None, a context tuple, or a list of them (a MultiLMState)."""
    if state is None:
        return None
    if hasattr(state, "states"):
        return [state_contexts(member) for member in state.states]
    return state.context


def assert_same_beams(want, got, tol=SCORE_TOL):
    """Two ranked OutputBeam lists: texts, frames, LM states identical; scores within ``tol``."""
    assert len(got) == len(want)
    assert len(want) > 0
    for wb, gb in zip(want, got):
        assert gb.text == wb.text
        assert gb.text_frames == wb.text_frames
        assert type(gb.last_lm_state).__name__ == type(wb.last_lm_state).__name__
        assert state_contexts(gb.last_lm_state) == state_contexts(wb.last_lm_state)
        assert abs(gb.logit_score - wb.logit_score) <= tol
        assert abs(gb.lm_score - wb.lm_score) <= tol


# ---- BPE and multi-character labels
# The JAX package's own BPE alphabet (its engine tests), right-bounded unknown piece included.
BPE_LABELS = ["▁bug", "▁bun", "ny", "s", "g", "un", "▁⁇▁", ""]
LM_WORDS = UNIGRAMS + ["guns"]  # every word of ARPA


def piece_vocabulary(words, extra_letters="aeot"):
    """A ``▁``-style piece vocabulary grown from ``words`` (raw labels, blank last).

    ``<unk>`` (the alphabet makes it ``▁⁇▁``) and ``▁``; every letter of
    ``words`` and of ``extra_letters``, bare and ``▁``-prefixed; and every
    2-4-letter substring of ``words``, ``▁``-prefixed where it starts a word.
    For the ARPA words: 47 pieces, the longest ``▁`` + 4 letters.
    """
    letters = sorted(set("".join(words)) | set(extra_letters))
    multi = set()
    for w in words:
        for n in range(2, 5):
            for i in range(len(w) - n + 1):
                multi.add(("▁" if i == 0 else "") + w[i : i + n])
    return ["<unk>", "▁"] + letters + ["▁" + c for c in letters] + sorted(multi) + [""]


def split_word(word, labels, prefixed=True):
    """Greedy longest-match pieces of ``word``; the first ``▁``-prefixed unless ``prefixed`` is False."""
    ids, i = [], 0
    while i < len(word):
        for n in range(min(4, len(word) - i), 0, -1):
            piece = ("▁" if i == 0 and prefixed else "") + word[i : i + n]
            if piece in labels:
                ids.append(labels.index(piece))
                i += n
                break
        else:
            raise ValueError(f"{word!r} cannot be split into pieces of {labels}")
    return ids


def piece_logits(seed, labels, n_words, forced_break=True):
    """Noisy peaked logits over a piece alphabet: words of ARPA split into pieces.

    Each piece holds 1-2 frames, a blank 0-1 frames after it. With
    ``forced_break`` the middle word follows ``▁⁇▁`` and starts with a plain
    (not ``▁``-prefixed) piece, so only the unknown piece's right bound
    breaks the word there. ``labels`` are normalized (``▁⁇▁``, blank ``""``).
    """
    rng = np.random.RandomState(seed)
    blank, unk = labels.index(""), labels.index("▁⁇▁")
    path = []
    for j in range(n_words):
        word = LM_WORDS[rng.randint(len(LM_WORDS))]
        forced = forced_break and j == n_words // 2
        pieces = ([unk] if forced else []) + split_word(word, labels, prefixed=not forced)
        for p in pieces:
            path += [p] * rng.randint(1, 3) + [blank] * rng.randint(0, 2)
    mat = rng.randn(len(path), len(labels)).astype(np.float32) * 1.3
    mat[np.arange(len(path)), path] += 3.0
    return mat


def conformer_width(pieces):
    """129 columns, as a Conformer-CTC's 128 pieces + blank: ``pieces`` after 81 filler
    pieces (seeded), so the pieces the logits spell, and the blank, have ids above 120."""
    rng = np.random.RandomState(9)
    fill = []
    while len(fill) < 81:
        piece = ("▁" if rng.rand() < 0.5 else "") + "".join(rng.choice(list("acdefhijklmopqrtvwxz"), 2))
        if piece not in fill:
            fill.append(piece)
    return pieces[:2] + fill + pieces[2:]


def one_hot(labels, pieces):
    """A one-hot logit matrix spelling ``pieces`` (normalized labels), one frame each."""
    mat = np.zeros((len(pieces), len(labels)), dtype=np.float32)
    for i, piece in enumerate(pieces):
        mat[i, labels.index(piece)] = 1.0
    return mat


# ---- streaming
def stream_planes(beam_state):
    """A stream's carried beam state as numpy ``[1, B, ...]`` planes.

    The port keeps ``[1, B]`` torch planes; the JAX package keeps one
    utterance's ``[B]`` arrays, which get the batch axis here.
    """
    return {
        key: val.cpu().numpy() if isinstance(val, torch.Tensor) else np.asarray(val)[None]
        for key, val in beam_state.items()
    }


def assert_same_stream_state(want, got, tol=SCORE_TOL):
    """Two carried beam states: the same planes and live slots; at live slots,
    integer planes (hash lanes, masked to 32 bits) equal and float planes within ``tol``."""
    want, got = stream_planes(want), stream_planes(got)
    assert set(got) == set(want)
    live = want["logit"] > -1e29
    np.testing.assert_array_equal(got["logit"] > -1e29, live)
    assert live.any()
    for key, w in want.items():
        g = got[key]
        assert g.shape == w.shape, key
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g[live], w[live], atol=tol, rtol=0, err_msg=key)
        else:
            lanes = [x[live].astype(np.int64) & 0xFFFFFFFF for x in (g, w)]
            np.testing.assert_array_equal(lanes[0], lanes[1], err_msg=key)


def assert_same_views(want, got, tol=SCORE_TOL):
    """Two ranked streaming views (``LMBeam`` lists): words, partial words, spans and
    last labels identical; scores within ``tol``."""
    assert len(got) == len(want)
    assert len(want) > 0
    for wb, gb in zip(want, got):
        assert gb.text == wb.text
        assert gb.partial_word == wb.partial_word
        assert gb.text_frames == wb.text_frames
        assert gb.partial_frames == wb.partial_frames
        assert gb.last_char == wb.last_char
        assert abs(gb.logit_score - wb.logit_score) <= tol
        assert abs(gb.lm_score - wb.lm_score) <= tol


def kenlm64_fp_tables(ngrams, order):
    """Orders 2 .. ``order`` of ``ngrams`` (``NGramTables.ngrams``) as tables keyed by KenLM's 64-bit
    chain (``kenlm64``), the layout a KenLM binary's tables take."""
    from pyctcdecode_torch.models.device_tables import build_fp_table_from_hashes
    from pyctcdecode_torch.ops.hashing import kenlm_chain_host

    tables = []
    for n in range(2, order + 1):
        grams = ngrams[n - 1]
        keys = np.array(list(grams), dtype=np.int64)
        probs = np.array([v[0] for v in grams.values()], dtype=np.float32)
        backoffs = np.array([v[1] for v in grams.values()], dtype=np.float32)
        tables.append(build_fp_table_from_hashes(kenlm_chain_host(keys), probs, backoffs, n))
    return tables



# ---- fixtures a test module imports by name
@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The torch engine on the CPU is hundreds of tiny ops a step: beside the suite's other workers, a
    thread pool a process makes each op wait on busy cores (about 20x slower), so a module's tests run
    on one thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


JAX_NATIVE_SOURCE = Path(__file__).resolve().parents[1] / "pyctcdecode_tpu" / "csrc" / "ctclm.cpp"


@functools.lru_cache(maxsize=None)
def jax_native_library():
    """The JAX package's ``ctclm.cpp`` built with its package's flags into a library of its own, loaded once a process.

    The JAX package's build writes its library in place, so a test worker
    may load it half-written while another writes it, and its loader then
    gives up for the rest of the process. This copy compiles to a temporary
    file that is renamed to ``build/libctclm-jax-<hash>.so`` (the hash of
    the source): a worker loads a whole file or builds its own. ``None``
    where ``g++`` is missing or fails.
    """
    from pyctcdecode_torch.csrc.build import BUILD_DIR

    digest = hashlib.sha256(JAX_NATIVE_SOURCE.read_bytes()).hexdigest()[:16]
    lib = BUILD_DIR / f"libctclm-jax-{digest}.so"
    if not lib.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            subprocess.run(["g++", "-O3", "-march=native", "-std=c++17", "-shared", "-fPIC", "-o", tmp,
                            str(JAX_NATIVE_SOURCE)], check=True, capture_output=True)
        except (OSError, subprocess.CalledProcessError):
            os.unlink(tmp)
            return None
        os.replace(tmp, lib)
    return ctypes.CDLL(str(lib))


@pytest.fixture(scope="module", autouse=True)
def jax_native():
    """The JAX package's native ARPA reader on :func:`jax_native_library` for the module's tests.

    Handed to the package through its own ``_bind``; its state is put back
    after the module. Where the library does not build, the package's own
    loader runs as it would without this fixture.
    """
    lib = jax_native_library()
    if lib is None:
        yield None
        return
    from pyctcdecode_tpu import csrc

    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(csrc, "_LIB", csrc._bind(lib))
        patch.setattr(csrc, "_LIB_FAILED", False)
        yield lib
