"""``probe_rows``: every order's bucket probe at once, against the per-order probes.

The plain ``probe_rows`` (what the wrapper runs on CPU tensors, and what the
CUDA kernel is held against on the card) must give, bit for bit, what the
port's per-order ``probe_fp`` loop gives and what the JAX package's
``probe_fp_jnp`` gives on the same tables and queries; ``lm_score_words``,
which now probes through it, must equal ``lm_score_words_jnp``. The LM is an
inline ARPA 3-gram; a second pair of tables is built dense enough to fill both
sub-blocks of a bucket row.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyctcdecode_torch.alphabet import Alphabet as TAlphabet
from pyctcdecode_torch.models import device_tables as tdt
from pyctcdecode_torch.models.language_model import LanguageModel as TLanguageModel
from pyctcdecode_torch.models.ngram import open_ngram_file
from pyctcdecode_torch.ops import gather as tg
from pyctcdecode_torch.ops.tokens import build_token_arrays as t_tokens
from pyctcdecode_tpu.alphabet import Alphabet as JAlphabet
from pyctcdecode_tpu.models import device_tables as jdt
from pyctcdecode_tpu.models.language_model import LanguageModel as JLanguageModel
from pyctcdecode_tpu.models.ngram import NGramModel as JNGramModel
from pyctcdecode_tpu.ops.tokens import build_token_arrays as j_tokens

from .helpers import SAMPLE_LABELS
from .torch_cases import ARPA, UNIGRAMS
from .torch_cases import one_torch_thread  # noqa: F401  (autouse fixture)

GEOMETRY = (tdt._BUCKET_SLOTS, tdt._SUB_WIDTH)
EMPTY = 0xFFFFFFFF


@pytest.fixture(scope="module")
def lms(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("lm") / "bb3.arpa")
    with open(path, "w") as fh:
        fh.write(ARPA)
    jlm = JLanguageModel(JNGramModel.from_file(path), UNIGRAMS)
    tlm = TLanguageModel(open_ngram_file(path, backend="python"), UNIGRAMS)
    jdlm = jdt.build_device_lm(jlm, j_tokens(JAlphabet.build_alphabet(SAMPLE_LABELS)))
    tdlm = tdt.build_device_lm(tlm, t_tokens(TAlphabet.build_alphabet(SAMPLE_LABELS)))
    return jdlm, tdlm, tlm.ngram_model.tables


def _jax_tables(jdlm):
    return [dict(tab, hash_mode="fnv") for tab in jdlm.as_device()["fp"]]


def _queries(tables_py, kind):
    """``(full [Q, 3], ctx_len [Q])`` id planes for one kind of probe traffic."""
    vocab = len(tables_py.vocab)
    rng = np.random.RandomState(len(kind))
    if kind == "hits at every order":
        grams = [k for k in tables_py.ngrams[2]]  # present trigrams; their tails may be bigrams
        grams += [(-1,) + k for k in tables_py.ngrams[1]]  # present bigrams under a pad
        full = np.array(grams, dtype=np.int64)
        ctx_len = np.where(full[:, 0] >= 0, 2, 1)
    elif kind == "misses":
        full = rng.randint(0, vocab, size=(64, 3)).astype(np.int64)
        present = set(tables_py.ngrams[2]) | {(-2,) + k for k in tables_py.ngrams[1]}
        keep = [tuple(r) not in present and tuple(r[1:]) not in tables_py.ngrams[1] for r in full]
        full = full[np.array(keep)]
        ctx_len = np.full(len(full), 2)
    elif kind == "every context length":
        grams = np.array(list(tables_py.ngrams[2]), dtype=np.int64)
        full = np.repeat(grams, 3, axis=0)
        ctx_len = np.tile(np.arange(3), len(grams))  # 0: neither order valid, 1: bigram, 2: both
    else:  # padded contexts: -1 in the leading columns, as short histories carry
        full = rng.randint(0, vocab, size=(40, 3)).astype(np.int64)
        ctx_len = rng.randint(0, 3, size=40)
        for row, n in zip(full, ctx_len):
            row[: 2 - n] = -1
    return full, ctx_len.astype(np.int64)


def _assert_probe_equal(got, want):
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def _three_ways(tdev_fp, jtabs, full, ctx_len):
    """probe_rows, the probe_fp loop and the JAX probes, each as ``(found, prob, backoff)`` [T, Q]."""
    order = full.shape[-1]
    tfull, tlen = torch.as_tensor(full), torch.as_tensor(ctx_len)
    before = tg.probe_rows.launches
    got = tg.probe_rows(tfull, tlen, tdev_fp, *GEOMETRY)
    assert tg.probe_rows.launches == before  # the CPU route launches nothing
    loop, jax_side = [], []
    for t, (ttab, jtab) in enumerate(zip(tdev_fp, jtabs)):
        n = t + 2
        valid = ctx_len + 1 >= n
        loop.append(tdt.probe_fp(ttab, tfull[..., order - n :], torch.as_tensor(valid)))
        jax_side.append(jdt.probe_fp_jnp(
            jtab, jnp.asarray(full.reshape(-1, order)[:, order - n :].astype(np.int32)),
            jnp.asarray(valid.reshape(-1)),
        ))
    loop = [torch.stack(x).numpy() for x in zip(*loop)]
    jax_side = [np.stack([np.asarray(x).reshape(ctx_len.shape) for x in plane]) for plane in zip(*jax_side)]
    return [g.numpy() for g in got], loop, jax_side


@pytest.mark.parametrize(
    "kind", ["hits at every order", "misses", "every context length", "padded contexts"]
)
def test_probe_rows_matches_probe_fp_loop_and_jax(lms, kind):
    jdlm, tdlm, tables_py = lms
    full, ctx_len = _queries(tables_py, kind)
    assert len(full) > 0
    got, loop, jax_side = _three_ways(tdlm.as_device("cpu")["fp"], _jax_tables(jdlm), full, ctx_len)
    assert got[0].dtype == np.bool_ and got[0].shape == (2, len(full))
    _assert_probe_equal(got, loop)
    _assert_probe_equal(got, jax_side)
    found = got[0]
    if kind == "hits at every order":
        tri = full[:, 0] >= 0
        assert found[1][tri].all() and not found[1][~tri].any()  # a padded key is no trigram
        assert found[0][~tri].all()
        assert (got[1][0][~tri] != 0).all()  # found bigrams carry their log-prob
    elif kind == "misses":
        assert not found.any()
        assert not got[1].any() and not got[2].any()
    elif kind == "every context length":
        assert not found[:, ctx_len == 0].any()
        assert not found[1][ctx_len == 1].any()
        assert found[1][ctx_len == 2].all()


def test_probe_rows_keeps_the_leading_shape(lms):
    jdlm, tdlm, tables_py = lms
    full, ctx_len = _queries(tables_py, "every context length")
    full, ctx_len = full[:12].reshape(3, 4, 3), ctx_len[:12].reshape(3, 4)
    got, loop, jax_side = _three_ways(tdlm.as_device("cpu")["fp"], _jax_tables(jdlm), full, ctx_len)
    assert got[0].shape == (2, 3, 4)
    _assert_probe_equal(got, loop)
    _assert_probe_equal(got, jax_side)


def test_probe_rows_reads_both_sub_blocks_and_skips_empty_ones():
    """Buckets filled past 16 residents use the second sub-block; sparse ones leave it empty."""
    rng = np.random.RandomState(1)
    ttabs, jtabs, keys_by_order = [], [], []
    for n, count in ((2, 190), (3, 20)):
        keys = np.unique(rng.randint(0, 1000, size=(count, n)).astype(np.int32), axis=0)
        probs = -rng.rand(len(keys)).astype(np.float32) - 0.1
        backoffs = -rng.rand(len(keys)).astype(np.float32)
        ttab, jtab = tdt.build_fp_table(keys, probs, backoffs), jdt.build_fp_table(keys, probs, backoffs)
        np.testing.assert_array_equal(ttab.bucket, jtab.bucket)
        ttabs.append({"bucket": torch.as_tensor(np.ascontiguousarray(ttab.bucket)).to(torch.int32),
                      "size": ttab.size, "seed_lo": ttab.seed_lo, "seed_hi": ttab.seed_hi})
        jtabs.append({"bucket": jnp.asarray(jtab.bucket), "size": jtab.size, "hash_mode": "fnv",
                      "seed_lo": jnp.uint32(jtab.seed_lo), "seed_hi": jnp.uint32(jtab.seed_hi)})
        keys_by_order.append((keys, probs, backoffs))
    lo_second = np.asarray(ttabs[0]["bucket"])[:, tdt._SUB_WIDTH : tdt._SUB_WIDTH + tdt._BUCKET_SLOTS]
    assert (lo_second.view(np.uint32) != EMPTY).any()  # the dense table spills into sub-block 1
    lo_second = np.asarray(ttabs[1]["bucket"])[:, tdt._SUB_WIDTH : tdt._SUB_WIDTH + tdt._BUCKET_SLOTS]
    assert (lo_second.view(np.uint32) == EMPTY).all()  # the sparse one never does

    bi, bi_p, bi_b = keys_by_order[0]
    full = np.concatenate([np.full((len(bi), 1), 7), bi], axis=1).astype(np.int64)  # every bigram
    tri = keys_by_order[1][0].astype(np.int64)
    full = np.concatenate([full, tri, rng.randint(1000, 2000, size=(30, 3))], axis=0)  # + trigrams + misses
    ctx_len = np.full(len(full), 2, dtype=np.int64)
    got, loop, jax_side = _three_ways(ttabs, jtabs, full, ctx_len)
    _assert_probe_equal(got, loop)
    _assert_probe_equal(got, jax_side)
    assert got[0][0][: len(bi)].all()
    np.testing.assert_array_equal(got[1][0][: len(bi)], bi_p)
    np.testing.assert_array_equal(got[2][0][: len(bi)], bi_b)
    assert got[0][1][len(bi) : len(bi) + len(tri)].all()
    assert not got[0][:, -30:].any()


def test_lm_score_words_through_probe_rows_matches_jax(lms):
    """The scorer probes through ``probe_rows`` (once a call) and equals the JAX scorer."""
    jdlm, tdlm, tables_py = lms
    full, ctx_len = (np.concatenate(parts) for parts in zip(
        *(_queries(tables_py, kind) for kind in
          ("hits at every order", "misses", "every context length", "padded contexts"))
    ))
    width = tdlm.order - 1
    ctx = full[:, :width].copy()
    for row, n in zip(ctx, ctx_len):
        row[: width - n] = -1  # a context holds exactly ctx_len ids
    wid = full[:, -1]
    bo = np.stack([tdt.context_suffix_backoffs(tdlm, ctx[i, width - ctx_len[i]:]) for i in range(len(ctx))])
    jdev = dict(jdlm.as_device())
    jdev["fp"] = _jax_tables(jdlm)
    want = jdt.lm_score_words_jnp(
        jdev, jdlm.order, np.float32(jdlm.unk_prob10), jnp.asarray(ctx.astype(np.int32)),
        jnp.asarray(ctx_len.astype(np.int32)), jnp.asarray(wid.astype(np.int32)), jnp.asarray(bo),
    )
    calls = []
    real = tdt.probe_rows

    def counted(*args):
        calls.append(args[0].shape)
        return real(*args)

    tdt.probe_rows = counted
    try:
        got = tdt.lm_score_words(
            tdlm.as_device("cpu"), torch.as_tensor(ctx), torch.as_tensor(ctx_len),
            torch.as_tensor(wid), torch.as_tensor(bo),
        )
    finally:
        tdt.probe_rows = real
    assert calls == [(len(ctx), tdlm.order)]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w).astype(g.numpy().dtype))


def test_probe_rows_rejects_what_the_kernel_does_not_take(lms):
    _, tdlm, _ = lms
    fp = tdlm.as_device("cpu")["fp"]
    full = torch.zeros((4, 3), dtype=torch.int64)
    ctx_len = torch.zeros(4, dtype=torch.int64)
    with pytest.raises(TypeError, match="full"):
        tg.probe_rows(full.to(torch.int32), ctx_len, fp, *GEOMETRY)
    with pytest.raises(TypeError, match="ctx_len"):
        tg.probe_rows(full, ctx_len.to(torch.int32), fp, *GEOMETRY)
    with pytest.raises(ValueError, match="ctx_len"):
        tg.probe_rows(full, ctx_len[:3], fp, *GEOMETRY)
    with pytest.raises(ValueError, match="tables"):
        tg.probe_rows(full, ctx_len, fp[:1], *GEOMETRY)
    with pytest.raises(ValueError, match="contiguous"):
        tg.probe_rows(torch.zeros((4, 6), dtype=torch.int64)[:, ::2], ctx_len, fp, *GEOMETRY)
    with pytest.raises(ValueError, match="sub-blocks"):
        tg.probe_rows(full, ctx_len, fp, 8, 64)
    meta = torch.device("meta")  # a device that is neither the CPU nor CUDA: refuse, do not fall back
    meta_fp = [dict(tab, bucket=tab["bucket"].to(meta)) for tab in fp]
    with pytest.raises(ValueError, match="CUDA tensors"):
        tg.probe_rows(full.to(meta), ctx_len.to(meta), meta_fp, *GEOMETRY)
