"""``gather_rows``: the port's row gather against the JAX package's row reads.

The Pallas gather this replaces cannot be imported as a function: its kernel
is defined inside ``main()`` of ``scripts/pallas_gather_probe.py`` and needs
TPU memory spaces. That script checks its kernel against the XLA gather
``tab[idx]``; so does this file, and against numpy ``tab[idx]`` and the JAX
package's ``trie_fetch_rows`` / ``probe_fp_jnp`` on the same tables and
indices, with and without the slot select (a node's own words out of a row
that packs several nodes). Everything is integer data: results must be
bit-equal.

Here, without a GPU, the wrapper runs its plain version; the CUDA kernel is
held against the same plain version on the card
(``test_torch_kernels_cuda.py`` and ``chip_smoke.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyctcdecode_torch.models import device_tables as tdt
from pyctcdecode_torch.ops import gather as tg
from pyctcdecode_tpu.models import device_tables as jdt

from .test_torch_device_tables import tables  # noqa: F401  (module-scoped LM fixture)
from .torch_cases import one_torch_thread  # noqa: F401  (autouse fixture)


def _table(rng, rows, width):
    return rng.randint(-(1 << 31), 1 << 31, size=(rows, width)).astype(np.int32)


@pytest.mark.parametrize(
    "rows,width,idx_shape,repeats",
    [
        (2048, 64, (1200,), False),  # the trie plane's row width
        (512, 128, (300,), False),  # the bucket plane's row width
        (64, 4, (1,), False),  # one query, the narrowest legal row
        (300, 64, (4, 100), True),  # [utterances, beams], beams bunched on few rows
        (100, 8, (3, 5, 7), True),
    ],
)
def test_gather_rows_matches_numpy_and_xla(rows, width, idx_shape, repeats):
    rng = np.random.RandomState(rows + width)
    tab = _table(rng, rows, width)
    idx = rng.randint(0, rows, size=idx_shape).astype(np.int64)
    if repeats:
        idx.reshape(-1)[: idx.size * 3 // 4] = rng.randint(0, 3, size=idx.size * 3 // 4)
    before = tg.gather_rows.launches
    got = tg.gather_rows(torch.as_tensor(tab), torch.as_tensor(idx))
    assert tg.gather_rows.launches == before  # the CPU route launches nothing
    assert got.dtype == torch.int32 and tuple(got.shape) == (*idx_shape, width)
    np.testing.assert_array_equal(got.numpy(), tab[idx])
    np.testing.assert_array_equal(got.numpy(), np.asarray(jnp.asarray(tab)[jnp.asarray(idx)]))


def test_gather_rows_matches_jax_trie_row_reads(tables):  # noqa: F811
    """Whole plane rows (pack = 1 geometry) and the real packed plane's node slots."""
    rng = np.random.RandomState(3)
    tab = _table(rng, 500, 64)
    idx = rng.randint(0, 500, size=(6, 17))
    whole = {"pack": 1, "stride": 64, "width": 64}
    want = jdt.trie_fetch_rows(jnp, jnp.asarray(tab), whole, jnp.asarray(idx.astype(np.int32)))
    got = tg.gather_rows(torch.as_tensor(tab), torch.as_tensor(idx.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    jdlm, tdlm, _ = tables
    tp = tdlm.trie_pack
    plane = torch.as_tensor(tdlm.trie_plane())
    assert plane.shape[1] == tp["pack"] * tp["stride"]
    nodes = rng.randint(0, tdlm.trie.n_nodes, size=(5, 40))
    nodes[:, :30] = nodes[:, :1]  # the beams of an utterance share few nodes
    rows = tg.gather_rows(plane, torch.as_tensor(nodes // tp["pack"]))
    slots = rows.reshape(5, 40, tp["pack"], tp["stride"]).numpy()
    ii, jj = np.meshgrid(np.arange(5), np.arange(40), indexing="ij")
    got = slots[ii, jj, nodes % tp["pack"], : tp["width"]]
    want = jdt.trie_fetch_rows(
        jnp, jdlm.as_device()["trie_rows"], jdlm.trie_pack, jnp.asarray(nodes.astype(np.int32))
    )
    np.testing.assert_array_equal(got, np.asarray(want))


def test_probes_take_their_rows_through_gather_rows(tables, monkeypatch):  # noqa: F811
    """``probe_fp`` and ``trie_fetch_rows`` read rows only via ``gather_rows``, in range."""
    jdlm, tdlm, present = tables
    calls = []

    def counted(table, idx, slot=None, stride=None, width=None):
        assert int(idx.min()) >= 0 and int(idx.max()) < table.shape[0]
        if slot is not None:
            assert int(slot.min()) >= 0 and (int(slot.max()) + 1) * stride <= table.shape[1]
        calls.append((tuple(table.shape), tuple(idx.shape)))
        return tg.gather_rows(table, idx, slot, stride, width)

    monkeypatch.setattr(tdt, "gather_rows", counted)
    tdev = tdlm.as_device("cpu")
    jdev = jdlm.as_device()
    rng = np.random.RandomState(4)
    for order_idx, table in enumerate(tdlm.fp_tables):
        keys = present[table.n - 1][rng.permutation(len(present[table.n - 1]))[:64]].reshape(4, 16, -1)
        valid = np.ones((4, 16), dtype=bool)
        got = tdt.probe_fp(tdev["fp"][order_idx], torch.as_tensor(keys), torch.as_tensor(valid))
        want = jdt.probe_fp_jnp(  # one query axis on the JAX side
            dict(jdev["fp"][order_idx], hash_mode="fnv"),
            jnp.asarray(keys.reshape(64, -1)), jnp.asarray(valid.reshape(64)),
        )
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy().reshape(64), np.asarray(w))
        assert bool(got[0].all())  # present n-grams are found
        assert calls[-1] == (tuple(tdev["fp"][order_idx]["bucket"].shape), (4, 16))
    nodes = torch.as_tensor(rng.randint(0, tdlm.trie.n_nodes, size=(4, 16)))
    tdt.trie_fetch_rows(tdev["trie_rows"], tdev["trie_pack"], nodes)
    assert calls[-1] == (tuple(tdev["trie_rows"].shape), (4, 16))
    assert len(calls) == len(tdlm.fp_tables) + 1


@pytest.mark.parametrize(
    "rows,n_chars,lead",
    [
        (300, 28, (4, 25)),  # the char alphabet's geometry: 4 nodes of 16 words a row, 13 read
        (300, 60, (7,)),  # 2 nodes a row
        (200, 200, (3, 5)),  # a node fills its row: pack 1, the width cut alone
        (64, 3, (2, 3, 4)),  # 8 narrow nodes a row
    ],
)
def test_slot_select_matches_jax_trie_fetch_rows(rows, n_chars, lead):
    """``gather_rows`` with a slot: a node's own words out of a multi-node row, bit-equal."""
    tp = jdt.trie_pack_params(n_chars)
    assert tp == tdt.trie_pack_params(n_chars)
    pack, stride, width = tp["pack"], tp["stride"], tp["width"]
    rng = np.random.RandomState(rows + n_chars)
    plane = _table(rng, rows, pack * stride)
    nodes = rng.randint(0, rows * pack, size=lead)
    nodes.reshape(-1)[: nodes.size // 2] = nodes.reshape(-1)[0]  # beams bunch on few nodes
    want = np.asarray(jdt.trie_fetch_rows(jnp, jnp.asarray(plane), tp, jnp.asarray(nodes.astype(np.int32))))
    tplane, tnodes = torch.as_tensor(plane), torch.as_tensor(nodes.astype(np.int64))
    before = tg.gather_rows.launches
    got = tg.gather_rows(tplane, tnodes // pack, tnodes % pack, stride, width)
    assert tg.gather_rows.launches == before
    assert got.dtype == torch.int32 and tuple(got.shape) == (*lead, width)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tdt.trie_fetch_rows(tplane, tp, tnodes).numpy(), want)
    if pack == 1:
        cut = tg.gather_rows(tplane, tnodes, None, stride, width)
        np.testing.assert_array_equal(cut.numpy(), want)


@pytest.mark.parametrize(
    "slot,stride,width,error,match",
    [
        (torch.zeros(3, dtype=torch.int32), 4, 4, TypeError, "slot"),
        (torch.zeros(4, dtype=torch.int64), 4, 4, ValueError, "slot"),
        (torch.zeros(3, dtype=torch.int64), 4, 5, ValueError, "width"),
        (torch.zeros(3, dtype=torch.int64), 16, 4, ValueError, "stride"),
        (None, None, 0, ValueError, "width"),
    ],
)
def test_slot_select_rejects_bad_geometry(slot, stride, width, error, match):
    table = torch.zeros((8, 8), dtype=torch.int32)
    with pytest.raises(error, match=match):
        tg.gather_rows(table, torch.zeros(3, dtype=torch.int64), slot, stride, width)


@pytest.mark.parametrize(
    "table,idx,error,match",
    [
        (torch.zeros((8, 6), dtype=torch.int32), torch.zeros(3, dtype=torch.int64), ValueError, "16 bytes"),
        (torch.zeros((8, 0), dtype=torch.int32), torch.zeros(3, dtype=torch.int64), ValueError, "16 bytes"),
        (torch.zeros((8, 8), dtype=torch.int64), torch.zeros(3, dtype=torch.int64), TypeError, "table"),
        (torch.zeros((8, 8), dtype=torch.float32), torch.zeros(3, dtype=torch.int64), TypeError, "table"),
        (torch.zeros((8, 8), dtype=torch.int32), torch.zeros(3, dtype=torch.int32), TypeError, "idx"),
        (torch.zeros(64, dtype=torch.int32), torch.zeros(3, dtype=torch.int64), ValueError, "rows, width"),
        (torch.zeros((8, 16), dtype=torch.int32)[:, ::2], torch.zeros(3, dtype=torch.int64), ValueError, "contiguous"),
        (torch.zeros((8, 8), dtype=torch.int32), torch.zeros((3, 4), dtype=torch.int64)[:, ::2], ValueError, "contiguous"),
        (torch.zeros((8, 8), dtype=torch.int32), [0, 1], TypeError, "idx"),
    ],
)
def test_gather_rows_rejects_what_the_kernel_does_not_take(table, idx, error, match):
    with pytest.raises(error, match=match):
        tg.gather_rows(table, idx)


def test_empty_index_gives_empty_rows():
    out = tg.gather_rows(torch.zeros((8, 8), dtype=torch.int32), torch.zeros((0, 5), dtype=torch.int64))
    assert tuple(out.shape) == (0, 5, 8)
