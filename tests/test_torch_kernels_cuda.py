"""The port on the card: CUDA kernels vs plain versions, GPU decode vs CPU decode.

Every test here needs an NVIDIA GPU and skips without one. The module
imports neither JAX nor the JAX package, so on the GPU machine it runs
without the suite's JAX configuration:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py
"""
import numpy as np
import pytest
import torch

import pyctcdecode_torch as P
from pyctcdecode_torch import engine
from pyctcdecode_torch.models import device_tables as tdt
from pyctcdecode_torch.models.ngram import open_ngram_file
from pyctcdecode_torch.ops import backtrace as tb
from pyctcdecode_torch.ops import commit as tc
from pyctcdecode_torch.ops import gather as tg
from pyctcdecode_torch.ops import merge as tm
from pyctcdecode_torch.ops import replay as tr
from pyctcdecode_torch.ops import walk as tw

from .helpers import SAMPLE_LABELS
from .torch_cases import (
    ARPA,
    ARPA_2GRAM,
    DEAD,
    LM_WORDS,
    UNIGRAMS,
    assert_outputs,
    assert_same_beams,
    chunk_token_planes,
    conformer_width,
    expand_inputs,
    kenlm64_fp_tables,
    merge_inputs,
    piece_logits,
    piece_vocabulary,
    torch_merge_args,
    torch_planes,
    word_logits,
)
from .w2v2_cases import random_logits as w2v2_logits
from .walk_cases import CASES as WALK_CASES
from .walk_cases import HOT_WEIGHT, HOTWORDS, walk_decoder, walk_inputs


def assert_same_batch(want, got):
    assert len(got) == len(want)
    for wb, gb in zip(want, got):
        assert_same_beams(wb, gb)


def _cuda() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_kernels_match_plain_versions():
    """Each kernel against its plain version on the same card inputs."""
    dev = _cuda()
    kl, kh, valid, logit, extra, prune = merge_inputs(np.random.RandomState(6), 4, 7, 100)
    args = [a.to(dev) for a in torch_merge_args(kl, kh, valid, logit, extra, prune)]
    got = tm.merge_prune(*args)
    torch.cuda.synchronize()
    assert_outputs([g.cpu() for g in got], [w.cpu() for w in tm.merge_prune_ref(*args)])
    # (lmax, is_bpe, seed, [N, K], cluster sizes); the last is wav2vec2's 32-label char step, whose
    # "</s>" makes lmax 4, at the picked cluster size and at every forced one
    for lmax, is_bpe, seed, (n, k), clusters in ((1, False, 7, (4, 9), (0,)), (3, True, 7, (4, 9), (0,)),
                                                 (4, False, 404, (32, 32), (0, 1, 2, 4, 8))):
        beam, tok, cids, pscore, prune = expand_inputs(np.random.RandomState(seed), n, k, 100, lmax)
        eargs = (
            {key: val.to(dev) for key, val in torch_planes(beam).items()},
            {key: val.to(dev) for key, val in torch_planes(tok).items()},
            torch.as_tensor(cids).to(dev), torch.as_tensor(pscore).to(dev),
            torch.as_tensor(prune).to(dev), is_bpe,
        )
        want = [w.cpu() for w in tm.expand_merge_prune_ref(*eargs)]
        for cluster in clusters:
            got = tm.expand_merge_prune(*eargs, cluster=cluster)
            torch.cuda.synchronize()
            assert_outputs([g.cpu() for g in got], want)


def _on(dev, args):
    return [a.to(dev) for a in args]


@pytest.mark.cuda
@pytest.mark.parametrize(
    "n,k,b,window",
    [(3, 1, 100, False), (3, 1, 100, True), (3, 5, 100, False), (2, 29, 100, True),
     (2, 3, 40, True), (2, 6, 37, True), (2, 2, 260, True), (2, 29, 1024, True),
     (1, 9, 1024, False), (1, 64, 1024, True)],
)
def test_cuda_kernels_at_shapes_the_column_layout_makes_risky(n, k, b, window):
    """K = 1, K below and off the cluster size, ragged and wide beams, a dead utterance.

    Both kernels, at the cluster size picked from K and at every forced one
    (1 block an utterance up to 8): all must agree with the plain version.
    At [1, 64, 1024] with one or two blocks an utterance the score stash no
    longer fits in shared memory and lives in the score output.
    """
    dev = _cuda()
    rng = np.random.RandomState(1000 * k + b)
    prune = np.full(n, -3.0 if window else -np.inf, dtype=np.float32)
    kl, kh, valid, logit, extra, _ = merge_inputs(rng, n, k, b)
    beam, tok, cids, pscore, _ = expand_inputs(rng, n, k, b, 1)
    if n > 1:
        valid[-1] = False
        logit[-1] = DEAD
        beam["logit"][-1] = DEAD
    live = n - 1 if n > 1 else n
    margs = _on(dev, torch_merge_args(kl, kh, valid, logit, extra, prune))
    eargs = (
        {key: val.to(dev) for key, val in torch_planes(beam).items()},
        {key: val.to(dev) for key, val in torch_planes(tok).items()},
        torch.as_tensor(cids).to(dev), torch.as_tensor(pscore).to(dev),
        torch.as_tensor(prune).to(dev), False,
    )
    m_want = [w.cpu() for w in tm.merge_prune_ref(*margs)]
    e_want = [w.cpu() for w in tm.expand_merge_prune_ref(*eargs)]
    for cluster in (0, 1, 2, 4, 8):
        for got, want in ((tm.merge_prune(*margs, cluster=cluster), m_want),
                          (tm.expand_merge_prune(*eargs, cluster=cluster), e_want)):
            torch.cuda.synchronize()
            got = [g.cpu() for g in got]
            assert not torch.isnan(got[0]).any()
            assert_outputs([g[:live] for g in got], [w[:live] for w in want])
            if n > 1:
                assert bool((got[0][-1] == DEAD).all())


@pytest.mark.cuda
def test_cuda_chunk_step_with_the_window_off():
    """Per-utterance chunk token planes with empty slots, ``prune = -inf``, a dead utterance."""
    dev = _cuda()
    rng = np.random.RandomState(8)
    beam, tok, cids, pscore, _ = expand_inputs(rng, 4, 5, 100, 1)
    tok = chunk_token_planes(rng, tok, 29)
    beam["logit"][-1] = DEAD
    eargs = (
        {key: val.to(dev) for key, val in torch_planes(beam).items()},
        {key: val.to(dev) for key, val in torch_planes(tok).items()},
        torch.as_tensor(cids).to(dev), torch.as_tensor(pscore).to(dev),
        torch.full((4,), float("-inf"), device=dev), False,
    )
    got = [g.cpu() for g in tm.expand_merge_prune(*eargs)]
    torch.cuda.synchronize()
    want = [w.cpu() for w in tm.expand_merge_prune_ref(*eargs)]
    assert not torch.isnan(got[0]).any()
    assert torch.equal(got[0] > -1e29, want[0] > -1e29)  # no window: the live sets are equal
    assert_outputs([g[:-1] for g in got], [w[:-1] for w in want])
    assert bool((got[0][-1] == DEAD).all())


@pytest.mark.cuda
@pytest.mark.parametrize(
    "rows,width,idx_shape",
    [(4096, 64, (1000,)), (512, 128, (7, 33)), (64, 4, (1,)), (1000, 24, (3, 5, 11))],
)
def test_gather_rows_kernel_matches_plain_version(rows, width, idx_shape):
    """The gather kernel is bit-exact, with repeated indices and ragged counts."""
    dev = _cuda()
    rng = np.random.RandomState(rows + width)
    table = torch.as_tensor(rng.randint(-(1 << 31), 1 << 31, (rows, width)).astype(np.int32)).to(dev)
    idx = rng.randint(0, rows, idx_shape)
    idx.reshape(-1)[: idx.size // 2] = idx.reshape(-1)[0]  # heavy repeats
    idx = torch.as_tensor(idx.astype(np.int64)).to(dev)
    before = tg.gather_rows.launches
    got = tg.gather_rows(table, idx)
    torch.cuda.synchronize()
    assert tg.gather_rows.launches == before + 1
    assert got.shape == (*idx_shape, width) and got.dtype == torch.int32
    assert torch.equal(got, tg.gather_rows_ref(table, idx))


@pytest.mark.cuda
@pytest.mark.parametrize(
    "rows,n_chars,lead", [(300, 28, (4, 25)), (300, 60, (7,)), (200, 200, (3, 5)), (64, 3, (2, 3, 4))]
)
def test_slot_select_kernel_matches_plain_version(rows, n_chars, lead):
    """A node's own words out of a multi-node row: vector and word paths, bit-exact."""
    dev = _cuda()
    tp = tdt.trie_pack_params(n_chars)
    pack, stride, width = tp["pack"], tp["stride"], tp["width"]
    rng = np.random.RandomState(rows + n_chars)
    plane = torch.as_tensor(
        rng.randint(-(1 << 31), 1 << 31, (rows, pack * stride)).astype(np.int32)).to(dev)
    nodes = rng.randint(0, rows * pack, size=lead)
    nodes.reshape(-1)[: nodes.size // 2] = nodes.reshape(-1)[0]
    nodes = torch.as_tensor(nodes.astype(np.int64)).to(dev)
    before = tg.gather_rows.launches
    got = tdt.trie_fetch_rows(plane, tp, nodes)
    torch.cuda.synchronize()
    assert tg.gather_rows.launches == before + 1
    assert got.shape == (*lead, width)
    want = tg.gather_rows_ref(plane, nodes // pack, nodes % pack, stride, width)
    assert torch.equal(got, want)
    assert torch.equal(got.cpu(), tdt.trie_fetch_rows(plane.cpu(), tp, nodes.cpu()))
    # slots of whole 16-byte vectors take the vector path
    wide = tg.gather_rows(plane, nodes // pack, nodes % pack, stride, stride)
    assert torch.equal(wide, tg.gather_rows_ref(plane, nodes // pack, nodes % pack, stride, stride))


def _probe_tables(dev, rng, counts, id_range):
    tabs, keys_by_order = [], []
    for n, count in enumerate(counts, start=2):
        keys = np.unique(rng.randint(0, id_range, size=(count, n)).astype(np.int32), axis=0)
        probs = -rng.rand(len(keys)).astype(np.float32) - 0.1
        backoffs = -rng.rand(len(keys)).astype(np.float32)
        tab = tdt.build_fp_table(keys, probs, backoffs)
        tabs.append({"bucket": torch.as_tensor(np.ascontiguousarray(tab.bucket)).to(torch.int32).to(dev),
                     "size": tab.size, "seed_lo": tab.seed_lo, "seed_hi": tab.seed_hi})
        keys_by_order.append(keys)
    return tabs, keys_by_order


@pytest.mark.cuda
@pytest.mark.parametrize("counts,lead", [((190, 20), (257,)), ((5000, 4000), (16, 100)), ((300, 200, 100, 50), (3, 41))])
def test_probe_rows_kernel_matches_plain_version(counts, lead):
    """Hits at every order (both sub-blocks), misses, every context length, -1 pads: bit-exact."""
    dev = _cuda()
    rng = np.random.RandomState(1)
    tabs, keys_by_order = _probe_tables(dev, rng, counts, 1000)
    order = len(counts) + 1
    q = int(np.prod(lead))
    full = rng.randint(0, 1100, size=(q, order)).astype(np.int64)
    for t, keys in enumerate(keys_by_order):  # a share of the queries ends in a present (t + 2)-gram
        rows = np.arange(t, q, 2 * len(counts))
        full[rows, order - (t + 2):] = keys[rng.randint(0, len(keys), size=len(rows))]
    ctx_len = rng.randint(0, order, size=q).astype(np.int64)
    ctx_len[: q // 2] = order - 1
    for row, n in zip(full, ctx_len):
        row[: order - 1 - n] = -1
    tfull = torch.as_tensor(full.reshape(*lead, order)).to(dev)
    tlen = torch.as_tensor(ctx_len.reshape(lead)).to(dev)
    before = tg.probe_rows.launches
    got = tg.probe_rows(tfull, tlen, tabs, tdt._BUCKET_SLOTS, tdt._SUB_WIDTH)
    torch.cuda.synchronize()
    assert tg.probe_rows.launches == before + 1
    want = tg.probe_rows_ref(tfull, tlen, tabs, tdt._BUCKET_SLOTS, tdt._SUB_WIDTH)
    assert got[0].dtype == torch.bool and got[0].shape == (order - 1, *lead)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    assert bool(got[0].any(dim=tuple(range(1, got[0].dim()))).all())  # every order has hits
    cpu_tabs = [dict(tab, bucket=tab["bucket"].cpu()) for tab in tabs]
    for g, w in zip(got, tg.probe_rows(tfull.cpu(), tlen.cpu(), cpu_tabs, tdt._BUCKET_SLOTS, tdt._SUB_WIDTH)):
        assert torch.equal(g.cpu(), w)


def _mode_table(dev, rng, keys, mode):
    """One order's table over id rows ``keys``: FNV-keyed, or KenLM-keyed (built from the chain hashes)."""
    from pyctcdecode_torch.ops.hashing import kenlm_chain_host

    probs = -rng.rand(len(keys)).astype(np.float32) - 0.1
    backoffs = -rng.rand(len(keys)).astype(np.float32)
    if mode == "kenlm64":
        tab = tdt.build_fp_table_from_hashes(kenlm_chain_host(keys), probs, backoffs, keys.shape[1])
    else:
        tab = tdt.build_fp_table(keys.astype(np.uint32).view(np.int32), probs, backoffs)
    assert tab.hash_mode == mode
    return {"bucket": torch.as_tensor(np.ascontiguousarray(tab.bucket)).to(torch.int32).to(dev),
            "size": tab.size, "seed_lo": tab.seed_lo, "seed_hi": tab.seed_hi, "hash_mode": mode}


@pytest.mark.cuda
@pytest.mark.parametrize("modes", [("kenlm64", "kenlm64"), ("fnv", "kenlm64"), ("kenlm64", "fnv", "kenlm64")])
def test_probe_rows_kenlm_mode_matches_plain_version(modes):
    """KenLM-keyed tables, alone and mixed with FNV tables in one launch, bit-exact.

    Ids near ``2**31`` and ``2**32 - 2`` (the chain adds 1 to each id in
    uint32), hits at every order, misses, every context length, -1 pads.
    """
    dev = _cuda()
    rng = np.random.RandomState(21)
    ids = np.concatenate([np.arange(600), (1 << 31) + np.arange(-50, 50), (1 << 32) - 2 - np.arange(50)])
    tabs, keys_by_order = [], []
    for n, mode in enumerate(modes, start=2):
        keys = np.unique(rng.choice(ids, size=(3000 // n, n)).astype(np.int64), axis=0)
        tabs.append(_mode_table(dev, rng, keys, mode))
        keys_by_order.append(keys)
    order = len(modes) + 1
    q = 4 * 100
    full = rng.choice(ids, size=(q, order)).astype(np.int64)
    for t, keys in enumerate(keys_by_order):  # a share of the queries ends in a present (t + 2)-gram
        rows = np.arange(t, q, 2 * len(modes))
        full[rows, order - (t + 2):] = keys[rng.randint(0, len(keys), size=len(rows))]
    ctx_len = rng.randint(0, order, size=q).astype(np.int64)
    ctx_len[: q // 2] = order - 1
    for row, n in zip(full, ctx_len):
        row[: order - 1 - n] = -1
    tfull = torch.as_tensor(full.reshape(4, 100, order)).to(dev)
    tlen = torch.as_tensor(ctx_len.reshape(4, 100)).to(dev)
    before = tg.probe_rows.launches
    got = tg.probe_rows(tfull, tlen, tabs, tdt._BUCKET_SLOTS, tdt._SUB_WIDTH)
    torch.cuda.synchronize()
    assert tg.probe_rows.launches == before + 1
    want = tg.probe_rows_ref(tfull, tlen, tabs, tdt._BUCKET_SLOTS, tdt._SUB_WIDTH)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    assert bool(got[0].any(dim=(1, 2)).all())  # every order has hits
    with pytest.raises(ValueError, match="hash_mode"):
        tg.probe_rows(tfull, tlen, [dict(tabs[0], hash_mode="murmur")] + tabs[1:],
                      tdt._BUCKET_SLOTS, tdt._SUB_WIDTH)


def _windows(tabs, n_shards, rank):
    """Rank ``rank``'s row window of every table cut into ``n_shards`` (the sharded decoder's planes)."""
    out = []
    for tab in tabs:
        plane = tdt.shard_bucket_plane(tab["bucket"].cpu().numpy(), n_shards)[rank]
        out.append(dict(tab, bucket=torch.as_tensor(plane).to(tab["bucket"].device),
                        row0=rank * tdt.shard_rows(tab["size"], n_shards)))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("n_shards", [2, 4])
@pytest.mark.parametrize("modes", [("fnv", "fnv"), ("kenlm64", "fnv", "kenlm64")])
def test_probe_rows_windows_match_plain_version_and_sum_to_the_whole(modes, n_shards):
    """Each row window bit-exact against its plain version; the windows' answers sum to the whole table's."""
    dev = _cuda()
    rng = np.random.RandomState(31 + n_shards)
    ids = np.arange(900)
    tabs, keys_by_order = [], []
    for n, mode in enumerate(modes, start=2):
        keys = np.unique(rng.choice(ids, size=(4000 // n, n)).astype(np.int64), axis=0)
        tabs.append(_mode_table(dev, rng, keys, mode))
        keys_by_order.append(keys)
    order = len(modes) + 1
    q = 16 * 100
    full = rng.choice(ids, size=(q, order)).astype(np.int64)
    for t, keys in enumerate(keys_by_order):
        rows = np.arange(t, q, 2 * len(modes))
        full[rows, order - (t + 2):] = keys[rng.randint(0, len(keys), size=len(rows))]
    ctx_len = rng.randint(0, order, size=q).astype(np.int64)
    tfull = torch.as_tensor(full.reshape(16, 100, order)).to(dev)
    tlen = torch.as_tensor(ctx_len.reshape(16, 100)).to(dev)
    geometry = (tdt._BUCKET_SLOTS, tdt._SUB_WIDTH)
    whole = tg.probe_rows(tfull, tlen, tabs, *geometry)
    summed = None
    for rank in range(n_shards):
        win = _windows(tabs, n_shards, rank)
        before = tg.probe_rows.launches
        got = tg.probe_rows(tfull, tlen, win, *geometry)
        torch.cuda.synchronize()
        assert tg.probe_rows.launches == before + 1
        for g, w in zip(got, tg.probe_rows_ref(tfull, tlen, win, *geometry)):
            assert torch.equal(g, w)
        part = (got[0].to(torch.int32), got[1], got[2])
        summed = part if summed is None else tuple(a + b for a, b in zip(summed, part))
    assert int(summed[0].max()) <= 1 and torch.equal(summed[0] > 0, whole[0])
    assert torch.equal(summed[1], whole[1]) and torch.equal(summed[2], whole[2])
    assert bool(whole[0].any(dim=(1, 2)).all())


@pytest.mark.cuda
def test_world_size_one_sharded_decode_matches_the_plain_decoder(tmp_path):
    """``ShardedCTCDecoder(shard_lm=True)`` over a one-process NCCL group: the plain decoder's results, to the bit."""
    import socket

    import torch.distributed as dist

    from pyctcdecode_torch.parallel import ShardedCTCDecoder, make_data_mesh
    from pyctcdecode_torch.parallel.launch import initialize_from_env

    _cuda()
    path = str(tmp_path / "bb3.arpa")
    with open(path, "w") as fh:
        fh.write(ARPA)
    dec = P.TorchBeamSearchDecoderCTC(P.Alphabet.build_alphabet(SAMPLE_LABELS),
                                      P.LanguageModel(open_ngram_file(path), UNIGRAMS))
    batch = [word_logits(s, t) for s, t in ((40, 33), (41, 18), (42, 27))]
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    assert initialize_from_env(coordinator=f"127.0.0.1:{port}", num_processes=1, process_id=0)
    try:
        sharded = ShardedCTCDecoder(dec, mesh=make_data_mesh(), shard_lm=True)
        for kw in ({}, dict(token_chunking=2, blank_collapse=True)):
            want, want_stats = dec.decode_beams_batch(batch, beam_width=8, collect_stats=True, **kw)
            got, got_stats = sharded.decode_beams_batch(batch, beam_width=8, collect_stats=True, **kw)
            assert got_stats == want_stats
            for w, g in zip(want, got):
                assert_same_beams(w, g, tol=0.0)
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
def test_probe_rows_refuses_another_bucket_geometry():
    dev = _cuda()
    tabs, _ = _probe_tables(dev, np.random.RandomState(2), (50,), 100)
    full = torch.zeros((4, 2), dtype=torch.int64, device=dev)
    ctx_len = torch.ones(4, dtype=torch.int64, device=dev)
    narrow = [dict(tab, bucket=tab["bucket"][:, :64].contiguous()) for tab in tabs]
    with pytest.raises(ValueError, match="geometry"):
        tg.probe_rows(full, ctx_len, narrow, 16, 64)


@pytest.mark.cuda
def test_gpu_decode_matches_cpu_decode(tmp_path):
    """The whole engine on CUDA (kernels) vs on the CPU (plain versions)."""
    _cuda()
    path = str(tmp_path / "bb3.arpa")
    with open(path, "w") as fh:
        fh.write(ARPA)
    alphabet = P.Alphabet.build_alphabet(SAMPLE_LABELS)
    lm = P.LanguageModel(open_ngram_file(path), UNIGRAMS)
    gpu = P.TorchBeamSearchDecoderCTC(alphabet, lm)
    cpu = P.TorchBeamSearchDecoderCTC(alphabet, lm, device="cpu")
    batch = [word_logits(11, 33), word_logits(12, 17), word_logits(13, 40)]
    expand_before = tm.expand_merge_prune.launches
    merge_before = tm.merge_prune.launches
    got = gpu.decode_beams_batch(batch, beam_width=16, prune_history=True)
    seg = gpu._segment_frames_effective()  # the steps pad to whole segments
    assert tm.expand_merge_prune.launches - expand_before == -(-40 // seg) * seg  # one per step
    assert tm.merge_prune.launches - merge_before == 1
    want = cpu.decode_beams_batch(batch, beam_width=16, prune_history=True)
    for g_beams, c_beams in zip(got, want):
        assert len(g_beams) == len(c_beams) > 0
        for g, c in zip(g_beams, c_beams):
            assert g.text == c.text
            assert g.text_frames == c.text_frames
            assert g.last_lm_state == c.last_lm_state
            assert abs(g.logit_score - c.logit_score) <= 1e-4
            assert abs(g.lm_score - c.lm_score) <= 1e-4
    # the serving call: chunks, collapse, two length groups; per step one trie fetch and
    # one word commit (both orders probed in-kernel); per finalize one probe for the last
    # word and one for </s>
    kw = dict(beam_width=16, prune_history=True, token_chunking=3, blank_collapse=True,
              length_bucketing=2)
    expand_before = tm.expand_merge_prune.launches
    merge_before = tm.merge_prune.launches
    gather_before = tg.gather_rows.launches
    probe_before = tg.probe_rows.launches
    commit_before = tc.commit_words.launches
    walk_before = tw.walk_partial.launches
    got = gpu.decode_beams_batch(batch, **kw)
    steps = tm.expand_merge_prune.launches - expand_before
    assert tw.walk_partial.launches - walk_before == steps
    assert tm.merge_prune.launches - merge_before == 2  # one finalize per group
    assert tg.gather_rows.launches - gather_before == steps
    assert tc.commit_words.launches - commit_before == steps
    assert tg.probe_rows.launches - probe_before == 2 * 2
    assert_same_batch(cpu.decode_beams_batch(batch, **kw), got)
    assert_same_batch(want, got)  # and the dense decode's results


@pytest.mark.cuda
def test_gather_and_probe_alternate_between_two_members_tables():
    """Two members' trie planes and bucket tables in one process, calls alternating.

    Nothing of a table's size, seeds or geometry may stick to the wrappers
    between calls: each call is held against its plain version.
    """
    dev = _cuda()
    rng = np.random.RandomState(4)
    planes = []
    for rows, n_chars in ((300, 28), (170, 31)):
        tp = tdt.trie_pack_params(n_chars)
        plane = torch.as_tensor(
            rng.randint(-(1 << 31), 1 << 31, (rows, tp["pack"] * tp["stride"])).astype(np.int32)).to(dev)
        planes.append((plane, tp, rows * tp["pack"]))
    members = [_probe_tables(dev, rng, (400, 300), 900)[0], _probe_tables(dev, rng, (5000,), 3000)[0]]
    for rep in range(3):
        for (plane, tp, n_nodes), tabs in zip(planes, members):
            nodes = torch.as_tensor(rng.randint(0, n_nodes, size=(4, 25)).astype(np.int64)).to(dev)
            got = tdt.trie_fetch_rows(plane, tp, nodes)
            want = tg.gather_rows_ref(plane, nodes // tp["pack"], nodes % tp["pack"], tp["stride"], tp["width"])
            assert torch.equal(got, want)
            order = len(tabs) + 1
            full = torch.as_tensor(rng.randint(-1, 1000, size=(4, 25, order)).astype(np.int64)).to(dev)
            ctx_len = torch.as_tensor(rng.randint(0, order, size=(4, 25)).astype(np.int64)).to(dev)
            got = tg.probe_rows(full, ctx_len, tabs, tdt._BUCKET_SLOTS, tdt._SUB_WIDTH)
            want = tg.probe_rows_ref(full, ctx_len, tabs, tdt._BUCKET_SLOTS, tdt._SUB_WIDTH)
            for g, w in zip(got, want):
                assert torch.equal(g, w)


@pytest.mark.cuda
def test_expand_with_a_hotword_partial_score_and_no_lm():
    """The hotword completion score as ``pscore`` (weight x length / shortest completion)."""
    dev = _cuda()
    rng = np.random.RandomState(9)
    beam, tok, cids, _, prune = expand_inputs(rng, 3, 8, 100, 1)
    beam["wfused"] = np.where(rng.rand(3, 100) < 0.3, 10.0, 0.0).astype(np.float32)  # hotword boosts
    plen = rng.randint(0, 9, size=(3, 8, 100))
    min_comp = np.maximum(plen, rng.randint(1, 12, size=plen.shape))
    hot_pref = (rng.rand(*plen.shape) < 0.4) & (plen > 0)
    pscore = np.where(hot_pref, np.float32(10.0) * plen.astype(np.float32) / min_comp, 0.0)
    eargs = (
        {key: val.to(dev) for key, val in torch_planes(beam).items()},
        {key: val.to(dev) for key, val in torch_planes(tok).items()},
        torch.as_tensor(cids).to(dev), torch.as_tensor(pscore.astype(np.float32)).to(dev),
        torch.as_tensor(prune).to(dev), False,
    )
    got = tm.expand_merge_prune(*eargs)
    torch.cuda.synchronize()
    assert_outputs([g.cpu() for g in got], [w.cpu() for w in tm.expand_merge_prune_ref(*eargs)])


@pytest.mark.cuda
def test_gpu_two_member_hotword_decode_matches_cpu(tmp_path):
    """Two members (a 3-gram with ``</s>`` credit, a 2-gram without) and hotwords, CUDA vs CPU.

    Per step: one ``expand_merge_prune``, one ``gather_rows`` per member and
    one ``commit_words`` for both (every probe in-kernel); per finalize one
    ``merge_prune`` and, per member, one ``probe_rows`` for the last word
    plus one for ``</s>`` where the member scores it. Hotwords without an LM
    read no LM table: their commit is the same one launch, with no member.
    """
    _cuda()
    members = []
    for name, text, kw in (("a", ARPA, {}), ("b", ARPA_2GRAM, dict(alpha=0.3, beta=2.0, score_boundary=False))):
        path = tmp_path / f"{name}.arpa"
        path.write_text(text)
        members.append(P.LanguageModel(open_ngram_file(str(path)), UNIGRAMS, **kw))
    alphabet = P.Alphabet.build_alphabet(SAMPLE_LABELS)
    lm = P.MultiLanguageModel(members)
    batch = [word_logits(11, 33), word_logits(12, 17), word_logits(13, 40)]
    hot = dict(hotwords=["bugs bunny", "sun"], hotword_weight=8.0)
    for model, probes_per_finalize in ((lm, 3), (None, 0)):
        gpu = P.TorchBeamSearchDecoderCTC(alphabet, model)
        cpu = P.TorchBeamSearchDecoderCTC(alphabet, model, device="cpu")
        for kw in (dict(beam_width=16, prune_history=True, **hot),
                   dict(beam_width=16, prune_history=True, token_chunking=3, blank_collapse=True,
                        length_bucketing=2, **hot)):
            before = {fn: fn.launches for fn in (tm.expand_merge_prune, tm.merge_prune, tg.gather_rows,
                                                 tg.probe_rows, tc.commit_words)}
            got = gpu.decode_beams_batch(batch, **kw)
            used = {fn: fn.launches - n for fn, n in before.items()}
            steps, finalizes = used[tm.expand_merge_prune], used[tm.merge_prune]
            assert steps >= 40 and finalizes == (2 if "length_bucketing" in kw else 1)
            assert used[tg.gather_rows] == (2 if model is not None else 0) * steps
            assert used[tc.commit_words] == steps
            assert used[tg.probe_rows] == probes_per_finalize * finalizes
            assert_same_batch(cpu.decode_beams_batch(batch, **kw), got)


@pytest.mark.cuda
@pytest.mark.parametrize("n,k,chunk", [(32, 129, False), (16, 5, True)])
def test_cuda_bpe_form_at_the_bpe_path_shapes(n, k, chunk):
    """``expand_merge_prune`` with ``lmax`` 5 and the forced break, at the bpe path's
    dense step [32, 129, 100] and its serving chunk [16, 5, 100] (window off), every cluster size."""
    dev = _cuda()
    rng = np.random.RandomState(500 + k)
    beam, tok, cids, pscore, prune = expand_inputs(rng, n, k, 100, 5)
    if chunk:
        tok = chunk_token_planes(rng, tok, 129)
        prune = np.full(n, -np.inf, dtype=np.float32)
    eargs = (
        {key: val.to(dev) for key, val in torch_planes(beam).items()},
        {key: val.to(dev) for key, val in torch_planes(tok).items()},
        torch.as_tensor(cids).to(dev), torch.as_tensor(pscore).to(dev),
        torch.as_tensor(prune).to(dev), True,
    )
    want = [w.cpu() for w in tm.expand_merge_prune_ref(*eargs)]
    for cluster in (0, 1, 2, 4, 8):
        got = [g.cpu() for g in tm.expand_merge_prune(*eargs, cluster=cluster)]
        torch.cuda.synchronize()
        assert not torch.isnan(got[0]).any()
        assert_outputs(got, want)


@pytest.mark.cuda
def test_gpu_bpe_decode_matches_cpu_decode(tmp_path):
    """A piece vocabulary (labels up to 5 chars, ``▁⁇▁`` mid-utterance) on CUDA vs on the CPU."""
    _cuda()
    path = str(tmp_path / "bb3.arpa")
    with open(path, "w") as fh:
        fh.write(ARPA)
    alphabet = P.Alphabet.build_alphabet(piece_vocabulary(LM_WORDS))
    lm = P.LanguageModel(open_ngram_file(path), UNIGRAMS)
    gpu = P.TorchBeamSearchDecoderCTC(alphabet, lm)
    cpu = P.TorchBeamSearchDecoderCTC(alphabet, lm, device="cpu")
    batch = [piece_logits(seed, alphabet.labels, 6) for seed in range(3)]
    for kw in (dict(beam_width=16), dict(beam_width=16, token_chunking=3, blank_collapse=True,
                                         length_bucketing=2, hotwords=["guns", "sunny bun"])):
        expand_before = tm.expand_merge_prune.launches
        got = gpu.decode_beams_batch(batch, prune_history=True, **kw)
        assert tm.expand_merge_prune.launches > expand_before
        assert_same_batch(cpu.decode_beams_batch(batch, prune_history=True, **kw), got)


@pytest.mark.cuda
@pytest.mark.parametrize("n,t,b,r,par,tok", [
    (32, 544, 100, 100, torch.int8, torch.int8),  # a dense decode's logs at beam 100
    (16, 535, 100, 1, torch.int8, torch.int8),  # a serving group's timeline logs, top_n = 1
    (32, 496, 100, 100, torch.int8, torch.int16),  # a bpe decode (V = 129)
    (8, 300, 200, 10, torch.int16, torch.int8),  # beam 200, emit_paths < B
    (4, 70, 1024, 1024, torch.int16, torch.int32),  # the widest beam: a tile of 4 frames
    (3, 5, 7, 2, torch.int32, torch.int32),
])
def test_backtrace_paths_matches_plain_version(n, t, b, r, par, tok):
    """Random logs with padded frames (-1, identity parents) and timeline carry markers (-3)."""
    dev = _cuda()
    rng = np.random.RandomState(n + t + b)
    parents = rng.randint(0, b, (n, t, b))
    trace = rng.randint(-1, 120, (n, t, b))
    carry = rng.rand(n, t) < 0.3  # a frame's non-final chunks: identity parents, token -3
    trace[carry] = -3
    parents[carry] = np.arange(b)
    lengths = rng.randint(1, t + 1, n)
    pad = np.arange(t)[None, :] >= lengths[:, None]
    trace[pad] = -1
    parents[pad] = np.arange(b)
    src = np.stack([rng.permutation(b)[:r] for _ in range(n)])
    args = (torch.as_tensor(parents, device=dev).to(par), torch.as_tensor(trace, device=dev).to(tok),
            torch.as_tensor(src, device=dev))
    before = tb.backtrace_paths.launches
    got = tb.backtrace_paths(*args)
    torch.cuda.synchronize()
    assert tb.backtrace_paths.launches == before + 1
    want = tb.backtrace_paths_ref(*args)
    assert got.dtype == tok and got.shape == (n, r, t)
    assert torch.equal(got, want)


def _replay_checked(monkeypatch):
    """Put a checker in place of the engine's ``replay_winners``: each step's kernel against its twin.

    Every call of a decode's step runs the kernel and ``replay_winners_ref``
    on the same real inputs and asserts every output equal to the bit. The
    returned dict counts the calls and the cases the steps held: gated rows
    emitting ``-3`` (a timeline's non-final chunk) and ``-1`` (inactive),
    dead lanes, history duplicates.
    """
    seen = {"calls": 0, "carry": 0, "inactive": 0, "dead": 0, "dup": 0, "pooled": 0, "dense": 0}
    kernel = engine.replay_winners

    def checked(state, cm, tok, win, gate, active, prune_history, is_bpe, stats, out_dtypes):
        before = tr.replay_winners.launches
        got = kernel(state, cm, tok, win, gate, active, prune_history, is_bpe, stats, out_dtypes)
        want = tr.replay_winners_ref(state, cm, tok, win, gate, active, prune_history, is_bpe, stats, out_dtypes)
        torch.cuda.synchronize()
        assert tr.replay_winners.launches == before + 1
        for key in want[0]:
            assert got[0][key].dtype == want[0][key].dtype and torch.equal(got[0][key], want[0][key]), key
        for g, w, name in zip(got[1:], want[1:], ("parent", "token", "flags")):
            assert (g is None) == (w is None), name
            if w is not None:
                assert g.dtype == w.dtype and torch.equal(g, w), name
        seen["calls"] += 1
        seen["pooled" if "parent" in win else "dense"] += 1
        seen["carry"] += int((want[2] == -3).sum())
        seen["inactive"] += int((~active).sum())
        seen["dead"] += int((want[0]["logit"] < -1e29).sum())
        if want[3] is not None:
            seen["dup"] += int(((want[3] & tr.FLAG_DUP) != 0).sum())
        return got

    monkeypatch.setattr(engine, "replay_winners", checked)
    return seen


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["char", "char serving", "bpe", "bpe serving", "two members, hotwords",
                                  "two members, hotwords, serving"])
def test_replay_winners_matches_plain_version_on_real_steps(tmp_path, monkeypatch, case):
    """``replay_winners`` against ``replay_winners_ref`` on every step of real decodes, to the bit.

    Beam 100, ``prune_history`` and ``collect_stats`` on, three utterances
    of unequal lengths (inactive rows); dense and serving (a timeline whose
    non-final chunks emit ``-3``); the char alphabet with one LM, the same
    with two members and hotwords, and a 129-piece BPE vocabulary (labels up
    to 5 chars, int16 tokens).
    """
    _cuda()
    members = []
    for name, text, kw in (("a", ARPA, {}), ("b", ARPA_2GRAM, dict(alpha=0.3, beta=2.0, score_boundary=False))):
        path = tmp_path / f"{name}.arpa"
        path.write_text(text)
        members.append(P.LanguageModel(open_ngram_file(str(path)), UNIGRAMS, **kw))
    kw = dict(beam_width=100, prune_history=True, collect_stats=True)
    if case.startswith("bpe"):
        alphabet = P.Alphabet.build_alphabet(conformer_width(piece_vocabulary(LM_WORDS)))
        lm = members[0]
        batch = [piece_logits(seed, alphabet.labels, 6) for seed in range(3)]
    else:
        alphabet = P.Alphabet.build_alphabet(SAMPLE_LABELS)
        lm = P.MultiLanguageModel(members) if "two members" in case else members[0]
        batch = [word_logits(11, 33), word_logits(12, 17), word_logits(13, 40)]
        if "hotwords" in case:
            kw.update(hotwords=["bugs bunny", "sun"], hotword_weight=8.0)
    if "serving" in case:
        kw.update(token_chunking=3, blank_collapse=True, length_bucketing=2)
    dec = P.TorchBeamSearchDecoderCTC(alphabet, lm).with_options(segment_frames=0)  # the eager loop: a call a step
    seen = _replay_checked(monkeypatch)
    dec.decode_beams_batch(batch, **kw)
    assert seen["calls"] >= 17 and seen["inactive"] > 0 and seen["dead"] > 0 and seen["dup"] > 0
    if "serving" in case:
        assert seen["pooled"] == seen["calls"] and seen["carry"] > 0
    else:
        assert seen["dense"] == seen["calls"] and seen["carry"] == 0
    if case.startswith("bpe"):
        assert dec._tabs["tok"]["raw_chars"].shape[1] == 5


@pytest.mark.cuda
def test_replay_winners_matches_plain_version_on_a_stream(tmp_path, monkeypatch):
    """The stream's N = 1 steps, chunk by chunk, to the bit."""
    _cuda()
    path = tmp_path / "a.arpa"
    path.write_text(ARPA)
    lm = P.LanguageModel(open_ngram_file(str(path)), UNIGRAMS)
    dec = P.TorchBeamSearchDecoderCTC(P.Alphabet.build_alphabet(SAMPLE_LABELS), lm).with_options(segment_frames=0)
    seen = _replay_checked(monkeypatch)
    mat = word_logits(21, 30)
    state = dec.get_starting_state(beam_width=100)
    for i in range(3):
        dec.partial_decode_beams(state, mat[10 * i : 10 * (i + 1)], is_end=i == 2)
    assert seen["calls"] == 30 and seen["dead"] > 0


def _commit_checked(monkeypatch):
    """Put a checker in place of the engine's ``commit_words``: each step's kernel against its twin.

    Every call of a decode's step runs the kernel and ``commit_words_ref`` on
    the same real inputs and asserts every output equal to the bit, the
    decode counters' hit masks included. The returned dict counts the calls,
    the beams that commit and those that do not, and the hits at orders >= 2.
    """
    seen = {"calls": 0, "commits": 0, "idle": 0, "ngram_hits": 0}
    kernel = engine.commit_words

    def checked(lms, prm, state, trie_rows, use_hot, stats):
        before = tc.commit_words.launches
        got = kernel(lms, prm, state, trie_rows, use_hot, stats)
        want = tc.commit_words_ref(lms, prm, state, trie_rows, use_hot, stats)
        torch.cuda.synchronize()
        assert tc.commit_words.launches == before + 1
        assert sorted(got) == sorted(want)
        for key, val in want.items():
            if key == "probe_hits":
                for g_member, w_member in zip(got[key], val, strict=True):
                    for g, w in zip(g_member, w_member, strict=True):
                        assert g.dtype == w.dtype and torch.equal(g, w), key
                seen["ngram_hits"] += sum(int(hits.sum()) for member in val for hits in member[1:])
            else:
                assert got[key].dtype == val.dtype and torch.equal(got[key], val), key
        seen["calls"] += 1
        seen["commits"] += int((state["p_len"] > 0).sum())
        seen["idle"] += int((state["p_len"] == 0).sum())
        return got

    monkeypatch.setattr(engine, "commit_words", checked)
    return seen


def _kenlm64_tables(lm, dev):
    """``lm``'s n-gram tables keyed by KenLM's chain (``kenlm64``), as the device dicts the engine reads."""
    return [{"bucket": torch.as_tensor(np.ascontiguousarray(t.bucket)).to(torch.int32).to(dev), "size": int(t.size),
             "seed_lo": int(t.seed_lo), "seed_hi": int(t.seed_hi), "hash_mode": t.hash_mode}
            for t in kenlm64_fp_tables(lm.ngram_model.tables.ngrams, lm.order)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["char", "char serving", "bpe", "two members, hotwords",
                                  "two members, hotwords, serving", "three members", "kenlm64"])
def test_commit_words_matches_plain_version_on_real_steps(tmp_path, monkeypatch, case):
    """``commit_words`` against ``commit_words_ref`` on every step of real decodes, to the bit.

    Beam 100 and ``collect_stats`` on (the hit masks), three utterances of
    unequal lengths; dense and serving; the char alphabet with one 3-gram, with
    two members (a 3-gram and a 2-gram at other parameters) and hotwords, with
    three members (the members' mean divides by 3), with the 3-gram's tables
    keyed by KenLM's chain (``kenlm64``), and a 129-piece BPE vocabulary.
    """
    _cuda()
    members = []
    for name, text, kw in (("a", ARPA, {}), ("b", ARPA_2GRAM, dict(alpha=0.3, beta=2.0, score_boundary=False)),
                           ("c", ARPA_2GRAM, dict(alpha=0.7, beta=-0.5, unk_score_offset=-4.0))):
        path = tmp_path / f"{name}.arpa"
        path.write_text(text)
        members.append(P.LanguageModel(open_ngram_file(str(path), backend="python"), UNIGRAMS, **kw))
    kw = dict(beam_width=100, prune_history=True, collect_stats=True)
    if case == "bpe":
        alphabet = P.Alphabet.build_alphabet(conformer_width(piece_vocabulary(LM_WORDS)))
        lm = members[0]
        batch = [piece_logits(seed, alphabet.labels, 6) for seed in range(3)]
    else:
        alphabet = P.Alphabet.build_alphabet(SAMPLE_LABELS)
        lm = members[0]
        if "two members" in case:
            lm = P.MultiLanguageModel(members[:2])
        elif case == "three members":
            lm = P.MultiLanguageModel(members)
        batch = [word_logits(11, 33), word_logits(12, 17), word_logits(13, 40)]
        if "hotwords" in case:
            kw.update(hotwords=["bugs bunny", "sun"], hotword_weight=8.0)
    if "serving" in case:
        kw.update(token_chunking=3, blank_collapse=True, length_bucketing=2)
    dec = P.TorchBeamSearchDecoderCTC(alphabet, lm).with_options(segment_frames=0)  # the eager loop: a call a step
    if case == "kenlm64":
        tabs = dec._tabs["lms"][0]
        tabs["fp"] = _kenlm64_tables(members[0], tabs["fp"][0]["bucket"].device)
        assert all(t["hash_mode"] == "kenlm64" for t in tabs["fp"])
    seen = _commit_checked(monkeypatch)
    dec.decode_beams_batch(batch, **kw)
    assert seen["calls"] >= 17 and seen["commits"] > 0 and seen["idle"] > 0 and seen["ngram_hits"] > 0


def _same_walk(got, want):
    """Two ``walk_partial`` answers equal to the bit: the entry planes, the hot entries, the scores' bits."""
    (g_ent, g_h, g_score), (w_ent, w_h, w_score) = got, want
    assert len(g_ent) == len(w_ent)
    for g, w in zip(g_ent, w_ent):
        assert g.dtype == w.dtype and torch.equal(g, w)
    assert (g_h is None) == (w_h is None)
    if w_h is not None:
        assert g_h.dtype == w_h.dtype and torch.equal(g_h, w_h)
    assert g_score.dtype == w_score.dtype and g_score.shape == w_score.shape
    assert torch.equal(g_score.view(torch.int32), w_score.view(torch.int32))  # a -0.0 is not a 0.0


def _walk_checked(monkeypatch):
    """Put a checker in place of the engine's ``walk_partial``: each step's kernel against its twin."""
    seen = {"calls": 0}
    kernel = engine.walk_partial

    def checked(*args):
        before = tw.walk_partial.launches
        got = kernel(*args)
        want = tw.walk_partial_ref(*args)
        torch.cuda.synchronize()
        assert tw.walk_partial.launches == before + 1
        _same_walk(got, want)
        seen["calls"] += 1
        return got

    monkeypatch.setattr(engine, "walk_partial", checked)
    return seen


@pytest.mark.cuda
@pytest.mark.parametrize("case", WALK_CASES)
def test_walk_partial_matches_plain_version(tmp_path, monkeypatch, case):
    """``walk_partial`` against ``walk_partial_ref`` to the bit, and one launch a step.

    The CPU tests' seeded steps (``tests/walk_cases.py``: one-letter labels,
    wav2vec2's 32, 129 BPE pieces, two members with hotwords on timeline
    chunks, beams in the corners), with the parameters as host numbers and
    as the segment programs' device views; then every step of a real decode
    of the case's decoder at beam 100 (the eager loop); then the same decode
    through the captured graphs, one ``walk_partial`` launch a step.
    """
    _cuda()
    dec = walk_decoder(case, tmp_path, "cuda")
    for seed, on_device in ((1, False), (2, True)):
        args = walk_inputs(case, dec, seed, params_on_device=on_device)
        before = tw.walk_partial.launches
        got = tw.walk_partial(*args)
        want = tw.walk_partial_ref(*args)
        torch.cuda.synchronize()
        assert tw.walk_partial.launches == before + 1
        _same_walk(got, want)
    kw = dict(beam_width=100, prune_history=True)
    if case in ("two members, hotwords", "edges"):
        kw.update(hotwords=HOTWORDS, hotword_weight=HOT_WEIGHT)
    if case == "two members, hotwords":
        kw.update(token_chunking=3, blank_collapse=True, length_bucketing=2)
    if case == "w2v2":
        batch = [w2v2_logits(seed, t) for seed, t in ((1, 33), (2, 17), (3, 40))]
    elif case in ("bpe", "edges"):
        batch = [piece_logits(seed, dec._labels, 6) for seed in range(3)]
    else:
        batch = [word_logits(11, 33), word_logits(12, 17), word_logits(13, 40)]
    seen = _walk_checked(monkeypatch)
    dec.with_options(segment_frames=0).decode_beams_batch(batch, **kw)  # the eager loop: a call a step
    assert seen["calls"] >= 17
    monkeypatch.undo()
    before = {fn: fn.launches for fn in (tm.expand_merge_prune, tw.walk_partial)}
    dec.decode_beams_batch(batch, **kw)  # the captured segment graphs
    used = {fn: fn.launches - n for fn, n in before.items()}
    assert used[tw.walk_partial] == used[tm.expand_merge_prune] > 0
