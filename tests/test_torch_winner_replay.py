"""The engine step's winner replay: the plain twin on small hand-made steps.

``replay_winners_ref`` (and the wrapper, which runs it on CPU tensors) gates
padded rows, kills dead lanes, emits the timeline's carry marker, shifts the
history ring only on a commit at a boundary and keeps the older of two
beams with one history. The decode parity suites run it on real steps; the
CUDA kernel is held to it to the bit on the card
(``test_torch_kernels_cuda.py``).
"""
import numpy as np
import pytest
import torch

from pyctcdecode_torch.models.device_tables import HOT_NODE_MASK, DeviceLM
from pyctcdecode_torch.ops import replay as tr
from pyctcdecode_torch.ops.merge import DEAD
from pyctcdecode_torch.ops.tokens import KIND_BLANK, KIND_BOUNDARY, KIND_REGULAR

from .torch_cases import one_torch_thread  # noqa: F401  (autouse fixture)

N, B, K, RING = 2, 4, 3, 2
BLANK, SPACE, LETTER = 0, 1, 2  # token ids of the table below
OUT = (torch.int8, torch.int8)


def _tok():
    """Five tokens: blank, a boundary, three one- or two-char letters."""
    rng = np.random.RandomState(0)
    return {
        "kind": torch.tensor([KIND_BLANK, KIND_BOUNDARY, KIND_REGULAR, KIND_REGULAR, KIND_REGULAR]),
        "piece_len": torch.tensor([0, 0, 1, 2, 1]),
        "raw_chars": torch.tensor([[-1, -1], [-1, -1], [3, -1], [4, 5], [6, -1]]),
        "raw_len": torch.tensor([0, 0, 1, 2, 1]),
        "seed_lo": torch.as_tensor(rng.randint(0, 2**32, 5, dtype=np.int64)),
        "seed_hi": torch.as_tensor(rng.randint(0, 2**32, 5, dtype=np.int64)),
        "right_bound": torch.zeros(5, dtype=torch.int32),
    }


def _state(seed, n_lms=1, hot=False):
    rng = np.random.RandomState(seed)

    def lanes(*shape):
        return torch.as_tensor(rng.randint(0, 2**32, (N, B) + shape, dtype=np.int64))

    state = {
        "text_lo": lanes(), "text_hi": lanes(), "p_lo": lanes(), "p_hi": lanes(),
        "p_len": torch.as_tensor(rng.randint(0, 3, (N, B))),
        "last_tok": torch.as_tensor(rng.randint(0, 5, (N, B))),
        "n_words": torch.as_tensor(rng.randint(0, 4, (N, B))),
        "force": torch.zeros((N, B), dtype=torch.bool),
        "logit": torch.as_tensor(rng.randn(N, B).astype(np.float32)),
        "fused": torch.as_tensor(rng.randn(N, B).astype(np.float32)),
        "ring_lo": lanes(RING), "ring_hi": lanes(RING),
    }
    cm = {"word_fused": torch.as_tensor(rng.randn(N, B).astype(np.float32))}
    for i in range(n_lms):
        state[f"p_node{i}"] = torch.as_tensor(rng.randint(0, 1000, (N, B)))
        state[f"p_flags{i}"] = torch.zeros((N, B), dtype=torch.int64)
        for src in (state, cm):
            src[f"ctx{i}"] = torch.as_tensor(rng.randint(0, 50, (N, B, 2)))
            src[f"ctx_len{i}"] = torch.as_tensor(rng.randint(0, 3, (N, B)))
            src[f"ctx_bo{i}"] = torch.as_tensor(rng.randn(N, B, 2).astype(np.float32))
    if hot:
        state["h_node"] = torch.as_tensor(rng.randint(0, 100, (N, B)))
        state["h_bits"] = torch.zeros((N, B), dtype=torch.int64)
    return state, cm


def _entries(rng, shape, n_lms):
    return [torch.as_tensor(rng.randint(0, 1 << 30, shape, dtype=np.int64)) for _ in range(n_lms)]


def _pooled(parent, tok, score=None, n_lms=1, seed=1):
    """Per-winner planes (a timeline step's): ``parent`` and ``tok`` ``[N, B]`` lists."""
    rng = np.random.RandomState(seed)
    return {
        "parent": torch.tensor(parent), "bp": torch.tensor(parent), "tok": torch.tensor(tok),
        "logit": torch.as_tensor(rng.randn(N, B).astype(np.float32)),
        "score": torch.zeros((N, B)) if score is None else torch.tensor(score, dtype=torch.float32),
        "ent": _entries(rng, (N, B), n_lms), "h_ent": None,
    }


def _dense(seed, n_lms=1, hot=False):
    """A dense step's ranking over ``[N, K * B]`` random scores, some dead."""
    rng = np.random.RandomState(seed)
    sc = rng.randn(N, K * B).astype(np.float32)
    sc[rng.rand(N, K * B) < 0.8] = DEAD
    srt = torch.sort(torch.as_tensor(sc), dim=-1, descending=True, stable=True)
    return {
        "order": srt.indices, "score": srt.values,
        "src": torch.as_tensor(rng.randint(0, K * B, (N, K, B)).astype(np.int32)),
        "merged": torch.as_tensor(rng.randn(N, K, B).astype(np.float32)),
        "toks": torch.tensor([[BLANK, SPACE, LETTER + 1]] * N),
        "ent": _entries(rng, (N, B, K), n_lms),
        "h_ent": torch.as_tensor(rng.randint(0, 1 << 30, (N, B, K), dtype=np.int64)) if hot else None,
    }


def _replay(state, cm, win, gate, active, prune_history=False, stats=False):
    return tr.replay_winners(state, cm, _tok(), win, torch.tensor(gate), torch.tensor(active), prune_history,
                             False, stats, OUT)


CASES = {
    "dense": lambda: (_state(3), _dense(4)),
    "dense, two members and hotwords": lambda: (_state(5, n_lms=2, hot=True), _dense(6, n_lms=2, hot=True)),
    "pooled": lambda: (_state(7), _pooled([[0, 1, 2, 3]] * N, [[LETTER, SPACE, BLANK, -1]] * N)),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("prune_history", [False, True])
def test_an_inactive_row_passes_every_key_through(case, prune_history):
    (state, cm), win = CASES[case]()
    out, parent, token, _ = _replay(state, cm, win, [True, False], [True, False], prune_history)
    assert sorted(out) == sorted(state)
    for key, old in state.items():
        assert torch.equal(out[key][1], old[1]), key
    assert parent[1].tolist() == list(range(B)) and token[1].tolist() == [-1] * B
    assert parent.dtype == token.dtype == torch.int8


@pytest.mark.parametrize("case", sorted(CASES))
def test_a_dead_lane_gets_dead_and_the_sentinel(case):
    (state, cm), win = CASES[case]()
    if "order" not in win:
        win["score"][:, 2] = DEAD
    dead = (win["score"][:, :B] < -1e29).tolist()
    assert any(any(row) for row in dead)
    out, _, _, flags = _replay(state, cm, win, [True, True], [True, True], stats=True)
    for n in range(N):
        for j in range(B):
            if dead[n][j]:
                assert out["logit"][n, j] == DEAD and out["last_tok"][n, j] == -2 - j
                assert not flags[n, j] & tr.FLAG_ALIVE
            else:
                assert out["logit"][n, j] > -1e29 and out["last_tok"][n, j] >= 0
                assert flags[n, j] & tr.FLAG_ALIVE


def test_a_non_final_timeline_chunk_emits_the_identity_parent_and_the_carry_marker():
    state, cm = _state(8)
    win = _pooled([[3, 3, 0, 1]] * N, [[LETTER, LETTER + 1, BLANK, SPACE]] * N)
    out, parent, token, _ = _replay(state, cm, win, [False, True], [True, True])
    assert parent[0].tolist() == list(range(B)) and token[0].tolist() == [-3] * B
    for key, old in state.items():
        assert torch.equal(out[key][0], old[0]), key
    assert parent[1].tolist() == [3, 3, 0, 1] and token[1].tolist() == [LETTER, LETTER + 1, BLANK, SPACE]


@pytest.mark.parametrize(
    "p_len,tok,shifts",
    [(2, SPACE, True), (0, SPACE, False), (2, LETTER, False), (2, BLANK, False)],
    ids=["commit at a boundary", "boundary, nothing to commit", "a letter", "a blank"],
)
def test_the_ring_shifts_only_on_a_commit_at_a_boundary(p_len, tok, shifts):
    state, cm = _state(9)
    state["p_len"][:] = p_len
    state["last_tok"][:] = LETTER + 2  # no token of this step stays by repetition
    win = _pooled([[1, 0, 3, 2]] * N, [[tok] * B] * N)
    out, _, _, flags = _replay(state, cm, win, [True, True], [True, True], stats=True)
    par = win["parent"]
    for n in range(N):
        for j in range(B):
            p = int(par[n, j])
            old_lo, old_hi = state["ring_lo"][n, p].tolist(), state["ring_hi"][n, p].tolist()
            if shifts:
                assert out["ring_lo"][n, j].tolist() == old_lo[1:] + [int(state["p_lo"][n, p])]
                assert out["ring_hi"][n, j].tolist() == old_hi[1:] + [int(state["p_hi"][n, p])]
                assert out["n_words"][n, j] == state["n_words"][n, p] + 1
            else:
                assert out["ring_lo"][n, j].tolist() == old_lo and out["ring_hi"][n, j].tolist() == old_hi
                assert out["n_words"][n, j] == state["n_words"][n, p]
            bits = tr.FLAG_BND | tr.FLAG_COMMIT
            assert (int(flags[n, j]) & bits == bits) == shifts


@pytest.mark.parametrize("prune_history", [False, True])
def test_the_history_dedup_keeps_the_lower_index_beam(prune_history):
    state, cm = _state(10)
    # slots 1 and 3 replay parent 2 with the same letter: one history twice
    win = _pooled([[0, 2, 1, 2]] * N, [[LETTER, LETTER + 1, BLANK, LETTER + 1]] * N)
    out, _, _, flags = _replay(state, cm, win, [True, True], [True, True], prune_history, stats=True)
    for n in range(N):
        assert out["logit"][n, 1] > -1e29 and out["last_tok"][n, 1] == LETTER + 1
        if prune_history:
            assert out["logit"][n, 3] == DEAD and out["last_tok"][n, 3] == -2 - 3
            assert [int(f) & tr.FLAG_DUP for f in flags[n]] == [0, 0, 0, tr.FLAG_DUP]
        else:
            assert torch.equal(out["logit"][n, 3], win["logit"][n, 3])
            assert not (flags[n] & tr.FLAG_DUP).any()


def test_members_and_hot_entries_split_into_node_and_flags():
    state, cm = _state(11, n_lms=2, hot=True)
    win = _dense(12, n_lms=2, hot=True)
    out, _, _, _ = _replay(state, cm, win, [True, True], [True, True])
    top = win["order"][:, :B]
    col, par = top // B, top % B
    for i in range(2):
        ent = torch.stack([win["ent"][i][n, par[n], col[n]] for n in range(N)])
        assert torch.equal(out[f"p_node{i}"], ent & DeviceLM.NODE_MASK)
        assert torch.equal(out[f"p_flags{i}"] | out[f"p_node{i}"], ent)
    h = torch.stack([win["h_ent"][n, par[n], col[n]] for n in range(N)])
    assert torch.equal(out["h_node"], h & HOT_NODE_MASK) and torch.equal(out["h_bits"] | out["h_node"], h)


def test_the_wrapper_refuses_a_state_without_its_planes():
    (state, cm), win = CASES["dense"]()
    del state["ring_hi"]
    with pytest.raises(ValueError, match="state: expected the planes"):
        _replay(state, cm, win, [True, True], [True, True])
