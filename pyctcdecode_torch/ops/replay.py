"""The engine step's winner replay: one CUDA kernel and its plain twin.

:func:`replay_winners` takes a decode step from "the top-B ranking is known"
to "the new beam state and the step's backpointers are written". Per
utterance ``n`` and new beam slot ``j`` it

* resolves the winner: with a dense step's ranking (``order``, the stable
  descending sort of the ``[N, K * B]`` candidate scores) its token column
  ``order // B``, parent beam ``order % B``, the merge kernel's donor
  ``src % B`` (the backtrace's parent), its merged logit and the members'
  packed trie entries; a timeline step resolves its pooled winners in
  PyTorch and hands per-winner planes instead;
* replays the transition from the parent's row and the token's table
  entries: stay / boundary (``force`` for BPE), the committed text hash,
  the partial-word hash extended over the label's chars, the word count,
  the fused score, the history ring on a commit, each member's context at a
  boundary, trie node and flags, the hot-trie entry; dead lanes get
  ``DEAD`` and the ``-2 - j`` last-token sentinel;
* with ``prune_history``, folds (partial, last token, word count, ring)
  into two mixed 32-bit lanes and kills a beam whose key a lower slot of
  its utterance holds (the older beam survives);
* gates the padded steps: where ``gate[n]`` is off the row keeps every
  state plane it had and emits the identity parent with token ``-3``
  (``active[n]``: a timeline's non-final chunk) or ``-1`` (inactive).

No Pallas kernel of the JAX reference computes this: there it is XLA's
lowering of the step's tail (its ``engine.py:1290-1535``) and
of ``_select_fields_mxu`` (``:597``), the one-hot matmul selection a TPU
needs. In the port it was ~115 small PyTorch launches a step (gathers,
``where``, int64 bit ops); one launch does it now.

What bounds it on the H100: launch latency and one pass over the state, not
arithmetic: a 32 x 100 step reads and writes well under 1 MB (under 0.5 us
at 3.35 TB/s). The kernel (``csrc/replay.cu``) runs one block per utterance
and one thread per beam; a thread reads its winner's parent row and token
entries (L2-resident in a step) and writes its row of every output plane
once; the history keys of an utterance meet in shared memory.

Lane convention as everywhere in the engine: hash lanes are int64 tensors
holding uint32 values, scores float32. The replay is integer arithmetic plus
one float32 add (``fused + word score`` at a boundary), so the kernel equals
its twin to the bit.

On CPU tensors :func:`replay_winners` runs :func:`replay_winners_ref`; on
CUDA tensors it launches the kernel or raises. ``replay_winners.launches``
counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, Optional, Tuple

import torch

from ..models.device_tables import HOT_NODE_MASK, DeviceLM
from .hashing import M32, hash_extend_char_t, hash_text_commit_t, mix4_t
from .backtrace import LOG_DTYPES
from .merge import DEAD, DEAD_THRESH, MAX_BEAM, _check, _launch, _launch_device, _ptr
from .tokens import KIND_BLANK, KIND_BOUNDARY

MAX_MEMBERS = 8  # LM members the kernel's launch struct holds
# per-winner bits of the flags plane (``stats=True``)
FLAG_BND, FLAG_COMMIT, FLAG_ALIVE, FLAG_DUP = 1, 2, 4, 8

_LANES = ("text_lo", "text_hi", "p_lo", "p_hi", "p_len", "last_tok", "n_words")

Replayed = Tuple[Dict[str, torch.Tensor], torch.Tensor, torch.Tensor, Optional[torch.Tensor]]


def replay_keys(n_lms: int, use_hot: bool) -> List[str]:
    """The beam-state planes the replay reads and writes."""
    keys = list(_LANES) + ["force", "logit", "fused", "ring_lo", "ring_hi"]
    for i in range(n_lms):
        keys += [f"p_node{i}", f"p_flags{i}", f"ctx{i}", f"ctx_len{i}", f"ctx_bo{i}"]
    if use_hot:
        keys += ["h_node", "h_bits"]
    return keys


def beam_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[n, idx[n, j], ...]`` for ``x`` ``[N, B, ...]`` and ``idx`` ``[N, B']``."""
    if x.dim() == 2:
        return x.gather(1, idx)
    return x.gather(1, idx[..., None].expand(-1, -1, *x.shape[2:]))


def replay_winners_ref(state: Dict[str, torch.Tensor], cm: Dict[str, torch.Tensor],
                       tok: Dict[str, torch.Tensor], win: Dict, gate: torch.Tensor, active: torch.Tensor,
                       prune_history: bool, is_bpe: bool, stats: bool,
                       out_dtypes: Tuple[torch.dtype, torch.dtype]) -> Replayed:
    """Plain version of :func:`replay_winners` (any device)."""
    n, b = state["logit"].shape
    device = state["logit"].device
    iota_b = torch.arange(b, device=device)
    sentinel = (-2 - iota_b).expand(n, b)
    use_hot = "h_node" in state
    lmax = int(tok["raw_chars"].shape[1])
    ring_width = state["ring_lo"].shape[2]
    new_state: Dict[str, torch.Tensor] = {}
    if "order" in win:
        # ---- top-B; positional fields by gather
        k = win["toks"].shape[1]
        top_scores, top_idx = win["score"][:, :b], win["order"][:, :b]
        tok_col = top_idx // b
        top_parent = top_idx % b
        src_w = win["src"].reshape(n, k * b).gather(1, top_idx).to(torch.int64)
        top_logit = win["merged"].reshape(n, k * b).gather(1, top_idx)
        parent = src_w % b  # newest-wins, backtrace only
        flat_w = top_parent * k + tok_col
        ent_w = [e.reshape(n, b * k).gather(1, flat_w) for e in win["ent"]]
        if use_hot:
            h_w = win["h_ent"].reshape(n, b * k).gather(1, flat_w)
        tok_w = win["toks"].gather(1, tok_col)
    else:
        # pooled winners (a timeline step) may carry tokens from earlier
        # chunks of the frame: token planes resolve by full-vocabulary id
        top_scores, top_parent, parent, top_logit = win["score"], win["parent"], win["bp"], win["logit"]
        ent_w, h_w = win["ent"], win.get("h_ent")
        tok_w = win["tok"].clamp(min=0)
    sel_alive = top_scores > DEAD_THRESH
    for i, e in enumerate(ent_w):
        new_state[f"p_node{i}"] = e & DeviceLM.NODE_MASK
        new_state[f"p_flags{i}"] = e & ~DeviceLM.NODE_MASK
    if use_hot:
        new_state["h_node"] = h_w & HOT_NODE_MASK
        new_state["h_bits"] = h_w & ~HOT_NODE_MASK

    # ---- transition replay for the winners: every other field is a
    # deterministic function of (parent beam, token)
    bsel = {
        key: beam_rows(state[key], top_parent)
        for key in ("text_lo", "text_hi", "p_lo", "p_hi", "p_len", "last_tok",
                    "force", "fused", "n_words", "ring_lo", "ring_hi")
    }
    m_wfused = beam_rows(cm["word_fused"], top_parent)
    kind_w = tok["kind"][tok_w]
    blank_w = kind_w == KIND_BLANK
    boundary_w = kind_w == KIND_BOUNDARY
    cid_w = tok["raw_chars"][tok_w]  # [N, B, lmax]
    seed_lo_w = tok["seed_lo"][tok_w]
    seed_hi_w = tok["seed_hi"][tok_w]
    plen_w = tok["piece_len"][tok_w]
    rlen_w = tok["raw_len"][tok_w]
    right_w = tok["right_bound"][tok_w]
    commit_w = bsel["p_len"] > 0
    mt_lo, mt_hi = hash_text_commit_t(bsel["text_lo"], bsel["text_hi"], bsel["p_lo"], bsel["p_hi"])
    stay_w = blank_w | (bsel["last_tok"] == tok_w)
    if is_bpe:
        bnd_w = ~stay_w & (boundary_w | bsel["force"])
    else:
        bnd_w = ~stay_w & boundary_w
    ext_lo_w, ext_hi_w = bsel["p_lo"], bsel["p_hi"]
    for l in range(lmax):
        c_w = cid_w[..., l]
        nlo_w, nhi_w = hash_extend_char_t(ext_lo_w, ext_hi_w, c_w.clamp(min=0))
        ext_lo_w = torch.where(c_w >= 0, nlo_w, ext_lo_w)
        ext_hi_w = torch.where(c_w >= 0, nhi_w, ext_hi_w)
    new_state["p_lo"] = torch.where(
        stay_w, bsel["p_lo"], torch.where(bnd_w, seed_lo_w, ext_lo_w)
    )
    new_state["p_hi"] = torch.where(
        stay_w, bsel["p_hi"], torch.where(bnd_w, seed_hi_w, ext_hi_w)
    )
    new_state["p_len"] = torch.where(
        stay_w,
        bsel["p_len"],
        torch.where(bnd_w, plen_w, bsel["p_len"] + rlen_w),
    )
    m_text_lo = torch.where(commit_w, mt_lo, bsel["text_lo"])
    m_text_hi = torch.where(commit_w, mt_hi, bsel["text_hi"])
    new_state["text_lo"] = torch.where(bnd_w, m_text_lo, bsel["text_lo"])
    new_state["text_hi"] = torch.where(bnd_w, m_text_hi, bsel["text_hi"])
    new_state["fused"] = bsel["fused"] + torch.where(bnd_w, m_wfused, 0.0)
    new_state["n_words"] = torch.where(bnd_w, bsel["n_words"] + commit_w.to(torch.int64), bsel["n_words"])
    new_state["force"] = torch.where(bnd_w, right_w != 0, bsel["force"])
    bnd2 = bnd_w[..., None]
    c2 = (commit_w & bnd_w)[..., None]
    new_state["ring_lo"] = torch.where(
        c2, torch.cat([bsel["ring_lo"][..., 1:], bsel["p_lo"][..., None]], dim=-1), bsel["ring_lo"]
    )
    new_state["ring_hi"] = torch.where(
        c2, torch.cat([bsel["ring_hi"][..., 1:], bsel["p_hi"][..., None]], dim=-1), bsel["ring_hi"]
    )
    for i in range(len(ent_w)):
        for key in (f"ctx{i}", f"ctx_len{i}", f"ctx_bo{i}"):
            c_val = beam_rows(state[key], top_parent)
            m_val = beam_rows(cm[key], top_parent)
            new_state[key] = torch.where(bnd2 if c_val.dim() == 3 else bnd_w, m_val, c_val)
    token_sel = tok_w  # == toks[src // b] by construction
    new_state["logit"] = torch.where(sel_alive, top_logit, DEAD)
    new_state["last_tok"] = torch.where(sel_alive, tok_w, sentinel)

    dup_h = torch.zeros_like(sel_alive)
    if prune_history:
        # fold (partial, last token, word count, history ring) into two
        # mixed 32-bit lanes; dedup B x B, the older beam survives
        nw_cap = new_state["n_words"].clamp(max=ring_width)
        nw_cap = nw_cap | (new_state["force"].to(torch.int64) << 16)
        last_u = new_state["last_tok"] & M32
        hk_lo = mix4_t(new_state["p_lo"], new_state["p_hi"], last_u, nw_cap)
        hk_hi = mix4_t(new_state["p_hi"], new_state["p_lo"], nw_cap, last_u ^ 0x9E3779B9)
        for i in range(ring_width):
            hk_lo = mix4_t(hk_lo, new_state["ring_lo"][..., i], new_state["ring_hi"][..., i], 2 * i + 1)
            hk_hi = mix4_t(hk_hi, new_state["ring_hi"][..., i], new_state["ring_lo"][..., i], 2 * i + 2)
        eq = (hk_lo[:, :, None] == hk_lo[:, None, :]) & (hk_hi[:, :, None] == hk_hi[:, None, :])
        lower = torch.tril(torch.ones((b, b), dtype=torch.bool, device=device), diagonal=-1)
        dup_h = (eq & lower).any(dim=2)
        new_state["logit"] = torch.where(dup_h, DEAD, new_state["logit"])
        new_state["last_tok"] = torch.where(dup_h, sentinel, new_state["last_tok"])
    flags = None
    if stats:
        flags = (bnd_w.to(torch.int32) * FLAG_BND + commit_w.to(torch.int32) * FLAG_COMMIT
                 + sel_alive.to(torch.int32) * FLAG_ALIVE + dup_h.to(torch.int32) * FLAG_DUP)

    # gated rows (padded steps, a timeline's non-final chunks) pass state
    # through untouched and emit identity backpointers: token -3 (the carry
    # marker) where the row is active, -1 where it is not
    out_state = {}
    for key, old in state.items():
        g = gate.view((n,) + (1,) * (old.dim() - 1))
        out_state[key] = torch.where(g, new_state[key], old)
    parent = torch.where(gate[:, None], parent, iota_b)
    token_sel = torch.where(gate[:, None], token_sel, -3)
    token_sel = torch.where(active[:, None], token_sel, -1)
    return out_state, parent.to(out_dtypes[0]), token_sel.to(out_dtypes[1]), flags


# --------------------------------------------------------------------------
# the kernel's launch struct (``csrc/replay.cu`` ``ReplayArgs``)
# --------------------------------------------------------------------------
_P = ctypes.c_void_p


class _Member(ctypes.Structure):
    _fields_ = [(name, _P) for name in (
        "p_node", "p_flags", "ctx", "ctx_len", "ctx_bo", "cm_ctx", "cm_ctx_len", "cm_ctx_bo", "ent",
        "o_p_node", "o_p_flags", "o_ctx", "o_ctx_len", "o_ctx_bo")] + [("w", ctypes.c_int)]


_ARG_PTRS = (
    "text_lo", "text_hi", "p_lo", "p_hi", "p_len", "last_tok", "n_words", "ring_lo", "ring_hi",
    "h_node", "h_bits", "force", "logit", "fused", "cm_wfused",
    "o_text_lo", "o_text_hi", "o_p_lo", "o_p_hi", "o_p_len", "o_last_tok", "o_n_words", "o_ring_lo",
    "o_ring_hi", "o_h_node", "o_h_bits", "o_force", "o_logit", "o_fused",
    "kind", "piece_len", "raw_chars", "raw_len", "seed_lo", "seed_hi", "right_bound",
    "order", "score", "src", "merged", "toks", "w_parent", "w_bp", "w_tok", "w_logit", "h_ent",
    "gate", "active", "parent_out", "token_out", "flags",
)
_ARG_INTS = ("n", "b", "k", "m_stride", "lmax", "ring", "n_lms", "is_bpe", "prune_history",
             "par_bytes", "tok_bytes")


class _ReplayArgs(ctypes.Structure):
    _fields_ = ([(name, _P) for name in _ARG_PTRS] + [("m", _Member * MAX_MEMBERS)]
                + [("node_mask", ctypes.c_int64), ("hot_node_mask", ctypes.c_int64)]
                + [(name, ctypes.c_int) for name in _ARG_INTS])


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    """Build (first use) and load ``csrc/replay.cu``; declare its C signature; check the struct's size."""
    from ..csrc.build import load

    lib = load("replay.cu")
    lib.replay_winners_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.replay_winners_launch.restype = ctypes.c_int
    lib.replay_args_size.argtypes = []
    lib.replay_args_size.restype = ctypes.c_int
    if lib.replay_args_size() != ctypes.sizeof(_ReplayArgs):
        raise RuntimeError(f"replay_winners: launch struct of {ctypes.sizeof(_ReplayArgs)} bytes here, "
                           f"{lib.replay_args_size()} in csrc/replay.cu")
    return lib


def replay_winners(state: Dict[str, torch.Tensor], cm: Dict[str, torch.Tensor], tok: Dict[str, torch.Tensor],
                   win: Dict, gate: torch.Tensor, active: torch.Tensor, prune_history: bool, is_bpe: bool,
                   stats: bool, out_dtypes: Tuple[torch.dtype, torch.dtype]) -> Replayed:
    """The winners' new beam state and the step's backpointers ``[N, B]``, bit-exact.

    ``state``: exactly the planes :func:`replay_keys` names, ``[N, B]``
    int64 lanes and counters, ``force`` bool, ``logit`` / ``fused`` f32,
    ``ring_lo`` / ``ring_hi`` int64 ``[N, B, R]``, per member ``ctx{i}``
    int64 and ``ctx_bo{i}`` f32 ``[N, B, w_i]``; ``cm``: the commit's
    ``word_fused`` f32 ``[N, B]`` and each member's ``ctx{i}`` /
    ``ctx_len{i}`` / ``ctx_bo{i}``, shaped as the state's; ``tok``: the
    token tables (``kind``, ``piece_len``, ``raw_len``, ``seed_lo``,
    ``seed_hi`` int64 ``[V]``, ``raw_chars`` int64 ``[V, lmax]``,
    ``right_bound`` int32 ``[V]``).

    ``win``, a dense step's ranking: ``order`` int64 and ``score`` f32
    ``[N, M]`` (the stable descending sort of the ``[N, K * B]`` scores,
    ``M >= B``: the first B are read), ``src`` int32 and ``merged`` f32
    ``[N, K, B]`` (the merge kernel's), ``toks`` int64 ``[N, K]``, ``ent``
    one int64 ``[N, B, K]`` packed trie entry plane a member, ``h_ent``
    (``[N, B, K]``, or None without hotwords). Or pooled winners: ``parent``,
    ``bp`` (backtrace parent), ``tok`` (-1 at dead lanes) int64, ``logit``
    and ``score`` f32, each ``[N, B]``, ``ent`` / ``h_ent`` ``[N, B]``.

    ``gate`` / ``active``: bool ``[N]``. Returns ``(state', parent, token,
    flags)``: the new planes (``state``'s keys), the backpointers in
    ``out_dtypes`` (the logs' types, ``LOG_DTYPES``), and with ``stats`` the int32
    ``[N, B]`` ``FLAG_*`` bits of each winner (None without).

    Contract: every index (``order``, ``parent``, tokens, ``src``) is in
    range, as the engine's are by construction; the kernel does not check.
    """
    n, b = state["logit"].shape
    dev = state["logit"].device
    n_lms = len(win["ent"])
    use_hot = "h_node" in state
    if sorted(state) != sorted(replay_keys(n_lms, use_hot)):
        raise ValueError(f"state: expected the planes {replay_keys(n_lms, use_hot)}, got {sorted(state)}")
    if use_hot != (win.get("h_ent") is not None):
        raise ValueError("win: give h_ent exactly when the state has hotword planes")
    if b > MAX_BEAM:
        raise ValueError(f"replay_winners: beam width {b} exceeds {MAX_BEAM}")
    if any(dt not in LOG_DTYPES for dt in out_dtypes):
        raise TypeError(f"out_dtypes: expected two of {LOG_DTYPES}, got {out_dtypes}")
    ring = state["ring_lo"].shape[-1]
    lmax = tok["raw_chars"].shape[-1]
    vocab = tok["kind"].shape[0]
    i64, f32 = torch.int64, torch.float32
    # (launch struct field, member or None, tensor, dtype, shape): checked, then the kernel's
    planes = [(key, None, state[key], i64, (n, b)) for key in _LANES]
    planes += [("force", None, state["force"], torch.bool, (n, b)),
               ("logit", None, state["logit"], f32, (n, b)), ("fused", None, state["fused"], f32, (n, b)),
               ("ring_lo", None, state["ring_lo"], i64, (n, b, ring)),
               ("ring_hi", None, state["ring_hi"], i64, (n, b, ring)),
               ("cm_wfused", None, cm["word_fused"], f32, (n, b)),
               ("raw_chars", None, tok["raw_chars"], i64, (vocab, lmax)),
               ("right_bound", None, tok["right_bound"], torch.int32, (vocab,)),
               ("gate", None, gate, torch.bool, (n,)), ("active", None, active, torch.bool, (n,))]
    planes += [(key, None, tok[key], i64, (vocab,)) for key in ("kind", "piece_len", "raw_len", "seed_lo", "seed_hi")]
    if use_hot:
        planes += [(key, None, state[key], i64, (n, b)) for key in ("h_node", "h_bits")]
    widths = [state[f"ctx{i}"].shape[-1] for i in range(n_lms)]
    for i, w in enumerate(widths):
        planes += [("p_node", i, state[f"p_node{i}"], i64, (n, b)), ("p_flags", i, state[f"p_flags{i}"], i64, (n, b))]
        for name, dtype, shape in (("ctx", i64, (n, b, w)), ("ctx_len", i64, (n, b)), ("ctx_bo", f32, (n, b, w))):
            planes += [(name, i, state[f"{name}{i}"], dtype, shape), ("cm_" + name, i, cm[f"{name}{i}"], dtype, shape)]
    if "order" in win:
        k = win["toks"].shape[-1]
        m_stride = win["order"].shape[-1]
        if m_stride < b:
            raise ValueError(f"win order: expected [{n}, M >= {b}], got {tuple(win['order'].shape)}")
        planes += [("order", None, win["order"], i64, (n, m_stride)), ("score", None, win["score"], f32, (n, m_stride)),
                   ("src", None, win["src"], torch.int32, (n, k, b)), ("merged", None, win["merged"], f32, (n, k, b)),
                   ("toks", None, win["toks"], i64, (n, k))]
        ent_shape: Tuple[int, ...] = (n, b, k)
    else:
        k, m_stride = 1, b
        planes += [("w_parent", None, win["parent"], i64, (n, b)), ("w_bp", None, win["bp"], i64, (n, b)),
                   ("w_tok", None, win["tok"], i64, (n, b)), ("w_logit", None, win["logit"], f32, (n, b)),
                   ("score", None, win["score"], f32, (n, b))]
        ent_shape = (n, b)
    planes += [("ent", i, e, i64, ent_shape) for i, e in enumerate(win["ent"])]
    if use_hot:
        planes.append(("h_ent", None, win["h_ent"], i64, ent_shape))
    for field, member, t, dtype, shape in planes:
        _check(field if member is None else f"{field}{member}", t, dtype, shape, dev)
    if dev.type == "cpu":
        return replay_winners_ref(state, cm, tok, win, gate, active, prune_history, is_bpe, stats, out_dtypes)
    _launch_device(dev)
    if n_lms > MAX_MEMBERS:
        raise ValueError(f"replay_winners: the kernel takes at most {MAX_MEMBERS} LM members, got {n_lms}")
    out = {key: torch.empty_like(val) for key, val in state.items()}
    parent = torch.empty((n, b), dtype=out_dtypes[0], device=dev)
    token = torch.empty((n, b), dtype=out_dtypes[1], device=dev)
    flags = torch.empty((n, b), dtype=torch.int32, device=dev) if stats else None
    if n == 0:
        return out, parent, token, flags
    args = _ReplayArgs()
    for field, member, t, _, _ in planes:
        setattr(args if member is None else args.m[member], field, _ptr(t))
    for key in out:
        if key[-1].isdigit() and not key.startswith("ring"):  # a member's plane
            name, i = key.rstrip("0123456789"), int(key[len(key.rstrip("0123456789")):])
            setattr(args.m[i], "o_" + name, _ptr(out[key]))
        else:
            setattr(args, "o_" + key, _ptr(out[key]))
    for i, w in enumerate(widths):
        args.m[i].w = w
    args.parent_out, args.token_out = _ptr(parent), _ptr(token)
    if stats:
        args.flags = _ptr(flags)
    args.node_mask, args.hot_node_mask = DeviceLM.NODE_MASK, HOT_NODE_MASK
    args.n, args.b, args.k, args.m_stride, args.lmax, args.ring, args.n_lms = n, b, k, m_stride, lmax, ring, n_lms
    args.is_bpe, args.prune_history = int(bool(is_bpe)), int(bool(prune_history))
    args.par_bytes, args.tok_bytes = parent.element_size(), token.element_size()
    _launch("replay_winners", dev, _library().replay_winners_launch, ctypes.byref(args))
    replay_winners.launches += 1
    return out, parent, token, flags


replay_winners.launches = 0
