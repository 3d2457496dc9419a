"""The engine step's trie walk and partial score: one CUDA kernel and its plain twin.

:func:`walk_partial` answers, for every candidate of a decode step (utterance
``n``, beam ``b``, token column ``k``), where the candidate's partial word
stands in each LM member's trie and in the hotword trie, and what the
partial word scores:

* the transition class from the beam's last token and the token's kind:
  a blank or a repeat stays, a boundary token (and with a BPE alphabet any
  token after a right-bounded piece, the beam's ``force``) starts a word;
* the packed entry (node id | ``BIT_*`` flags) each trie reaches: the
  beam's own where it stays, the token's piece seed at a boundary, and
  otherwise the beam's node walked over the label's letters, the first
  from the beam's fetched trie row, each later one from the trie plane;
  the hot trie the same way;
* the partial word's length and its score (``score_partial_token``):
  the hotword completion score on a hotword prefix, else the members'
  averaged unknown-prefix penalty, scaled past ``AVG_TOKEN_LEN`` letters.

The JAX reference computes this as XLA's lowering of its ``_make_step``'s
partial-word extension walk (``engine.py:946`` onward), its
``_decode_trie_cells`` (``:730``) and ``_partial_score`` (``:794``); no
Pallas kernel. The port ran it as about 40 small kernels a step for a
one-letter alphabet and about 30 more for each further letter a label can
have (w2v2's ``</s>``: 4 levels; BPE pieces: 5), each over the ``[N, B, K]``
candidates and each bound by its launch.

What bounds it on the H100: launch latency and a chain of dependent loads,
not bytes. A 32 x 100 char step reads a trie slot word or two a letter
walked and writes one int64 entry plane a member and the f32 scores (about
1.5 MB, under 0.5 us at 3.35 TB/s); BPE's 129 tokens write about 5 MB. The
kernel (``csrc/walk.cu``) runs one thread a candidate, a warp over 32 beam
rows of one token: the warp's letters and loop bound are the token's own, so
a one-letter label stops after one level. Each level issues every member's
and the hot trie's loads before reading any. It rounds every f32 operation
as PyTorch's CUDA kernels round the twin's, in the same order, so it equals
the twin on the card to the bit: a true division by a host scalar (the
``AVG_TOKEN_LEN`` scaling, the members' mean) multiplies by the scalar's f32
reciprocal there, a division of two tensors (the hotword score) divides.

The kernel takes up to :data:`MAX_MEMBERS` members, with or without
hotwords (:func:`walk_kernel_fits`); the trie planes are whole on every
process, so row-sharded n-gram tables change nothing here. On CPU tensors
:func:`walk_partial` runs :func:`walk_partial_ref`; on CUDA tensors it
launches the kernel or raises. ``walk_partial.launches`` counts kernel
launches.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..constants import AVG_TOKEN_LEN
from ..models.device_tables import HOT_MINCOMP_MAX, HOT_MINCOMP_SHIFT, HOT_NODE_MASK, DeviceLM
from .commit import _scalar
from .hashing import M32
from .merge import _check, _launch, _launch_device, _ptr
from .tokens import KIND_BLANK, KIND_BOUNDARY

MAX_MEMBERS = 8  # LM members the kernel's launch struct holds

_NODE_MASK = DeviceLM.NODE_MASK
_BIT_UNI_PREFIX = DeviceLM.BIT_UNI_PREFIX

Walked = Tuple[List[torch.Tensor], Optional[torch.Tensor], torch.Tensor]


# --------------------------------------------------------------------------
# the plain PyTorch composition
# --------------------------------------------------------------------------
def _decode_trie_cells(tp: Dict[str, int], fc, word, cid):
    """Packed trie cell -> packed child entry (node id | ``BIT_*`` flags).

    Children are stored as ``rank`` among the node's BFS-contiguous children
    plus the child's 3 flag bits, ``cpw`` cells per i32 word (see
    ``device_tables.trie_pack_params``): ``child = first_child + rank``; an
    all-ones rank means no child and resolves to the dead node.
    """
    rb, cpw = tp["rb"], tp["cpw"]
    bpc = rb + 3
    shift = (cid % cpw) * bpc
    cell = ((word.to(torch.int64) & M32) >> shift) & ((1 << bpc) - 1)
    rank = cell & ((1 << rb) - 1)
    flags3 = (cell >> rb) & 7
    entry = (fc.to(torch.int64) + rank) | (flags3 << 28)
    return torch.where(rank == (1 << rb) - 1, tp["dead"], entry)


def _trie_cells_at(lm: Dict, node: torch.Tensor, cid: torch.Tensor):
    """``(word, first_child)`` of ``node``'s packed trie slot for char ``cid`` (element gathers).

    The walk's later characters: after the first one, the node differs per
    (beam, token), so each reads its two words of the plane on its own. The
    slot geometry comes from ``trie_pack``.
    """
    tp = lm["trie_pack"]
    rows = lm["trie_rows"]
    base = (node // tp["pack"]) * rows.shape[1] + (node % tp["pack"]) * tp["stride"]
    flat = rows.reshape(-1)
    return flat[base + 1 + cid // tp["cpw"]], flat[base]


def partial_score(n_lms: int, hot: Optional[Dict], prm: Dict,
                  flag_list: List[torch.Tensor], h_entry: Optional[torch.Tensor], plen):
    """score_partial_token for in-progress words, from the packed entry bits.

    Hotword-prefix partials take the hotword completion score, weight x
    length / shortest completion (ref decoder.py:410-418,
    language_model.py:141-150); every other partial the member-averaged LM
    score: 0 on the prefix of a known unigram, else the unknown-prefix
    penalty, scaled up past ``AVG_TOKEN_LEN`` chars (ref
    language_model.py:326-336, 478-481). ``h_entry`` is the packed hot
    entry (node | bits), or None without hotwords (``hot`` None).
    """
    plen_f = plen.to(torch.float32)
    acc = None
    for i in range(n_lms):
        is_pref = (flag_list[i] & _BIT_UNI_PREFIX) != 0
        punk = prm["lm"][i]["unk_offset"] * (~is_pref).to(torch.float32)
        punk = torch.where(plen > AVG_TOKEN_LEN, punk * plen_f / AVG_TOKEN_LEN, punk)
        acc = punk if acc is None else acc + punk
    if acc is None:
        lm_part = torch.zeros(plen.shape, dtype=torch.float32, device=plen.device)
    else:
        if n_lms > 1:
            acc = acc / n_lms
        lm_part = torch.where(plen > 0, acc, 0.0)
    if hot is None:
        return lm_part
    hot_pref = ((h_entry & HOT_NODE_MASK) != hot["dead"]) & (plen > 0)
    min_comp = (h_entry >> HOT_MINCOMP_SHIFT) & HOT_MINCOMP_MAX
    hot_part = prm["hot_weight"] * plen_f / min_comp.clamp(min=1).to(torch.float32)
    return torch.where(hot_pref, hot_part, lm_part)


def walk_partial_ref(lms: List[Dict], hot: Optional[Dict], prm: Dict, state: Dict, toks: torch.Tensor,
                     tok: Dict, trie_rows: List[torch.Tensor], is_bpe: bool) -> Walked:
    """Plain version of :func:`walk_partial` (any device; any member count)."""
    n, b = state["p_len"].shape
    k = toks.shape[1]
    n_lms, use_hot = len(lms), hot is not None
    if not (n_lms or use_hot):
        return [], None, torch.zeros((n, k, b), dtype=torch.float32, device=toks.device)
    lmax = int(tok["raw_chars"].shape[1])  # longest label, in chars
    tok_kind = tok["kind"][toks]  # [N, K]
    tok_plen = tok["piece_len"][toks]
    tok_rlen = tok["raw_len"][toks]
    cids = tok["raw_chars"][toks]  # [N, K, lmax], -1 past the label's end
    blank = tok_kind == KIND_BLANK
    boundary_kind = tok_kind == KIND_BOUNDARY

    # ---- transition classes [N, B, K]
    stay = blank[:, None, :] | (state["last_tok"][:, :, None] == toks[:, None, :])
    if is_bpe:
        # after a right-bounded piece every token that does not stay starts a word
        as_boundary = ~stay & (boundary_kind[:, None, :] | state["force"][:, :, None])
    else:
        as_boundary = ~stay & boundary_kind[:, None, :]
    p_entry_n: List[torch.Tensor] = []  # per member: packed trie entry [N, B, K]
    h_entry_n = None  # packed hot entry [N, B, K]
    # extension walk over the label's chars; an entry stays put past the label's end
    cur_n = [(state[f"p_node{i}"] | state[f"p_flags{i}"])[..., None] for i in range(n_lms)]
    ext_n = [c.expand(n, b, k) for c in cur_n]
    h_cur = (state["h_node"] | state["h_bits"])[..., None] if use_hot else None
    h_ext = h_cur.expand(n, b, k) if use_hot else None
    for l in range(lmax):
        cid = cids[..., l]
        has = (cid >= 0)[:, None, :]
        cid_safe = cid.clamp(min=0)[:, None, :]
        for i, lm in enumerate(lms):
            tp = lm["trie_pack"]
            if l == 0:
                # the first char from the beam's own row [N, B, W]
                rows = trie_rows[i]
                col = (1 + cid_safe // tp["cpw"]).expand(n, b, k)
                word, fc = rows.gather(2, col), rows[..., 0:1]
            else:
                word, fc = _trie_cells_at(lm, ext_n[i] & _NODE_MASK, cid_safe)
            ext_n[i] = torch.where(has, _decode_trie_cells(tp, fc, word, cid_safe), ext_n[i])
        if use_hot:
            if l == 0:  # the beam's hot-trie row, then the token's char column
                h_ent = hot["next"][state["h_node"]].gather(2, cid_safe.expand(n, b, k))
            else:
                h_ent = hot["next"][h_ext & HOT_NODE_MASK, cid_safe]
            h_ext = torch.where(has, h_ent, h_ext)

    def walked(cur, seed_entry, ent):
        return torch.where(stay, cur, torch.where(as_boundary, seed_entry, ent))

    for i, lm in enumerate(lms):
        p_entry_n.append(walked(cur_n[i], lm["seed_node"][toks][:, None, :], ext_n[i]))
    if use_hot:
        h_entry_n = walked(h_cur, hot["seed"][toks][:, None, :], h_ext)
    p_len = state["p_len"][..., None]
    p_len_n = torch.where(
        stay, p_len,
        torch.where(as_boundary, tok_plen[:, None, :], p_len + tok_rlen[:, None, :]),
    )
    pscore = partial_score(n_lms, hot, prm, [e & ~_NODE_MASK for e in p_entry_n], h_entry_n, p_len_n)
    return p_entry_n, h_entry_n, pscore.transpose(1, 2).contiguous()  # [N, K, B]


def walk_kernel_fits(lms: Sequence[Dict]) -> bool:
    """Whether :func:`walk_partial`'s kernel takes these members: up to :data:`MAX_MEMBERS`."""
    return len(lms) <= MAX_MEMBERS


# --------------------------------------------------------------------------
# the kernel's launch struct (``csrc/walk.cu`` ``WalkArgs``)
# --------------------------------------------------------------------------
_P = ctypes.c_void_p


class _WalkMember(ctypes.Structure):
    _fields_ = ([(name, _P) for name in ("row", "plane", "p_node", "p_flags", "seed", "unk_offset", "o_ent")]
                + [("dead", ctypes.c_int64), ("unk_offset_v", ctypes.c_float)]
                + [(name, ctypes.c_int) for name in ("row_w", "plane_w", "rb", "cpw", "pack", "stride")])


_ARG_PTRS = ("toks", "last_tok", "force", "p_len", "h_node", "h_bits", "hot_next", "hot_seed", "hot_weight",
             "kind", "piece_len", "raw_len", "raw_chars", "o_h_ent", "o_pscore")
_ARG_INTS = ("n", "b", "k", "lmax", "hot_c", "n_lms", "is_bpe")


class _WalkArgs(ctypes.Structure):
    _fields_ = ([("m", _WalkMember * MAX_MEMBERS)] + [(name, _P) for name in _ARG_PTRS]
                + [(name, ctypes.c_int64) for name in ("node_mask", "hot_node_mask", "hot_dead", "bit_uni_prefix")]
                + [("hot_weight_v", ctypes.c_float)] + [(name, ctypes.c_int) for name in _ARG_INTS])


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    """Build (first use) and load ``csrc/walk.cu``; declare its C signature; check the struct's size."""
    from ..csrc.build import load

    lib = load("walk.cu")
    lib.walk_partial_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.walk_partial_launch.restype = ctypes.c_int
    lib.walk_args_size.argtypes = []
    lib.walk_args_size.restype = ctypes.c_int
    if lib.walk_args_size() != ctypes.sizeof(_WalkArgs):
        raise RuntimeError(f"walk_partial: launch struct of {ctypes.sizeof(_WalkArgs)} bytes here, "
                           f"{lib.walk_args_size()} in csrc/walk.cu")
    return lib


def walk_partial(lms: List[Dict], hot: Optional[Dict], prm: Dict, state: Dict, toks: torch.Tensor,
                 tok: Dict, trie_rows: List[torch.Tensor], is_bpe: bool) -> Walked:
    """Every candidate's trie entries and partial score, one launch, bit-exact.

    ``lms``: the members' device table dicts
    (:meth:`~pyctcdecode_torch.models.device_tables.DeviceLM.as_device`:
    ``trie_rows``, ``trie_pack``, ``seed_node``); ``hot``: the call's
    hotword trie (``next`` int64 ``[nodes, chars]``, ``seed`` int64 ``[V]``,
    ``dead``), or None without hotwords; ``prm``: the engine's unpacked
    parameters (each member's ``unk_offset`` and ``hot_weight``: Python
    numbers, or 0-d f32 tensors on the device); ``state``: the beam state,
    of which it reads ``last_tok``, ``p_len`` int64 and ``force`` bool
    ``[N, B]``, per member ``p_node{i}`` / ``p_flags{i}`` and with hotwords
    ``h_node`` / ``h_bits`` int64 ``[N, B]``; ``toks``: the step's token of
    each column, int64 ``[N, K]``; ``tok``: the token tables (``kind``,
    ``piece_len``, ``raw_len`` int64 ``[V]``, ``raw_chars`` int64 ``[V,
    lmax]``); ``trie_rows``: each member's fetched trie rows, int32 ``[N, B,
    W]``.

    Returns ``(ent, h_ent, pscore)``: one packed trie entry plane a member,
    int64 ``[N, B, K]``; the hot entries ``[N, B, K]`` (None without
    hotwords); the partial scores, f32 ``[N, K, B]``.

    Contract: tokens, nodes and chars are in range, as the engine's are by
    construction; the kernel does not check.
    """
    n, b = state["p_len"].shape
    k = toks.shape[-1]
    dev = state["p_len"].device
    i64 = torch.int64
    use_hot = hot is not None
    if len(trie_rows) != len(lms) or len(prm["lm"]) < len(lms):
        raise ValueError(f"walk_partial: {len(lms)} members, {len(trie_rows)} trie row planes, "
                         f"{len(prm['lm'])} members' parameters")
    vocab, lmax = tok["raw_chars"].shape
    planes = [("toks", toks, i64, (n, k)), ("last_tok", state["last_tok"], i64, (n, b)),
              ("p_len", state["p_len"], i64, (n, b)), ("force", state["force"], torch.bool, (n, b)),
              ("raw_chars", tok["raw_chars"], i64, (vocab, lmax))]
    planes += [(key, tok[key], i64, (vocab,)) for key in ("kind", "piece_len", "raw_len")]
    if use_hot:
        planes += [(key, state[key], i64, (n, b)) for key in ("h_node", "h_bits")]
        planes += [("hot['next']", hot["next"], i64, None), ("hot['seed']", hot["seed"], i64, (vocab,))]
    for i, lm in enumerate(lms):
        planes += [(f"p_node{i}", state[f"p_node{i}"], i64, (n, b)), (f"p_flags{i}", state[f"p_flags{i}"], i64, (n, b)),
                   (f"trie_rows[{i}]", trie_rows[i], torch.int32, (n, b, trie_rows[i].shape[-1])),
                   (f"lms[{i}]['trie_rows']", lm["trie_rows"], torch.int32, None),
                   (f"lms[{i}]['seed_node']", lm["seed_node"], i64, (vocab,))]
    for name, t, dtype, shape in planes:
        _check(name, t, dtype, shape, dev)
    if dev.type == "cpu":
        return walk_partial_ref(lms, hot, prm, state, toks, tok, trie_rows, is_bpe)
    _launch_device(dev)
    if not walk_kernel_fits(lms):
        raise ValueError(f"walk_partial: the kernel takes up to {MAX_MEMBERS} LM members, got {len(lms)}; "
                         f"run walk_partial_ref")
    ent = [torch.empty((n, b, k), dtype=i64, device=dev) for _ in lms]
    h_ent = torch.empty((n, b, k), dtype=i64, device=dev) if use_hot else None
    pscore = torch.empty((n, k, b), dtype=torch.float32, device=dev)
    if n * b * k == 0:
        return ent, h_ent, pscore

    args = _WalkArgs()
    for i, lm in enumerate(lms):
        tp = lm["trie_pack"]
        m = args.m[i]
        m.row, m.plane = _ptr(trie_rows[i]), _ptr(lm["trie_rows"])
        m.p_node, m.p_flags = _ptr(state[f"p_node{i}"]), _ptr(state[f"p_flags{i}"])
        m.seed, m.o_ent = _ptr(lm["seed_node"]), _ptr(ent[i])
        m.unk_offset, m.unk_offset_v = _scalar(f"prm['lm'][{i}]['unk_offset']", prm["lm"][i]["unk_offset"], dev)
        m.dead = int(tp["dead"])
        m.row_w, m.plane_w = trie_rows[i].shape[-1], lm["trie_rows"].shape[-1]
        m.rb, m.cpw, m.pack, m.stride = tp["rb"], tp["cpw"], tp["pack"], tp["stride"]
    for name, t in (("toks", toks), ("last_tok", state["last_tok"]), ("force", state["force"]),
                    ("p_len", state["p_len"]), ("kind", tok["kind"]), ("piece_len", tok["piece_len"]),
                    ("raw_len", tok["raw_len"]), ("raw_chars", tok["raw_chars"]), ("o_pscore", pscore)):
        setattr(args, name, _ptr(t))
    if use_hot:
        args.h_node, args.h_bits = _ptr(state["h_node"]), _ptr(state["h_bits"])
        args.hot_next, args.hot_seed, args.o_h_ent = _ptr(hot["next"]), _ptr(hot["seed"]), _ptr(h_ent)
        args.hot_weight, args.hot_weight_v = _scalar("prm['hot_weight']", prm["hot_weight"], dev)
        args.hot_dead, args.hot_c = int(hot["dead"]), hot["next"].shape[-1]
    args.node_mask, args.hot_node_mask, args.bit_uni_prefix = _NODE_MASK, HOT_NODE_MASK, _BIT_UNI_PREFIX
    args.n, args.b, args.k, args.lmax = n, b, k, lmax
    args.n_lms, args.is_bpe = len(lms), int(bool(is_bpe))
    _launch("walk_partial", dev, _library().walk_partial_launch, ctypes.byref(args))
    walk_partial.launches += 1
    return ent, h_ent, pscore


walk_partial.launches = 0
