"""Block-diagonal candidate merge + window prune: CUDA kernels and plain twins.

Replaces the two Pallas kernels of the JAX reference package
(its ``ops/pallas_merge.py``):

* :func:`merge_prune` <- ``merge_score_pallas`` (its single-utterance
  ``pallas_call`` and the batched-grid vmap rule, one CUDA kernel for both);
* :func:`expand_merge_prune` <- ``expand_merge_score_pallas`` (likewise).

What they compute: a candidate's merge key includes the token just applied,
so candidates collide only within one token column. Per column, the B x B
key-collision matrix gives each candidate its group logsumexp (``merged``),
whether an older member exists (``dup``) and the group's newest member
(the backtrace donor). A group-first member scores ``merged + extra``,
every other member ``DEAD``; then the window prune keeps ``score >= max
over the utterance + prune``. ``src = k * B + donor``. The expand variant
first builds the candidates from [B] parent planes and [K] token planes
(4-way transition, partial-word hash extension, keys, logits, ``extra =
(fused + word score at a boundary) + pscore``).

What bounds it on the H100: at the decode shapes (N utterances, K = 29
tokens, B = 100 beams) the inputs are a few MB, so the card's bytes bound is
about a microsecond; the pairwise work, K * B * B compare/max/exp-sum
terms per utterance, is a few tens of millions of scalar operations, also
about a microsecond at the card's float32 rate. What a launch really pays
for is how little of the card it fills and how long one column's collision
scan runs. The design (``csrc/merge.cu``) makes one (utterance, column) the
work unit: the blocks of an utterance form a thread-block cluster of 1, 2,
4 or 8 (picked from K), each block merges several columns at once, one
group of warps per column, and the utterance-wide max behind the window
prune crosses the cluster through distributed shared memory. The scan
compares one 64-bit key word per candidate into hit bitmasks and sums only
over set bits, in ascending order; scores wait for the max on chip, so
every output is written once. Tensor cores have no work here (no product).

Dtype contract (the port's lane convention): hash lanes are ``int64``
tensors holding uint32 values, flags and ids ``int32``, scores
``float32``. Every tensor is contiguous and on one device.

On CPU tensors each wrapper runs its plain PyTorch version
(:func:`merge_prune_ref`, :func:`expand_merge_prune_ref`); on CUDA tensors
it launches the kernel or raises. ``<wrapper>.launches`` counts kernel
launches. ``cluster`` forces the blocks per utterance (1, 2, 4 or 8) for
measurements; the default 0 picks it from K.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Sequence, Tuple

import torch

from .hashing import hash_extend_char_t, mix4_t

DEAD = -1.0e30
DEAD_THRESH = -1.0e29
MAX_BEAM = 1024  # one thread per beam of a column
CLUSTER_SIZES = (0, 1, 2, 4, 8)  # 0: picked from K

X_BEAM = ("text_lo", "text_hi", "cm_text_lo", "cm_text_hi", "p_lo", "p_hi",
          "force", "fused", "wfused", "logit", "last_tok")  # [N, B] planes
X_TOK = ("tok", "blank", "boundary", "right", "seed_lo", "seed_hi",
         "tok_logp", "admit")  # [N, K] planes
_LANE = {"text_lo", "text_hi", "cm_text_lo", "cm_text_hi", "p_lo", "p_hi",
         "seed_lo", "seed_hi"}
_FLOAT = {"fused", "wfused", "logit", "tok_logp"}

Outputs = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _plane_dtype(name: str) -> torch.dtype:
    if name in _LANE:
        return torch.int64
    if name in _FLOAT:
        return torch.float32
    return torch.int32


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape: Optional[Sequence[int]],
           device: torch.device) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor on ``device`` (of ``shape``, if given)."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a torch.Tensor, got {type(t).__name__}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _launch_device(device: torch.device) -> None:
    if device.type != "cuda":
        raise ValueError(
            f"the kernels run on CUDA tensors (or their plain version on CPU "
            f"tensors); got {device}"
        )


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    """Build (first use) and load ``csrc/merge.cu``; declare its C signatures."""
    from ..csrc.build import load

    lib = load("merge.cu")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.merge_prune_launch.argtypes = [vp] * 9 + [ci] * 4 + [vp]
    lib.merge_prune_launch.restype = ci
    lib.expand_merge_prune_launch.argtypes = [vp] * 25 + [ci] * 6 + [vp]
    lib.expand_merge_prune_launch.restype = ci
    return lib


def _check_cluster(cluster: int) -> None:
    if cluster not in CLUSTER_SIZES:
        raise ValueError(f"cluster: expected one of {CLUSTER_SIZES}, got {cluster}")


def _launch(what: str, dev: torch.device, launch_fn, *args) -> None:
    """Call ``launch_fn(*args, stream)`` on ``dev``'s current stream; raise on its error.

    The device guard is entered only when ``dev`` is not the current device:
    it costs more host time than the launch itself, and the decode step is
    bound by host time.
    """
    if torch.cuda.current_device() == dev.index:
        err = launch_fn(*args, ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    else:
        with torch.cuda.device(dev):
            err = launch_fn(*args, ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed (cudaError {err})")


# --------------------------------------------------------------------------
# plain PyTorch versions
# --------------------------------------------------------------------------
def merge_prune_ref(kl, kh, valid, logit, extra, prune) -> Outputs:
    """Plain version of :func:`merge_prune` (any device)."""
    n, k, b = kl.shape
    v = valid != 0
    eq = v[..., :, None] & v[..., None, :]
    eq = eq & (kl[..., :, None] == kl[..., None, :]) & (kh[..., :, None] == kh[..., None, :])
    idx = torch.arange(b, device=kl.device)
    lj = logit[..., None, :].expand(eq.shape)
    m = torch.where(eq, lj, float("-inf")).amax(dim=-1)
    first = torch.where(eq, idx, b).amin(dim=-1)
    donor = torch.where(eq, idx, -1).amax(dim=-1).clamp(min=0)
    tot = torch.where(eq, torch.exp(lj - m[..., None]), 0.0).sum(dim=-1)
    merged = m + torch.log(tot)
    rep = v & (first >= idx)
    score = torch.where(rep, merged + extra, DEAD)
    mx = score.reshape(n, -1).amax(dim=-1)
    score = torch.where(score >= (mx + prune)[:, None, None], score, DEAD)
    src = (torch.arange(k, device=kl.device)[:, None] * b + donor).to(torch.int32)
    return score, merged, src


def expand_merge_prune_ref(beam: Dict[str, torch.Tensor], tok: Dict[str, torch.Tensor],
                           cids: torch.Tensor, pscore: torch.Tensor, prune: torch.Tensor,
                           is_bpe: bool) -> Outputs:
    """Plain version of :func:`expand_merge_prune` (any device)."""

    def bb(x):  # beam plane [N, B] -> [N, 1, B]
        return x[:, None, :]

    def tk(x):  # token plane [N, K] -> [N, K, 1]
        return x[:, :, None]

    stay = (tk(tok["blank"]) != 0) | (bb(beam["last_tok"]) == tk(tok["tok"]))
    force_p = bb(beam["force"])
    if is_bpe:
        bnd = ~stay & ((tk(tok["boundary"]) != 0) | (force_p != 0))
    else:
        bnd = ~stay & (tk(tok["boundary"]) != 0)
    ext_lo, ext_hi = bb(beam["p_lo"]), bb(beam["p_hi"])
    for cid_plane in cids:
        cid = tk(cid_plane)
        has = cid >= 0
        nlo, nhi = hash_extend_char_t(ext_lo, ext_hi, cid.clamp(min=0))
        ext_lo = torch.where(has, nlo, ext_lo)
        ext_hi = torch.where(has, nhi, ext_hi)
    p_lo_n = torch.where(stay, bb(beam["p_lo"]), torch.where(bnd, tk(tok["seed_lo"]), ext_lo))
    p_hi_n = torch.where(stay, bb(beam["p_hi"]), torch.where(bnd, tk(tok["seed_hi"]), ext_hi))
    text_lo_n = torch.where(bnd, bb(beam["cm_text_lo"]), bb(beam["text_lo"]))
    text_hi_n = torch.where(bnd, bb(beam["cm_text_hi"]), bb(beam["text_hi"]))
    force_n = torch.where(bnd, tk(tok["right"]), force_p).to(torch.int64) & 0xFFFFFFFF
    logit_p = bb(beam["logit"])
    alive = logit_p > DEAD_THRESH
    logit_n = torch.where(alive, logit_p + tk(tok["tok_logp"]), DEAD)
    valid = alive & (tk(tok["admit"]) != 0)
    kl = mix4_t(text_lo_n, p_lo_n, p_hi_n, force_n)
    kh = mix4_t(text_hi_n, p_hi_n, p_lo_n, force_n)
    extra = (bb(beam["fused"]) + torch.where(bnd, bb(beam["wfused"]), 0.0)) + pscore
    return merge_prune_ref(kl, kh, valid, logit_n, extra, prune)


# --------------------------------------------------------------------------
# wrappers
# --------------------------------------------------------------------------
def merge_prune(kl: torch.Tensor, kh: torch.Tensor, valid: torch.Tensor, logit: torch.Tensor,
                extra: torch.Tensor, prune: torch.Tensor, cluster: int = 0) -> Outputs:
    """Merge + window prune of pre-keyed candidates ``[N, K, B]``.

    ``kl``/``kh`` int64 lanes, ``valid`` int32, ``logit``/``extra`` f32,
    all ``[N, K, B]``; ``prune`` f32 ``[N]``. Returns ``(score, merged,
    src)``: the window-pruned score (DEAD at duplicate or pruned members),
    the group logsumexp at every member, and ``k * B + donor`` (int32).
    """
    n, k, b = kl.shape
    dev = kl.device
    shape = (n, k, b)
    _check("kl", kl, torch.int64, shape, dev)
    _check("kh", kh, torch.int64, shape, dev)
    _check("valid", valid, torch.int32, shape, dev)
    _check("logit", logit, torch.float32, shape, dev)
    _check("extra", extra, torch.float32, shape, dev)
    _check("prune", prune, torch.float32, (n,), dev)
    if b > MAX_BEAM:
        raise ValueError(f"merge_prune: beam width {b} exceeds {MAX_BEAM}")
    _check_cluster(cluster)
    if dev.type == "cpu":
        return merge_prune_ref(kl, kh, valid, logit, extra, prune)
    _launch_device(dev)
    score = torch.empty(shape, dtype=torch.float32, device=dev)
    merged = torch.empty(shape, dtype=torch.float32, device=dev)
    src = torch.empty(shape, dtype=torch.int32, device=dev)
    if n == 0 or k == 0 or b == 0:
        return score, merged, src
    _launch(
        "merge_prune", dev, _library().merge_prune_launch,
        *(_ptr(t) for t in (kl, kh, valid, logit, extra, prune, score, merged, src)),
        n, k, b, cluster,
    )
    merge_prune.launches += 1
    return score, merged, src


merge_prune.launches = 0


def expand_merge_prune(beam: Dict[str, torch.Tensor], tok: Dict[str, torch.Tensor],
                       cids: torch.Tensor, pscore: torch.Tensor, prune: torch.Tensor,
                       is_bpe: bool, cluster: int = 0) -> Outputs:
    """Candidate expansion + merge + window prune for ``N`` utterances.

    ``beam``: the ``X_BEAM`` parent planes ``[N, B]``; ``tok``: the
    ``X_TOK`` token planes ``[N, K]``; ``cids``: int32 ``[lmax, N, K]``
    label char ids (-1 past the label's end); ``pscore``: f32 ``[N, K,
    B]`` partial-word score; ``prune``: f32 ``[N]``. Returns ``(score,
    merged, src)`` as :func:`merge_prune`, ``[N, K, B]`` token-major.
    """
    n, b = beam["logit"].shape
    k = tok["tok"].shape[1]
    dev = beam["logit"].device
    for name in X_BEAM:
        _check(name, beam[name], _plane_dtype(name), (n, b), dev)
    for name in X_TOK:
        _check(name, tok[name], _plane_dtype(name), (n, k), dev)
    lmax = cids.shape[0]
    _check("cids", cids, torch.int32, (lmax, n, k), dev)
    _check("pscore", pscore, torch.float32, (n, k, b), dev)
    _check("prune", prune, torch.float32, (n,), dev)
    if b > MAX_BEAM:
        raise ValueError(f"expand_merge_prune: beam width {b} exceeds {MAX_BEAM}")
    _check_cluster(cluster)
    if dev.type == "cpu":
        return expand_merge_prune_ref(beam, tok, cids, pscore, prune, is_bpe)
    _launch_device(dev)
    score = torch.empty((n, k, b), dtype=torch.float32, device=dev)
    merged = torch.empty((n, k, b), dtype=torch.float32, device=dev)
    src = torch.empty((n, k, b), dtype=torch.int32, device=dev)
    if n == 0 or k == 0 or b == 0:
        return score, merged, src
    args = [beam[name] for name in X_BEAM] + [tok[name] for name in X_TOK]
    args += [cids, pscore, prune, score, merged, src]
    _launch(
        "expand_merge_prune", dev, _library().expand_merge_prune_launch,
        *(_ptr(t) for t in args), n, k, b, lmax, int(bool(is_bpe)), cluster,
    )
    expand_merge_prune.launches += 1
    return score, merged, src


expand_merge_prune.launches = 0
