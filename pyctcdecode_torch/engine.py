"""Device engine: fixed-width vectorized CTC beam search over a frame loop.

The JAX reference package's ``engine.py`` keeps the whole beam state
as fixed-shape device arrays and scans a per-frame step over the frames,
``vmap``-ped over utterances. This port writes the batch dimension ``N``
out: every state plane is ``[N, B, ...]`` (``decode_beams`` is the case
``N = 1``), and the scan is a Python loop over frames. Per frame:

    1. LM commit scoring: fetch each beam's trie row, probe the n-gram
       fingerprint tables for the word it would commit (``_commit_quantities``);
    2-3. walk every candidate's partial word through the tries and score
       it — the hand-written CUDA kernel
       :func:`~pyctcdecode_torch.ops.walk.walk_partial`; expand B beams x K
       tokens (4-way CTC transition), merge colliding candidates within each
       token column and window-prune — the hand-written CUDA kernel
       :func:`~pyctcdecode_torch.ops.merge.expand_merge_prune`;
    4. rank the top B (stable sort: lowest position wins ties, as
       ``lax.top_k``);
    5. select the winners, replay their transitions, optionally prune
       duplicate histories, and gate padded steps — the hand-written CUDA
       kernel :func:`~pyctcdecode_torch.ops.replay.replay_winners`.

Text never exists on the device: beams are 2x32-bit rolling hashes plus trie
nodes, and each frame emits a ``(parent, token)`` backpointer pair; the final
ranking merges beams by text (``_finalize``, the
:func:`~pyctcdecode_torch.ops.merge.merge_prune` kernel with K = 1) and a
backtrace turns pointers into token paths, which the host replays into words
and frame spans.

Semantic contracts kept bit for bit with the reference: uint32 wraparound
hashes (int64 lanes here, see ``ops/hashing.py``), the ``DEAD`` /
``DEAD_THRESH`` sentinels, newest-member donor with first-member rank
position, lowest-position tie order, and the ``-2 - arange(B)`` sentinels
of dead beams' last token. TPU lowering workarounds of the reference (one-hot
matmul selection, one-hot token lookups, optimization barriers, layout
transposes) are plain indexing and ``gather`` here.

Two step inputs share the step function. Dense: one log-prob row per frame,
all (or the top K) tokens expanded. Timeline (``EngineConfig.token_timeline``,
the serving configuration): the host splits each frame's exactly-admitted
token set into K-wide chunks (``utils.logits.token_timeline``); one step
expands one chunk against the frozen beam set, merges in-chunk with the
window off, ranks pool U chunk into a carried top-B candidate pool, and on
the frame's last chunk applies the window and promotes the pool to the new
beam set. Non-final steps emit identity backpointers with token ``-3``.

Language models are a list of members: one for a plain LM, N for a
``MultiLanguageModel``, whose fused word scores average over the members
(ref ``language_model.py:455-502``). Each member carries its own trie node,
context ids and backoffs per beam (state planes ``p_node{i}``, ``ctx{i}``,
...), and each costs one trie fetch and one n-gram probe a step. Hotwords
are a per-call packed trie walked beside the members (``h_node`` /
``h_bits``): a committed hotword adds the hotword weight, an in-progress
hotword prefix takes the hotword completion score as its partial score.

Labels may be longer than one character: a BPE alphabet's pieces, or a char
alphabet's multi-character labels. A token that extends the partial word
walks each trie (and the hot trie) one character at a time
(:mod:`~pyctcdecode_torch.ops.walk`): the first character from the beam's
fetched trie row, each later one from the trie plane at the node reached so
far. With a BPE alphabet a right-bounded piece (``▁⁇▁``) sets the beam's
``force`` flag, and the next token that does not stay starts a new word even
when it is a regular piece.
"""
from __future__ import annotations

import dataclasses
import gc
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .constants import LOG_BASE_CHANGE_FACTOR
from .models.device_tables import (
    DeviceLM,
    LMShard,
    lm_score_words,
    trie_fetch_rows,
)
from .ops import kernel_wrappers
from .ops.backtrace import backtrace_paths
from .ops.commit import commit_kernel_fits, commit_words, commit_words_ref, hot_gain
from .ops.hashing import M32, as_lane, hash_text_commit_t, mix4_t
from .ops.merge import DEAD, DEAD_THRESH, expand_merge_prune, merge_prune
from .ops.replay import FLAG_ALIVE, FLAG_BND, FLAG_COMMIT, FLAG_DUP, beam_rows, replay_keys, replay_winners
from .ops.tokens import KIND_BLANK, KIND_BOUNDARY, TokenArrays
from .ops.walk import partial_score, walk_kernel_fits, walk_partial, walk_partial_ref
from .utils import profiling

_BIT_IN_VOCAB = DeviceLM.BIT_IN_VOCAB
_BIT_UNI_WORD = DeviceLM.BIT_UNI_WORD
_LOG10 = float(np.float32(LOG_BASE_CHANGE_FACTOR))


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Static decode configuration."""

    beam_width: int
    vocab_size: int
    k_tokens: int  # tokens expanded per frame (== vocab_size: exact)
    prune_history: bool
    # backtrace only the top-N beams (None: all B)
    emit_paths: Optional[int] = None
    # decode host-built token timelines: each step is one K-wide chunk of a
    # frame's admitted tokens against a carried candidate pool, promoted to
    # the beam set on the frame's last chunk. Output-exact for any k_tokens
    # (merges are confined to one token column, so chunks never split a
    # merge group, and iterated top-B over pool U chunk equals the frame's
    # top-B).
    token_timeline: bool = False
    use_hotwords: bool = False
    # BPE alphabet: a right-bounded piece forces a word break before the next token
    is_bpe: bool = False
    orders: Tuple[int, ...] = ()  # per-LM-member n-gram orders (empty when no LM)
    # accumulate per-utterance decode counters in the state (see stats_fields);
    # off, the step issues no op for them
    collect_stats: bool = False

    @property
    def n_lms(self) -> int:
        """Number of LM members (0 without an LM)."""
        return len(self.orders)

    def ctx_w(self, i: int) -> int:
        """Context width of member ``i``."""
        return max(self.orders[i] - 1, 1)

    @property
    def ring_width(self) -> int:
        """History ring width, from the largest member order; sets the history-prune window."""
        return max(max(self.orders, default=1) - 1, 1)


def stats_fields(cfg: EngineConfig) -> List[str]:
    """Names of the decode counters, in the order of the ``stats`` plane's columns.

    Every counter is a sum over an utterance's decoded frames of a per-frame
    count; divide by ``frames`` for rates. ``probe_hits_o{n}`` /
    ``probe_queries`` is the order-``n`` full-suffix hit rate of the
    per-frame commit scoring, over all LM members.

    With ``token_timeline`` the work counters (``beams_alive``,
    ``candidates_valid``, ``merged_dups``, ``probe_queries``,
    ``probe_hits_*``) sum over virtual steps (chunks), and the frame-shaped
    ones (``frames``, ``window_pruned``, ``selected_alive``,
    ``history_pruned``, ``words_committed``) count each frame's last chunk
    only, so per-frame rates read as in the dense decode (the JAX reference's
    ``stats_fields``).
    """
    names = [
        "frames",
        "beams_alive",
        "candidates_valid",
        "merged_dups",
        "window_pruned",
        "selected_alive",
        "history_pruned",
        "words_committed",
    ]
    if cfg.n_lms:
        names.append("probe_queries")
        names += [f"probe_hits_o{n}" for n in range(1, max(cfg.orders) + 1)]
    return names


def build_table_args(
    tokens: TokenArrays, device_lms: Sequence[DeviceLM], device: torch.device,
    shard: Optional[LMShard] = None,
) -> Dict[str, Any]:
    """Upload the token tables and every LM member's tables to ``device`` (once per decoder).

    Hotword tables change per call: they go to the decode function instead
    (see :func:`make_decode_fn`). ``shard`` row-shards every n-gram bucket
    plane over a process group (:meth:`DeviceLM.as_device`): each process
    keeps its row block and every probe becomes collective.
    """
    def put(arr: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
        return torch.as_tensor(np.asarray(arr), device=device).to(dtype)

    tok = {
        "kind": put(tokens.kind, torch.int64),
        "piece_len": put(tokens.piece_len, torch.int64),
        "raw_chars": put(tokens.raw_chars, torch.int64),  # [V, lmax], -1 past the label's end
        "raw_len": put(tokens.raw_len, torch.int64),
        "right_bound": put(tokens.right_bound, torch.int32),
        "seed_lo": as_lane(tokens.seed_hash_lo, device),
        "seed_hi": as_lane(tokens.seed_hash_hi, device),
    }
    return {"tok": tok, "lms": [dlm.as_device(device, shard) for dlm in device_lms]}


def _params_dict(cfg: EngineConfig, params: Any,
                 score_boundary: Optional[Sequence[bool]] = None) -> Dict[str, Any]:
    """Unpack the f32 parameter vector.

    Layout: ``[token_min_logp, beam_prune_logp, hot_weight, (alpha_i,
    beta_i, unk_offset_i, score_boundary_i) x n_lms]``. A numpy vector
    unpacks into Python scalars; values pass through float32, so scalar
    arithmetic on f32 tensors matches the reference's f32 parameter math. A
    device tensor (the segment programs' static buffer, which a captured
    graph reads at every replay) unpacks into 0-d f32 views, which give the
    same f32 results; its ``score_boundary`` flags, which select the
    finalize's probes, come from ``score_boundary`` (the host vector's, see
    :func:`score_boundary_flags`), and without it are absent (the step
    does not read them).
    """
    if isinstance(params, torch.Tensor):
        p: List[Any] = list(params.unbind(0))
    else:
        p = [float(x) for x in np.asarray(params, dtype=np.float32)]
    out: Dict[str, Any] = {
        "token_min_logp": p[0], "beam_prune_logp": p[1], "hot_weight": p[2], "lm": [],
    }
    for i in range(cfg.n_lms):
        base = 3 + 4 * i
        member = {"alpha": p[base], "beta": p[base + 1], "unk_offset": p[base + 2]}
        if not isinstance(params, torch.Tensor):
            member["score_boundary"] = p[base + 3] > 0.5
        elif score_boundary is not None:
            member["score_boundary"] = bool(score_boundary[i])
        out["lm"].append(member)
    return out


def score_boundary_flags(cfg: EngineConfig, params: np.ndarray) -> Tuple[bool, ...]:
    """Each member's ``score_boundary`` flag in the host parameter vector (a finalize program's key)."""
    return tuple(member["score_boundary"] for member in _params_dict(cfg, params)["lm"])


def _init_state(cfg: EngineConfig, start: Sequence[Dict], n: int, device: torch.device) -> Dict:
    """Initial beam state ``[N, B, ...]``.

    ``start``: one dict per LM member, ``{"ctx": [ctx_w(i)] int, "len":
    int, "bo": [ctx_w(i)] f32}`` (the member's start context, its length
    and its suffix backoffs); empty without an LM.
    """
    b = cfg.beam_width
    iota = torch.arange(b, device=device)

    def zi(*extra: int) -> torch.Tensor:
        return torch.zeros((n, b) + extra, dtype=torch.int64, device=device)

    logit = torch.full((n, b), DEAD, dtype=torch.float32, device=device)
    logit[:, 0] = 0.0
    state = {
        "text_lo": zi(),
        "text_hi": zi(),
        "p_lo": zi(),
        "p_hi": zi(),
        "p_len": zi(),
        "last_tok": torch.where(iota == 0, -1, -2 - iota).expand(n, b).contiguous(),
        "force": torch.zeros((n, b), dtype=torch.bool, device=device),
        "logit": logit,
        "fused": torch.zeros((n, b), dtype=torch.float32, device=device),
        "ring_lo": zi(cfg.ring_width),
        "ring_hi": zi(cfg.ring_width),
        "n_words": zi(),
    }
    for i in range(cfg.n_lms):
        w = cfg.ctx_w(i)
        ctx = torch.as_tensor(np.asarray(start[i]["ctx"], dtype=np.int64), device=device)
        bo = torch.as_tensor(np.asarray(start[i]["bo"], dtype=np.float32), device=device)
        state[f"p_node{i}"] = zi()
        state[f"p_flags{i}"] = zi()  # packed entry bits of the current node
        state[f"ctx{i}"] = ctx.expand(n, b, w).contiguous()
        state[f"ctx_len{i}"] = torch.full((n, b), int(start[i]["len"]), dtype=torch.int64, device=device)
        state[f"ctx_bo{i}"] = bo.expand(n, b, w).contiguous()
    if cfg.use_hotwords:
        state["h_node"] = zi()
        state["h_bits"] = zi()  # packed hot entry (min-completion + terminal)
    if cfg.token_timeline:
        # carried candidate pool: the running top-B of the current frame's
        # merged candidates across its token chunks (see _make_step)
        dead = torch.full((n, b), DEAD, dtype=torch.float32, device=device)
        state["pool_score"] = dead
        state["pool_logit"] = dead.clone()
        state["pool_pf"] = iota.expand(n, b).contiguous()  # first-member parent (replay)
        state["pool_pd"] = iota.expand(n, b).contiguous()  # newest-member parent (backtrace)
        state["pool_tok"] = torch.full((n, b), -1, dtype=torch.int64, device=device)
        for i in range(cfg.n_lms):
            state[f"pool_ent{i}"] = zi()  # packed trie entry of the candidate
        if cfg.use_hotwords:
            state["pool_h"] = zi()  # packed hot entry of the candidate
    if cfg.collect_stats:
        state["stats"] = torch.zeros((n, len(stats_fields(cfg))), dtype=torch.int64, device=device)
    return state


def _commit_quantities(cfg: EngineConfig, lms: List[Dict], prm: Dict, state: Dict,
                       trie_rows: List[torch.Tensor]) -> Dict:
    """Per-beam word-commit effects: text hash, fused word score, new contexts.

    One :func:`~pyctcdecode_torch.ops.commit.commit_words` launch for every
    member where the kernel takes the members' tables; row-sharded tables
    (a collective probe), an order-1 member or more than 8 probe tables in
    all keep the PyTorch composition,
    :func:`~pyctcdecode_torch.ops.commit.commit_words_ref`. The members'
    fused scores are summed in member order and then divided by the member
    count, as the reference does (float32 order matters at 1e-4); the
    hotword boost is added after. With ``cfg.collect_stats``,
    ``"probe_hits"`` holds each member's per-order hit masks.
    """
    commit = commit_words if commit_kernel_fits(lms) else commit_words_ref
    return commit(lms, prm, state, trie_rows, cfg.use_hotwords, cfg.collect_stats)


def _walk_quantities(cfg: EngineConfig, lms: List[Dict], hot: Optional[Dict], prm: Dict, state: Dict,
                     toks: torch.Tensor, tok: Dict, trie_rows: List[torch.Tensor]):
    """Every candidate's packed trie entries and partial score: ``(ent, h_ent, pscore)``.

    One :func:`~pyctcdecode_torch.ops.walk.walk_partial` launch where the
    kernel takes the members (up to 8), else the PyTorch composition,
    :func:`~pyctcdecode_torch.ops.walk.walk_partial_ref`.
    """
    walk = walk_partial if walk_kernel_fits(lms) else walk_partial_ref
    return walk(lms, hot if cfg.use_hotwords else None, prm, state, toks, tok, trie_rows, cfg.is_bpe)


def _path_dtype(vocab_size: int) -> torch.dtype:
    """Narrowest signed dtype for emitted token ids (+ -1/-2/-3 sentinels)."""
    if vocab_size <= 120:
        return torch.int8
    if vocab_size <= 32_000:
        return torch.int16
    return torch.int32


def _parent_dtype(beam_width: int) -> torch.dtype:
    """Narrowest signed dtype for emitted parent (beam-slot) indices."""
    if beam_width <= 127:
        return torch.int8
    if beam_width <= 32_767:
        return torch.int16
    return torch.int32


def _top_b(scores: torch.Tensor, b: int):
    """Top ``b`` per row, ties to the lowest position (``lax.top_k`` order)."""
    srt = torch.sort(scores, dim=-1, descending=True, stable=True)
    return srt.values[:, :b], srt.indices[:, :b]


def _make_step(cfg: EngineConfig, tables: Dict, hot: Optional[Dict], prm: Dict,
               n_frames: torch.Tensor):
    """Build the per-frame (timeline: per-chunk) step over ``[N, B]`` state planes."""
    b, k, v = cfg.beam_width, cfg.k_tokens, cfg.vocab_size
    tl = cfg.token_timeline
    tok_dev, lms = tables["tok"], tables["lms"]
    n_lms, use_hot = cfg.n_lms, cfg.use_hotwords
    device = n_frames.device
    n = n_frames.shape[0]
    iota_b = torch.arange(b, device=device)
    iota_v = torch.arange(v, device=device)
    # timeline chunks merge with the window off: the frame's max is only
    # known at its last chunk, where the pooled top-1 is that max
    if tl:
        prune = torch.full((n,), float("-inf"), dtype=torch.float32, device=device)
    else:  # a Python float, or a 0-d device view in the segment programs
        prune = torch.zeros((n,), dtype=torch.float32, device=device) + prm["beam_prune_logp"]
    out_dtypes = (_parent_dtype(b), _path_dtype(v))  # the backpointers as the logs keep them

    def step(state: Dict, xs, t):
        """One frame: commit (kernel) -> walk (kernel) -> expand+merge+prune (kernel) -> top-B -> replay (kernel).

        ``xs`` is the frame's log-prob row ``[N, V]``, or with
        ``cfg.token_timeline`` one chunk ``(toks [N, K] (-1: empty slot),
        tok_logp [N, K], is_final [N])`` per utterance. ``t``, the step's
        index, is a Python int, or a 0-d int64 device tensor in the segment
        programs (a captured graph must not freeze it). Returns the new
        state and the step's ``(parent, token)`` backpointers ``[N, B]`` in
        the logs' types (:func:`_parent_dtype`, :func:`_path_dtype`).
        """
        active = t < n_frames  # [N]
        if tl:
            toks_in, tok_logp, fin = xs
            is_final = fin != 0  # [N]
            admit = toks_in >= 0
            toks = toks_in.clamp(min=0).to(torch.int64)  # clamped for lookups only
            tok_logp = tok_logp.contiguous()
        else:
            logp_row = xs
            if k < v:
                _, pre = _top_b(logp_row, k)
                toks = torch.sort(pre, dim=-1).values
                tok_logp = logp_row.gather(1, toks)
            else:
                toks = iota_v.expand(n, v).contiguous()
                tok_logp = logp_row.contiguous()
            argmax_tok = logp_row.argmax(dim=-1)
            admit = (tok_logp >= prm["token_min_logp"]) | (toks == argmax_tok[:, None])

        tok_kind = tok_dev["kind"][toks]  # [N, K]
        tok_right = tok_dev["right_bound"][toks]
        cids = tok_dev["raw_chars"][toks]  # [N, K, lmax], -1 past the label's end
        seed_lo_k = tok_dev["seed_lo"][toks]
        seed_hi_k = tok_dev["seed_hi"][toks]
        blank = tok_kind == KIND_BLANK
        boundary_kind = tok_kind == KIND_BOUNDARY

        # one trie-row fetch per member, shared by commit scoring and the walk
        trie_rows_b = [
            trie_fetch_rows(lm["trie_rows"], lm["trie_pack"], state[f"p_node{i}"])
            for i, lm in enumerate(lms)
        ]
        cm = _commit_quantities(cfg, lms, prm, state, trie_rows_b)

        # ---- the trie walk and the partial score, [N, B, K] / [N, K, B]; the
        # merge kernel below re-derives the transition classes in registers
        p_entry_n, h_entry_n, pscore = _walk_quantities(cfg, lms, hot, prm, state, toks, tok_dev, trie_rows_b)

        # ---- stages 2-3 on the kernel: [N, K, B] token-major candidates
        beam = {
            "text_lo": state["text_lo"],
            "text_hi": state["text_hi"],
            "cm_text_lo": cm["text_lo"],
            "cm_text_hi": cm["text_hi"],
            "p_lo": state["p_lo"],
            "p_hi": state["p_hi"],
            "force": state["force"].to(torch.int32),
            "fused": state["fused"],
            "wfused": cm["word_fused"],
            "logit": state["logit"],
            "last_tok": state["last_tok"].to(torch.int32),
        }
        tokp = {
            "tok": toks.to(torch.int32),
            "blank": blank.to(torch.int32),
            "boundary": boundary_kind.to(torch.int32),
            "right": tok_right,
            "seed_lo": seed_lo_k,
            "seed_hi": seed_hi_k,
            "tok_logp": tok_logp,
            "admit": admit.to(torch.int32),
        }
        cid_planes = cids.permute(2, 0, 1).to(torch.int32, memory_format=torch.contiguous_format)
        sc, merged, src = expand_merge_prune(beam, tokp, cid_planes, pscore, prune, cfg.is_bpe)

        if tl:
            # ---- pool U chunk ranking. Ranking key = (score desc,
            # frame-local enumeration rank asc). One stable descending sort
            # over concat([pool, chunk]) realizes it: ties go to the lowest
            # position; pool entries precede chunk candidates and come from
            # earlier chunks of the frame; chunk candidates sit in
            # enumeration order; and the pool is itself a previous top-B, so
            # its equal-score members are already in rank order.
            def pooled(pool_key: str, chunk: torch.Tensor) -> torch.Tensor:
                return torch.cat([state[pool_key], chunk.reshape(n, k * b)], dim=1)

            top_scores, top_src = _top_b(pooled("pool_score", sc), b)
            # the window, over the whole frame's best, on its last chunk only
            win = top_scores[:, :1] + prm["beam_prune_logp"]
            if cfg.collect_stats:  # the frame's window kills, over its whole pool
                win_killed = ((top_scores > DEAD_THRESH) & (top_scores < win)).sum(1)
            top_scores = torch.where(is_final[:, None] & (top_scores < win), DEAD, top_scores)
            top_parent = pooled("pool_pf", iota_b.expand(n, k, b)).gather(1, top_src)
            parent = pooled("pool_pd", src.to(torch.int64) % b).gather(1, top_src)
            sel_tok = pooled("pool_tok", toks[:, :, None].expand(n, k, b)).gather(1, top_src)
            top_logit = pooled("pool_logit", merged).gather(1, top_src)
            sel_alive = top_scores > DEAD_THRESH
            # dead lanes keep pool_tok's -1 sentinel
            sel_tok = torch.where(sel_alive, sel_tok, -1)
            fin2 = is_final[:, None]
            pool_new = {
                "pool_score": torch.where(fin2, DEAD, top_scores),
                "pool_logit": torch.where(fin2, DEAD, top_logit),
                "pool_pf": torch.where(fin2, iota_b, top_parent),
                "pool_pd": torch.where(fin2, iota_b, parent),
                "pool_tok": torch.where(fin2, -1, sel_tok),
            }
            ent_w = [
                pooled(f"pool_ent{i}", e.transpose(1, 2)).gather(1, top_src)
                for i, e in enumerate(p_entry_n)
            ]
            for i, e in enumerate(ent_w):
                pool_new[f"pool_ent{i}"] = torch.where(fin2, 0, e)
            h_w = None
            if use_hot:
                h_w = pooled("pool_h", h_entry_n.transpose(1, 2)).gather(1, top_src)
                pool_new["pool_h"] = torch.where(fin2, 0, h_w)
            winners = {"parent": top_parent, "bp": parent, "tok": sel_tok, "logit": top_logit,
                       "score": top_scores, "ent": ent_w, "h_ent": h_w}
            # beam lanes advance only on the frame's last chunk, pool lanes on
            # every active step; non-final steps emit identity backpointers
            # with token -3 (carry marker): the backtrace composes through
            # them unchanged and the host path replay skips them
            gate = active & is_final
        else:
            # ---- top-B (the kernel reads the first B of the ranking)
            srt = torch.sort(sc.reshape(n, k * b), dim=-1, descending=True, stable=True)
            winners = {"order": srt.indices, "score": srt.values, "src": src, "merged": merged,
                       "toks": toks, "ent": p_entry_n, "h_ent": h_entry_n}
            gate = active  # inactive (padded) frames pass state through untouched

        # ---- the winners' transition replay, history dedup and padded-step
        # gate: one kernel (every other field is a deterministic function of
        # (parent beam, token))
        out_state, parent, token_sel, flags = replay_winners(
            {key: state[key] for key in replay_keys(n_lms, use_hot)}, cm, tok_dev, winners, gate, active,
            cfg.prune_history, cfg.is_bpe, cfg.collect_stats, out_dtypes,
        )

        if cfg.collect_stats:
            # per-utterance counts of this step (stats_fields). The kernel's
            # src holds every valid candidate's newest group member, so the
            # groups are the candidates that are their own donor; a group's
            # merged logit is the same at every member.
            alive = state["logit"] > DEAD_THRESH
            alive_ct = alive.sum(1)
            valid = alive[:, None, :] & admit[:, :, None]  # [N, K, B]
            own = valid & ((src.to(torch.int64) % b) == iota_b)
            fin_gate = is_final.to(torch.int64) if tl else 1
            if tl:
                window_pruned = fin_gate * win_killed
            else:
                live = (own & (merged > DEAD_THRESH)).sum((1, 2))
                window_pruned = live - (sc > DEAD_THRESH).sum((1, 2))
            all_bits = FLAG_BND | FLAG_COMMIT | FLAG_ALIVE
            counts = [
                torch.ones_like(alive_ct) * fin_gate,  # frames
                alive_ct,
                alive_ct * admit.sum(1),  # candidates_valid
                alive_ct * admit.sum(1) - own.sum((1, 2)),  # merged_dups
                window_pruned,
                fin_gate * ((flags & FLAG_ALIVE) != 0).sum(1),
                fin_gate * ((flags & FLAG_DUP) != 0).sum(1) if cfg.prune_history else torch.zeros_like(alive_ct),
                # words actually committed: winners that cross a boundary holding a partial
                fin_gate * ((flags & all_bits) == all_bits).sum(1),
            ]
            if n_lms:
                counts.append(n_lms * alive_ct)  # probe_queries
                for order_n in range(1, max(cfg.orders) + 1):
                    counts.append(sum((hits[order_n - 1] & alive).sum(1)
                                      for hits in cm["probe_hits"] if order_n <= len(hits)))
            new_stats = state["stats"] + torch.stack(counts, dim=1)

        # the keys the kernel does not write: the pool lanes (timeline) and the
        # counters advance on every active step
        merged_state = {}
        for key, old in state.items():
            if key in out_state:
                merged_state[key] = out_state[key]
            else:
                fresh = new_stats if key == "stats" else pool_new[key]
                merged_state[key] = torch.where(active[:, None], fresh, old)
        return merged_state, (parent, token_sel)

    return step


def _finalize(cfg: EngineConfig, lms: List[Dict], hot: Optional[Dict], prm: Dict, state: Dict,
              do_commit: bool = True, is_end: bool = True) -> Dict:
    """Rank the current hypotheses (ref decoder.py:558-602).

    ``do_commit`` force-commits trailing partial words and merges beams by
    committed text (``force_next_word`` / end-of-decode semantics); without
    it the partial words survive and keep their partial score, and the
    merge key also carries the partial, last-token and force lanes (a
    streaming chunk). ``is_end`` scores the final word, the empty word
    (``<unk>``) where nothing commits, with ``is_last_word`` semantics:
    ``</s>`` credit where the member has ``score_boundary``. Members are
    averaged and the hotword boost is added. Beams merge on the
    ``merge_prune`` kernel with K = 1, extra 0 and no prune window; the
    donor's extra is added after, as the reference does; then the window
    prune and top-B.

    Returns the ranked ``src`` / ``logit`` / ``score`` ``[N, B]``, each
    member's context view after the scored word (``ctx{i}``,
    ``ctx_len{i}``, by rank), and under ``"carry"`` the per-slot planes
    that :func:`_committed_state` folds into the next chunk's state.
    """
    n, b = state["logit"].shape
    device = state["logit"].device
    alive = state["logit"] > DEAD_THRESH
    has_partial = state["p_len"] > 0
    commit = has_partial if do_commit else torch.zeros_like(has_partial)
    # the word scored here: the committed partial, or the empty word where
    # nothing commits but the stream ends (None: every beam)
    score_word = None if is_end else commit
    t_lo, t_hi = hash_text_commit_t(state["text_lo"], state["text_hi"], state["p_lo"], state["p_hi"])
    text_lo = torch.where(commit, t_lo, state["text_lo"])
    text_hi = torch.where(commit, t_hi, state["text_hi"])
    fused_sum = None
    ctx_out = []  # per member: (context, length, backoffs) after the scored word
    for i, lm in enumerate(lms):
        lm_prm = prm["lm"][i]
        flags = state[f"p_flags{i}"]
        in_model = ((flags & _BIT_IN_VOCAB) != 0) & commit
        wid = torch.where(in_model, lm["trie_word_id"][state[f"p_node{i}"]], lm["unk_id"])
        in_uni = ((flags & _BIT_UNI_WORD) != 0) & commit
        is_oov = ~in_model
        if lm["has_unigrams"]:
            is_oov = is_oov | ~in_uni
        raw10, ctx2, ctx2_len, ctx2_bo = lm_score_words(
            lm, state[f"ctx{i}"], state[f"ctx_len{i}"], wid, state[f"ctx_bo{i}"]
        )
        raw = raw10 + lm_prm["unk_offset"] * is_oov.to(torch.float32)
        if lm_prm["score_boundary"]:
            # probed on every finalize, as the reference does; credited at the end only
            eos = torch.full_like(wid, lm["eos_id"])
            eos10, _, _, _ = lm_score_words(lm, ctx2, ctx2_len, eos, ctx2_bo)
            if is_end:
                raw = raw + eos10
        fused = lm_prm["alpha"] * raw * _LOG10 + lm_prm["beta"]
        fused_sum = fused if fused_sum is None else fused_sum + fused
        ctx_out.append((ctx2, ctx2_len, ctx2_bo))
    fused_scored = state["fused"]
    if fused_sum is not None:
        word = fused_sum / len(lms) if len(lms) > 1 else fused_sum
        if score_word is not None:
            word = torch.where(score_word, word, 0.0)
        fused_scored = fused_scored + word
    if cfg.use_hotwords:
        fused_scored = fused_scored + hot_gain(prm, state["h_bits"], commit)

    if do_commit:
        # merge key: committed text only; the partial, last-token and force
        # lanes are 0, 1 and 0 (force included: ``where(do_commit, False, force)``)
        extra = fused_scored
        kl = mix4_t(text_lo, 0, 1, 0)
        kh = mix4_t(text_hi, 0, 1, 0)
    else:
        # the partials survive with their partial score; the key is the whole beam's
        h_entry = state["h_node"] | state["h_bits"] if cfg.use_hotwords else None
        flag_list = [state[f"p_flags{i}"] for i in range(cfg.n_lms)]
        extra = fused_scored + partial_score(cfg.n_lms, hot if cfg.use_hotwords else None, prm, flag_list,
                                                 h_entry, state["p_len"])
        last_u = (state["last_tok"] + 2) & M32
        force_u = state["force"].to(torch.int64)
        kl = mix4_t(text_lo, state["p_lo"], last_u, force_u)
        kh = mix4_t(text_hi, state["p_hi"], last_u, force_u)
    logit_f = torch.where(alive, state["logit"], DEAD)
    zeros = torch.zeros((n, 1, b), dtype=torch.float32, device=device)
    no_window = torch.full((n,), float("-inf"), dtype=torch.float32, device=device)
    merged_b, _, src_m = merge_prune(
        kl[:, None].contiguous(), kh[:, None].contiguous(), alive.to(torch.int32)[:, None].contiguous(),
        logit_f[:, None].contiguous(), zeros, no_window,
    )
    merged_b = merged_b[:, 0]  # group logsumexp at group-first beams, else DEAD
    donor = src_m[:, 0].to(torch.int64)
    live = merged_b > DEAD_THRESH
    lm_score = torch.where(live, merged_b + extra.gather(1, donor), DEAD)
    # window prune relative to the best, then top-B (ref decoder.py:536-554)
    mx = lm_score.amax(dim=1, keepdim=True)
    sc = torch.where(lm_score >= mx + prm["beam_prune_logp"], lm_score, DEAD)
    score, top_idx = _top_b(sc, b)
    src = donor.gather(1, top_idx)
    out = {"src": src, "logit": merged_b.gather(1, top_idx), "score": score}
    for i, (ctx2, ctx2_len, _) in enumerate(ctx_out):
        view, view_len = ctx2, ctx2_len
        if score_word is not None:
            view = torch.where(score_word[..., None], ctx2, state[f"ctx{i}"])
            view_len = torch.where(score_word, ctx2_len, state[f"ctx_len{i}"])
        out[f"ctx{i}"] = beam_rows(view, src)
        out[f"ctx_len{i}"] = beam_rows(view_len, src)
    out["carry"] = {"commit": commit, "text_lo": text_lo, "text_hi": text_hi,
                    "fused": fused_scored, "ctx": ctx_out}
    return out


def _committed_state(cfg: EngineConfig, state: Dict, fin: Dict) -> Dict:
    """The carried state after a committing finalize: the ranked winners, word-aligned.

    Rows are in rank order (slot r holds rank r). Text, history ring, word
    count, fused score and contexts carry the commit; the partial, trie
    node, flag and hot planes are zeroed; ``last_tok`` is -1 where alive
    and ``-2 - r`` where dead, so that dead slots never merge.
    """
    n, b = state["logit"].shape
    device = state["logit"].device
    carry, src = fin["carry"], fin["src"]
    commit = carry["commit"]
    c2 = commit[..., None]
    sel_alive = fin["score"] > DEAD_THRESH

    def zeros() -> torch.Tensor:
        return torch.zeros((n, b), dtype=torch.int64, device=device)

    new = {
        "text_lo": beam_rows(carry["text_lo"], src),
        "text_hi": beam_rows(carry["text_hi"], src),
        "p_lo": zeros(),
        "p_hi": zeros(),
        "p_len": zeros(),
        "last_tok": torch.where(sel_alive, -1, -2 - torch.arange(b, device=device)),
        "force": torch.zeros((n, b), dtype=torch.bool, device=device),
        "logit": torch.where(sel_alive, fin["logit"], DEAD),
        "fused": beam_rows(carry["fused"], src),
        "n_words": beam_rows(state["n_words"] + commit.to(torch.int64), src),
    }
    for ring, lane in (("ring_lo", "p_lo"), ("ring_hi", "p_hi")):
        shifted = torch.cat([state[ring][..., 1:], state[lane][..., None]], dim=-1)
        new[ring] = beam_rows(torch.where(c2, shifted, state[ring]), src)
    for i, (ctx2, ctx2_len, ctx2_bo) in enumerate(carry["ctx"]):
        new[f"p_node{i}"] = zeros()
        new[f"p_flags{i}"] = zeros()
        new[f"ctx{i}"] = beam_rows(torch.where(c2, ctx2, state[f"ctx{i}"]), src)
        new[f"ctx_len{i}"] = beam_rows(torch.where(commit, ctx2_len, state[f"ctx_len{i}"]), src)
        new[f"ctx_bo{i}"] = beam_rows(torch.where(c2, ctx2_bo, state[f"ctx_bo{i}"]), src)
    if cfg.use_hotwords:
        new["h_node"] = zeros()
        new["h_bits"] = zeros()
    return new


def make_decode_fn(cfg: EngineConfig, tables: Dict):
    """Build the batch decode function over uploaded ``tables``.

    ``fn(logp [N, T, V] f32, n_frames [N] int64, params f32 vector, start,
    hot)`` runs the frame loop (one :func:`make_segment_decode_fns` segment
    of all T steps, on the host vector ``params``) and the finalization on
    ``logp``'s device and returns the ranked beams (top ``emit_paths`` or
    all B) with their token paths ``[N, R, T]`` (backtraced on the device; -1 at padded
    frames) and each member's final context (``ctx{i}``, ``ctx_len{i}``).
    ``start`` holds one start dict per LM member (see :func:`_init_state`);
    ``hot`` is this call's hotword trie, ``{"next": int64 [nodes, chars],
    "seed": int64 [V], "dead": int}`` on ``logp``'s device, or None (it must
    be given exactly when ``cfg.use_hotwords``). With ``cfg.collect_stats``
    the outputs hold ``"stats"``, int64 ``[N, len(stats_fields(cfg))]``.

    With ``cfg.token_timeline``, ``logp`` is the host-built timeline tuple
    ``(toks [N, Tv, K] int, tlogp [N, Tv, K] f32, is_final [N, Tv] int)``,
    ``n_frames`` counts virtual steps, and the paths are ``[N, R, Tv]`` with
    -3 at a frame's non-final chunks.
    """

    def decode(logp, n_frames: torch.Tensor, params: np.ndarray,
               start: Sequence[Dict], hot: Optional[Dict] = None) -> Dict[str, torch.Tensor]:
        t_max = (logp[2] if cfg.token_timeline else logp).shape[1]
        init_fn, seg_fn, fin_fn = make_segment_decode_fns(cfg, tables, t_max)  # one segment: all the steps
        state, (parents, trace) = seg_fn(init_fn(start, n_frames.shape[0]), logp, 0, n_frames, params, hot=hot)
        return fin_fn(state, params, parents, trace, hot=hot)

    return decode


def make_segment_decode_fns(cfg: EngineConfig, tables: Dict, seg_frames: int):
    """Build the segmented batch decode over uploaded ``tables``: ``(init_fn, seg_fn, fin_fn)``.

    The reference's segment programs (its ``make_segment_decode_fns``): the
    frame loop stays on the host, and one program advances ``seg_frames``
    steps from a frame offset that is an input, so the program is reused
    across segment indices, batches and utterance lengths. Here that program
    is a captured CUDA graph (:class:`SegmentGraph`), which replays a
    segment's few thousand launches at once; on the CPU ``seg_fn`` runs
    eagerly. Every step reads its frame index ``t0 + i`` and the parameter
    vector as device data, so a replay sees the values of its own decode.

    * ``init_fn(start, n) -> state``: a fresh ``[n, B]`` beam state
      (``start`` as for :func:`make_decode_fn`);
    * ``seg_fn(state, seg_in, t0, n_frames, params, tabs=None, hot=None) ->
      (state', (parents, trace))``: ``seg_frames`` steps from absolute step
      ``t0`` (an int, or a 0-d int64 device tensor). ``seg_in`` is the
      segment's log-probs ``[N, S, V]``, or with ``cfg.token_timeline`` its
      timeline slice ``(toks [N, S, K] int64, tlogp [N, S, K], is_final [N,
      S])`` and ``n_frames`` counts virtual steps; ``params`` is the f32
      parameter vector as a device tensor (read as device data), or the
      host vector (its values built into the ops); ``tabs`` replaces the
      build's ``tables`` (a row-sharded LM's). Steps at or past ``n_frames`` leave a
      row's state as it is and emit -1. The backpointers keep the port's
      layout: ``parents`` (:func:`_parent_dtype`) and ``trace``
      (:func:`_path_dtype`), each ``[N, S, B]``, not packed into one word.
    * ``fin_fn(state, params, parents, trace, tabs=None, hot=None) -> out``:
      the finalize (:func:`_ranked_outputs`, on the host vector ``params``,
      whose ``score_boundary`` flags select the probes) and the device
      backtrace (:func:`~pyctcdecode_torch.ops.backtrace.backtrace_paths`)
      over the whole logs ``[N, T, B]``; ``out`` is exactly
      :func:`make_decode_fn`'s. On the card a decode replays the finalize
      as a :class:`FinalizeGraph` (:func:`finalize_program`) instead.
    """
    if seg_frames < 1:
        raise ValueError(f"seg_frames must be at least 1; got {seg_frames}")
    device = tables["tok"]["kind"].device

    def init_fn(start: Sequence[Dict], n: int) -> Dict:
        return _init_state(cfg, start, n, device)

    def seg_fn(state: Dict, seg_in, t0, n_frames: torch.Tensor, params: Union[torch.Tensor, np.ndarray],
               tabs: Optional[Dict] = None, hot: Optional[Dict] = None):
        step = _make_step(cfg, tables if tabs is None else tabs, hot, _params_dict(cfg, params), n_frames)
        parents, trace = [], []
        for i in range(seg_frames):
            if cfg.token_timeline:
                xs = tuple(plane[:, i] for plane in seg_in)
            else:
                xs = seg_in[:, i]
            state, (par, tok) = step(state, xs, t0 + i)
            parents.append(par)
            trace.append(tok)
        return state, (torch.stack(parents, dim=1), torch.stack(trace, dim=1))

    def fin_fn(state: Dict, params: np.ndarray, parents: torch.Tensor, trace: torch.Tensor,
               tabs: Optional[Dict] = None, hot: Optional[Dict] = None) -> Dict[str, torch.Tensor]:
        lms = (tables if tabs is None else tabs)["lms"]
        out = _ranked_outputs(cfg, lms, hot, _params_dict(cfg, params), state)
        out["paths"] = backtrace_paths(parents, trace, out["beam_src"].contiguous())
        return out

    return init_fn, seg_fn, fin_fn


def _ranked_outputs(cfg: EngineConfig, lms: List[Dict], hot: Optional[Dict], prm: Dict,
                    state: Dict) -> Dict[str, torch.Tensor]:
    """A batch decode's end (:func:`_finalize`, committing and ending): all but the paths.

    The top ``cfg.emit_paths`` ranks (all B without it): ``beam_src``,
    ``logit``, ``lm_score`` and each member's ``ctx{i}`` / ``ctx_len{i}``
    ``[N, R]``; with ``cfg.collect_stats`` the counters, ``stats``.
    """
    fin = _finalize(cfg, lms, hot, prm, state)
    r = cfg.beam_width if cfg.emit_paths is None else cfg.emit_paths
    out = {"beam_src": fin["src"][:, :r], "logit": fin["logit"][:, :r], "lm_score": fin["score"][:, :r]}
    for i in range(cfg.n_lms):
        out[f"ctx{i}"] = fin[f"ctx{i}"][:, :r]
        out[f"ctx_len{i}"] = fin[f"ctx_len{i}"][:, :r]
    if cfg.collect_stats:
        # a copy: a segment graph's state planes are overwritten by its next decode
        out["stats"] = state["stats"].clone()
    return out


def _stream_finalize(cfg: EngineConfig, lms: List[Dict], hot: Optional[Dict], prm: Dict, state: Dict,
                     do_commit: bool, is_end: bool):
    """A stream chunk's end: ``(ranked, committed)``, see :func:`make_stream_fns`' ``finalize_fn``."""
    fin = _finalize(cfg, lms, hot, prm, state, do_commit, is_end)
    ranked = {key: fin[key] for key in ("src", "score", "logit")}
    return ranked, (_committed_state(cfg, state, fin) if do_commit else None)


NEXT = "next."  # prefix of the committed state's planes in a stream finalize program's outputs


def finalize_program(cfg: EngineConfig, tables: Dict, score_boundary: Sequence[bool],
                     stream: Optional[Tuple[bool, bool]] = None):
    """The finalize of one key as a :class:`FinalizeGraph` captures it: ``fn(state, params, hot=None) -> out``.

    ``params`` is the f32 parameter vector as a tensor: device data, so a
    replay reads the values of its own call. What :func:`_finalize` branches
    on is the key, fixed here: each member's ``score_boundary`` (the host
    vector's, :func:`score_boundary_flags`) and, for a stream, ``(do_commit,
    is_end)``. With the key fixed on the host, the captured finalize issues
    the eager finalize's ops and gives its results to the bit; the reference
    traces the two stream flags instead, so that one compilation serves
    every mode, while here a stream uses at most three graphs (``is_end``
    implies a commit).

    ``stream=None`` is a batch decode's end (:func:`_ranked_outputs`, paths
    aside: the logs' length varies, so the backtrace runs after the
    replay). A stream's form gives the ranked ``src`` / ``score`` / ``logit``
    ``[1, B]`` and, when it commits, the carried state after the commit
    (:func:`_committed_state`), each plane under :data:`NEXT` + its name.
    Every output is a tensor of a flat dict.
    """
    lms = tables["lms"]

    def fn(state: Dict, params: torch.Tensor, hot: Optional[Dict] = None) -> Dict[str, torch.Tensor]:
        prm = _params_dict(cfg, params, score_boundary)
        if stream is None:
            return _ranked_outputs(cfg, lms, hot, prm, state)
        ranked, committed = _stream_finalize(cfg, lms, hot, prm, state, *stream)
        if committed is not None:
            ranked.update({NEXT + key: val for key, val in committed.items()})
        return ranked

    return fn


def run_segments(seg_fn, seg_frames: int, state: Dict, seg_in, n_seg: int, n_frames: torch.Tensor,
                 params: torch.Tensor, hot: Optional[Dict], parents: torch.Tensor, trace: torch.Tensor,
                 graph: Optional["SegmentGraph"] = None) -> Dict:
    """Advance ``state`` ``n_seg`` segments of ``seg_frames`` steps; the backpointers go into the logs.

    ``seg_in(s)`` is segment ``s``'s input; ``parents`` / ``trace`` ``[N,
    n_seg * seg_frames, B]`` are logs the caller owns, so a graph's next run
    cannot overwrite them. With ``graph`` (the key's :class:`SegmentGraph`)
    the state, lengths and parameters are loaded into its static buffers and
    each segment is one replay; the state returned is then the graph's
    static state, which the caller reads (a :class:`FinalizeGraph` does, in
    place) or copies before the graph runs again. Without it ``seg_fn`` runs
    eagerly.
    """
    if graph is not None:
        graph.load(state, n_frames, params)
    for s in range(n_seg):
        cut = slice(s * seg_frames, (s + 1) * seg_frames)
        if graph is None:
            state, (par, tok) = seg_fn(state, seg_in(s), s * seg_frames, n_frames, params, hot=hot)
        else:
            par, tok = graph.run(seg_in(s), s * seg_frames)
        parents[:, cut].copy_(par)
        trace[:, cut].copy_(tok)
    return state if graph is None else graph.state


class _Captured:
    """A program run eagerly once, then captured as a CUDA graph and replayed (see :class:`SegmentGraph`).

    A subclass's :meth:`_body` reads and writes static buffers only,
    allocated outside any capture (its first, eager run may size its
    outputs). The first :meth:`_execute` runs the body eagerly (its real
    work, and the warm-up that loads every kernel before a capture) and
    captures it right after on a side stream; later ones replay. The
    capture allocates only intermediates, from ``pool``, which the graphs
    of one decoder share:
    no graph keeps a tensor of the pool past its capture, so replays in any
    order are safe. Python's cyclic garbage collector is held off during a
    capture: freeing a CUDA graph or event there (cyclic garbage of a
    caller's) would invalidate it. The graphs themselves hold no reference
    cycle, so a dropped graph is freed at once, outside any capture.

    A replay calls no kernel wrapper, so each adds to every wrapper's
    ``launches`` the launches its capture made (counted and taken back at
    capture, which runs nothing, whether it succeeds or fails). A capture
    or replay error raises; nothing runs the program eagerly instead.

    Collectives (a row-sharded LM's probes,
    :func:`~pyctcdecode_torch.models.device_tables.probe_rows_sharded`) are
    captured with the rest. The eager first run comes before the capture on
    purpose: NCCL makes its communicator and its stream at a group's first
    collective, which must not fall inside a capture. In the capture each
    collective runs on the process group's NCCL stream, forked from the side
    stream by an event and joined back by one before the call returns, so
    every fork is joined before ``capture_end``. A replay issues the same
    collectives, so every process of the group must replay its graphs in
    the same order (see ``TorchBeamSearchDecoderCTC._segment_graph``).
    """

    KIND = ""  # the ``note`` of the tracer's ``graph.capture`` span

    def __init__(self, device: torch.device, pool) -> None:
        self.device, self.pool = device, pool
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.counts: Dict[Any, int] = {}

    def _body(self) -> None:
        raise NotImplementedError

    def _capture(self) -> None:
        wrappers = kernel_wrappers()
        before = [fn.launches for fn in wrappers]
        graph = torch.cuda.CUDAGraph()
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        tr = profiling.TRACER
        span = None if tr is None else tr.span("graph.capture", self.KIND)
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.stream(side):
                graph.capture_begin(pool=self.pool)
                try:
                    self._body()
                finally:
                    graph.capture_end()
        finally:
            if collecting:
                gc.enable()
            counts = {fn: fn.launches - n for fn, n in zip(wrappers, before)}
            for fn, n in counts.items():  # the capture ran nothing, failed or not
                fn.launches -= n
            if span is not None:
                tr.end(span)
        torch.cuda.current_stream(self.device).wait_stream(side)
        profiling.count("graph.captures")
        self.counts = counts
        self.graph = graph

    def _execute(self) -> None:
        if self.graph is None:
            self._body()
            self._capture()
        else:
            self.graph.replay()
            for fn, n in self.counts.items():
                fn.launches += n


class SegmentGraph(_Captured):
    """One segment program (``seg_fn``) captured as a CUDA graph and replayed down the utterances.

    The graph reads and writes static buffers, allocated here and never
    during the capture: the beam state, the segment's input planes, its
    first step index ``t0`` (0-d int64), ``n_frames`` and the parameter
    vector, and it writes the segment's ``parents`` / ``trace``. A decode
    fills the state, lengths and parameters with :meth:`load`, then calls
    :meth:`run` for each segment and copies its backpointers out before the
    next run; the final state stays in :attr:`state`, where the key's
    finalize graphs (:attr:`finals`, :class:`FinalizeGraph`) read it.
    ``seg_fn``'s tables (which its closure holds) and ``hot`` are read at
    the addresses captured, so the graph keeps them alive.
    """

    KIND = "segment"

    def __init__(self, seg_fn, state: Dict, seg_in, n_frames: torch.Tensor, params: torch.Tensor,
                 hot: Optional[Dict], pool) -> None:
        super().__init__(n_frames.device, pool)
        self.state = {key: torch.empty_like(val) for key, val in state.items()}
        self.seg_in = tuple(torch.empty_like(x) for x in seg_in) if isinstance(seg_in, tuple) \
            else torch.empty_like(seg_in)
        self.t0 = torch.zeros((), dtype=torch.int64, device=n_frames.device)
        self.n_frames = torch.empty_like(n_frames)
        self.params = torch.empty_like(params)
        self.hot = hot
        self._seg_fn = seg_fn
        self.parents: Optional[torch.Tensor] = None
        self.trace: Optional[torch.Tensor] = None
        self.finals: Dict[Any, "FinalizeGraph"] = {}  # this key's finalize programs, by their own key

    def load(self, state: Dict, n_frames: torch.Tensor, params: torch.Tensor) -> None:
        """Fill the static state, lengths and parameters for a new decode."""
        for key, val in state.items():
            self.state[key].copy_(val)
        self.n_frames.copy_(n_frames)
        self.params.copy_(params)

    def _body(self) -> None:
        new, (par, tok) = self._seg_fn(self.state, self.seg_in, self.t0, self.n_frames, self.params,
                                       hot=self.hot)
        for key, val in new.items():
            self.state[key].copy_(val)
        if self.parents is None:  # the eager first run sizes the outputs, outside any capture
            self.parents, self.trace = torch.empty_like(par), torch.empty_like(tok)
        self.parents.copy_(par)
        self.trace.copy_(tok)

    def run(self, seg_in, t0: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Advance the static state one segment from step ``t0``; returns its ``(parents, trace)`` buffers."""
        if isinstance(seg_in, tuple):
            for dst, src in zip(self.seg_in, seg_in):
                dst.copy_(src)
        else:
            self.seg_in.copy_(seg_in)
        self.t0.fill_(t0)
        self._execute()
        return self.parents, self.trace


class FinalizeGraph(_Captured):
    """A finalize program (:func:`finalize_program`) captured over a :class:`SegmentGraph`'s buffers.

    It reads the segment graph's static state, parameters and hotword
    tables where they are (it holds those, not the segment graph, which
    holds it), so a replay ranks what the segments left there (or what
    :meth:`SegmentGraph.load` put there: a stream's empty chunk), and writes
    every output into a static buffer of :attr:`out`, sized by the eager
    first run. A caller copies what it keeps into tensors it owns before
    anything can replay this graph again (a pipelined batch, a second
    stream on the same decoder).
    """

    KIND = "finalize"

    def __init__(self, fn, segment: SegmentGraph) -> None:
        super().__init__(segment.device, segment.pool)
        self._fn = fn
        self._state, self._params, self._hot = segment.state, segment.params, segment.hot
        self.out: Optional[Dict[str, torch.Tensor]] = None

    def _body(self) -> None:
        out = self._fn(self._state, self._params, hot=self._hot)
        if self.out is None:  # the eager first run sizes the outputs, outside any capture
            self.out = {key: torch.empty(val.shape, dtype=val.dtype, device=val.device) for key, val in out.items()}
        for key, val in out.items():
            self.out[key].copy_(val)

    def run(self) -> Dict[str, torch.Tensor]:
        """Rank the segment graph's current state; returns the static output buffers."""
        self._execute()
        return self.out


def make_stream_fns(cfg: EngineConfig, tables: Dict, seg_frames: int = 0):
    """Build the streaming primitives over uploaded ``tables``: one utterance, ``[1, B]`` planes.

    Returns ``(init_fn, chunk_fn, finalize_fn)``:

    * ``init_fn(start) -> state``: a fresh beam state (``start`` as for
      :func:`make_decode_fn`);
    * ``chunk_fn(state, logp [1, Tc, V] f32, params, hot=None, graph_for=None)
      -> (state', parents [1, Tc, B], trace [1, Tc, B])``: the frame steps
      of one chunk (frame indices relative to the chunk), with the
      backpointers narrowed to :func:`_parent_dtype` / :func:`_path_dtype`;
    * ``finalize_fn(state, params, do_commit, is_end, hot) -> (ranked,
      committed)``: the ranked view ``{"src", "score", "logit"}`` ``[1, B]``
      of the current hypotheses (:func:`_finalize`), and the carried state
      after the commit (:func:`_committed_state`) when ``do_commit``, else
      None. On the card a stream replays it as a :class:`FinalizeGraph`
      (:func:`finalize_program`) instead.

    With ``seg_frames = 0`` a chunk runs exactly its frames, one step at a
    time. With ``seg_frames > 0`` it runs as ``ceil(Tc / seg_frames)``
    segments of :func:`make_segment_decode_fns`' ``seg_fn`` at N = 1
    (``n_frames = [Tc]``, chunk-relative ``t0``), the logits padded with
    zeros to whole segments: the padded steps are inactive, as the
    reference's chunks padded to ``_bucket`` sizes are, and the logs are cut
    back to the chunk's ``Tc`` steps. ``graph_for(seg_fn, state, seg_in,
    n_frames, params) -> SegmentGraph`` gives the key's graph (made from
    these prototypes on a miss), which replays each segment; ``state'`` is
    then the graph's static state, read or copied by the caller before the
    graph runs again.
    """
    if cfg.token_timeline:
        raise ValueError(
            "the streaming API does not support token_timeline decoding "
            "(chunk_fn consumes dense logit chunks; use the batch APIs "
            "for timeline mode)"
        )
    device = tables["tok"]["kind"].device
    par_dtype, tok_dtype = _parent_dtype(cfg.beam_width), _path_dtype(cfg.vocab_size)
    seg_fn = make_segment_decode_fns(cfg, tables, seg_frames)[1] if seg_frames else None

    def init_fn(start: Sequence[Dict]) -> Dict:
        return _init_state(cfg, start, 1, device)

    def chunk_fn(state: Dict, logp: torch.Tensor, params: np.ndarray, hot: Optional[Dict] = None,
                 graph_for: Optional[Callable[..., SegmentGraph]] = None):
        n, tc, v = logp.shape
        t_pad = -(-tc // seg_frames) * seg_frames if seg_frames else tc
        tr = profiling.TRACER
        if tr is not None:
            tr.count("steps.active", n * tc)
            tr.count("steps.launched", n * t_pad)
        if seg_frames:
            n_seg = t_pad // seg_frames
            padded = torch.nn.functional.pad(logp, (0, 0, 0, t_pad - tc))
            parents = torch.empty((n, t_pad, cfg.beam_width), dtype=par_dtype, device=device)
            trace = torch.empty((n, t_pad, cfg.beam_width), dtype=tok_dtype, device=device)
            n_frames = torch.full((n,), tc, dtype=torch.int64, device=device)
            prm = torch.as_tensor(np.asarray(params, dtype=np.float32), device=device)
            graph = None
            if graph_for is not None:  # an empty chunk still loads and finalizes through the graph
                proto = padded[:, :seg_frames] if n_seg else logp.new_empty((n, seg_frames, v))
                graph = graph_for(seg_fn, state, proto, n_frames, prm)
            state = run_segments(seg_fn, seg_frames, state, lambda s: padded[:, s * seg_frames : (s + 1) * seg_frames],
                                 n_seg, n_frames, prm, hot, parents, trace, graph)
            return state, parents[:, :tc], trace[:, :tc]
        parents = torch.empty((n, tc, cfg.beam_width), dtype=par_dtype, device=device)
        trace = torch.empty((n, tc, cfg.beam_width), dtype=tok_dtype, device=device)
        if tc:
            prm = _params_dict(cfg, params)
            step = _make_step(cfg, tables, hot, prm, torch.full((n,), tc, dtype=torch.int64, device=device))
            for t in range(tc):
                state, (par, tok) = step(state, logp[:, t], t)
                parents[:, t] = par
                trace[:, t] = tok
        return state, parents, trace

    def finalize_fn(state: Dict, params: np.ndarray, do_commit: bool, is_end: bool,
                    hot: Optional[Dict] = None):
        return _stream_finalize(cfg, tables["lms"], hot, _params_dict(cfg, params), state, do_commit, is_end)

    return init_fn, chunk_fn, finalize_fn
