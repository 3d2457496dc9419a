"""The engine step's trie walk (``ops/walk.py``) on real tries: five cases and their step inputs.

Imports numpy, torch and the port only (no JAX), so the card tests (``test_torch_kernels_cuda``)
hold the kernel to its twin on the very inputs the CPU tests hold the twin to the JAX engine on.
"""
import numpy as np
import torch

import pyctcdecode_torch as P
from pyctcdecode_torch import engine
from pyctcdecode_torch.models.device_tables import HOT_NODE_MASK, trie_fetch_rows
from pyctcdecode_torch.models.ngram import open_ngram_file

from .helpers import SAMPLE_LABELS
from .torch_cases import ARPA, ARPA_2GRAM, LM_WORDS, UNIGRAMS, conformer_width, piece_vocabulary
from .w2v2_cases import ARPA as W2V2_ARPA
from .w2v2_cases import W2V2_LABELS

# char: one-letter labels (lmax 1); w2v2: wav2vec2-base-960h's 32 labels (</s>: lmax 4); bpe: a
# 129-piece vocabulary (lmax 5, a right-bounded piece); two members, hotwords: a 3-gram and a 2-gram
# at other settings and a hot trie, on timeline chunks (tokens per utterance, empty slots as token 0);
# edges: the bpe pieces with both members and hotwords, most beams in a corner: on the dead node,
# forced after a right-bounded piece, repeating a token of the step, or past AVG_TOKEN_LEN letters
CASES = ("char", "w2v2", "bpe", "two members, hotwords", "edges")
N, B = 3, 16
CHUNK = 5  # token columns of the timeline case
HOTWORDS = ["bugs bunny", "sun", "gunny"]
HOT_WEIGHT = 8.0
UNK_OFFSETS = (-10.0, -6.5)


def _members(case, root):
    """The case's LM members: the 3-gram, and for two-member cases the 2-gram beside it."""
    texts = [("a", W2V2_ARPA if case == "w2v2" else ARPA, {})]
    if case in ("two members, hotwords", "edges"):
        texts.append(("b", ARPA_2GRAM, dict(alpha=0.3, beta=2.0, unk_score_offset=UNK_OFFSETS[1])))
    members = []
    for name, text, kw in texts:
        path = root / f"{name}.arpa"
        path.write_text(text)
        unigrams = None if case == "w2v2" else UNIGRAMS
        members.append(P.LanguageModel(open_ngram_file(str(path), backend="python"), unigrams,
                                       unk_score_offset=kw.pop("unk_score_offset", UNK_OFFSETS[0]), **kw))
    return members


def walk_decoder(case, root, device):
    """The case's decoder on ``device``: its tables and hot trie are what its step hands the walk."""
    if case in ("bpe", "edges"):
        labels = conformer_width(piece_vocabulary(LM_WORDS))
    else:
        labels = W2V2_LABELS if case == "w2v2" else SAMPLE_LABELS
    members = _members(case, root)
    lm = members[0] if len(members) == 1 else P.MultiLanguageModel(members)
    return P.TorchBeamSearchDecoderCTC(P.Alphabet.build_alphabet(labels), lm, device=device)


def _entries(rng, dlm, nb, dead_share):
    """Packed trie entries of ``nb`` beams: the root, piece seeds (nodes with children), any node, the dead node."""
    trie = dlm.trie
    seeds = dlm.seed_node.astype(np.int64)
    pick = rng.rand(nb)
    nodes = np.where(pick < 0.4, seeds[rng.randint(0, len(seeds), nb)], rng.randint(0, trie.n_nodes, nb))
    nodes = np.where(pick > 0.9, 0, nodes)
    nodes = np.where(rng.rand(nb) < dead_share, trie.dead, nodes)
    return nodes, dlm._node_flag_bits(nodes).astype(np.int64)


def walk_inputs(case, dec, seed, params_on_device=False):
    """The walk's arguments at one step of ``dec``: ``(lms, hot, prm, state, toks, tok, trie_rows, is_bpe)``.

    The beam state is seeded: entries on real nodes of each trie (and the hot trie), partial lengths 0-9,
    last tokens among the step's tokens, the start token and dead beams' sentinels, ``force`` on some
    beams. ``edges`` puts half the beams on the dead node, forces most and repeats tokens.
    """
    rng = np.random.RandomState(seed)
    tabs, device = dec._tabs, dec.device
    v = len(dec._labels)
    nb = N * B
    edges = case == "edges"
    use_hot = case in ("two members, hotwords", "edges")
    hot, _ = dec._hot_tables(HOTWORDS, HOT_WEIGHT) if use_hot else (None, 0.0)
    if case == "two members, hotwords":
        toks = np.sort(rng.randint(0, v, size=(N, CHUNK)), axis=1)
        toks[:, 0] = np.where(rng.rand(N) < 0.5, 0, toks[:, 0])  # a clamped empty slot
    else:
        toks = np.broadcast_to(np.arange(v), (N, v)).copy()
    k = toks.shape[1]
    state = {
        "p_len": np.where(rng.rand(nb) < 0.2, 0, rng.randint(1, 13 if edges else 10, nb)).astype(np.int64),
        "force": rng.rand(nb) < (0.7 if edges else 0.3),
    }
    last = toks[np.repeat(np.arange(N), B), rng.randint(0, k, nb)]
    last = np.where(rng.rand(nb) < (0.6 if edges else 0.3), last, rng.randint(0, v, nb))
    last = np.where(rng.rand(nb) < 0.1, -1, last)
    state["last_tok"] = np.where(rng.rand(nb) < 0.1, -2 - np.tile(np.arange(B), N), last).astype(np.int64)
    for i, dlm in enumerate(dec._device_lm):
        state[f"p_node{i}"], state[f"p_flags{i}"] = _entries(rng, dlm, nb, 0.5 if edges else 0.1)
    if use_hot:
        nxt = hot["next_host"].astype(np.int64).reshape(-1)
        ent = nxt[rng.randint(0, nxt.size, nb)]
        ent = np.where(rng.rand(nb) < 0.3, hot["seed"].cpu().numpy()[rng.randint(0, v, nb)], ent)
        state["h_node"], state["h_bits"] = ent & HOT_NODE_MASK, ent & ~HOT_NODE_MASK
    state = {key: torch.as_tensor(val).reshape(N, B).to(device) for key, val in state.items()}
    cfg = engine.EngineConfig(beam_width=B, vocab_size=v, k_tokens=k, prune_history=False, use_hotwords=use_hot,
                              is_bpe=dec._tokens.is_bpe, orders=tuple(d.order for d in dec._device_lm))
    vec = np.asarray([-5.0, -10.0, HOT_WEIGHT] + [x for i in range(cfg.n_lms)
                                                   for x in (0.5, 1.0, UNK_OFFSETS[i], 1.0)], dtype=np.float32)
    prm = engine._params_dict(cfg, torch.as_tensor(vec, device=device) if params_on_device else vec)
    lms = tabs["lms"]
    trie_rows = [trie_fetch_rows(lm["trie_rows"], lm["trie_pack"], state[f"p_node{i}"]) for i, lm in enumerate(lms)]
    return lms, hot, prm, state, torch.as_tensor(toks, device=device), tabs["tok"], trie_rows, cfg.is_bpe


def classes(args):
    """How many candidates stay, cross a boundary, are forced across one, and walk from the dead node."""
    lms, _, _, state, toks, tok, _, is_bpe = args
    kind = tok["kind"][toks][:, None, :]
    stay = (kind == 0) | (state["last_tok"][:, :, None] == toks[:, None, :])
    boundary = ~stay & (kind == 1)
    forced = ~stay & ~boundary & state["force"][:, :, None] if is_bpe else torch.zeros_like(stay)
    walks = ~stay & ~boundary & ~forced
    dead = torch.zeros_like(stay)
    if lms:
        dead = (state["p_node0"] == lms[0]["trie_pack"]["dead"])[:, :, None] & walks
    return {"stay": int(stay.sum()), "boundary": int(boundary.sum()), "forced": int(forced.sum()),
            "walks": int(walks.sum()), "dead": int(dead.sum())}
