"""Sharded decoding over ``torch.distributed`` (gloo on the CPU), and the row-windowed probe.

``ShardedCTCDecoder`` runs one process a device: the tests spawn 2 and 3
processes of this module (``python -m tests.test_torch_parallel``), each
bringing the group up from the ``PYCTC_*`` variables, decoding the same
global batch with ``shard_lm`` off and on, and writing what it got. Every
process's global result must equal the JAX package's decoder on the same
ARPA, unigrams, labels and batch (texts, ``text_frames``, LM states and
counters equal, scores within ``SCORE_TOL``), as must the single-process
port decoder, and it must equal the latter to the bit (one process owns
each probed row and the others add zeros, so the sums are exact). Three
processes over four utterances leave the last process
nothing but padded rows. Each process also runs every case with ``shard_lm``
through a wrapped decoder made with ``with_options(segment_frames=4)``: the
segment and finalize programs the card captures, run eagerly here with
their gloo collectives. Those results must equal the eager sharded decode's
and the single decoder's to the bit, and every process must issue its
collective probes at the same points of the segment and finalize programs
(a log of each probe's query shape between the two). LM knobs set with
``reset_params`` on the wrapped
decoder after its first decodes reach the next one. The row windows themselves are checked in one
process: ``probe_rows_ref`` over 2 and 3 windows, summed, equals the
whole-table probe in both hash modes, and the windows are the JAX
package's ``build_table_args(shard=...)`` planes, block for block.
"""
import functools
import os
import pickle
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BEAM = 8
HOTWORDS = ["bunny", "sun"]
CASES = {  # every case with shard_lm on; the first two with it off too
    "dense": {},
    "stats": dict(collect_stats=True),
    "blank_collapse": dict(blank_collapse=True),
    "token_chunking": dict(token_chunking=3, collect_stats=True),
    "hotwords": dict(hotwords=HOTWORDS, hotword_weight=6.0),
    "auto_k": dict(max_tokens_per_frame="auto", blank_collapse=True),
}
SEGMENT = 4  # steps a segment of the segmented sharded decodes
RETUNE = dict(alpha=0.9, beta=2.5)  # LM knobs set on the wrapped decoder after its sharded decodes


def _batch():
    from .torch_cases import word_logits

    batch = [word_logits(21, 22), word_logits(22, 11), word_logits(23, 28), word_logits(24, 16)]
    batch[2][4:12, -1] += 14.0  # a blank run for the collapse
    return batch


def _decoder(arpa):
    import pyctcdecode_torch as P
    from pyctcdecode_torch.models.ngram import open_ngram_file

    from .helpers import SAMPLE_LABELS
    from .torch_cases import UNIGRAMS

    lm = P.LanguageModel(open_ngram_file(arpa), UNIGRAMS)
    return P.TorchBeamSearchDecoderCTC(P.Alphabet.build_alphabet(SAMPLE_LABELS), lm, device="cpu")


def _logged_collectives(log: list):
    """Record each collective probe's query shape, between ``"segments"`` and ``"finalize"`` marks."""
    from pyctcdecode_torch import torch_decoder
    from pyctcdecode_torch.models import device_tables

    probe, run_segments = device_tables.probe_rows_sharded, torch_decoder.run_segments

    def logged_probe(shard, full, *args, **kw):
        log.append(tuple(full.shape))
        return probe(shard, full, *args, **kw)

    def logged_segments(*args, **kw):
        log.append("segments")
        state = run_segments(*args, **kw)
        log.append("finalize")
        return state

    device_tables.probe_rows_sharded = logged_probe
    torch_decoder.run_segments = logged_segments


def _worker(out_path: str, arpa: str) -> None:
    """One process of the group: every case with ``shard_lm`` off and on, and in segments, pickled to ``out_path``."""
    from pyctcdecode_torch.parallel import ShardedCTCDecoder, all_reduce_counts, make_data_mesh, process_shard

    mesh = make_data_mesh(device="cpu")
    rank = torch.distributed.get_rank()
    dec, batch = _decoder(arpa), _batch()
    out = {"rank": rank, "shard": process_shard(len(batch)), "collectives": {}}
    for shard_lm in (False, True):
        sharded = ShardedCTCDecoder(dec, mesh=mesh, shard_lm=shard_lm)
        for name, kw in list(CASES.items())[: None if shard_lm else 2]:
            out[(shard_lm, name)] = sharded.decode_beams_batch(batch, beam_width=BEAM, **kw)
        out[(shard_lm, "multiprocess")] = sharded.decode_beams_batch_multiprocess(batch, beam_width=BEAM, top_n=2)
    log: list = []
    _logged_collectives(log)
    segmented = ShardedCTCDecoder(dec.with_options(segment_frames=SEGMENT), mesh=mesh, shard_lm=True)
    for name, kw in CASES.items():
        del log[:]
        out[("segmented", name)] = segmented.decode_beams_batch(batch, beam_width=BEAM, **kw)
        out["collectives"][name] = list(log)
    out["texts"] = sharded.decode_batch(batch, beam_width=BEAM)
    out["planes"] = [(t["row0"], t["size"], t["bucket"].numpy()) for t in sharded._tabs["lms"][0]["fp"]]
    out["counts"] = all_reduce_counts(mesh, np.array([rank + 1, 10 * (rank + 1)]))
    dec.reset_params(**RETUNE)  # read by the next sharded decode (shard_lm on)
    out["retuned"] = sharded.decode_beams_batch(batch, beam_width=BEAM)
    with open(out_path, "wb") as fh:
        pickle.dump(out, fh)
    torch.distributed.destroy_process_group()


@pytest.fixture(scope="module")
def arpa(tmp_path_factory):
    from .torch_cases import ARPA

    path = str(tmp_path_factory.mktemp("lm") / "bb3.arpa")
    with open(path, "w") as fh:
        fh.write(ARPA)
    return path


def _start(world: int, arpa: str, tmp_path) -> list:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = []
    for rank in range(world):
        env = dict(os.environ, PYCTC_COORDINATOR=f"127.0.0.1:{port}", PYCTC_NUM_PROCESSES=str(world),
                   PYCTC_PROCESS_ID=str(rank), PYTHONPATH=REPO)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "tests.test_torch_parallel", str(tmp_path / f"{rank}.pkl"), arpa],
            cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        ))
    return procs


def _finish(procs: list, tmp_path) -> list:
    try:
        outs = [p.communicate(timeout=240)[0].decode() for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    parts = []
    for rank in range(len(procs)):
        with open(tmp_path / f"{rank}.pkl", "rb") as fh:
            parts.append(pickle.load(fh))
    return parts


def _same(want, got, tol=0.0):
    from .torch_cases import assert_same_beams

    assert len(want) == len(got)
    for w, g in zip(want, got):
        assert_same_beams(w, g, tol=tol)


def _split(kw, out):
    """(results, stats or None) of a ``decode_beams_batch`` call made with ``kw``."""
    return out if kw.get("collect_stats") else (out, None)


@functools.lru_cache(maxsize=None)
def _wants(arpa: str) -> dict:
    """Every case, the top-2 call and the texts, from the JAX package's decoder and the single port decoder."""
    from pyctcdecode_tpu import Alphabet as JAlphabet
    from pyctcdecode_tpu import LanguageModel as JLanguageModel
    from pyctcdecode_tpu import TPUBeamSearchDecoderCTC
    from pyctcdecode_tpu.models.ngram import NGramModel as JNGramModel

    from .helpers import SAMPLE_LABELS
    from .torch_cases import UNIGRAMS

    jdec = TPUBeamSearchDecoderCTC(JAlphabet.build_alphabet(SAMPLE_LABELS),
                                   JLanguageModel(JNGramModel.from_file(arpa), UNIGRAMS))
    dec, batch = _decoder(arpa), _batch()
    out = {}
    for name, kw in list(CASES.items()) + [("top2", dict(top_n=2))]:
        out[name] = (_split(kw, jdec.decode_beams_batch(batch, beam_width=BEAM, **kw)),
                     _split(kw, dec.decode_beams_batch(batch, beam_width=BEAM, **kw)))
    out["texts"] = (jdec.decode_batch(batch, beam_width=BEAM), dec.decode_batch(batch, beam_width=BEAM))
    return out


def _check(want, got):
    """``got`` (results, stats) equals JAX's within ``SCORE_TOL`` and the single port decoder's to the bit."""
    from .torch_cases import SCORE_TOL

    (j_res, j_stats), (p_res, p_stats) = want
    assert got[1] == j_stats
    _same(j_res, got[0], tol=SCORE_TOL)
    _same(p_res, got[0])


@pytest.mark.parametrize("world", [2, 3])
def test_sharded_decode_equals_the_single_decoder(world, arpa, tmp_path):
    from pyctcdecode_torch.models.device_tables import shard_bucket_plane

    procs = _start(world, arpa, tmp_path)
    wants = _wants(arpa)  # while the processes decode
    parts = _finish(procs, tmp_path)
    dec, batch = _decoder(arpa), _batch()
    per = -(-len(batch) // world)
    for name, kw in CASES.items():
        for part in parts:
            for shard_lm in (False, True):
                if (shard_lm, name) in part:
                    _check(wants[name], _split(kw, part[(shard_lm, name)]))
            # in segments: JAX's results and the single decoder's, and the eager sharded decode's to the bit
            got = _split(kw, part[("segmented", name)])
            _check(wants[name], got)
            eager = _split(kw, part[(True, name)])
            _same(eager[0], got[0])
            assert got[1] == eager[1]
        # every process probed at the same points: each step of the padded segments, then the finalize
        log = parts[0]["collectives"][name]
        assert all(part["collectives"][name] == log for part in parts[1:])
        assert log[0] == "segments" and log.count("segments") == log.count("finalize") == 1
        steps, tail = log.index("finalize") - 1, len(log) - log.index("finalize") - 1
        assert steps > 0 and steps % SEGMENT == 0 and tail in (1, 2)
    (j_top2, _), (p_top2, _) = wants["top2"]
    for part in parts:
        start, stop = min(part["rank"] * per, len(batch)), min((part["rank"] + 1) * per, len(batch))
        assert part["shard"] == (start, stop)
        for shard_lm in (False, True):
            results, span = part[(shard_lm, "multiprocess")]
            assert span == (start, stop)
            _check(((j_top2[start:stop], None), (p_top2[start:stop], None)), (results, None))
        assert part["texts"] == wants["texts"][0]
        assert part["counts"].tolist() == [sum(range(1, world + 1)), 10 * sum(range(1, world + 1))]
    # ``reset_params`` on the wrapped decoder reaches a shard_lm decode
    dec.reset_params(**RETUNE)
    retuned = dec.decode_beams_batch(batch, beam_width=BEAM)
    assert [b[0].lm_score for b in retuned] != [b[0].lm_score for b in wants["dense"][1][0]]
    for part in parts:
        _same(retuned, part["retuned"])
    # each process holds its row block of every bucket plane
    assert parts[-1][(True, "dense")] and (world * per > len(batch) or world == 2)
    for t, tab in enumerate(dec._device_lm[0].fp_tables):
        blocks = shard_bucket_plane(tab.bucket, world)
        for part in parts:
            row0, size, plane = part["planes"][t]
            assert (row0, size) == (part["rank"] * blocks.shape[1], tab.size)
            np.testing.assert_array_equal(plane, blocks[part["rank"]])


def test_single_decoder_equals_jax(arpa):
    """The reference every sharded result is held to: the single port decoder against JAX's, case by case."""
    wants = _wants(arpa)
    for name in list(CASES) + ["top2"]:
        _check(wants[name], wants[name][1])
    assert wants["texts"][1] == wants["texts"][0]


@pytest.fixture(scope="module")
def lm_tables(arpa, tmp_path_factory):
    """Bucket tables of both hash modes: an FNV model (ARPA) and a KenLM binary's, with present n-grams."""
    import pyctcdecode_torch as P
    from pyctcdecode_torch.evaluation import make_parity_arpa
    from pyctcdecode_torch.models import device_tables as tdt
    from pyctcdecode_torch.models.ngram import open_ngram_file
    from pyctcdecode_torch.ops.tokens import build_token_arrays
    from pyctcdecode_tpu.models.kenlm_bin import write_kenlm_binary
    from pyctcdecode_tpu.models.ngram import read_arpa

    root = tmp_path_factory.mktemp("tables")
    path = str(root / "small3.arpa")
    make_parity_arpa(path, n_vocab=300, n_bigrams=2000, n_trigrams=1500)
    binary = str(root / "small3.bin")
    write_kenlm_binary(read_arpa(path), binary)
    tokens = build_token_arrays(P.Alphabet.build_alphabet([" "] + list("abcdefghijklmnopqrstuvwxyz") + ["'", ""]))
    out = {}
    for mode, model in (("fnv", open_ngram_file(path, backend="python")), ("kenlm64", open_ngram_file(binary))):
        dlm = tdt.build_device_lm(P.LanguageModel(model, []), tokens)
        assert {t.hash_mode for t in dlm.fp_tables} == {mode}
        out[mode] = dlm
    present = open_ngram_file(path, backend="python").tables.ngrams
    return out, present


@pytest.mark.parametrize("mode", ["fnv", "kenlm64"])
@pytest.mark.parametrize("world", [2, 3])
def test_window_probes_sum_to_the_whole_probe(lm_tables, mode, world):
    from pyctcdecode_torch.models.device_tables import LMShard, _BUCKET_SLOTS, _SUB_WIDTH
    from pyctcdecode_torch.ops.gather import probe_rows, probe_rows_ref

    dlms, present = lm_tables
    dlm = dlms[mode]
    rng = np.random.RandomState(world)
    q = 600
    full = rng.randint(0, len(present[0]), size=(q, 3)).astype(np.int64)
    grams = np.array(list(present[2]), dtype=np.int64)
    full[::3] = grams[rng.randint(0, len(grams), size=len(full[::3]))]  # trigram hits
    bigrams = np.array(list(present[1]), dtype=np.int64)
    full[1::3, 1:] = bigrams[rng.randint(0, len(bigrams), size=len(full[1::3]))]  # bigram hits
    ctx_len = rng.randint(0, 3, size=q).astype(np.int64)
    full_t, ctx_t = torch.as_tensor(full.reshape(20, 30, 3)), torch.as_tensor(ctx_len.reshape(20, 30))
    whole = probe_rows_ref(full_t, ctx_t, dlm.as_device("cpu")["fp"], _BUCKET_SLOTS, _SUB_WIDTH)
    assert int(whole[0].sum()) > 100  # hits at both orders
    summed = None
    for rank in range(world):
        tabs = dlm.as_device("cpu", LMShard(None, rank, world))["fp"]
        part = probe_rows(full_t, ctx_t, tabs, _BUCKET_SLOTS, _SUB_WIDTH)  # the wrapper's checks, then the plain version
        part = (part[0].to(torch.int32), part[1], part[2])
        summed = part if summed is None else tuple(a + b for a, b in zip(summed, part))
    assert torch.equal(summed[0] > 0, whole[0]) and int(summed[0].max()) <= 1
    assert torch.equal(summed[1], whole[1]) and torch.equal(summed[2], whole[2])


@pytest.mark.parametrize("world", [2, 3])
def test_sharded_planes_equal_jax_build_table_args(arpa, world):
    import jax.numpy as jnp

    from pyctcdecode_torch.models.device_tables import LMShard
    from pyctcdecode_tpu import Alphabet as JAlphabet
    from pyctcdecode_tpu import LanguageModel as JLanguageModel
    from pyctcdecode_tpu.engine import build_table_args as j_build_table_args
    from pyctcdecode_tpu.models.device_tables import build_device_lm as j_build_device_lm
    from pyctcdecode_tpu.models.ngram import NGramModel as JNGramModel
    from pyctcdecode_tpu.ops.tokens import build_token_arrays as j_tokens

    from .helpers import SAMPLE_LABELS
    from .torch_cases import UNIGRAMS

    j_tok = j_tokens(JAlphabet.build_alphabet(SAMPLE_LABELS))
    jdlm = j_build_device_lm(JLanguageModel(JNGramModel.from_file(arpa), UNIGRAMS), j_tok)
    j_tabs = j_build_table_args(jnp, j_tok, jdlm, shard=("data", world))
    import pyctcdecode_torch as P
    from pyctcdecode_torch.models import device_tables as tdt
    from pyctcdecode_torch.models.ngram import open_ngram_file
    from pyctcdecode_torch.ops.tokens import build_token_arrays

    # both read in Python: the native engine's tables hold the same residents in other slots
    tdlm = tdt.build_device_lm(P.LanguageModel(open_ngram_file(arpa, backend="python"), UNIGRAMS),
                               build_token_arrays(P.Alphabet.build_alphabet(SAMPLE_LABELS)))
    for rank in range(world):
        fp = tdlm.as_device("cpu", LMShard(None, rank, world))["fp"]
        for t, j in zip(fp, j_tabs["lms"][0]["fp"]):
            np.testing.assert_array_equal(t["bucket"].numpy(), np.asarray(j["bucket"])[rank])
            assert t["seed_lo"] == int(j["seed_lo"]) and t["seed_hi"] == int(j["seed_hi"])


def test_make_data_mesh_without_a_group_raises(monkeypatch):
    from pyctcdecode_torch.parallel import make_data_mesh, process_shard

    for key in ("PYCTC_COORDINATOR", "PYCTC_NUM_PROCESSES", "PYCTC_PROCESS_ID",
                "MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(key, raising=False)
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        make_data_mesh(device="cpu")
    assert not torch.distributed.is_initialized()
    monkeypatch.setenv("PYCTC_NUM_PROCESSES", "2")
    with pytest.raises(ValueError, match="incomplete"):
        make_data_mesh(device="cpu")
    assert process_shard(5) == (0, 5)  # one process without a group


if __name__ == "__main__":
    _worker(sys.argv[1], sys.argv[2])
