"""The port on two gloo ranks (CPU, f32) against keds_tpu on a 2-device mesh
and against its own one-process run: the sharded top-k, the sharded
retriever and fingerprint, the engine with a mesh, and the train steps of
the image stream, the text stream and a RawBatch.

The ranks run once, as child processes that import no jax
(``tests/torch_dist_worker.py core``); every test reads their outputs.  The
JAX references run here on 2 of the 8 CPU devices tests/conftest.py makes.
"""

import json
from types import SimpleNamespace

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from keds_tpu.config import Config as JConfig
from keds_tpu.engine import ComposedQueryEngine as JEngine
from keds_tpu.io.checkpoint import save_train_checkpoint
from keds_tpu.ops import topk as jtopk
from keds_tpu.parallel.mesh import make_mesh as jmake_mesh, shard_batch as jshard_batch
from keds_tpu.retrieval.database import KnowledgeDB as JKnowledgeDB, Retriever as JRetriever
from keds_tpu.retrieval.database import db_fingerprint as jdb_fingerprint
from keds_tpu.train import losses as jlosses
from keds_tpu.train.trainer import make_optimizer as jmake_optimizer
from keds_tpu.train.trainer import make_train_step as jmake_train_step
import keds_tpu.engine as jengine_mod

from keds_tpu_torch.engine import ComposedQueryEngine
from keds_tpu_torch.ops.topk import mips_topk
from keds_tpu_torch.retrieval.database import KnowledgeDB, Retriever, db_fingerprint
from keds_tpu_torch.train.losses import RawBatch, TrainBatch
from keds_tpu_torch.train.trainer import make_optimizer, make_train_step

from torch_dist_worker import OPT, SPLIT_ID, leaves, run_ranks
from torch_port_helpers import (D, JCFG, TCFG, jax_models, port_models, prompt_tokens,
                                to_numpy)

torch.set_num_threads(1)
W = 2
PROMPT = np.zeros((1, 77), np.int32)
PROMPT[0, :5] = [49406, 320, 1125, 539, 49407]   # "a photo of"
FEAT_TOL = 1e-5     # f32 features and gradients: sums in another order
TOPK_CASES = ("n_pad_negative_scores", "k_above_shard_rows", "ties_across_shards",
              "k_zero")


def _topk_inputs(rng):
    """(queries, rows, k) of each case."""
    q = np.abs(rng.standard_normal((5, D))).astype(np.float32)
    neg = -np.abs(rng.standard_normal((37, D))).astype(np.float32)   # every score < 0
    small = rng.standard_normal((9, D)).astype(np.float32)           # 5 rows a shard, k=6
    half = rng.standard_normal((8, D)).astype(np.float32)
    tied = np.concatenate([half, half])        # row i and row i + 8 score alike
    cases = [(q, neg, 4), (rng.standard_normal((5, D)).astype(np.float32), small, 6),
             (rng.standard_normal((5, D)).astype(np.float32), tied, 5)]
    # k = 0 (the serve CLI's --topn 0): empty results; over 9 rows, so a pad
    # row gives JAX's Pallas backend a candidate (it refuses k = 0 itself)
    return cases + [(q, small, 0)]


def _templates(rng, n, n_stars):
    """(n, 77) "a photo of * x n_stars <ids> EOT" token rows."""
    out = np.zeros((n, 77), np.int32)
    out[:, :4] = [49406, 320, 1125, 539]
    out[:, 4:4 + n_stars] = SPLIT_ID
    for i in range(n):
        m = int(rng.integers(2, 12))
        out[i, 4 + n_stars:4 + n_stars + m] = rng.integers(1000, 40000, m)
        out[i, 4 + n_stars + m] = 49407
    return out


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    d = tmp_path_factory.mktemp("dist_core")
    rng = np.random.default_rng(0)
    z = {"n_topk": np.array(len(TOPK_CASES))}
    for i, (q, rows, k) in enumerate(_topk_inputs(rng)):
        z[f"topk{i}_q"], z[f"topk{i}_db"], z[f"topk{i}_k"] = q, rows, np.array(k)
    z["ret_img"], z["ret_txt"] = (rng.standard_normal((37, D)).astype(np.float32)
                                  for _ in range(2))
    z["ret_feat"], z["ret_k"] = rng.standard_normal((6, D)).astype(np.float32), np.array(5)
    z["eng_img"], z["eng_txt"] = (rng.standard_normal((41, D)).astype(np.float32)
                                  for _ in range(2))
    for i, n in enumerate((5, 3)):
        z[f"eng_q{i}"] = rng.integers(0, 256, (n, 32, 32, 3), dtype=np.uint8)
        z[f"eng_t{i}"] = prompt_tokens(n, 6 + 9 * i, seed=i)
    for i, n in enumerate((4, 3)):
        z[f"eng_c{i}"] = rng.integers(0, 256, (n, 32, 32, 3), dtype=np.uint8)
    z["eng_topn"] = np.array(4)
    z["tr_img_db"], z["tr_txt_db"] = (rng.standard_normal((33, D)).astype(np.float32)
                                      for _ in range(2))
    z["tr_db_other"] = _templates(rng, 33, 2)
    z["tr_k"], z["tr_prompt"] = np.array(8), PROMPT
    z["tr_feat_img"], z["tr_feat_cap"] = (rng.standard_normal((3, 8, D)).astype(np.float32)
                                          for _ in range(2))
    z["tr_other"] = np.stack([_templates(rng, 8, 3) for _ in range(3)])
    z["tr_images"] = rng.integers(0, 256, (3, 8, 32, 32, 3), dtype=np.uint8)
    z["tr_caps"] = np.stack([prompt_tokens(8, 5, seed=t) for t in range(3)])
    np.savez(d / "inputs.npz", **z)
    params, heads = jax_models()
    save_train_checkpoint(str(d / "model.pt"), epoch=1, name="t", clip_params=params,
                          clip_cfg=JCFG, heads=heads)
    outs = run_ranks("core", d, timeout=240)
    return SimpleNamespace(z=z, outs=outs, mesh=jmake_mesh(W))


def _ranks_agree(run, key):
    a, b = (o[key] for o in run.outs)
    np.testing.assert_array_equal(a, b)
    return a


# --- sharded top-k -------------------------------------------------------------

@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("case", range(len(TOPK_CASES)), ids=TOPK_CASES)
def test_mips_topk_sharded_matches_jax(run, case, backend):
    q, rows, k = (run.z[f"topk{case}_{n}"] for n in ("q", "db", "k"))
    vals, idx = (_ranks_agree(run, f"topk{case}_{n}") for n in ("vals", "idx"))
    jdb = JKnowledgeDB.from_arrays(rows, rows, dtype=jnp.float32, normalize=False)
    jv, ji = jtopk.mips_topk_sharded(jnp.asarray(q), jdb.shard_over(run.mesh).image_db,
                                     int(k), run.mesh, backend=backend, interpret=True,
                                     n_real=len(rows))
    jv, ji = np.asarray(jv), np.asarray(ji)
    np.testing.assert_allclose(vals, jv, rtol=0, atol=FEAT_TOL)
    # indices equal wherever the scores are more than 1e-6 apart; the tie case
    # is exact: equal rows give bit-equal scores, and the lower row wins
    apart = np.abs(np.diff(jv, axis=1, prepend=np.inf)) > 1e-6
    apart &= np.abs(np.diff(jv, axis=1, append=-np.inf)) > 1e-6
    if TOPK_CASES[case] == "ties_across_shards":
        apart[:] = True
    np.testing.assert_array_equal(idx[apart], ji[apart])
    # and the port's one-process search of the whole database
    pv, pi = mips_topk(torch.from_numpy(q), torch.from_numpy(rows), int(k))
    np.testing.assert_array_equal(idx, pi.numpy())
    if TOPK_CASES[case] == "n_pad_negative_scores":
        assert (vals < 0).all() and (idx < len(rows)).all()   # no pad row in the result
    if TOPK_CASES[case] == "k_zero":
        assert vals.shape == idx.shape == jv.shape == (len(q), 0)
        assert (vals.dtype, idx.dtype) == (jv.dtype, ji.dtype)


# --- sharded retrieval -----------------------------------------------------------

def test_sharded_retriever_matches_jax_and_one_process(run):
    z = run.z
    k = int(z["ret_k"])
    jdb = JKnowledgeDB.from_arrays(z["ret_img"], z["ret_txt"], dtype=jnp.float32)
    jr = JRetriever(jdb.shard_over(run.mesh), mesh=run.mesh, sharded=True)
    feat, _ = jshard_batch(run.mesh, jnp.asarray(z["ret_feat"]))
    jti, jtt = jr.retrieve_features(feat, k=k, rng=None)
    jcap, jcap_idx = jr.retrieve_caption_neighbors(feat, k=2)
    one = Retriever(KnowledgeDB.from_arrays(z["ret_img"], z["ret_txt"],
                                            dtype=torch.float32, device="cpu"))
    f = torch.from_numpy(z["ret_feat"])
    ti, tt = one.retrieve_features(f, k=k)
    cap, cap_idx = one.retrieve_caption_neighbors(f, k=2)
    # gathered rows are copies: exact
    for key, j, p in (("ret_topk_img", jti, ti), ("ret_topk_txt", jtt, tt),
                      ("ret_cap", jcap, cap), ("ret_cap_idx", jcap_idx, cap_idx)):
        got = _ranks_agree(run, key)
        np.testing.assert_array_equal(got, np.asarray(j))
        np.testing.assert_array_equal(got, p.numpy())


def test_db_fingerprint_of_shards_is_the_whole_dbs(run):
    z = run.z
    got = json.loads(str(_ranks_agree(run, "ret_fingerprint")))
    whole = db_fingerprint(KnowledgeDB.from_arrays(z["ret_img"], z["ret_txt"],
                                                   dtype=torch.float32, device="cpu"))
    assert got == whole
    assert got == jdb_fingerprint(JKnowledgeDB.from_arrays(z["ret_img"], z["ret_txt"],
                                                           dtype=jnp.float32))


# --- the engine with a mesh --------------------------------------------------------

@pytest.fixture(scope="module")
def jax_engine(run):
    z = run.z
    params, heads = jax_models()
    jdb = JKnowledgeDB.from_arrays(z["eng_img"], z["eng_txt"], dtype=jnp.float32,
                                   normalize=False).shard_over(run.mesh)
    mp = pytest.MonkeyPatch()
    mp.setattr(jengine_mod, "star_token_id", lambda: SPLIT_ID)
    je = JEngine(params, JCFG, heads, jdb, db_topk=8, compute_dtype=jnp.float32,
                 retriever=JRetriever(jdb, mesh=run.mesh, sharded=True), mesh=run.mesh,
                 encode_chunk=None)
    mp.undo()
    return je


def test_engine_with_mesh_matches_jax_and_one_process(run, jax_engine):
    z = run.z
    ims, txs = [z["eng_q0"], z["eng_q1"]], [z["eng_t0"], z["eng_t1"]]
    corpus_batches = [z["eng_c0"], z["eng_c1"]]
    composed = _ranks_agree(run, "eng_composed")
    corpus = _ranks_agree(run, "eng_corpus")
    np.testing.assert_allclose(composed, jax_engine.compose(ims, txs), rtol=0, atol=FEAT_TOL)
    np.testing.assert_allclose(corpus, jax_engine.encode_corpus(corpus_batches), rtol=0,
                               atol=FEAT_TOL)
    # the 7-row corpus splits 4 + 4 with one zero pad row, masked in the merge
    assert int(run.outs[0]["eng_corpus_rows"]) == 4
    js, ji = jax_engine.search(ims, txs, jax_engine.corpus_to_device(corpus), topn=4)
    scores, idx = (_ranks_agree(run, k) for k in ("eng_scores", "eng_idx"))
    np.testing.assert_allclose(scores, js, rtol=0, atol=FEAT_TOL)
    np.testing.assert_array_equal(idx, ji)
    tparams, theads = port_models(*jax_models())
    one = ComposedQueryEngine(tparams, TCFG, theads,
                              KnowledgeDB.from_arrays(z["eng_img"], z["eng_txt"],
                                                      dtype=torch.float32, normalize=False,
                                                      device="cpu"),
                              split_id=SPLIT_ID, compute_dtype=torch.float32, db_topk=8,
                              encode_chunk=None, device="cpu")
    np.testing.assert_allclose(composed, one.compose(ims, txs), rtol=0, atol=FEAT_TOL)
    s1, i1 = one.search(ims, txs, one.corpus_to_device(corpus), topn=4)
    np.testing.assert_array_equal(idx, i1)


# --- train steps ---------------------------------------------------------------------

STREAMS = ("image", "text", "raw")


def _jax_batch(run, stream, t):
    z, put = run.z, (lambda a: jshard_batch(run.mesh, jnp.asarray(a), allow_pad=False)[0])
    if stream == "raw":
        return jlosses.RawBatch(put(z["tr_images"][t]), put(z["tr_caps"][t]),
                                put(np.zeros((8, 77), np.int32)))
    other = z["tr_other"][t] if stream == "text" else np.zeros((8, 77), np.int32)
    return jlosses.TrainBatch(put(z["tr_feat_img"][t]), put(z["tr_feat_cap"][t]),
                              put(other))


def _jax_step(run, stream, optimizer):
    z = run.z
    params, _ = jax_models()
    jdb = JKnowledgeDB.from_arrays(z["tr_img_db"], z["tr_txt_db"], dtype=jnp.float32)
    return jmake_train_step(params, JCFG, JRetriever(jdb), optimizer,
                            stream="text" if stream == "text" else "image",
                            prompt_tokens=PROMPT, split_id=SPLIT_ID, grad_scale=1 / W,
                            dropout=0.0, db_topk=int(z["tr_k"]),
                            db_other_tokens=(jnp.asarray(z["tr_db_other"])
                                             if stream == "text" else None),
                            compute_dtype=jnp.float32, encode_chunk=None, mesh=run.mesh)


def _recording(opt):
    """``opt``, whose state also keeps the last gradient it was given: the
    JAX step's gradient before the update."""
    def update(g, state, params=None):
        updates, inner = opt.update(g, state[1], params)
        return updates, (g, inner)

    return optax.GradientTransformation(
        lambda p: (jax.tree.map(jnp.zeros_like, p), opt.init(p)), update)


@pytest.fixture(scope="module")
def jax_runs(run):
    """Per stream, the JAX step on the 2-device mesh at grad_scale 1/2 with
    AdamW, three steps: (step-0 gradient leaves, losses, heads after)."""
    cfg = JConfig(**{k: OPT[k] for k in ("lr", "beta1", "beta2", "eps", "wd", "warmup")})
    cache = {}

    def get(stream):
        if stream not in cache:
            _, heads = jax_models()
            opt = _recording(jmake_optimizer(cfg, 10)[0])
            step = _jax_step(run, stream, opt)
            h, s, losses, grads = heads, opt.init(heads), [], None
            for t in range(3):
                h, s, loss = step(h, s, _jax_batch(run, stream, t), jax.random.key(t))
                losses.append(float(loss))
                grads = grads or [np.asarray(g) for g in jax.tree.leaves(s[0])]
            cache[stream] = (grads, losses, jax.tree.leaves(to_numpy(h)))
        return cache[stream]

    return get


def _port_grads(out, tag, n):
    return [out.get(f"{tag}_grad{i}") for i in range(n)]


def _assert_gradients_close(got, want):
    """Flattened head gradients: within FEAT_TOL of the largest entry.  Some
    entries are round-off by nature (a key bias of a softmax has no
    gradient), so no entry is held to its own size."""
    np.testing.assert_allclose(got, want, rtol=0, atol=FEAT_TOL * np.abs(want).max())
    assert np.abs(want).max() > 0


@pytest.mark.parametrize("stream", STREAMS)
def test_head_gradients_before_the_optimizer_match_jax(run, jax_runs, stream):
    """2 ranks (gradients summed over the ranks, times 1/2) against the JAX
    step at grad_scale 1/2 on the 2-device mesh, both before AdamW, which
    would hide a factor-of-W error."""
    _, heads = jax_models()
    jg, losses, _ = jax_runs(stream)
    tag = f"tr_{stream}_d0"
    got = [_port_grads(o, tag, len(jg)) for o in run.outs]
    n_cond = len(jax.tree.leaves(heads.text_condition))
    if stream == "text":          # text_condition: no gradient on either side
        assert all(g is None for o in got for g in o[-n_cond:])
        assert not any(g.any() for g in jg[-n_cond:])
        jg, got = jg[:-n_cond], [o[:-n_cond] for o in got]
    for a, b in zip(*got):
        np.testing.assert_array_equal(a, b)       # every rank holds the same gradient
    _assert_gradients_close(np.concatenate([g.ravel() for g in got[0]]),
                            np.concatenate([g.ravel() for g in jg]))


@pytest.mark.parametrize("stream", STREAMS)
def test_heads_after_three_steps_match_jax(run, jax_runs, stream):
    """AdamW on both sides, three steps: the losses, and the heads at an
    LR-scaled tolerance (an update moves an element by up to about the LR,
    and m / (sqrt(v) + eps) amplifies round-off where a gradient is near
    zero)."""
    _, losses, heads = jax_runs(stream)
    tag = f"tr_{stream}_d0"
    np.testing.assert_allclose(_ranks_agree(run, f"{tag}_losses"), losses, rtol=1e-5)
    for i, want in enumerate(heads):
        got = _ranks_agree(run, f"{tag}_param{i}")
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=0.05 * OPT["lr"] * 3)


@pytest.mark.parametrize("stream", STREAMS)
def test_a_step_under_a_mesh_records_its_all_reduce_stage(run, stream):
    """Each rank's train step under a profile: its stages in order, the
    gradients' all-reduce between backward and the optimizer."""
    stages = ["retrieve", "retrieve", "fuse", "text", "backward", "all_reduce", "optimizer"]
    for o in run.outs:
        assert list(o[f"tr_{stream}_d1_spans"]) == (
            ["train.step"] + (["encode"] if stream == "raw" else []) + stages)


@pytest.mark.parametrize("stream", STREAMS)
def test_two_ranks_equal_one_process_on_the_global_batch_with_dropout(run, stream):
    """Dropout 0.1: each rank draws the global batch's masks and keeps its
    rows, so 2 ranks equal one process stepping on the global batch (at the
    same grad_scale 1/2); the gradients are compared before the update."""
    z = run.z
    tparams, theads = port_models(*jax_models())
    opt, sched = make_optimizer(SimpleNamespace(**OPT), 10, theads)
    db = KnowledgeDB.from_arrays(z["tr_img_db"], z["tr_txt_db"], dtype=torch.float32,
                                 device="cpu")
    step = make_train_step(tparams, TCFG, Retriever(db), opt, sched,
                           stream="text" if stream == "text" else "image",
                           prompt_tokens=PROMPT, split_id=SPLIT_ID, dropout=0.1,
                           db_topk=int(z["tr_k"]),
                           db_other_tokens=z["tr_db_other"] if stream == "text" else None,
                           compute_dtype=torch.float32, device="cpu", grad_scale=1 / W,
                           seed=3)
    if stream == "raw":
        batch = RawBatch(torch.from_numpy(z["tr_images"][0]), torch.from_numpy(z["tr_caps"][0]))
    else:
        extra = ({"other_tokens": torch.from_numpy(z["tr_other"][0]).long()}
                 if stream == "text" else {})
        batch = TrainBatch(torch.from_numpy(z["tr_feat_img"][0]),
                           torch.from_numpy(z["tr_feat_cap"][0]), **extra)
    loss = float(step(theads, batch, 0))
    tag = f"tr_{stream}_d1"
    assert _ranks_agree(run, f"{tag}_losses")[0] == pytest.approx(loss, rel=1e-6)
    want = [p.grad for p in leaves(theads)]
    got = _port_grads(run.outs[0], tag, len(want))
    assert [g is None for g in got] == [g is None for g in want]
    for i, g in enumerate(got):
        if g is not None:
            np.testing.assert_array_equal(g, run.outs[1][f"{tag}_grad{i}"])
    _assert_gradients_close(np.concatenate([g.ravel() for g in got if g is not None]),
                            np.concatenate([g.numpy().ravel() for g in want if g is not None]))
    # dropout did drop: the gradient differs from the dropout-0 step's
    assert not np.allclose(run.outs[0][f"{tag}_grad0"], run.outs[0][f"tr_{stream}_d0_grad0"])
