"""Port text-stream training (CPU, f32) vs keds_tpu: the in-place splice,
the caption-neighbour search, the loss, whole train steps, bucketing,
precomputed packs and the step's refusals."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from keds_tpu.config import Config as JConfig
from keds_tpu.models import clip as jclip
from keds_tpu.retrieval.database import KnowledgeDB as JKnowledgeDB
from keds_tpu.retrieval.database import Retriever as JRetriever
from keds_tpu.train import losses as jlosses
from keds_tpu.train.trainer import make_optimizer as jmake_optimizer
from keds_tpu.train.trainer import make_train_step as jmake_train_step

from keds_tpu_torch.models import clip as tclip
from keds_tpu_torch.models.convert import head_parameters
from keds_tpu_torch.retrieval.database import KnowledgeDB, Retriever, unit_rows
from keds_tpu_torch.tokenizer import bucket_text
from keds_tpu_torch.train import losses
from keds_tpu_torch.train.trainer import make_optimizer, make_train_step

from torch_port_helpers import D, JCFG, SPLIT_ID, TCFG, jax_models, port_models, to_numpy

torch.set_num_threads(1)
LR = 1e-3
OPT = dict(lr=LR, beta1=0.9, beta2=0.98, eps=1e-6, wd=0.1, warmup=2)
PROMPT = np.zeros((1, 77), np.int32)
PROMPT[0, :5] = [49406, 320, 1125, 539, 49407]
N_DB = 64


def templates(rng, n: int, n_stars: int, max_other: int = 12) -> np.ndarray:
    """(n, 77) "a photo of" + ``n_stars`` stars + an other caption of 1 to
    ``max_other`` seeded ids + EOT: each row's EOT at its own position."""
    out = np.zeros((n, 77), np.int32)
    for r in range(n):
        other = rng.integers(1000, 40000, int(rng.integers(1, max_other + 1)))
        row = [49406, 320, 1125, 539] + [SPLIT_ID] * n_stars + other.tolist() + [49407]
        out[r, :len(row)] = row
    return out


def _port_opt_cfg():
    return SimpleNamespace(**OPT, skip_scheduler=False)


def _data(seed=0, b=8):
    rng = np.random.default_rng(seed)
    img, txt = (rng.standard_normal((N_DB, D)).astype(np.float32) for _ in range(2))
    table = templates(rng, N_DB, 2)
    batches = [(rng.standard_normal((b, D)).astype(np.float32),
                rng.standard_normal((b, D)).astype(np.float32), templates(rng, b, 3))
               for _ in range(3)]
    return img, txt, table, batches


def _port_batch(f, c, own, **idx):
    return losses.TrainBatch(torch.from_numpy(f), torch.from_numpy(c),
                             other_tokens=torch.from_numpy(np.asarray(own)), **idx)


def test_encode_text_img_train_matches_jax():
    params, _ = jax_models()
    tparams = port_models(params, jax_models()[1])[0]
    rng = np.random.default_rng(0)
    text = templates(rng, 6, 3)          # three stars: two replaced, one kept
    assert len(set(np.argmax(text == 49407, axis=1))) > 1
    tok = rng.standard_normal((6, 2, D)).astype(np.float32)
    ref = jax.jit(lambda p, t, k: jclip.encode_text_img_train(p, JCFG, t, k, SPLIT_ID))(
        params, jnp.asarray(text), jnp.asarray(tok))
    got = tclip.encode_text_img_train(tparams, TCFG, torch.from_numpy(text),
                                      torch.from_numpy(tok), split_id=SPLIT_ID)
    # f32 sums in another order: rtol 1e-5, and atol 1e-5 for the entries
    # near 0 of these unit-scale outputs
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    # the third star stays a token: overwriting it changes the output
    text2 = text.copy()
    text2[:, 6] = 1000
    moved = tclip.encode_text_img_train(tparams, TCFG, torch.from_numpy(text2),
                                        torch.from_numpy(tok), split_id=SPLIT_ID)
    assert (moved - got).abs().max() > 1e-4


def _near_tie_caption():
    """A caption feature and a DB whose top-2 change between one and two f32
    normalisations of the query: 16 entries of the feature within a few
    ulps of 1, and DB rows e_a + e_b over them, so that every score is one
    rounding of q[a] + q[b] whatever the order of the sums.  The case is
    one where the two libraries' norms round alike (their sums run in
    other orders, which moves some rows by an ulp)."""
    hot = np.arange(16)
    db = np.zeros((120, D), np.float32)
    for r, (a, b) in enumerate((a, b) for a in hot for b in hot if a < b):
        db[r, [a, b]] = 1.0
    for seed in range(300):
        rng = np.random.default_rng(seed)
        cap = rng.standard_normal((1, D)).astype(np.float32)
        cap[0, hot] = 1.0 + rng.integers(0, 8, len(hot)).astype(np.float32) * np.float32(2.0 ** -23)
        q1 = unit_rows(torch.from_numpy(cap))
        idx = [torch.sort(q @ torch.from_numpy(db).T, descending=True, stable=True)[1][0, :2]
               for q in (q1, unit_rows(q1))]
        jc = jnp.asarray(cap)
        j1 = jc / jnp.linalg.norm(jc, axis=-1, keepdims=True)
        alike = all(np.array_equal(t.numpy(), np.asarray(j)) for t, j in
                    ((q1, j1), (unit_rows(q1), j1 / jnp.linalg.norm(j1, axis=1, keepdims=True))))
        if alike and not torch.equal(*idx):
            return cap, db
    raise AssertionError("no near tie found")


def test_retrieve_caption_neighbors_matches_jax():
    rng = np.random.default_rng(1)
    txt = rng.standard_normal((N_DB, D)).astype(np.float32)
    caps = rng.standard_normal((5, D)).astype(np.float32)
    jr = JRetriever(JKnowledgeDB.from_arrays(txt, txt, dtype=jnp.float32))
    tr = Retriever(KnowledgeDB.from_arrays(txt, txt, dtype=torch.float32, device="cpu"))
    jc = jnp.asarray(caps)
    jf, ji = jr.retrieve_caption_neighbors(jc / jnp.linalg.norm(jc, axis=-1, keepdims=True))
    tf, ti = tr.retrieve_caption_neighbors(unit_rows(torch.from_numpy(caps)))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), atol=1e-6, rtol=0)
    idx = np.array([[3, 60], [0, 1], [63, 2], [5, 5], [7, 8]], np.int32)
    jf2, ji2 = jr.retrieve_caption_neighbors(jc, idx=jnp.asarray(idx))
    tf2, ti2 = tr.retrieve_caption_neighbors(torch.from_numpy(caps), idx=torch.from_numpy(idx))
    np.testing.assert_array_equal(ti2.numpy(), idx)
    np.testing.assert_allclose(tf2.numpy(), np.asarray(jf2), atol=1e-6, rtol=0)


def test_caption_search_normalises_twice_as_jax_does():
    cap, db = _near_tie_caption()
    jr = JRetriever(JKnowledgeDB.from_arrays(db, db, dtype=jnp.float32, normalize=False))
    tr = Retriever(KnowledgeDB.from_arrays(db, db, dtype=torch.float32, normalize=False,
                                           device="cpu"))
    jc = jnp.asarray(cap)
    _, ji = jr.retrieve_caption_neighbors(jc / jnp.linalg.norm(jc, axis=-1, keepdims=True))
    _, ti = tr.retrieve_caption_neighbors(unit_rows(torch.from_numpy(cap)))
    _, once = tr.retrieve_caption_neighbors(torch.from_numpy(cap))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert not torch.equal(once, ti)


def _loss_inputs(seed=3, b=6):
    rng = np.random.default_rng(seed)
    f, c = (rng.standard_normal((b, D)).astype(np.float32) for _ in range(2))
    ti = rng.standard_normal((b, 16, D)).astype(np.float32)
    top2 = rng.standard_normal((b, 2, D)).astype(np.float32)
    own = templates(rng, b, 3)
    neigh = templates(rng, 2 * b, 2).reshape(b, 2, 77)
    return f, c, ti, top2, own, neigh


def test_text_stream_loss_and_head_gradients_match_jax():
    params, heads = jax_models()
    tparams, theads = port_models(params, heads)
    f, c, ti, top2, own, neigh = _loss_inputs()
    jb = jlosses.TrainBatch(jnp.asarray(f), jnp.asarray(c), jnp.asarray(own))

    def jloss(h):
        return jlosses.text_stream_loss(h, params, JCFG, jb, jnp.asarray(ti),
                                        jnp.asarray(ti), jnp.asarray(top2),
                                        jnp.asarray(neigh), split_id=SPLIT_ID, train=False)

    ref, jgrads = jax.jit(jax.value_and_grad(jloss))(heads)
    leaves = jax.tree.leaves(theads)
    for t in leaves:
        t.requires_grad_(True)
    loss = losses.text_stream_loss(theads, tparams, TCFG, _port_batch(f, c, own),
                                   torch.from_numpy(ti), None, torch.from_numpy(top2),
                                   torch.from_numpy(neigh), SPLIT_ID, train=False)
    assert float(loss.detach()) == pytest.approx(float(ref), rel=1e-5)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    for g, jg in zip(grads, jax.tree.leaves(to_numpy(jgrads))):
        if g is None:                 # text_condition: no path to the loss
            assert not np.any(jg)
            continue
        np.testing.assert_allclose(g.numpy(), jg, atol=1e-5, rtol=0)
    assert sum(g is None for g in grads) == len(jax.tree.leaves(theads.text_condition))


def _steps(n_steps, batches, img, txt, table, dropout=0.0):
    """Port and JAX text-stream steps from the same heads over ``batches``."""
    params, heads = jax_models()
    tparams, theads = port_models(params, heads)
    jdb = JKnowledgeDB.from_arrays(img, txt, dtype=jnp.float32)
    tdb = KnowledgeDB.from_arrays(img, txt, dtype=torch.float32, device="cpu")
    jopt, _ = jmake_optimizer(JConfig(**OPT), total_steps=10)
    jstep = jmake_train_step(params, JCFG, JRetriever(jdb), jopt, stream="text",
                             prompt_tokens=PROMPT, split_id=SPLIT_ID, dropout=dropout,
                             db_other_tokens=jnp.asarray(table), compute_dtype=jnp.float32)
    topt, sched = make_optimizer(_port_opt_cfg(), 10, theads)
    tstep = make_train_step(tparams, TCFG, Retriever(tdb), topt, sched, stream="text",
                            prompt_tokens=PROMPT, split_id=SPLIT_ID, dropout=dropout,
                            db_other_tokens=table, compute_dtype=torch.float32, device="cpu")
    jh, js = heads, jopt.init(heads)
    out = []
    for t, (f, c, own) in enumerate(batches[:n_steps]):
        jh, js, jl = jstep(jh, js, jlosses.TrainBatch(jnp.asarray(f), jnp.asarray(c),
                                                      jnp.asarray(own)), jax.random.key(t))
        out.append((float(tstep(theads, _port_batch(f, c, own), t)), float(jl)))
    return out, theads, topt, jh, heads


@pytest.mark.parametrize("n_steps", [1, 3])
def test_text_train_steps_match_jax(n_steps):
    """f32, dropout 0, the same batches, DB and templates; the image
    permutations differ (two PRNGs), which cross-attention cancels.  Heads
    at the image-stream test's LR-scaled tolerance; text_condition is never
    updated on either side."""
    img, txt, table, batches = _data()
    out, theads, topt, jh, init = _steps(n_steps, batches, img, txt, table)
    for tl, jl in out:
        assert tl == pytest.approx(jl, abs=1e-5)
    for a, b in zip(jax.tree.leaves(theads), jax.tree.leaves(to_numpy(jh))):
        np.testing.assert_allclose(a.detach().numpy(), b, atol=0.05 * LR * n_steps, rtol=1e-3)
    for a, j, b in zip(jax.tree.leaves(theads.text_condition),
                       jax.tree.leaves(to_numpy(jh.text_condition)),
                       jax.tree.leaves(to_numpy(init.text_condition))):
        np.testing.assert_array_equal(a.detach().numpy(), b)
        np.testing.assert_array_equal(j, b)
        assert a not in topt.state
    moved = [not np.array_equal(a.detach().numpy(), b) for a, b in
             zip(jax.tree.leaves(theads.img2text), jax.tree.leaves(to_numpy(init.img2text)))]
    assert all(moved)


def _port_text_step(table, dropout=0.0, seed=0):
    tparams, theads = port_models(*jax_models())
    img, txt, _, _ = _data()
    tdb = KnowledgeDB.from_arrays(img, txt, dtype=torch.float32, device="cpu")
    opt, sched = make_optimizer(_port_opt_cfg(), 10, theads)
    step = make_train_step(tparams, TCFG, Retriever(tdb), opt, sched, stream="text",
                           prompt_tokens=PROMPT, split_id=SPLIT_ID, dropout=dropout, seed=seed,
                           db_other_tokens=table, compute_dtype=torch.float32, device="cpu")
    return theads, step, Retriever(tdb)


def test_own_template_bucketing_is_exact():
    """Own templates trimmed to the S=16 bucket give the full-77 loss."""
    _, _, table, batches = _data()
    f, c, _ = batches[0]
    own = templates(np.random.default_rng(9), len(f), 3, max_other=8)
    short = bucket_text(own, n_pseudo=1)
    assert short.shape[1] == 16
    (h0, s0, _), (h1, s1, _) = _port_text_step(table), _port_text_step(table)
    l77 = float(s0(h0, _port_batch(f, c, own), 0))
    l16 = float(s1(h1, _port_batch(f, c, short), 0))
    assert l16 == pytest.approx(l77, rel=1e-6)


def test_precomputed_indices_step_is_bit_identical():
    """Gathering a pack's rows (searched with the same arithmetic, as the
    port's tool does) gives the searched step's loss and heads bit for bit
    at the same generator, dropout on."""
    _, _, table, batches = _data()
    f, c, own = batches[1]
    (h0, s0, retr), (h1, s1, _) = (_port_text_step(table, dropout=0.1, seed=4)
                                   for _ in range(2))
    ii, ti = retr.neighbour_indices(torch.from_numpy(f), 16)
    ci = retr.caption_indices(unit_rows(torch.from_numpy(c)), 2)
    l0 = s0(h0, _port_batch(f, c, own), 5)
    l1 = s1(h1, _port_batch(f, c, own, img_idx=ii, txt_idx=ti, cap2_idx=ci), 5)
    assert torch.equal(l0, l1)
    for (_, name, a), (_, _, b) in zip(head_parameters(h0), head_parameters(h1)):
        torch.testing.assert_close(a, b, atol=0, rtol=0, msg=name)


def test_text_step_refusals():
    _, _, table, batches = _data()
    f, c, own = batches[0]
    heads, step, retr = _port_text_step(table)
    ii, ti = retr.neighbour_indices(torch.from_numpy(f), 16)
    with pytest.raises(ValueError, match="cap2_idx"):
        step(heads, _port_batch(f, c, own, img_idx=ii, txt_idx=ti), 0)
    with pytest.raises(ValueError, match="db_other_tokens"):
        _port_text_step(None)
    with pytest.raises(ValueError, match="stale"):
        _port_text_step(table[:-1])
