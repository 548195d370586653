"""Port image-stream training (CPU, f32) vs keds_tpu: losses, schedule,
optimizer, whole train steps, dropout, the loader and the dataset."""

import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from keds_tpu.config import Config as JConfig
from keds_tpu.data.datasets import FeaturePairDataset as JFeaturePairDataset
from keds_tpu.data.loader import DataLoader as JDataLoader
from keds_tpu.retrieval.database import KnowledgeDB as JKnowledgeDB
from keds_tpu.retrieval.database import Retriever as JRetriever
from keds_tpu.train import losses as jlosses
from keds_tpu.train.schedule import cosine_lr as jcosine_lr
from keds_tpu.train.trainer import make_optimizer as jmake_optimizer
from keds_tpu.train.trainer import make_train_step as jmake_train_step
from keds_tpu.train.trainer import weight_decay_mask as jweight_decay_mask

from keds_tpu_torch.data.datasets import FeaturePairDataset
from keds_tpu_torch.data.loader import DataLoader
from keds_tpu_torch.models.convert import weight_decay_mask
from keds_tpu_torch.models.heads import dropout
from keds_tpu_torch.retrieval.database import KnowledgeDB, Retriever
from keds_tpu_torch.train import losses
from keds_tpu_torch.train.schedule import cosine_lr
from keds_tpu_torch.train.trainer import make_optimizer, make_train_step, truncated_prompt

from torch_port_helpers import D, JCFG, TCFG, jax_models, port_models, to_numpy

torch.set_num_threads(1)
LR = 1e-3
OPT = dict(lr=LR, beta1=0.9, beta2=0.98, eps=1e-6, wd=0.1, warmup=2)
PROMPT = np.zeros((1, 77), np.int32)
PROMPT[0, :5] = [49406, 320, 1125, 539, 49407]   # "a photo of"


def _port_opt_cfg():
    return SimpleNamespace(**OPT, skip_scheduler=False)


@pytest.mark.parametrize("warmup,total", [(10, 100), (0, 7), (3, 3)])
def test_cosine_lr_matches_jax(warmup, total):
    ours, ref = cosine_lr(2e-4, warmup, total), jcosine_lr(2e-4, warmup, total)
    for step in range(total + 2):   # JAX evaluates in f32: ulps of the base LR
        assert ours(step) == pytest.approx(float(ref(step)), rel=1e-6, abs=2e-4 * 1e-6)


def test_info_nce_and_cosine_loss_match_jax():
    rng = np.random.default_rng(0)
    a, b = (rng.standard_normal((9, D)).astype(np.float32) for _ in range(2))
    a /= np.linalg.norm(a, axis=1, keepdims=True)
    b /= np.linalg.norm(b, axis=1, keepdims=True)
    ref = float(jlosses.info_nce(jnp.asarray(a), jnp.asarray(b), jnp.asarray(14.3)))
    got = float(losses.info_nce(torch.from_numpy(a), torch.from_numpy(b), torch.tensor(14.3)))
    assert got == pytest.approx(ref, rel=1e-6)
    c = rng.standard_normal((9, D)).astype(np.float32) * 3
    ref = float(jlosses.cosine_embedding_loss(jnp.asarray(a), jnp.asarray(c)))
    got = float(losses.cosine_embedding_loss(torch.from_numpy(a), torch.from_numpy(c)))
    assert got == pytest.approx(ref, rel=1e-5)


def test_weight_decay_mask_matches_jax():
    params, heads = jax_models()
    theads = port_models(params, heads)[1]
    ref = jax.tree.leaves(jweight_decay_mask(heads))
    got = jax.tree.leaves(weight_decay_mask(theads))
    assert got == [bool(x) for x in ref] and any(got) and not all(got)


def _loss_inputs(seed=0, b=6):
    rng = np.random.default_rng(seed)
    f = rng.standard_normal((b, D)).astype(np.float32)
    ti, tt = (rng.standard_normal((b, 16, D)).astype(np.float32) for _ in range(2))
    return f, ti, tt


def test_image_stream_loss_matches_jax():
    params, heads = jax_models()
    tparams, theads = port_models(params, heads)
    f, ti, tt = _loss_inputs()
    jb = jlosses.TrainBatch(jnp.asarray(f), jnp.asarray(f), jnp.zeros((6, 77), jnp.int32))
    ref = float(jlosses.image_stream_loss(heads, params, JCFG, jb, jnp.asarray(ti),
                                          jnp.asarray(tt), jnp.asarray(PROMPT), train=False))
    tb = losses.TrainBatch(torch.from_numpy(f), torch.from_numpy(f))
    got = float(losses.image_stream_loss(theads, tparams, TCFG, tb, torch.from_numpy(ti),
                                         torch.from_numpy(tt), torch.from_numpy(PROMPT),
                                         train=False))
    assert got == pytest.approx(ref, rel=1e-5)


def _port_loss_and_grads(prompt, perm=None):
    params, heads = jax_models()
    tparams, theads = port_models(params, heads)
    f, ti, tt = _loss_inputs(1)
    if perm is not None:
        ti = ti[:, perm]
    leaves = jax.tree.leaves(theads)
    for t in leaves:
        t.requires_grad_(True)
    tb = losses.TrainBatch(torch.from_numpy(f), torch.from_numpy(f))
    loss = losses.image_stream_loss(theads, tparams, TCFG, tb, torch.from_numpy(ti),
                                    torch.from_numpy(tt), torch.from_numpy(prompt),
                                    train=False)
    return float(loss.detach()), [g.numpy() for g in torch.autograd.grad(loss, leaves)]


def test_prompt_truncated_to_8_equals_77():
    short = truncated_prompt(PROMPT, TCFG.eot_id)
    assert short.shape == (1, 8)
    l77, g77 = _port_loss_and_grads(PROMPT)
    l8, g8 = _port_loss_and_grads(short)
    assert l8 == pytest.approx(l77, rel=1e-6)
    for a, b in zip(g8, g77):
        np.testing.assert_allclose(a, b, atol=1e-6, rtol=1e-5)


def test_neighbour_permutation_leaves_loss_unchanged():
    l0, g0 = _port_loss_and_grads(PROMPT)
    l1, g1 = _port_loss_and_grads(PROMPT, perm=np.random.default_rng(3).permutation(16))
    assert l1 == pytest.approx(l0, rel=1e-6)
    for a, b in zip(g1, g0):
        np.testing.assert_allclose(a, b, atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("n_steps", [1, 3])
def test_train_steps_match_jax(n_steps):
    """make_train_step on both sides: f32, dropout 0, the same batches and DB.
    The neighbour permutations differ (two PRNGs), which cross-attention
    cancels.  Heads are compared at an LR-scaled tolerance: an AdamW update
    moves an element by up to ~LR, and m / (sqrt(v) + eps) amplifies
    round-off where the gradient is near zero."""
    params, heads = jax_models()
    tparams, theads = port_models(params, heads)
    rng = np.random.default_rng(2)
    img, txt = (rng.standard_normal((64, D)).astype(np.float32) for _ in range(2))
    jdb = JKnowledgeDB.from_arrays(img, txt, dtype=jnp.float32)
    tdb = KnowledgeDB.from_arrays(img, txt, dtype=torch.float32, device="cpu")
    jopt, _ = jmake_optimizer(JConfig(**OPT), total_steps=10)
    jstep = jmake_train_step(params, JCFG, JRetriever(jdb), jopt, stream="image",
                             prompt_tokens=PROMPT, split_id=265, dropout=0.0,
                             compute_dtype=jnp.float32)
    topt, sched = make_optimizer(_port_opt_cfg(), 10, theads)
    tstep = make_train_step(tparams, TCFG, Retriever(tdb), topt, sched, stream="image",
                            prompt_tokens=PROMPT, split_id=265, dropout=0.0,
                            compute_dtype=torch.float32, device="cpu")
    jh, js = heads, jopt.init(heads)
    for t in range(n_steps):
        f, c = (rng.standard_normal((8, D)).astype(np.float32) for _ in range(2))
        jh, js, jl = jstep(jh, js, jlosses.TrainBatch(jnp.asarray(f), jnp.asarray(c),
                                                      jnp.zeros((8, 77), jnp.int32)),
                           jax.random.key(t))
        tl = tstep(theads, losses.TrainBatch(torch.from_numpy(f), torch.from_numpy(c)), t)
        assert float(tl) == pytest.approx(float(jl), abs=1e-5)
    for a, b in zip(jax.tree.leaves(theads), jax.tree.leaves(to_numpy(jh))):
        np.testing.assert_allclose(a.detach().numpy(), b, atol=0.05 * LR * n_steps, rtol=1e-3)


def test_train_step_refuses_what_is_not_ported():
    params, heads = jax_models()
    tparams, theads = port_models(params, heads)
    tdb = KnowledgeDB.from_arrays(np.eye(D, dtype=np.float32), np.eye(D, dtype=np.float32),
                                  dtype=torch.float32, device="cpu")
    opt, sched = make_optimizer(_port_opt_cfg(), 10, theads)
    step = make_train_step(tparams, TCFG, Retriever(tdb), opt, sched, stream="image",
                           prompt_tokens=PROMPT, split_id=265, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        step(theads, (torch.zeros(2, 32, 32, 3), torch.zeros(2, 77)), 0)


def test_train_step_marks_each_stage_and_is_unchanged_by_it():
    rng = np.random.default_rng(5)
    img, txt, f, c = (rng.standard_normal((n, D)).astype(np.float32) for n in (32, 32, 8, 8))
    tdb = KnowledgeDB.from_arrays(img, txt, dtype=torch.float32, device="cpu")
    batch = losses.TrainBatch(torch.from_numpy(f), torch.from_numpy(c))
    runs = []
    for marks in (None, []):
        tparams, theads = port_models(*jax_models())
        opt, sched = make_optimizer(_port_opt_cfg(), 10, theads)
        step = make_train_step(tparams, TCFG, Retriever(tdb), opt, sched, stream="image",
                               prompt_tokens=PROMPT, split_id=265, device="cpu")
        loss = step(theads, batch, 0) if marks is None else step(theads, batch, 0,
                                                                 mark=marks.append)
        runs.append((float(loss), jax.tree.leaves(theads), marks))
    (l0, h0, _), (l1, h1, marks) = runs
    assert marks == ["retrieval", "heads_forward", "text_tower_forward", "backward",
                     "optimizer"]
    assert l1 == l0
    for a, b in zip(h1, h0):
        torch.testing.assert_close(a, b, atol=0, rtol=0)


def test_dropout_keep_rate_scale_and_reproducibility():
    x = torch.ones(200_000)
    y = dropout(x, 0.1, torch.Generator().manual_seed(0), True)
    kept = y != 0
    assert abs(kept.float().mean().item() - 0.9) < 0.005
    torch.testing.assert_close(y[kept], torch.full_like(y[kept], 1 / 0.9))
    torch.testing.assert_close(dropout(x, 0.1, torch.Generator().manual_seed(0), True), y)
    assert not torch.equal(dropout(x, 0.1, torch.Generator().manual_seed(1), True), y)
    assert dropout(x, 0.1, torch.Generator().manual_seed(0), False) is x
    assert dropout(x, 0.1, None, True) is x


def _packed_dir(tmp_path, n=23):
    rng = np.random.default_rng(4)
    np.save(tmp_path / "image_features.npy", rng.standard_normal((n, D)).astype(np.float32))
    np.save(tmp_path / "text_features.npy", rng.standard_normal((n, D)).astype(np.float32))
    (tmp_path / "names.json").write_text(json.dumps([f"s{i:03d}" for i in range(n)]))
    return str(tmp_path)


@pytest.mark.parametrize("epoch", [0, 3])
def test_loader_order_matches_jax(tmp_path, epoch):
    ours = DataLoader(FeaturePairDataset(_packed_dir(tmp_path)), 5, shuffle=True, seed=7,
                      drop_last=True, num_workers=2)
    ref = JDataLoader(JFeaturePairDataset(str(tmp_path)), 5, shuffle=True, seed=7,
                      drop_last=True)
    ours.set_epoch(epoch)
    ref.set_epoch(epoch)
    np.testing.assert_array_equal(ours.indices(), ref._indices())
    assert ours.num_batches == ref.num_batches == 4
    batches = list(ours)
    assert len(batches) == 4
    for i, (img, txt) in enumerate(batches):
        idx = ref._indices()[i * 5:(i + 1) * 5]
        np.testing.assert_array_equal(img, np.load(tmp_path / "image_features.npy")[idx])
        np.testing.assert_array_equal(txt, np.load(tmp_path / "text_features.npy")[idx])


def test_feature_pair_dataset_matches_jax(tmp_path):
    ours, ref = FeaturePairDataset(_packed_dir(tmp_path)), JFeaturePairDataset(str(tmp_path))
    assert ours.names == ref.names and len(ours) == len(ref)
    np.testing.assert_array_equal(ours.image_feats, ref.image_feats)
    np.testing.assert_array_equal(ours.text_feats, ref.text_feats)
    img, txt = ours[5]
    np.testing.assert_array_equal(img, ref.image_feats[5])
    assert img.dtype == txt.dtype == np.float32
    nb = tuple(np.arange(len(ours) * w, dtype=np.int64).reshape(len(ours), w) for w in (16, 16, 2))
    ours.attach_neighbors(nb)
    assert [a.tolist() for a in ours[2][2:]] == [a[2].tolist() for a in nb]
    with pytest.raises(ValueError, match="do not match"):
        ours.attach_neighbors((nb[0][:3],) + nb[1:])
