"""keds_tpu_torch's evaluators against keds_tpu's on the tiny on-disk trees:
the same CLIP, knowledge DB and head checkpoints, each package's own
datasets, transforms, loaders and tokenizer (one synthetic vocab), f32 on
the CPU.  Every evaluator's result dict must equal the JAX evaluator's,
under host and device ranking, and the port's device tables must equal its
host tables."""

import functools
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

pytest.importorskip("PIL")

from keds_tpu import tokenizer as jtok  # noqa: E402
from keds_tpu.data import datasets as jds  # noqa: E402
from keds_tpu.data.loader import DataLoader as JLoader  # noqa: E402
from keds_tpu.evalkit import evaluators as jev  # noqa: E402
from keds_tpu.retrieval.database import KnowledgeDB as JDB, Retriever as JRetriever  # noqa: E402
from keds_tpu import transforms as jtf  # noqa: E402

from keds_tpu_torch.data import datasets as tds  # noqa: E402
from keds_tpu_torch.data.loader import DataLoader as TLoader  # noqa: E402
from keds_tpu_torch.evalkit import evaluators as tev  # noqa: E402
from keds_tpu_torch.parallel.mesh import make_mesh  # noqa: E402
from keds_tpu_torch.retrieval.database import KnowledgeDB as TDB, Retriever as TRetriever  # noqa: E402
from keds_tpu_torch import transforms as ttf  # noqa: E402
from torch_port_helpers import (JCFG, TCFG, eval_db_arrays, jax_models, port_models,  # noqa: E402
                                write_branches, write_eval_tree, write_synthetic_vocab)

torch.set_num_threads(1)

EVALUATORS = ("cirr", "cirr_test", "fashion", "coco", "imgnet")


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """Data root, branches and the synthetic vocab, for the whole module;
    the JAX tokenizer's caches are cleared before and after."""
    root = tmp_path_factory.mktemp("eval")
    vocab = write_synthetic_vocab(root / "merges.txt.gz")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("KEDS_TPU_BPE_VOCAB", vocab)
        jtok.get_tokenizer.cache_clear()
        jtok.star_token_id.cache_clear()
        try:
            yield write_eval_tree(root), write_branches(root)
        finally:
            jtok.get_tokenizer.cache_clear()
            jtok.star_token_id.cache_clear()


def _drive(pkg, name, ranking, data, branches):
    """One evaluator of ``pkg`` ("jax" or "port") on the tiny trees."""
    jax_side = pkg == "jax"
    ds, tf, Loader = (jds, jtf, JLoader) if jax_side else (tds, ttf, TLoader)
    params, _ = jax_models()
    img, txt = eval_db_arrays()
    if jax_side:
        ctx = jev.EvalContext(clip_params=params, cfg=JCFG,
                              retriever=JRetriever(JDB.from_arrays(img, txt, dtype=jnp.float32)),
                              image_branch=branches[0], text_branch=branches[1],
                              compute_dtype=jnp.float32, eval_ranking=ranking)
        ev = jev
    else:
        ctx = tev.EvalContext(clip_params=port_models(params, jax_models()[1])[0], cfg=TCFG,
                              retriever=TRetriever(TDB.from_arrays(img, txt, dtype=torch.float32,
                                                                   device="cpu")),
                              image_branch=branches[0], text_branch=branches[1],
                              compute_dtype=torch.float32, eval_ranking=ranking, device="cpu")
        ev = tev
    t_val = tf.image_transform(JCFG.image_resolution)
    if name == "cirr":
        return ev.evaluate_cirr(ctx, Loader(ds.CIRR(transforms=t_val, root=data), 4),
                                Loader(ds.CIRR(transforms=t_val, root=data, mode="imgs"), 4),
                                epochs=[1, 2])
    if name == "cirr_test":
        return ev.evaluate_cirr_test(
            ctx, Loader(ds.CIRR(transforms=t_val, root=data, test=True), 4),
            Loader(ds.CIRR(transforms=t_val, root=data, mode="imgs", test=True), 8),
            image_epoch=1, text_epoch=2)
    if name == "fashion":
        src = ds.FashionIQ(cloth="dress", transforms=t_val, root=data, is_return_target_path=True)
        tgt = ds.FashionIQ(cloth="dress", transforms=t_val, root=data, mode="imgs")
        return ev.evaluate_fashion(ctx, Loader(src, 4), Loader(tgt, 4), epochs=[1])
    if name == "coco":
        src = ds.CsvCOCO(transforms=t_val, root=data,
                         transforms_region=tf.region_transform(JCFG.image_resolution))
        return ev.evaluate_coco(ctx, Loader(src, 3), epochs=[1])
    lists = [os.path.join(data, "imgnet", f) for f in ("imgnet_real_query.txt",
                                                       "imgnet_targets.txt")]
    src, tgt = (ds.ImageList(f, root=data, transforms=t_val, is_labels=True) for f in lists)
    return ev.evaluate_imgnet_retrieval(ctx, ["a cartoon of *", "a toy of *"],
                                        Loader(src, 3), Loader(tgt, 5), epochs=[1])


@functools.lru_cache()
def _result(pkg, name, ranking, data, branches):
    return _drive(pkg, name, ranking, data, branches)


@pytest.mark.parametrize("ranking", ["host", "device"])
@pytest.mark.parametrize("name", EVALUATORS)
def test_port_evaluator_equals_jax(tree, name, ranking):
    data, branches = tree
    port = _result("port", name, ranking, data, branches)
    assert port == _result("jax", name, ranking, data, branches)
    assert port        # not an empty sweep


@pytest.mark.parametrize("name", ["cirr", "fashion", "coco", "imgnet"])
def test_port_device_ranking_equals_host(tree, name):
    data, branches = tree
    assert (_result("port", name, "device", data, branches)
            == _result("port", name, "host", data, branches))


def test_device_ranking_launches_topk_per_feature_set(tree, monkeypatch):
    """The device CIRR sweep ranks three feature sets an epoch at
    k = min(101, T), through mips_topk, and fetches only indices."""
    data, branches = tree
    calls = []
    real = tev.mips_topk

    def counting(q, db, k):
        calls.append((tuple(q.shape), tuple(db.shape), k, q.dtype))
        return real(q, db, k)

    monkeypatch.setattr(tev, "mips_topk", counting)
    _drive("port", "cirr", "device", data, branches)
    assert calls == [((6, 64), (12, 64), 12, torch.float32)] * 6   # 2 epochs x 3


def test_eval_context_refuses_what_is_not_ported(tree, tmp_path):
    params, _ = jax_models()
    img, txt = eval_db_arrays()
    retr = TRetriever(TDB.from_arrays(img, txt, dtype=torch.float32, device="cpu"))
    clip = port_models(params, jax_models()[1])[0]
    # a mesh is ported now: one of a single rank is no mesh
    one = tev.EvalContext(clip, TCFG, retr, mesh=make_mesh(device="cpu"), device="cpu",
                          split_id=265)
    assert one.mesh is None and one.device == torch.device("cpu")
    with pytest.raises(NotImplementedError, match="item 15"):
        tev.EvalContext(clip, TCFG, retr, quant_towers="int8", device="cpu", split_id=265)
    orbax = tmp_path / "epoch_1.pt"
    orbax.mkdir()
    (orbax / "_CHECKPOINT_METADATA").write_text("{}")
    ctx = tev.EvalContext(clip, TCFG, retr, device="cpu", split_id=265)
    with pytest.raises(ValueError, match=".pt checkpoint files only"):
        ctx.load_heads(str(tmp_path), 1)
    with pytest.raises(ValueError, match=".pt checkpoint files only"):
        ctx.load_heads(str(orbax), 3)


def test_fixed_branch_file_is_cached(tree):
    """A branch that is one checkpoint file gives every epoch its heads,
    read once."""
    _, branches = tree
    params, _ = jax_models()
    img, txt = eval_db_arrays()
    ctx = tev.EvalContext(port_models(params, jax_models()[1])[0], TCFG,
                          TRetriever(TDB.from_arrays(img, txt, dtype=torch.float32,
                                                     device="cpu")),
                          device="cpu", split_id=265)
    fixed = os.path.join(branches[0], "epoch_2.pt")
    a, b = ctx.load_heads(fixed, 1), ctx.load_heads(fixed, 7)
    assert a is b
    sweep = ctx.load_heads(branches[0], 2)
    assert sweep is not a and all(torch.equal(x, y) for x, y in zip(
        _flat(sweep), _flat(a)))


def _flat(heads):
    from keds_tpu_torch.models.convert import head_parameters

    return [t for _, _, t in head_parameters(heads)]


def test_extract_image_features_matches_jax(tree):
    data, _ = tree
    params, _ = jax_models()
    img, txt = eval_db_arrays()
    jctx = jev.EvalContext(clip_params=params, cfg=JCFG,
                           retriever=JRetriever(JDB.from_arrays(img, txt, dtype=jnp.float32)),
                           compute_dtype=jnp.float32)
    tctx = tev.EvalContext(port_models(params, jax_models()[1])[0], TCFG,
                           TRetriever(TDB.from_arrays(img, txt, dtype=torch.float32,
                                                      device="cpu")),
                           compute_dtype=torch.float32, device="cpu")
    jf, jn = jev.extract_image_features(
        jctx, jds.CIRR(transforms=jtf.image_transform(32), root=data, mode="imgs"), 5)
    tf_, tn = tev.extract_image_features(
        tctx, tds.CIRR(transforms=ttf.image_transform(32), root=data, mode="imgs"), 5)
    assert tn == jn and tctx.split_id == jctx.split_id == 265
    np.testing.assert_allclose(tf_, jf, atol=2e-5, rtol=1e-4)
    assert tev.get_templates() == jev.get_templates()
