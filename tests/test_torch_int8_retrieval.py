"""The int8 and approx retrieval backends (ROADMAP item 14) against keds_tpu
on the CPU: synth's corpora bit for bit, ``quantize_int8`` bit for bit,
``mips_topk_int8`` and ``mips_topk_approx`` index for index, the Retriever's
backends, the pre-quantized artifacts, and the sharded int8 search on two
gloo ranks against JAX's 2-device mesh.

Stage 1 of the int8 search is exact integer arithmetic in both packages, so
its scores agree bit for bit.  Stage 2 re-ranks in f32 with sums in another
order (an einsum there, a batched product here): two candidates whose exact
scores lie within NEAR_TIE of each other may swap, and the tests count such
swaps and fail on any other difference.  Values agree to VAL_TOL.
"""

import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from keds_tpu.config import Config as JConfig
from keds_tpu.ops import topk as jtopk
from keds_tpu.parallel.mesh import make_mesh as jmake_mesh
from keds_tpu.retrieval import synth as jsynth
from keds_tpu.retrieval.database import KnowledgeDB as JKnowledgeDB, Retriever as JRetriever

from keds_tpu_torch.config import Config
from keds_tpu_torch.ops import topk
from keds_tpu_torch.retrieval import synth
from keds_tpu_torch.retrieval.database import KnowledgeDB, Retriever
from keds_tpu_torch.tools.build_database import main as build_db

from torch_dist_worker import run_ranks
from torch_port_helpers import D, jax_models, port_models

torch.set_num_threads(1)
NEAR_TIE = 1e-5     # exact-score gap below which an f32 re-rank may swap two rows
VAL_TOL = 1e-6      # f32 re-rank values: sums of D products in another order


def _unit(rng, n, d=D):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _corpus(kind, n, seed):
    """(queries (9, D), rows (n, D)) unit f32: Gaussian, correlated at
    spread 0.05 (near-duplicates) or 0.35, or Gaussian rows each present
    twice (exact int8 and f32 ties)."""
    rng = np.random.default_rng(seed)
    if kind == "gaussian":
        return _unit(rng, 9), _unit(rng, n)
    if kind == "duplicated":
        half = _unit(rng, n // 2)
        return _unit(rng, 9), np.concatenate([half, half, half[:n - 2 * (n // 2)]])
    spread = float(kind.split("=")[1])
    geom = synth.shared_geometry(rng, D)
    rows = synth.correlated_embeddings(rng, n, D, spread=spread, basis=geom)
    return synth.correlated_embeddings(np.random.default_rng(seed + 1), 9, D,
                                       spread=spread, basis=geom), rows


def assert_equal_but_near_ties(idx, ref_idx, q, rows):
    """Equal index arrays, except at positions where both picks score within
    NEAR_TIE of each other exactly (f64); returns the count of those."""
    idx, ref_idx = np.asarray(idx), np.asarray(ref_idx)
    swaps = 0
    for b, j in zip(*np.nonzero(idx != ref_idx)):
        exact = np.asarray(rows, np.float64) @ np.asarray(q[b], np.float64)
        gap = abs(exact[idx[b, j]] - exact[ref_idx[b, j]])
        assert gap < NEAR_TIE, (b, j, idx[b, j], ref_idx[b, j], gap)
        swaps += 1
    return swaps


# --- synth ---------------------------------------------------------------------

@pytest.mark.parametrize("spread", [0.35, 0.15, 0.05])
def test_synth_corpora_equal_jax_bit_for_bit(spread):
    geom_t, geom_j = (m.shared_geometry(np.random.default_rng(3), 48, n_clusters=8)
                      for m in (synth, jsynth))
    for a, b in zip(geom_t, geom_j):
        np.testing.assert_array_equal(a, b)
    a = synth.correlated_embeddings(np.random.default_rng(4), 200, 48, spread=spread,
                                    basis=geom_t)
    b = jsynth.correlated_embeddings(np.random.default_rng(4), 200, 48, spread=spread,
                                     basis=geom_j)
    assert a.dtype == np.float32
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        synth.correlated_embeddings(np.random.default_rng(5), 64, 32, spread=spread),
        jsynth.correlated_embeddings(np.random.default_rng(5), 64, 32, spread=spread))


def test_structured_images_equal_jax_bit_for_bit():
    np.testing.assert_array_equal(synth.structured_images(np.random.default_rng(2), 3, 24),
                                  jsynth.structured_images(np.random.default_rng(2), 3, 24))


def test_inject_outlier_channels_equals_jax():
    jparams, jheads = jax_models()
    tparams, _ = port_models(jparams, jheads)
    jout = jsynth.inject_outlier_channels(jparams)
    tout = synth.inject_outlier_channels(tparams)
    for tower in ("visual", "text"):
        for key in ("fc_w", "proj_w"):
            np.testing.assert_array_equal(tout[tower]["blocks"][key].numpy(),
                                          np.asarray(jout[tower]["blocks"][key]))
        assert tout[tower]["blocks"]["qkv_w"] is tparams[tower]["blocks"]["qkv_w"]
    assert not torch.equal(tout["visual"]["blocks"]["fc_w"], tparams["visual"]["blocks"]["fc_w"])


# --- quantize_int8 and the searches -------------------------------------------

@pytest.mark.parametrize("kind", ["gaussian", "correlated s=0.05", "bf16 rows", "zero rows"])
def test_quantize_int8_equals_jax_bit_for_bit(kind):
    rows = _corpus("gaussian" if kind != "correlated s=0.05" else kind, 300, 1)[1]
    if kind == "zero rows":
        rows[::7] = 0.0
    t = torch.from_numpy(rows)
    j = jnp.asarray(rows)
    if kind == "bf16 rows":
        t, j = t.to(torch.bfloat16), j.astype(jnp.bfloat16)
    q8, sc = topk.quantize_int8(t)
    jq8, jsc = jtopk.quantize_int8(j)
    assert q8.dtype == torch.int8 and sc.dtype == torch.float32
    np.testing.assert_array_equal(q8.numpy(), np.asarray(jq8))
    np.testing.assert_array_equal(sc.numpy(), np.asarray(jsc))


def test_topk_lower_index_equals_lax_top_k_with_ties():
    rng = np.random.default_rng(0)
    scores = np.round(rng.standard_normal((6, 500)), 1).astype(np.float32)   # many ties
    scores[2] = 0.0
    scores[3, ::2] = -0.0
    for k in (1, 16, 64, 500):
        vals, idx = topk.topk_lower_index(torch.from_numpy(scores), k)
        jv, ji = jax.lax.top_k(jnp.asarray(scores), k)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))


@pytest.mark.parametrize("kind", ["gaussian", "correlated s=0.05", "correlated s=0.35",
                                  "duplicated"])
@pytest.mark.parametrize("oversample,true_rows", [(1, False), (4, False), (4, True)])
def test_mips_topk_int8_matches_jax(kind, oversample, true_rows):
    q, rows = _corpus(kind, 2001, 11)
    tq, trows = torch.from_numpy(q), torch.from_numpy(rows)
    q8, sc = topk.quantize_int8(trows)
    jq8, jsc = jtopk.quantize_int8(jnp.asarray(rows))
    for k in (16, 2):
        vals, idx = topk.mips_topk_int8(tq, q8, sc, k, oversample=oversample,
                                        db=trows if true_rows else None)
        jv, ji = jtopk.mips_topk_int8(jnp.asarray(q), jq8, jsc, k, oversample=oversample,
                                      db=jnp.asarray(rows) if true_rows else None)
        assert idx.dtype == torch.int32 and vals.shape == (9, k)
        if oversample == 1:       # stage 1 only: exact integer scores
            np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
            np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))
        else:
            assert_equal_but_near_ties(idx, ji, q, rows)
            np.testing.assert_allclose(vals.numpy(), np.asarray(jv), atol=VAL_TOL, rtol=0)


def test_mips_topk_int8_plain_product_is_the_same_search():
    q, rows = _corpus("correlated s=0.05", 999, 3)
    q8, sc = topk.quantize_int8(torch.from_numpy(rows))
    a = topk.mips_topk_int8(torch.from_numpy(q), q8, sc, 16, db=torch.from_numpy(rows))
    b = topk.mips_topk_int8(torch.from_numpy(q), q8, sc, 16, db=torch.from_numpy(rows),
                            plain=True)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.parametrize("kind", ["gaussian", "duplicated"])
def test_mips_topk_approx_matches_jax(kind):
    q, rows = _corpus(kind, 1500, 5)
    vals, idx = topk.mips_topk_approx(torch.from_numpy(q), torch.from_numpy(rows), 16)
    jv, ji = jtopk.mips_topk_approx(jnp.asarray(q), jnp.asarray(rows), 16)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    np.testing.assert_allclose(vals.numpy(), np.asarray(jv), atol=VAL_TOL, rtol=0)


# --- the Retriever ---------------------------------------------------------------

@pytest.mark.parametrize("backend", ["auto", "xla", "pallas", "approx", "int8"])
def test_retriever_backends_retrieve_features_match_jax(backend):
    rng = np.random.default_rng(21)
    geom = synth.shared_geometry(rng, D)
    img = synth.correlated_embeddings(rng, 700, D, spread=0.15, basis=geom)
    txt = synth.correlated_embeddings(rng, 700, D, spread=0.15, basis=geom)
    feat = synth.correlated_embeddings(rng, 7, D, spread=0.15, basis=geom) * 3.0
    retr = Retriever(KnowledgeDB.from_arrays(img, txt, dtype=torch.float32, device="cpu"),
                     backend)
    jretr = JRetriever(JKnowledgeDB.from_arrays(img, txt, dtype=jnp.float32),
                       backend="xla" if backend == "auto" else backend)
    ti, tt = retr.retrieve_features(torch.from_numpy(feat), k=16)
    ji, jt = jretr.retrieve_features(jnp.asarray(feat), k=16, rng=None)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    cap, cap_idx = retr.retrieve_caption_neighbors(torch.from_numpy(feat), k=2)
    jcap, jcap_idx = jretr.retrieve_caption_neighbors(jnp.asarray(feat), k=2)
    np.testing.assert_array_equal(cap_idx.numpy(), np.asarray(jcap_idx))
    assert (retr.quant_arrays() is None) == (backend != "int8")


def test_retriever_refuses_an_unknown_backend():
    db = KnowledgeDB.from_arrays(_unit(np.random.default_rng(0), 8),
                                 _unit(np.random.default_rng(1), 8), device="cpu")
    with pytest.raises(ValueError, match="unknown retrieval backend"):
        Retriever(db, "faiss")


def _artifacts(tmp_path):
    """A DB written by both packages' build_database --int8 from one feature
    directory; returns (port dir, JAX dir)."""
    from keds_tpu.tools.build_database import main as jbuild_db

    feats = tmp_path / "feats"
    feats.mkdir()
    rng = np.random.default_rng(7)
    np.save(feats / "image_features.npy", rng.standard_normal((80, 32)).astype(np.float32))
    np.save(feats / "text_features.npy", rng.standard_normal((80, 32)).astype(np.float32))
    (feats / "names.json").write_text(json.dumps([f"n{i}" for i in range(80)]))
    out, jout = tmp_path / "db", tmp_path / "jdb"
    build_db(["--features", str(feats), "--out", str(out), "--size", "64", "--int8"])
    jbuild_db(["--features", str(feats), "--out", str(jout), "--size", "64", "--int8",
               "--no-pt"])
    return out, jout


def test_build_database_int8_writes_jax_arrays(tmp_path):
    out, jout = _artifacts(tmp_path)
    for name in ("image_db.npy", "text_db.npy", "image_db_int8.npy", "image_db_scale.npy",
                 "text_db_int8.npy", "text_db_scale.npy"):
        a, b = np.load(out / name), np.load(jout / name)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert (out / "database_names.txt").read_text() == (jout / "database_names.txt").read_text()
    pt = torch.load(out / "cc_image_databases.pt", weights_only=True)
    np.testing.assert_array_equal(pt.numpy(), np.load(jout / "image_db.npy"))
    # the JAX loader reads the port's torch.save artifacts
    jdb = JKnowledgeDB.from_config(JConfig(database_path=str(out)), dtype=jnp.float32)
    np.testing.assert_array_equal(np.asarray(jdb.image_db),
                                  KnowledgeDB.from_directory(str(out), torch.float32,
                                                             "cpu").image_db.numpy())


def test_prequantized_artifacts_are_loaded_and_used(tmp_path):
    """from_config reads the artifacts and the int8 Retriever scores with
    them: a corrupted scale changes the stage-1 scores, as it does in JAX."""
    out, _ = _artifacts(tmp_path)
    cfg = Config(database_path=str(out))
    db = KnowledgeDB.from_config(cfg, torch.float32, "cpu")
    assert db.quant is not None and set(db.quant) == {"image", "text"}
    q8_mem, sc_mem = topk.quantize_int8(db.image_db)
    np.testing.assert_array_equal(np.asarray(db.quant["image"][0]), q8_mem.numpy())
    np.testing.assert_allclose(db.quant["image"][1], sc_mem.numpy(), rtol=1e-6)

    scale = np.load(out / "image_db_scale.npy")
    scale[0] *= 50.0
    np.save(out / "image_db_scale.npy", scale)
    db2 = KnowledgeDB.from_config(cfg, torch.float32, "cpu")
    q = torch.from_numpy(_unit(np.random.default_rng(9), 4, 32))
    v1, _ = topk.mips_topk_int8(q, *Retriever(db, "int8").quant_arrays()[0], 8, oversample=1)
    v2, _ = topk.mips_topk_int8(q, *Retriever(db2, "int8").quant_arrays()[0], 8, oversample=1)
    assert not torch.allclose(v1, v2)
    jdb2 = JKnowledgeDB.from_config(JConfig(database_path=str(out)), dtype=jnp.float32)
    jv2, _ = jtopk.mips_topk_int8(jnp.asarray(q.numpy()),
                                  *JRetriever(jdb2, backend="int8")._int8["image"], 8,
                                  oversample=1)
    np.testing.assert_array_equal(v2.numpy(), np.asarray(jv2))


def test_stale_int8_artifacts_are_ignored(tmp_path, caplog):
    out, _ = _artifacts(tmp_path)
    q8 = np.load(out / "image_db_int8.npy")
    np.save(out / "image_db_int8.npy", q8[:32])
    with caplog.at_level("WARNING"):
        db = KnowledgeDB.from_config(Config(database_path=str(out)), torch.float32, "cpu")
    assert db.quant is None and "shape mismatch" in caplog.text
    np.testing.assert_array_equal(Retriever(db, "int8").quant_arrays()[0][0].numpy(),
                                  topk.quantize_int8(db.image_db)[0].numpy())


# --- two ranks ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("dist_int8")
    rng = np.random.default_rng(3)
    geom = synth.shared_geometry(rng, D)
    z = {"rows": synth.correlated_embeddings(rng, 37, D, spread=0.15, basis=geom),
         "txt": synth.correlated_embeddings(rng, 37, D, spread=0.15, basis=geom),
         "q": synth.correlated_embeddings(rng, 6, D, spread=0.15, basis=geom),
         "neg": -np.abs(rng.standard_normal((9, 16))).astype(np.float32)}
    np.savez(d / "inputs.npz", **z)
    return SimpleNamespace(z=z, outs=run_ranks("int8", d, timeout=240), mesh=jmake_mesh(2))


@pytest.mark.parametrize("true_rows", [True, False])
def test_int8_sharded_search_matches_jax_mesh(ranks, true_rows):
    z = ranks.z
    rows = np.concatenate([z["rows"], np.zeros((1, D), np.float32)])   # padded to 2 x 19
    q8, sc = jtopk.quantize_int8(jnp.asarray(rows))
    jv, ji = jtopk.mips_topk_int8_sharded(jnp.asarray(z["q"]), q8, sc, 5, ranks.mesh,
                                          n_real=37,
                                          db=jnp.asarray(rows) if true_rows else None)
    tag = "true" if true_rows else "deq"
    for out in ranks.outs:
        assert_equal_but_near_ties(out[f"sharded_{tag}_idx"], ji, z["q"], rows)
        np.testing.assert_allclose(out[f"sharded_{tag}_vals"], np.asarray(jv),
                                   atol=VAL_TOL, rtol=0)
    # and the one-process search on the whole DB
    whole = topk.mips_topk_int8(torch.from_numpy(z["q"]), *topk.quantize_int8(
        torch.from_numpy(z["rows"])), 5, db=torch.from_numpy(z["rows"]) if true_rows else None)
    assert_equal_but_near_ties(ranks.outs[0][f"sharded_{tag}_idx"], whole[1].numpy(),
                               z["q"], z["rows"])


@pytest.mark.parametrize("true_rows", [True, False])
def test_int8_sharded_search_at_k_zero_matches_jax_mesh(ranks, true_rows):
    """k = 0 (the serve CLI's --topn 0): empty (B, 0) f32 values and int32
    indices on every rank, as the JAX mesh gives."""
    z = ranks.z
    rows = np.concatenate([z["rows"], np.zeros((1, D), np.float32)])
    q8, sc = jtopk.quantize_int8(jnp.asarray(rows))
    jv, ji = jtopk.mips_topk_int8_sharded(jnp.asarray(z["q"]), q8, sc, 0, ranks.mesh,
                                          n_real=37,
                                          db=jnp.asarray(rows) if true_rows else None)
    tag = "true_k0" if true_rows else "deq_k0"
    for out in ranks.outs:
        for got, want in ((out[f"sharded_{tag}_vals"], jv), (out[f"sharded_{tag}_idx"], ji)):
            assert got.shape == want.shape == (len(z["q"]), 0)
            assert got.dtype == np.asarray(want).dtype


def test_int8_sharded_pad_rows_cannot_win(ranks):
    """Every true score is negative; the zero pad row scores 0.0 and must
    not appear."""
    for out in ranks.outs:
        assert (out["pad_idx"] < 9).all() and (out["pad_vals"] < 0).all()


def test_int8_retriever_over_a_sharded_db_matches_jax(ranks):
    z = ranks.z
    jretr = JRetriever(JKnowledgeDB.from_arrays(z["rows"], z["txt"], dtype=jnp.float32),
                       backend="int8")
    ji, jt = jretr.retrieve_features(jnp.asarray(z["q"]), k=4, rng=None)
    for out in ranks.outs:
        np.testing.assert_array_equal(out["int8_img"], np.asarray(ji))
        np.testing.assert_array_equal(out["int8_txt"], np.asarray(jt))


def test_approx_backend_over_a_sharded_db_matches_exact(ranks):
    z = ranks.z
    jretr = JRetriever(JKnowledgeDB.from_arrays(z["rows"], z["txt"], dtype=jnp.float32))
    ji, jt = jretr.retrieve_features(jnp.asarray(z["q"]), k=4, rng=None)
    for out in ranks.outs:
        np.testing.assert_array_equal(out["approx_img"], np.asarray(ji))
        np.testing.assert_array_equal(out["approx_txt"], np.asarray(jt))
