"""Four inputs the port once refused where keds_tpu answers, now answered
as keds_tpu answers them (f32 on the CPU): CLIP weights by model name from
the OpenAI cache, --num-partitions above the world size, an int8 product
of any depth, and B1's any-D padding; and the train CLI's
--pre-save-feature and --openai-pretrained."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from keds_tpu.models import loader as jloader
from keds_tpu.models.convert import clip_pytree_to_state_dict
from keds_tpu.ops import topk as jtopk
from keds_tpu.retrieval.database import KnowledgeDB as JKnowledgeDB, Retriever as JRetriever

from keds_tpu_torch.cli.main import main as train_main
from keds_tpu_torch.io.checkpoint import load_checkpoint
from keds_tpu_torch.models import loader as tloader
from keds_tpu_torch.ops import quant as tquant, topk as ttopk
from keds_tpu_torch.retrieval.database import KnowledgeDB, Retriever
from torch_port_helpers import JCFG, jax_models, run_cli, tiny_run_dir, to_numpy

torch.set_num_threads(1)


@pytest.fixture
def clip_cache(tmp_path, monkeypatch):
    """HOME at tmp_path, with a tiny reference-layout state dict cached as
    the OpenAI release names ViT-L/14's file."""
    monkeypatch.setenv("HOME", str(tmp_path))
    cache = tmp_path / ".cache" / "clip"
    cache.mkdir(parents=True)
    sd = {k: torch.from_numpy(np.array(v)) for k, v in
          clip_pytree_to_state_dict(to_numpy(jax_models()[0]), JCFG).items()}
    torch.save(sd, cache / "ViT-L-14.pt")
    return cache


def test_clip_weights_by_name_load_from_the_cache_as_jax(clip_cache, tmp_path):
    assert tloader.OPENAI_MODEL_URLS == jloader.OPENAI_MODEL_URLS
    path = str(clip_cache / "ViT-L-14.pt")
    assert tloader.resolve_clip_weights("ViT-L/14") == jloader.resolve_clip_weights(
        "ViT-L/14") == path
    tp, tcfg, _, _ = tloader.load_clip("ViT-L/14", device="cpu")
    jp, jcfg, _, _ = jloader.load_clip("ViT-L/14")
    assert tcfg.__dict__ == jcfg.__dict__
    jleaves = jax.tree_util.tree_flatten_with_path(to_numpy(jp))[0]
    tleaves = jax.tree_util.tree_flatten_with_path(jax.tree.map(lambda t: t.numpy(), tp))[0]
    assert [k for k, _ in jleaves] == [k for k, _ in tleaves]
    for (kp, a), (_, b) in zip(jleaves, tleaves):
        np.testing.assert_array_equal(b, a, err_msg=str(kp))
    # download_root as JAX's: the same file under another root
    other = tmp_path / "root"
    other.mkdir()
    (other / "ViT-L-14.pt").write_bytes((clip_cache / "ViT-L-14.pt").read_bytes())
    assert tloader.resolve_clip_weights("ViT-L/14", str(other)) == str(other / "ViT-L-14.pt")


def test_clip_weights_by_name_without_the_file_raise_naming_it(clip_cache):
    with pytest.raises(FileNotFoundError, match=r"no cached file at .*clip/RN50\.pt .*"
                                                "downloads nothing"):
        tloader.load_clip("RN50", device="cpu")
    with pytest.raises(FileNotFoundError, match="not a file and not a known model name"):
        tloader.resolve_clip_weights("ViT-H/14")
    with pytest.raises(FileNotFoundError, match="not a file and not a known model name"):
        jloader.resolve_clip_weights("ViT-H/14")


def test_openai_pretrained_trains_from_the_cached_weights(clip_cache, tmp_path):
    """--openai-pretrained --model ViT-L/14 parses and trains a tiny epoch
    on the cached file, as --clip-weights <that file> does, bit for bit."""
    data, dbdir, clip_path = tiny_run_dir(tmp_path)
    ref = run_cli(tmp_path, data, dbdir, clip_path, "by_path", 1)
    train_main(["--train-data", str(data), "--dataset-type", "directory",
                "--openai-pretrained", "--model", "ViT-L/14",
                "--database-path", str(dbdir), "--batch-size", "8", "--epochs", "1",
                "--lr", "1e-3", "--warmup", "2", "--skip-scheduler", "--db-topk", "8",
                "--precision", "fp32", "--logs", str(tmp_path / "logs"), "--name", "by_name",
                "--device", "cpu", "--seed", "3"])
    _assert_same_heads(ref / "epoch_1.pt", tmp_path / "logs" / "by_name" / "checkpoints"
                       / "epoch_1.pt")


def _assert_same_heads(a_path, b_path):
    a, b = load_checkpoint(str(a_path)), load_checkpoint(str(b_path))
    for key in ("state_dict_img2text", "state_dict_retrieval_fuse",
                "state_dict_text_condition"):
        for name, t in a[key].items():
            torch.testing.assert_close(b[key][name], t, atol=0, rtol=0)


def test_num_partitions_above_the_world_trains_as_one_rank(tmp_path):
    data, dbdir, clip_path = tiny_run_dir(tmp_path)
    ref = run_cli(tmp_path, data, dbdir, clip_path, "np0", 1)
    got = run_cli(tmp_path, data, dbdir, clip_path, "np2", 1, "--num-partitions", "2")
    assert "2 devices requested, 1 available — using all" in (
        tmp_path / "logs" / "np2" / "out.log").read_text()
    _assert_same_heads(ref / "epoch_1.pt", got / "epoch_1.pt")


def test_pre_save_feature_names_the_port_tool(tmp_path):
    data, dbdir, clip_path = tiny_run_dir(tmp_path)
    with pytest.raises(SystemExit, match=r"python -m keds_tpu_torch\.tools\.extract_features"):
        run_cli(tmp_path, data, dbdir, clip_path, "pre", 1, "--pre-save-feature")


# --- any depth: the padding the card paths take, held on the CPU ---------------

def test_split_plan_routes_any_depth():
    """bf16 at k <= 32 keeps the tensor-core tiling up to D = 1024 (D padded
    to 64) and takes the BF16 score route above (padded to 64 as well); f32
    pads D to 16."""
    bf16, f32 = torch.bfloat16, torch.float32
    for d, tiling, depth in ((96, ttopk.TC, 128), (100, ttopk.TC, 128), (1024, ttopk.TC, 1024),
                             (1000, ttopk.TC, 1024), (1025, ttopk.BF16, 1088),
                             (1280, ttopk.BF16, 1280)):
        got = ttopk.split_plan(64, 100_000, 132, bf16, 16, d)[0]
        assert got is tiling and ttopk.kernel_depth(got, d) == depth, d
    for d, depth in ((100, 112), (96, 96), (7, 16), (1280, 1280)):
        got = ttopk.split_plan(64, 100_000, 132, f32, 16, d)[0]
        assert got is ttopk.F32_MID and ttopk.kernel_depth(got, d) == depth
    assert ttopk.split_plan(64, 100_000, 132, bf16, 101, 100)[0] is ttopk.BF16


@pytest.mark.parametrize("d", [100, 96, 7])
def test_zero_padded_depth_ranks_as_the_unpadded(d):
    """The wrapper's zero columns add 0 to every product: the plain top-k of
    the padded inputs equals that of the unpadded ones, and JAX's."""
    rng = np.random.default_rng(d)
    q = rng.standard_normal((9, d)).astype(np.float32)
    db = rng.standard_normal((300, d)).astype(np.float32)
    depth = ttopk.kernel_depth(ttopk.F32, d)
    tq, tdb = torch.from_numpy(q), torch.from_numpy(db)
    step = ttopk.depth_step(ttopk.F32)
    padded = tquant.pad_depth(tq, step), tquant.pad_depth(tdb, step)
    assert padded[1].shape[1] == depth and padded[1].is_contiguous()
    pv, pi = ttopk.mips_topk_plain(*padded, 16)
    v, i = ttopk.mips_topk_plain(tq, tdb, 16)
    jv, ji = jtopk.mips_topk(jnp.asarray(q), jnp.asarray(db), 16)
    assert torch.equal(pi, i) and torch.equal(pv, v)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=0, atol=1e-5)


@pytest.mark.parametrize("depth", [100, 7])
def test_int8_product_zero_padded_is_exact(depth):
    rng = np.random.default_rng(depth)
    a = torch.from_numpy(rng.integers(-127, 128, (5, depth), dtype=np.int8))
    b = torch.from_numpy(rng.integers(-127, 128, (depth, 11), dtype=np.int8))
    padded = tquant.int8_matmul_plain(tquant.pad_depth(a), tquant.pad_depth(b.T).T)
    assert tquant.pad_depth(a).shape[1] == -(-depth // 8) * 8
    assert torch.equal(padded, tquant.int8_matmul(a, b))
    np.testing.assert_array_equal(padded.numpy(), a.numpy().astype(np.int64)
                                  @ b.numpy().astype(np.int64))


def test_int8_retriever_at_depth_100_equals_jax():
    """The int8 Retriever pads its tables once to depth 104; its search
    equals keds_tpu's int8 Retriever over the same D = 100 DB."""
    rng = np.random.default_rng(2)
    img, txt = (rng.standard_normal((257, 100)).astype(np.float32) for _ in range(2))
    q = rng.standard_normal((6, 100)).astype(np.float32)
    retr = Retriever(KnowledgeDB.from_arrays(img, txt, dtype=torch.float32, device="cpu"),
                     "int8")
    q8, scale = retr.quant_arrays()[0]
    assert q8.shape == (257, 104) and not q8[:, 100:].any()
    jretr = JRetriever(JKnowledgeDB.from_arrays(img, txt, dtype=jnp.float32), backend="int8")
    for oversample, db in ((4, retr.db.image_db), (4, None), (1, None)):
        v, i = ttopk.mips_topk_int8(torch.from_numpy(q), q8, scale, 8, oversample, db=db)
        jv, ji = jtopk.mips_topk_int8(jnp.asarray(q), *jretr._int8["image"], 8,
                                      oversample=oversample,
                                      db=None if db is None else jretr.db.image_db)
        np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
        np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=0, atol=1e-5)
    for name in ("image", "text"):
        v, i = retr.search(torch.from_numpy(q), getattr(retr.db, f"{name}_db"), 8, name)
        jv, ji = jretr.search(jnp.asarray(q), getattr(jretr.db, f"{name}_db"), 8, name)
        np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
        np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=0, atol=1e-5)
    assert sorted(tquant.INT8_MM.pads) == ["linear", "queries", "retrieval"]
