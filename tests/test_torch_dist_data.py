"""The port's multi-process data plumbing against keds_tpu's, in one process:
the process-group backend rule, each rank's loader order and the global
batches, the datasets' token needs, each rank's tar-stream shards and
samples, --worker-processes against threads, and the mesh of one rank."""

import io
import tarfile
from types import SimpleNamespace

import numpy as np
import pytest
import torch

PIL = pytest.importorskip("PIL")
from PIL import Image  # noqa: E402

from keds_tpu import tokenizer as jtok  # noqa: E402
from keds_tpu.data import datasets as jds  # noqa: E402
from keds_tpu.data import tarstream as jts  # noqa: E402
from keds_tpu.data.loader import DataLoader as JLoader  # noqa: E402

from keds_tpu_torch.data import datasets as tds  # noqa: E402
from keds_tpu_torch.data import tarstream as tts  # noqa: E402
from keds_tpu_torch.data.loader import DataLoader  # noqa: E402
from keds_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from torch_port_helpers import tiny_run_dir, write_synthetic_vocab  # noqa: E402

torch.set_num_threads(1)


@pytest.mark.parametrize("device_type,ranks,devices,want", [
    ("cpu", 2, 0, "gloo"), ("cpu", 4, 8, "gloo"), ("cuda", 2, 2, "nccl"),
    ("cuda", 4, 8, "nccl"), ("cuda", 2, 1, "gloo"), ("cuda", 8, 4, "gloo")])
def test_backend_rule(device_type, ranks, devices, want):
    """gloo for the CPU; NCCL when each rank has its own device; gloo when
    ranks share one (NCCL refuses two ranks on one device)."""
    assert tmesh.select_backend(device_type, ranks, devices) == want


class _Rows:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n


@pytest.mark.parametrize("n,batch,world,drop_last", [(24, 4, 2, True), (23, 4, 2, True),
                                                     (23, 3, 2, False), (17, 2, 4, False),
                                                     (10, 4, 3, True), (9, 5, 1, False)])
@pytest.mark.parametrize("epoch", [0, 2])
def test_loader_rank_order_and_global_batches_match_jax(n, batch, world, drop_last, epoch):
    """Each rank's order (contiguous blocks of each global step, the ragged
    tail included), its batch count, and the rank-independent global batches."""
    globals_ = []
    for rank in range(world):
        kw = dict(shuffle=True, seed=5, drop_last=drop_last, rank=rank, world_size=world)
        ours, ref = DataLoader(_Rows(n), batch, **kw), JLoader(_Rows(n), batch, **kw)
        ours.set_epoch(epoch)
        ref.set_epoch(epoch)
        np.testing.assert_array_equal(ours.indices(), ref._indices())
        assert ours.num_batches == ref.num_batches
        got = list(ours.global_batch_indices())
        want = list(ref.global_batch_indices())
        assert len(got) == len(want) == ours.num_batches
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
        globals_.append(got)
    for g in globals_[1:]:
        assert all(np.array_equal(a, b) for a, b in zip(g, globals_[0]))


@pytest.fixture
def vocab(tmp_path, monkeypatch):
    monkeypatch.setenv("KEDS_TPU_BPE_VOCAB", write_synthetic_vocab(tmp_path / "v.txt.gz"))
    jtok.get_tokenizer.cache_clear()
    jtok.star_token_id.cache_clear()
    yield
    jtok.get_tokenizer.cache_clear()
    jtok.star_token_id.cache_clear()


def test_token_needs_match_jax(tmp_path, vocab):
    """FeaturePairDataset.own_token_needs (and its cache, read back) and
    CsvDataset.caption_token_needs."""
    data, _, _ = tiny_run_dir(tmp_path)
    ours = tds.FeaturePairDataset(str(data), templates=True).own_token_needs(n_pseudo=1)
    (data / "own_token_needs.npy").unlink()
    (data / "own_token_needs.npy.meta.json").unlink()
    want = jds.FeaturePairDataset(str(data)).own_token_needs(n_pseudo=1)
    np.testing.assert_array_equal(ours, want)
    np.testing.assert_array_equal(   # the cache JAX wrote is the port's too
        tds.FeaturePairDataset(str(data), templates=True).own_token_needs(n_pseudo=1), want)
    assert len(set(want.tolist())) > 1
    with open(tmp_path / "x.csv", "w") as f:
        f.write("filepath\ttitle\n" + "".join(
            f"i{i}.png\t{' '.join(['the dog'] * (i % 7))} cafe\n" for i in range(11)))
    for n_pseudo in (1, 3):
        np.testing.assert_array_equal(
            tds.CsvDataset(str(tmp_path / "x.csv"), None, "filepath", "title")
            .caption_token_needs(n_pseudo),
            jds.CsvDataset(str(tmp_path / "x.csv"), None, img_key="filepath",
                           caption_key="title").caption_token_needs(n_pseudo))


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    """Three shards of 5 JPEGs and their caption map."""
    root = tmp_path_factory.mktemp("dist_shards")
    rng = np.random.default_rng(1)
    caps = {}
    for s in range(3):
        with tarfile.open(root / f"cc-{s:05d}.tar", "w") as tf:
            for i in range(5):
                key = f"s{s}_{i}"
                buf = io.BytesIO()
                Image.fromarray(rng.integers(0, 255, (40, 44, 3), dtype=np.uint8)).save(
                    buf, format="JPEG")
                info = tarfile.TarInfo(f"{key}.image_byte")
                info.size = len(buf.getvalue())
                tf.addfile(info, io.BytesIO(buf.getvalue()))
                caps[key] = f"{s} {i}"
    return root, caps


def _keys(mod, root, caps, **kw):
    """The caption keys of each batch a rank streams (decode keeps the
    key, so the order is the stream's)."""
    ds = mod.TarShardDataset(str(root / "cc-{00000..00002}.tar"), batch_size=2,
                             decode_image=lambda raw: np.zeros(1, np.uint8),
                             caption_map={k: k for k in caps}, shuffle_buffer=4, seed=3,
                             train_num_samples=12, **kw)
    ds.set_epoch(1)
    return [list(c) for _, c in ds], ds.num_batches


@pytest.mark.parametrize("resampled", [False, True])
def test_tar_stream_rank_split_matches_jax(shards, resampled):
    """Each rank's shards (``rank::world_size``, cycled so that the rank with
    one shard still makes the epoch's batches) and samples equal JAX's."""
    root, caps = shards
    for rank in range(2):
        kw = dict(rank=rank, world_size=2, resampled=resampled)
        ours, n = _keys(tts, root, caps, **kw)
        want, n_j = _keys(jts, root, caps, **kw)
        assert ours == want and n == n_j == 3 and len(ours) == 3


@pytest.mark.parametrize("mod", [jts, tts], ids=["jax", "port"])
def test_tar_stream_refuses_fewer_shards_than_ranks(shards, mod):
    """Without resampling, fewer shards than ranks is refused in both
    packages (a rank without shards would never yield, and the others
    would wait in a collective); with resampling every rank draws."""
    root, caps = shards
    kw = dict(batch_size=2, decode_image=lambda raw: np.zeros(1, np.uint8),
              caption_map={k: k for k in caps}, train_num_samples=16, world_size=4)
    url = str(root / "cc-{00000..00002}.tar")
    with pytest.raises(ValueError, match="number of shards must be >= number of nodes"):
        mod.TarShardDataset(url, rank=3, **kw)
    assert len(list(mod.TarShardDataset(url, rank=3, resampled=True, **kw))) == 2


def test_worker_processes_give_the_threads_batches(tmp_path, shards):
    """--worker-processes: the loader's and the tar stream's batches equal
    the thread pools' (deterministic decode: the val transform)."""
    data, _, _ = tiny_run_dir(tmp_path)
    ds = tds.FeaturePairDataset(str(data))
    runs = []
    for procs in (False, True):
        loader = DataLoader(ds, 5, shuffle=True, seed=1, drop_last=True, num_workers=2,
                            worker_processes=procs)
        runs.append(list(loader))
        loader.close()
    for a, b in zip(*runs):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    root, caps = shards
    out = []
    for procs in (False, True):
        ds = tts.TarShardDataset(str(root / "cc-{00000..00002}.tar"), batch_size=4,
                                 decode_image=tts.pil_jpeg_decoder(32, is_train=False,
                                                                   normalize=False),
                                 caption_map=caps, shuffle_buffer=4, seed=0,
                                 train_num_samples=12, workers=2, worker_processes=procs)
        out.append(list(ds))
        ds.close()
    assert len(out[0]) == len(out[1]) == 3
    for (ia, ca), (ib, cb) in zip(*out):
        np.testing.assert_array_equal(ia, ib)
        assert list(ca) == list(cb)


def test_mesh_of_one_rank(caplog, monkeypatch):
    """Without a process group: one rank, helpers that pass rows through,
    and --num-partitions above the world size clamped to it with the JAX
    package's warning (keds_tpu.parallel.mesh.make_mesh); fewer ranks than
    the world refused with its ValueError (shown with a patched world)."""
    assert not tmesh.maybe_init_distributed(SimpleNamespace(distributed=False))
    mesh = tmesh.make_mesh(0, "cpu")
    assert (mesh.rank, mesh.size, mesh.device.type) == (0, 1, "cpu")
    assert tmesh.make_mesh(1, "cpu").size == 1
    with caplog.at_level("WARNING"):
        clamped = tmesh.make_mesh(4, "cpu")
    assert (clamped.rank, clamped.size, clamped.device.type) == (0, 1, "cpu")
    assert "4 devices requested, 1 available — using all" in caplog.text
    with monkeypatch.context() as mp:
        mp.setattr(tmesh.dist, "is_initialized", lambda: True)
        mp.setattr(tmesh.dist, "get_world_size", lambda: 4)
        for n in (1, 2, 3):
            with pytest.raises(ValueError, match=rf"--num-partitions {n} must be a "
                                                 r"positive multiple of the process count \(4\)"):
                tmesh.make_mesh(n, "cpu")
    x = np.arange(10.0).reshape(5, 2)
    local, n = tmesh.shard_global_batch(mesh, x)
    assert n == 5 and torch.equal(local, torch.from_numpy(x))
    assert torch.equal(tmesh.fetch_global(mesh, local, 3), local[:3])
    assert torch.equal(tmesh.fetch_batches(mesh, local, [5]), local)
    assert tmesh.shard_rows(mesh, local) is local
    assert tmesh.gather_with_grad(mesh, local) is local
    assert mesh.comm.calls == 0
