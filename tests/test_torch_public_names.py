"""The last public names of keds_tpu that the port lacked, each against its
keds_tpu counterpart on the CPU, and the attention wrapper's zero padding of
narrow heads (its pad, slice and scale) with a plain stand-in for the
kernels."""

import ctypes
import dataclasses

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from keds_tpu import tokenizer as jtok
from keds_tpu import transforms as jtransforms
from keds_tpu.data.loader import DataLoader as JDataLoader
from keds_tpu.io import checkpoint as jckpt
from keds_tpu.models import clip as jclip
from keds_tpu.parallel.mesh import make_mesh
from keds_tpu.retrieval.database import KnowledgeDB as JKnowledgeDB
from keds_tpu.retrieval.database import Retriever as JRetriever

from keds_tpu_torch import tokenizer as ttok
from keds_tpu_torch import transforms as ttransforms
from keds_tpu_torch.data.loader import DataLoader
from keds_tpu_torch.io import checkpoint as tckpt
from keds_tpu_torch.models import clip as tclip
from keds_tpu_torch.ops import attention as att_mod
from keds_tpu_torch.parallel.mesh import Mesh
from keds_tpu_torch.retrieval.database import KnowledgeDB, Retriever

from torch_port_helpers import JCFG, TCFG, jax_models, port_models, write_synthetic_vocab

torch.set_num_threads(1)


# --- models/clip.py: causal_mask ------------------------------------------------

@pytest.mark.parametrize("n", [1, 5, 77])
def test_causal_mask_matches_jax(n):
    """Exact: the same -inf above the diagonal, zeros elsewhere, f32."""
    got = tclip.causal_mask(n)
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), np.asarray(jclip.causal_mask(n)))
    assert tclip.causal_mask(n, device="cpu").device.type == "cpu"


# --- data/loader.py: DataLoader.num_samples --------------------------------------

@pytest.mark.parametrize("n,batch,drop_last,world", [(10, 3, False, 1), (10, 3, True, 1),
                                                      (7, 4, False, 2), (0, 2, False, 1)])
def test_dataloader_num_samples_matches_jax(n, batch, drop_last, world):
    """The dataset's length whatever the batching (exact)."""
    data = list(range(n))
    kw = dict(batch_size=batch, drop_last=drop_last, rank=0, world_size=world)
    assert DataLoader(data, **kw).num_samples == JDataLoader(data, **kw).num_samples == n


# --- retrieval/database.py: Retriever.names_for ----------------------------------

def _db_arrays(n=40, d=16, seed=3):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, d)), rng.standard_normal((n, d)), [f"img_{i:03d}.jpg"
                                                                      for i in range(n)]


def test_names_for_matches_jax():
    """Names of a (B, k) index array, given as numpy or as a tensor (int64,
    int32, a non-contiguous view), equal the JAX Retriever's (exact)."""
    img, txt, names = _db_arrays()
    jr = JRetriever(JKnowledgeDB.from_arrays(img, txt, names=names, dtype=jnp.float32))
    r = Retriever(KnowledgeDB.from_arrays(img, txt, names, dtype=torch.float32, device="cpu"))
    idx = np.random.default_rng(4).integers(0, 40, (3, 5))
    want = jr.names_for(idx)
    assert len(want) == 15
    assert r.names_for(idx) == want
    assert r.names_for(torch.from_numpy(idx)) == want
    assert r.names_for(torch.from_numpy(idx).int()) == want
    assert r.names_for(torch.from_numpy(idx.T.copy()).t()) == want
    # the search's own indices
    _, cap_idx = r.retrieve_caption_neighbors(torch.from_numpy(img[:3]).float(), k=2)
    assert r.names_for(cap_idx) == jr.names_for(np.asarray(cap_idx))


def test_names_for_on_a_sharded_db_indexes_global_rows():
    """A DB that is shard_over a mesh keeps the whole DB's names: rank 1 of
    2, holding rows 20..39, names row 3 as the JAX sharded DB does (exact)."""
    img, txt, names = _db_arrays()
    mesh = Mesh(rank=1, size=2, device=torch.device("cpu"), backend="gloo")
    db = KnowledgeDB.from_arrays(img, txt, names, dtype=torch.float32,
                                 device="cpu").shard_over(mesh)
    assert db.image_db.shape[0] == 20
    jdb = JKnowledgeDB.from_arrays(img, txt, names=names, dtype=jnp.float32)
    jmesh = make_mesh(2)
    jr = JRetriever(jdb.shard_over(jmesh), mesh=jmesh, sharded=True)
    idx = np.array([[3, 39], [20, 0]])
    assert Retriever(db).names_for(torch.from_numpy(idx)) == jr.names_for(idx) == [
        "img_003.jpg", "img_039.jpg", "img_020.jpg", "img_000.jpg"]


# --- tokenizer.py: VOCAB_SIZE, ClipBPE.encode_batch, ClipBPE.decode ---------------

TEXTS = ["a photo of the dog", "", "Café naïve — 東京 🐶!", "the  cat\tand\nthe hat's",
         "numbers 12345 and photo"]


@pytest.fixture(scope="module")
def bpe(tmp_path_factory):
    path = write_synthetic_vocab(tmp_path_factory.mktemp("vocab") / "merges.txt.gz")
    return ttok.ClipBPE(path), jtok.ClipBPE(path)


def test_vocab_size_matches_jax():
    assert ttok.VOCAB_SIZE == jtok.VOCAB_SIZE == 49408


def test_encode_batch_matches_jax(bpe):
    """ASCII, non-ASCII and empty strings, as one batch (exact ids)."""
    port, jax_bpe = bpe
    got = port.encode_batch(TEXTS)
    assert got == jax_bpe.encode_batch(TEXTS)
    assert got == [port.encode(t) for t in TEXTS]
    assert got[1] == [] and port.encode_batch([]) == []


def test_decode_matches_jax_and_round_trips(bpe):
    """decode of each text's ids equals JAX's, and decode(encode(x)) gives
    the cleaned, lower-cased words with a space after each (exact)."""
    port, jax_bpe = bpe
    for text, ids in zip(TEXTS, port.encode_batch(TEXTS)):
        assert port.decode(ids) == jax_bpe.decode(ids)
        assert port.decode(np.asarray(ids, np.int64)) == jax_bpe.decode(ids)
    assert port.decode(port.encode("A Photo of the DOG")) == "a photo of the dog "
    assert port.decode([]) == ""
    # a byte that is not UTF-8 on its own is replaced, as in JAX
    lone = [port.encoder[port._b2u[0xE6]]]
    assert port.decode(lone) == jax_bpe.decode(lone) == "�"


# --- io/checkpoint.py: load_full_checkpoint ----------------------------------------

def _port_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for key in sorted(tree) for k, v in
                _port_leaves(tree[key], f"{prefix}/{key}").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, t in enumerate(tree) for k, v in
                _port_leaves(t, f"{prefix}/{i}").items()}
    return {prefix: tree}


def _assert_port_equal(got, want):
    got, want = _port_leaves(got), _port_leaves(want)
    assert got.keys() == want.keys()
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        torch.testing.assert_close(got[key], want[key], atol=0, rtol=0, msg=key)


def _assert_jax_equal(got, want):
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), strict=True)


# keds_tpu's save_pt writes the 0-d logit_scale as (1,) (a keds_tpu fault,
# ROADMAP §C; tests/test_torch_bench_fullscale.py pins it), and both
# packages' readers keep that shape: the shape its writer leaves it in.
LOGIT_SCALE_SHAPE = {"jax": (1,), "port": ()}


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_load_full_checkpoint_both_directions(tmp_path, writer):
    """A checkpoint written by either package's save_train_checkpoint, read
    by both packages' load_full_checkpoint: every tensor equal to the
    source (exact), config and epoch equal."""
    jparams, jheads = jax_models()
    tparams, theads = port_models(jparams, jheads)
    path = str(tmp_path / "full.pt")
    if writer == "jax":
        jckpt.save_train_checkpoint(path, epoch=3, name="t", clip_params=jparams,
                                    clip_cfg=JCFG, heads=jheads)
    else:
        tckpt.save_train_checkpoint(path, epoch=3, name="t", clip_params=tparams,
                                    clip_cfg=TCFG, heads=theads)
    params, cfg, heads, epoch = tckpt.load_full_checkpoint(path, device="cpu")
    assert epoch == 3 and dataclasses.asdict(cfg) == dataclasses.asdict(TCFG)
    assert tuple(params["logit_scale"].shape) == LOGIT_SCALE_SHAPE[writer]
    _assert_port_equal(dict(params, logit_scale=params["logit_scale"].reshape(())), tparams)
    _assert_port_equal(heads._asdict(), theads._asdict())
    jp, jcfg, jh, jepoch = jckpt.load_full_checkpoint(path)
    assert jepoch == 3 and dataclasses.asdict(jcfg) == dataclasses.asdict(JCFG)
    assert np.shape(jp["logit_scale"]) == LOGIT_SCALE_SHAPE[writer]
    _assert_jax_equal(dict(jp, logit_scale=np.reshape(jp["logit_scale"], ())), jparams)
    _assert_jax_equal(jh, jheads)


# --- transforms.py: device_preprocess ----------------------------------------------

# normalised units: the two resizes sum the same weighted pixels in another
# order (f32); 2e-6 measured at these sizes
PREPROCESS_TOL = 1e-5


@pytest.mark.parametrize("shape", [(2, 48, 64, 3), (2, 20, 30, 3), (2, 40, 40, 3),
                                   (1, 33, 57, 3)], ids=["shrink", "stretch", "square", "odd"])
def test_device_preprocess_matches_jax(shape):
    """Seeded non-uniform images: a shrink (antialiased), a stretch, a
    square input and odd sides, to 32 px (24 for the odd one)."""
    n_px = 24 if shape[1] == 33 else 32
    images = np.random.default_rng(sum(shape)).integers(0, 256, shape, dtype=np.uint8)
    got = ttransforms.device_preprocess(images, n_px=n_px, device="cpu")
    want = np.asarray(jtransforms.device_preprocess(images, n_px=n_px))
    assert got.shape == (shape[0], n_px, n_px, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=PREPROCESS_TOL, rtol=0)
    again = ttransforms.device_preprocess(torch.from_numpy(images), n_px=n_px, device="cpu")
    assert torch.equal(again, got)


def test_device_preprocess_matches_host_for_uniform_image():
    """JAX's own check (tests/test_transforms.py), on the port's functions:
    uniform images are resize-invariant, so device and host paths agree."""
    arr = np.full((1, 48, 64, 3), 200, np.uint8)
    dev = ttransforms.device_preprocess(arr, n_px=32, device="cpu").numpy()
    host = ttransforms.image_transform(32, is_train=False)(Image.fromarray(arr[0]))
    np.testing.assert_allclose(dev[0], host, atol=1e-2)


# --- ops/attention.py: narrow heads, at their own width or zero-padded ----------

def _dh16(dh):
    return -(-dh // 16) * 16


class _RouteLibs:
    """The libraries' route functions as the card test
    (test_torch_cuda.py::test_attention_routes_by_head_width) holds them:
    bf16 Dh < 64 runs at Dh rounded up to 16 on the resident kernels (288
    keys forward, 128 backward) and is padded to 64 above them; the f32
    backward pads Dh < 64 to 64; out = (width handed, width run at,
    workspace rows)."""

    @staticmethod
    def _out(ptr):
        return ctypes.cast(ptr, ctypes.POINTER(ctypes.c_int))

    def keds_attention_fwd_route(self, code, dh, s, ptr):
        out = self._out(ptr)
        if code == 1:
            out[0], out[1] = (64, 64) if dh <= 64 and s > 288 else (dh, _dh16(dh))
            return 1 if dh <= 64 else 2
        out[0], out[1] = dh, next((w for w in (32, 64, 128) if dh <= w), -(-dh // 8) * 8)
        return 0 if dh <= 128 else 2

    def keds_attention_bwd_route(self, code, dh, s, ptr):
        out = self._out(ptr)
        if dh > 64:             # the wide pair: a workspace row per query row
            out[0], out[1], out[2] = dh, _dh16(dh) if code == 1 else -(-dh // 8) * 8, s
            return 1
        resident = code == 1 and s <= 128
        out[0], out[1] = (dh, _dh16(dh)) if resident else (64, 64)
        # the tuned kernels' workspace above one launch's lengths (bf16 128
        # keys, f32 64), S rounded up to 16
        out[2] = 16 * -(-s // 16) if s > (128 if code == 1 else 64) else 0
        return 0


def _plain(q, k, v, causal, scale):
    """attention_reference at an explicit scale."""
    scores = torch.matmul(q.float() * scale, k.float().transpose(-1, -2))
    if causal:
        scores = scores + att_mod.causal_mask(q.shape[2])
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.matmul(probs.float(), v.float()).to(q.dtype)


@pytest.fixture
def plain_kernels(monkeypatch):
    """The wrapper's CUDA path on CPU tensors, each launch replaced by the
    plain math at the width and scale the wrapper hands it."""
    calls = []

    def forward(lib, code, q, k, v, out, causal, scale):
        calls.append(q.shape[-1])
        out.copy_(_plain(q, k, v, causal, scale))

    def backward(lib, code, q, k, v, dout, grads, causal, scale, rows):
        calls.append(q.shape[-1])
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in (q, k, v)]
            got = torch.autograd.grad(_plain(*leaves, causal, scale), leaves, dout)
        for g, src in zip(grads, got):
            g.copy_(src)

    libs = _RouteLibs()
    monkeypatch.setattr(att_mod, "require_cuda", lambda *t: None)
    monkeypatch.setattr(att_mod, "_launch_forward", forward)
    monkeypatch.setattr(att_mod, "_launch_backward", backward)
    monkeypatch.setattr(att_mod.KERNEL, "lib", lambda: libs)
    monkeypatch.setattr(att_mod.BWD_KERNEL, "lib", lambda: libs)
    return calls


def _inputs(dh, dtype, s=9, b=2, h=3, seed=0):
    """Strided q/k/v views of one (B, S, 3, H, Dh) buffer and a (B, H, S,
    Dh) view of a (B, S, H, Dh) output gradient."""
    rng = np.random.default_rng(seed + dh)
    qkv = torch.from_numpy(rng.standard_normal((b, s, 3, h, dh), np.float32)).to(dtype)
    dout = torch.from_numpy(rng.standard_normal((b, s, h, dh), np.float32)).to(dtype)
    return tuple(qkv[:, :, i].transpose(1, 2) for i in range(3)), dout.transpose(1, 2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("dh", [1, 16, 24, 32, 48])
@pytest.mark.parametrize("s", [9, 300])
@pytest.mark.parametrize("causal", [False, True])
def test_padded_forward_is_exact(plain_kernels, dtype, dh, s, causal):
    """bf16 up to 288 keys and f32 run at the caller's Dh (the kernel at Dh
    rounded up to 16 in bf16, 32 to 128 in f32: no pad counted, the result
    a view of a (B, S, H, Dh) buffer); bf16 above 288 keys streams at 64:
    the wrapper pads, counts it and slices the output back.  Either way
    the scale is the caller's 1/sqrt(Dh) and the result is the plain
    version on the caller's inputs, to 1e-6 (a padded product sums the
    same terms, with zeros, in an order the BLAS picks)."""
    (q, k, v), _ = _inputs(dh, dtype, s=s)
    padded = dtype == torch.bfloat16 and s > 288
    width = 64 if padded else dh
    route = att_mod._route(_RouteLibs().keds_attention_fwd_route,
                           int(dtype == torch.bfloat16), dh, s)
    assert route.width == width
    if dtype == torch.bfloat16:
        assert route.runs_at == (64 if padded else _dh16(dh))
    launches, pads = dict(att_mod.KERNEL.launches), dict(att_mod.KERNEL.pads)
    out = att_mod._forward_kernel(q, k, v, causal)
    variant = "bf16_tc" if dtype == torch.bfloat16 else "f32"
    assert plain_kernels == [width]
    assert att_mod.KERNEL.launches == dict(launches, **{variant: launches[variant] + 1})
    assert att_mod.KERNEL.pads == dict(pads, **{variant: pads[variant] + padded})
    assert out.shape == q.shape and out.dtype == dtype
    B, H, S, _ = q.shape
    assert out.stride() == (S * H * width, width, H * width, 1)
    torch.testing.assert_close(out.float(), att_mod.attention_reference(q, k, v, causal).float(),
                               atol=1e-6, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("dh", [1, 16, 24, 32, 48])
@pytest.mark.parametrize("s", [9, 130])
@pytest.mark.parametrize("causal", [False, True])
def test_padded_backward_is_exact(plain_kernels, dtype, dh, s, causal):
    """bf16 up to 128 keys runs at the caller's Dh (the kernel at Dh rounded
    up to 16; no pad counted, dq, dk and dv views of one (B, S, 3, H, Dh)
    buffer); bf16 above them (streamed, a workspace) and f32 pad to 64:
    the gradients are views of one (B, S, 3, H, 64) buffer sliced to Dh.
    Either way equal to the plain backward on the caller's inputs to 1e-6."""
    (q, k, v), dout = _inputs(dh, dtype, s=s)
    prefix = "bf16" if dtype == torch.bfloat16 else "f32"
    variant = prefix + ("_stream" if prefix == "bf16" and s > 128 else "")
    padded = not (prefix == "bf16" and s <= 128)
    width = 64 if padded else dh
    route = att_mod._route(_RouteLibs().keds_attention_bwd_route, int(prefix == "bf16"), dh, s)
    assert (route.width, route.runs_at) == ((64, 64) if padded else (dh, _dh16(dh)))
    launches, pads = dict(att_mod.BWD_KERNEL.launches), dict(att_mod.BWD_KERNEL.pads)
    grads = att_mod._backward_kernel(q, k, v, dout, causal)
    assert plain_kernels == [width]
    assert att_mod.BWD_KERNEL.launches == dict(launches, **{variant: launches[variant] + 1})
    assert att_mod.BWD_KERNEL.pads == dict(pads, **{variant: pads[variant] + padded})
    B, H, S, _ = q.shape
    ref = att_mod.attention_reference_backward(q, k, v, dout, causal)
    for i, (g, r) in enumerate(zip(grads, ref)):
        assert g.shape == q.shape and g.dtype == dtype
        assert g.stride() == (S * 3 * H * width, width, 3 * H * width, 1)
        assert g.data_ptr() == grads[0].data_ptr() + i * H * width * g.element_size()
        torch.testing.assert_close(g.float(), r.float(), atol=1e-6, rtol=0)


def test_padded_attention_saves_the_callers_inputs(plain_kernels):
    """The autograd Function saves the caller's q, k and v, whether the
    forward runs at their width (bf16 Dh = 32 at S = 9) or on copies padded
    to 64 (at S = 300), so autograd sees the caller's shapes."""
    for s, width in ((9, 32), (300, 64)):
        plain_kernels.clear()
        (q, k, v), _ = _inputs(32, torch.bfloat16, s=s)
        q.requires_grad_(True)
        out = att_mod._AttentionFunction.apply(q, k, v, True)
        assert plain_kernels == [width] and out.shape == q.shape
        assert [t.shape for t in out.grad_fn.saved_tensors] == [q.shape] * 3
        assert all(a is b or a.data_ptr() == b.data_ptr()
                   for a, b in zip(out.grad_fn.saved_tensors, (q, k, v)))


@pytest.mark.parametrize("dh", [64, 65, 80, 100, 320])
def test_aligned_rows_copies_into_16_byte_rows(dh):
    """The bf16 kernels stage 16-byte rows: a strided view whose rows are not
    16-byte aligned (Dh = 100: 200-byte rows) is copied into rows rounded up
    to 8 elements, a view of the same shape and values; aligned rows are
    passed through uncopied."""
    qkv = torch.randn((2, 5, 3, 3, dh), generator=torch.Generator().manual_seed(dh))
    q = qkv.to(torch.bfloat16)[:, :, 0].transpose(1, 2)
    out = att_mod._aligned_rows(q, 16)
    assert out.shape == q.shape and torch.equal(out, q)
    assert out.data_ptr() % 16 == 0 and all(st % 8 == 0 for st in out.stride()[:3])
    assert (out.data_ptr() == q.data_ptr()) == (dh % 8 == 0)
