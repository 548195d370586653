"""The port's ModifiedResNet (RN) image tower and its converters vs
keds_tpu.models.resnet / convert / clip on the same reference-layout RN
state dicts (f32 on the CPU, atol = rtol = 1e-4; the state-dict round trip
exactly)."""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from keds_tpu.models import clip as jclip, resnet as jresnet
from keds_tpu.models.convert import (clip_pytree_to_state_dict, clip_state_dict_to_pytree,
                                     infer_clip_config as jinfer)

from keds_tpu_torch import synth
from keds_tpu_torch.models import clip as tclip, resnet as tresnet
from keds_tpu_torch.models.convert import (cast_floating, clip_from_numpy,
                                           clip_from_state_dict, clip_to_state_dict,
                                           infer_clip_config)

from torch_port_helpers import rn_state_dict, to_numpy

torch.set_num_threads(1)
TOL = dict(atol=1e-4, rtol=1e-4)
# (vision_layers, width, resolution): the one-block tower, and two blocks in
# the first stage (one without a downsample) at a 3 x 3 final grid
SHAPES = [((1, 1, 1, 1), 8, 64), ((2, 1, 1, 1), 8, 96)]
IDS = ["1111-64px", "2111-96px"]


@functools.lru_cache()
def _models(layers, width, resolution):
    """(state dict, JAX params, JAX config, port params, port config)."""
    sd = rn_state_dict(layers, width, resolution)
    jparams, jcfg = clip_state_dict_to_pytree(sd)
    tparams, tcfg = clip_from_state_dict(sd, device="cpu")
    return sd, jax.tree.map(jnp.asarray, jparams), jcfg, tparams, tcfg


def _images(n, resolution, seed):
    return np.random.default_rng(seed).standard_normal(
        (n, resolution, resolution, 3)).astype(np.float32)


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_infer_clip_config_matches_jax(shape):
    sd, _, jcfg, _, tcfg = _models(*shape)
    assert dataclasses.asdict(infer_clip_config(sd)) == dataclasses.asdict(jinfer(sd))
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert not tcfg.is_vit and tcfg.vision_heads == jcfg.vision_heads == 4
    assert tcfg.image_resolution == shape[2] and tcfg.embed_dim != tcfg.transformer_width


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_encode_image_resnet_matches_jax(shape):
    _, jparams, jcfg, tparams, tcfg = _models(*shape)
    x = _images(3, shape[2], 1)
    ref = jresnet.encode_image_resnet(jparams, jnp.asarray(x), jcfg.vision_heads)
    out = tresnet.encode_image_resnet(tparams, torch.from_numpy(x), tcfg.vision_heads)
    assert out.shape == (3, 16)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_attention_pool_2d_matches_jax(shape):
    _, jparams, jcfg, tparams, _ = _models(*shape)
    grid, c = shape[2] // 32, 32 * shape[1]
    x = np.random.default_rng(2).standard_normal((2, grid, grid, c)).astype(np.float32)
    ref = jresnet.attention_pool_2d(jnp.asarray(x), jparams["visual"]["attnpool"],
                                    jcfg.vision_heads)
    out = tresnet.attention_pool_2d(torch.from_numpy(x), tparams["visual"]["attnpool"],
                                    jcfg.vision_heads)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_encode_image_dispatches_to_the_resnet_as_jax(shape):
    _, jparams, jcfg, tparams, tcfg = _models(*shape)
    x = _images(2, shape[2], 3)
    ref = jclip.encode_image(jparams, jcfg, jnp.asarray(x))
    np.testing.assert_allclose(tclip.encode_image(tparams, tcfg, torch.from_numpy(x)).numpy(),
                               np.asarray(ref), **TOL)
    u8 = np.random.default_rng(4).integers(0, 256, (4, shape[2], shape[2], 3), np.uint8)
    ref = jclip.encode_image_chunked(jparams, jcfg, jnp.asarray(u8), chunk=2)
    out = tclip.encode_image_chunked(tparams, tcfg, torch.from_numpy(u8), chunk=2)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_state_dict_round_trip_equals_jax_key_for_key(shape):
    sd, jparams, jcfg, tparams, tcfg = _models(*shape)
    want = clip_pytree_to_state_dict(to_numpy(jparams), jcfg)
    got = clip_to_state_dict(tparams, tcfg)
    assert list(got) == list(want)
    for key, a in want.items():
        b = got[key]
        assert isinstance(b, torch.Tensor) and b.shape == np.shape(a), key
        assert b.dtype == (torch.int64 if key.endswith("num_batches_tracked")
                           else torch.float32), key
        np.testing.assert_array_equal(b.numpy(), a, err_msg=key)
    assert set(got) == set(sd)


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_clip_from_numpy_carries_the_jax_rn_pytree(shape):
    """The JAX pytree (lists of lists of block dicts, HWIO kernels) gives the
    same parameters as the state dict and the same encode."""
    _, jparams, jcfg, tparams, tcfg = _models(*shape)
    carried = clip_from_numpy(to_numpy(jparams), device="cpu")
    flat = jax.tree_util.tree_leaves_with_path(tparams)
    other = dict(jax.tree_util.tree_leaves_with_path(carried))
    assert len(flat) == len(other)
    for path, a in flat:
        torch.testing.assert_close(other[path], a, atol=0, rtol=0)
    w = carried["visual"]["layers"][0][0]["conv2_w"]
    assert w.shape == (8, 8, 3, 3) and w.is_contiguous(memory_format=torch.channels_last)
    x = _images(2, shape[2], 5)
    ref = jclip.encode_image(jparams, jcfg, jnp.asarray(x))
    np.testing.assert_allclose(tclip.encode_image(carried, tcfg, torch.from_numpy(x)).numpy(),
                               np.asarray(ref), **TOL)


def test_bf16_tower_on_the_cpu_tracks_f32():
    _, _, _, tparams, tcfg = _models(*SHAPES[0])
    x = torch.from_numpy(_images(4, 64, 6))
    f32 = tclip.encode_image(tparams, tcfg, x)
    bf16 = tclip.encode_image(cast_floating(tparams, torch.bfloat16, "cpu"), tcfg, x)
    assert bf16.dtype == torch.bfloat16 and torch.isfinite(bf16).all()
    cos = torch.nn.functional.cosine_similarity(bf16.float(), f32, dim=1)
    assert float(cos.min()) > 0.99


def test_synthetic_rn_weights_load_in_jax_and_calibrate_their_batchnorms():
    """synth's RN tower is a reference-layout checkpoint that keds_tpu reads
    and encodes as the port does; each BatchNorm's statistics are those of
    the calibration batch, so its outputs come out normalised."""
    cfg = tclip.ClipConfig(embed_dim=16, image_resolution=64, vision_layers=(1, 1, 1, 1),
                           vision_width=8, vision_patch_size=0, transformer_width=64,
                           transformer_heads=1, transformer_layers=1)
    params = synth.init_clip(cfg, 3, torch.device("cpu"), torch.float32)
    sd = {k: v.numpy() for k, v in clip_to_state_dict(params, cfg).items()}
    jparams, jcfg = clip_state_dict_to_pytree(sd)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)
    x = _images(3, 64, 7)
    ref = jclip.encode_image(jax.tree.map(jnp.asarray, jparams), jcfg, jnp.asarray(x))
    out = tclip.encode_image(params, cfg, torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    # a fresh batch through the tower: the BatchNorms of the stem and the
    # first stage (16 x 16 and more positions an image) give about zero
    # mean and unit variance before their gains (b = 0)
    seen = []

    def recording_bn(t, p):
        y = tresnet._bn(t, p)
        z = y / p["g"][:, None, None]          # each bottleneck's bn3 has gain 0.25
        seen.append((float(z.mean()), float(z.var(dim=(0, 2, 3)).mean())))
        return y

    tresnet.encode_image_resnet(params, torch.randn((8, 64, 64, 3)), cfg.vision_heads,
                                bn=recording_bn)
    for mean, var in seen[:7]:          # stem bn1..bn3, layer1.0 bn1..bn3 and downsample
        assert abs(mean) < 0.15 and 0.7 < var < 1.3, (mean, var)


def test_rn_configs_are_the_published_shapes():
    for name, cfg in synth.RN_CONFIGS.items():
        assert not cfg.is_vit and cfg.transformer_layers == 12, name
        assert cfg.transformer_width // cfg.transformer_heads == 64
        assert cfg.vision_width * 32 // cfg.vision_heads == 64   # attention-pool heads of 64
    assert synth.RN_CONFIGS["RN50"].embed_dim == 1024
    assert synth.RN_CONFIGS["RN50x64"].image_resolution // 32 == 14    # 197 pool tokens
