"""The rest of the port's model surface vs keds_tpu.models.clip / layers on a
tiny ViT (f32 on the CPU, atol 1e-4): the full token sequence and every
block's output, MAE masking, the visual-invert composition, the per-sample
splice, the textual-invert mid-cross feature, clip_forward,
transformer_collect and model_config_for."""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from keds_tpu.models import clip as jclip, heads as jheads, layers as jlayers

from keds_tpu_torch.models import clip as tclip, heads as theads, layers as tlayers
from keds_tpu_torch.models.convert import clip_from_numpy, params_from_numpy

from torch_port_helpers import SPLIT_ID, to_numpy

torch.set_num_threads(1)
ATOL = 1e-4
EOT, SOT = 49407, 49406
# 8 vision blocks, so that the visual-invert fusion (before block L - 6)
# happens; 3 text blocks, so that the mid-cross feature enters twice
SURF = dict(embed_dim=64, image_resolution=32, vision_layers=8, vision_width=128,
            vision_patch_size=16, transformer_width=64, transformer_heads=1,
            transformer_layers=3)
JCFG, TCFG = jclip.ClipConfig(**SURF), tclip.ClipConfig(**SURF)


@functools.lru_cache()
def _models():
    params = jclip.init_clip(jax.random.key(0), JCFG)
    cross = jheads.init_crossformer(jax.random.key(1), 128, 64, 64, num_layers=1)
    text_cross = jheads.init_crossformer(jax.random.key(2), 64, 64, 64, num_layers=2)
    port = (clip_from_numpy(to_numpy(params), device="cpu"),
            params_from_numpy(to_numpy(cross), device="cpu"),
            params_from_numpy(to_numpy(text_cross), device="cpu"))
    return (params, cross, text_cross), port


def _images(n, seed):
    return np.random.default_rng(seed).standard_normal((n, 32, 32, 3)).astype(np.float32)


def _close(out, ref, atol=ATOL):
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=atol, rtol=1e-4)


def test_model_config_for_matches_jax():
    for name in jclip.MODEL_CONFIGS:
        assert dataclasses.asdict(tclip.model_config_for(name)) == dataclasses.asdict(
            jclip.model_config_for(name))
    for name in ("RN50", "RN101", "RN50x4", "RN50x16", "RN50x64", "ViT-X"):
        with pytest.raises(KeyError) as want:
            jclip.model_config_for(name)
        with pytest.raises(KeyError) as got:
            tclip.model_config_for(name)
        assert str(got.value) == str(want.value)


def test_encode_image_tokens_and_mid_features_match_jax():
    (params, _, _), (tparams, _, _) = _models()
    x = _images(2, 0)
    _close(tclip.encode_image_tokens(tparams, TCFG, torch.from_numpy(x)),
           jclip.encode_image_tokens(params, JCFG, jnp.asarray(x)))
    emb, mids = tclip.encode_image_mid_features(tparams, TCFG, torch.from_numpy(x))
    jemb, jmids = jclip.encode_image_mid_features(params, JCFG, jnp.asarray(x))
    assert mids.shape == (8, 2, 5, 128)
    _close(emb, jemb)
    _close(mids, jmids)
    _close(emb, jclip.encode_image(params, JCFG, jnp.asarray(x)))


@pytest.mark.parametrize("causal", [False, True])
def test_transformer_collect_matches_jax(causal):
    (params, _, _), (tparams, _, _) = _models()
    x = np.random.default_rng(1).standard_normal((2, 7, 64)).astype(np.float32)
    mask = jclip.causal_mask(7) if causal else None
    out, mids = tlayers.transformer_collect(torch.from_numpy(x), tparams["text"]["blocks"], 1,
                                            causal)
    jout, jmids = jlayers.transformer_collect(jnp.asarray(x), params["text"]["blocks"], 1,
                                              mask, causal)
    assert mids.shape == (3, 2, 7, 64)
    _close(out, jout)
    _close(mids, jmids)
    _close(mids[-1], out, atol=0)


@pytest.mark.parametrize("ratio", [0.4, 0.75, 1.0])
def test_masking_from_jax_noise_matches_jax(ratio):
    """The argsort -> keep -> restore logic fed JAX's noise equals
    random_masking's outputs."""
    x = np.random.default_rng(2).standard_normal((3, 10, 4)).astype(np.float32)
    key = jax.random.key(5)
    kept, mask, restore = jclip.random_masking(key, jnp.asarray(x), ratio)
    noise = np.array(jax.random.uniform(key, (3, 10)))
    tk, tm, tr = tclip.masking_from_noise(torch.from_numpy(x), torch.from_numpy(noise), ratio)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(kept))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(mask))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(restore))


@pytest.mark.parametrize("ratio", [0.4, 1.0])
def test_random_masking_properties(ratio):
    x = torch.arange(2 * 10 * 4, dtype=torch.float32).reshape(2, 10, 4)
    gen = torch.Generator().manual_seed(0)
    kept, mask, restore = tclip.random_masking(gen, x, ratio)
    n_keep = int(10 * (1 - ratio))
    assert kept.shape == (2, n_keep, 4) and mask.shape == (2, 10)
    torch.testing.assert_close(mask.sum(dim=1), torch.full((2,), 10.0 - n_keep))
    for b in range(2):
        rows = {tuple(r.tolist()) for r in x[b]}
        assert all(tuple(r.tolist()) in rows for r in kept[b])
        assert sorted(restore[b].tolist()) == list(range(10))
        # the kept rows are the unmasked ones, in the kept order's positions
        unmasked = (mask[b] == 0).nonzero().flatten()
        kept_rows = ((kept[b][:, 0] - x[b, 0, 0]) / 4).long()
        assert sorted(kept_rows.tolist()) == unmasked.tolist()
    again = tclip.random_masking(torch.Generator().manual_seed(0), x, ratio)
    torch.testing.assert_close(again[0], kept, atol=0, rtol=0)


def _crosses(cross, tcross):
    return (lambda q, k, v: jheads.crossformer_apply(cross, q, k, v),
            lambda q, k, v: theads.crossformer_apply(tcross, q, k, v))


def test_visual_composed_features_at_ratio_one_match_jax():
    """The live call: the tower over the CLS token alone (S = 1), the text
    feature fused before block 2; the eval twin gives the same."""
    (params, cross, _), (tparams, tcross, _) = _models()
    jc, tc = _crosses(cross, tcross)
    x = _images(2, 3)
    tf = np.random.default_rng(4).standard_normal((2, 64)).astype(np.float32)
    ref = jclip.get_visual_composed_features(params, JCFG, jnp.asarray(tf), jnp.asarray(x),
                                             jc, jax.random.key(2), mask_ratio=1.0)
    out = tclip.get_visual_composed_features(tparams, TCFG, torch.from_numpy(tf),
                                             torch.from_numpy(x), tc,
                                             torch.Generator().manual_seed(2), 1.0)
    assert out.shape == (2, 64)
    _close(out, ref)
    twin = tclip.get_visual_composed_features_eval(tparams, TCFG, torch.from_numpy(tf),
                                                   torch.from_numpy(x), tc, None, 1.0)
    _close(twin, ref)
    other = tclip.get_visual_composed_features(tparams, TCFG, 2 * torch.from_numpy(tf),
                                               torch.from_numpy(x), tc, None, 1.0)
    assert float((other - out).abs().max()) > 0     # the fusion matters


def test_visual_composed_features_below_ratio_one_match_jax(monkeypatch):
    """mask_ratio 0.75: the port's masking fed JAX's noise keeps JAX's
    tokens, and the CLS-query fusion gives JAX's feature."""
    (params, cross, _), (tparams, tcross, _) = _models()
    jc, tc = _crosses(cross, tcross)
    x = _images(2, 5)
    tf = np.random.default_rng(6).standard_normal((2, 64)).astype(np.float32)
    key = jax.random.key(7)
    noise = torch.from_numpy(np.array(jax.random.uniform(key, (2, 4))))
    monkeypatch.setattr(tclip, "random_masking",
                        lambda gen, t, r: tclip.masking_from_noise(t, noise, r))
    ref = jclip.get_visual_composed_features(params, JCFG, jnp.asarray(tf), jnp.asarray(x),
                                             jc, key, mask_ratio=0.75)
    out = tclip.get_visual_composed_features(tparams, TCFG, torch.from_numpy(tf),
                                             torch.from_numpy(x), tc, None, 0.75)
    _close(out, ref)


def _star_text(rows):
    text = np.zeros((len(rows), 77), np.int64)
    for i, body in enumerate(rows):
        text[i, :len(body)] = body
    return text


def test_encode_text_img_vis_matches_jax():
    (params, _, _), (tparams, _, _) = _models()
    rng = np.random.default_rng(8)
    one = _star_text([[SOT, 320] + [1125] * i + [SPLIT_ID, 267, EOT] for i in range(3)])
    tok = rng.standard_normal((3, 64)).astype(np.float32)
    _close(tclip.encode_text_img_vis(tparams, TCFG, torch.from_numpy(one),
                                     torch.from_numpy(tok), SPLIT_ID),
           jclip.encode_text_img_vis(params, JCFG, jnp.asarray(one), jnp.asarray(tok),
                                     SPLIT_ID))
    two = _star_text([[SOT, SPLIT_ID, 320, SPLIT_ID, EOT],
                      [SOT, 320, SPLIT_ID, 1125, 539, SPLIT_ID, 267, EOT]])
    toks = tuple(rng.standard_normal((2, 64)).astype(np.float32) for _ in range(2))
    _close(tclip.encode_text_img_vis(tparams, TCFG, torch.from_numpy(two),
                                     tuple(map(torch.from_numpy, toks)), SPLIT_ID),
           jclip.encode_text_img_vis(params, JCFG, jnp.asarray(two),
                                     tuple(map(jnp.asarray, toks)), SPLIT_ID))


def test_encode_text_img_vis_refuses_a_row_short_of_stars_as_jax():
    (params, _, _), (tparams, _, _) = _models()
    text = _star_text([[SOT, SPLIT_ID, SPLIT_ID, EOT], [SOT, SPLIT_ID, EOT]])
    tok = np.ones((2, 64), np.float32)
    with pytest.raises(ValueError) as want:
        jclip.encode_text_img_vis(params, JCFG, jnp.asarray(text),
                                  (jnp.asarray(tok), jnp.asarray(tok)), SPLIT_ID)
    with pytest.raises(ValueError) as got:
        tclip.encode_text_img_vis(tparams, TCFG, torch.from_numpy(text),
                                  (torch.from_numpy(tok), torch.from_numpy(tok)), SPLIT_ID)
    assert str(got.value) == str(want.value)
    assert "row 1 has 1 '*' placeholder(s) but 2 image tokens" in str(got.value)


def test_get_text_mid_cross_feature_matches_jax():
    """Row 0's EOT position is the splice point of every row, as in JAX."""
    (params, _, text_cross), (tparams, _, ttext_cross) = _models()
    text = _star_text([[SOT, 320, 1125, EOT], [SOT, 320, 1125, 539, 267, EOT]])
    img_tokens = np.random.default_rng(9).standard_normal((2, 5, 64)).astype(np.float32)
    ref = jclip.get_text_mid_cross_feature(params, JCFG, jnp.asarray(text),
                                           jnp.asarray(img_tokens), text_cross,
                                           jheads.crossformer_apply)
    out = tclip.get_text_mid_cross_feature(tparams, TCFG, torch.from_numpy(text),
                                           torch.from_numpy(img_tokens), ttext_cross,
                                           theads.crossformer_apply)
    assert out.shape == (2, 64)
    _close(out, ref)


def test_clip_forward_matches_jax():
    (params, _, _), (tparams, _, _) = _models()
    x = _images(2, 10)
    text = _star_text([[SOT, 320, 1125, EOT], [SOT, 539, EOT]])
    img, txt, scale = tclip.clip_forward(tparams, TCFG, torch.from_numpy(x),
                                         torch.from_numpy(text))
    jimg, jtxt, jscale = jclip.clip_forward(params, JCFG, jnp.asarray(x), jnp.asarray(text))
    _close(img, jimg)
    _close(txt, jtxt)
    assert scale.shape == () and float(scale) == pytest.approx(float(jscale), rel=1e-6)
    _close(tclip.clip_forward(tparams, TCFG, torch.from_numpy(x), None),
           jclip.clip_forward(params, JCFG, jnp.asarray(x), None))
    _close(tclip.clip_forward(tparams, TCFG, None, torch.from_numpy(text)),
           jclip.clip_forward(params, JCFG, None, jnp.asarray(text)))
