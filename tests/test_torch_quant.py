"""W8A8 int8 towers (ROADMAP item 15): ``keds_tpu_torch.ops.quant`` and the
quantized towers against ``keds_tpu.ops.quant`` on the CPU (f32).

The quantizers and one int8 linear agree bit for bit: the integer product is
exact in both packages and the dequantization is the same two f32 products.
Through a tower the activations entering each int8 product come from f32
sums taken in another order, and a value that sits at a rounding boundary of
its token's int8 grid rounds one step the other way there: TOWER_TOL holds
those steps (a step is 1/127 of a token's largest value, times a weight).
"""

import logging

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from keds_tpu.models import clip as jclip
from keds_tpu.models.convert import clip_state_dict_to_pytree
from keds_tpu.models.layers import linear as jlinear
from keds_tpu.ops import quant as jquant

from keds_tpu_torch.models import clip as tclip
from keds_tpu_torch.models.convert import (cast_floating, clip_from_state_dict,
                                           clip_to_state_dict)
from keds_tpu_torch.models.layers import _layer, _n_layers, linear, transformer
from keds_tpu_torch.ops import quant

from torch_port_helpers import (JCFG, TCFG, jax_models, port_models, prompt_tokens,
                                rn_state_dict)

torch.set_num_threads(1)
TOWER_TOL = 2e-3


def _w(shape, seed, scale=0.2):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


@pytest.mark.parametrize("shape", [(64, 32), (3, 48, 24)])
def test_quantize_weight_equals_jax(shape):
    w = _w(shape, 1)
    w[..., 3] = 0.0                      # an all-zero output channel: s = 1e-12
    wq, jwq = quant.quantize_weight(torch.from_numpy(w)), jquant.quantize_weight(jnp.asarray(w))
    assert wq["q"].dtype == torch.int8 and wq["s"].dtype == torch.float32
    assert wq["s"].shape == tuple(jwq["s"].shape) == shape[:-2] + (1, shape[-1])
    np.testing.assert_array_equal(wq["q"].numpy(), np.asarray(jwq["q"]))
    np.testing.assert_array_equal(wq["s"].numpy(), np.asarray(jwq["s"]))
    np.testing.assert_array_equal(quant.dequantize_weight(wq).numpy(),
                                  np.asarray(jquant.dequantize_weight(jwq)))
    assert quant.is_quantized(wq) and not quant.is_quantized(torch.from_numpy(w))
    # column-major int8 values: the layout cuBLASLt's int8 GEMM takes at every shape
    assert wq["q"].transpose(-1, -2).is_contiguous()


def test_quantize_activations_equals_jax():
    x = _w((2, 5, 64), 2, 3.0)
    x[0, 1] = 0.0
    q, s = quant.quantize_activations(torch.from_numpy(x))
    jq, js = jquant.quantize_activations(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_int8_linear_equals_jax(bias, dtype):
    x, w, b = _w((3, 7, 64), 3, 1.0), _w((64, 40), 4), _w((40,), 5)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    wq, jwq = quant.quantize_weight(torch.from_numpy(w)), jquant.quantize_weight(jnp.asarray(w))
    out = quant.int8_linear(torch.from_numpy(x).to(dtype), wq,
                            torch.from_numpy(b) if bias else None)
    ref = jquant.int8_linear(jnp.asarray(x, jdt), jwq, jnp.asarray(b) if bias else None)
    assert out.dtype == dtype and out.shape == (3, 7, 40)
    np.testing.assert_array_equal(out.float().numpy(), np.asarray(ref, np.float32))
    # within the int8 grids' error of the unquantized product (bf16 adds
    # its own rounding of the input and the output)
    limit = 0.05 if dtype == torch.float32 else 0.08
    assert np.abs(out.float().numpy() - (x @ w + (b if bias else 0))).max() < limit


def test_int8_matmul_plain_is_exact():
    rng = np.random.default_rng(0)
    a = rng.integers(-127, 128, (5, 1040)).astype(np.int8)
    b = rng.integers(-127, 128, (1040, 9)).astype(np.int8)
    out = quant.int8_matmul(torch.from_numpy(a), torch.from_numpy(b))
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), a.astype(np.int64) @ b.astype(np.int64))
    with pytest.raises(ValueError, match="int8 matrices"):
        quant.int8_matmul(torch.from_numpy(a).float(), torch.from_numpy(b))


def test_linear_dispatches_on_a_quantized_weight():
    x, w, b = _w((4, 64), 6, 1.0), _w((64, 32), 7), _w((32,), 8)
    tx, tw, tb = (torch.from_numpy(a) for a in (x, w, b))
    plain = linear(tx, tw, tb)
    np.testing.assert_allclose(plain.numpy(), np.asarray(jlinear(*map(jnp.asarray, (x, w, b)))),
                               atol=1e-5)
    wq = quant.quantize_weight(tw)
    np.testing.assert_array_equal(linear(tx, wq, tb).numpy(),
                                  quant.int8_linear(tx, wq, tb).numpy())
    np.testing.assert_array_equal(linear(tx, wq, tb).numpy(),
                                  np.asarray(jlinear(jnp.asarray(x), jquant.quantize_weight(
                                      jnp.asarray(w)), jnp.asarray(b))))


def test_stacked_quantized_blocks_slice_and_count_by_layer():
    params = port_models(*jax_models())[0]
    blocks = quant.quantize_clip_blocks(params)["visual"]["blocks"]
    assert _n_layers(blocks) == TCFG.vision_layers
    for i in range(_n_layers(blocks)):
        layer = _layer(blocks, i)
        assert layer["qkv_w"]["q"].shape == blocks["qkv_w"]["q"].shape[1:]
        assert torch.equal(layer["fc_w"]["s"], blocks["fc_w"]["s"][i])
        assert torch.equal(layer["ln1_g"], blocks["ln1_g"][i])
    x = torch.randn((2, 5, TCFG.vision_width), generator=torch.Generator().manual_seed(0))
    out = transformer(x, blocks, TCFG.vision_heads)
    assert out.shape == x.shape and torch.isfinite(out).all()


def test_quantize_clip_blocks_on_vit_equals_jax():
    jparams, jheads = jax_models()
    tparams = port_models(jparams, jheads)[0]
    tq, jq = quant.quantize_clip_blocks(tparams), jquant.quantize_clip_blocks(jparams)
    for tower in ("visual", "text"):
        for key, w in tq[tower]["blocks"].items():
            if key in ("qkv_w", "out_w", "fc_w", "proj_w"):
                for part in ("q", "s"):
                    np.testing.assert_array_equal(
                        w[part].numpy(), np.asarray(jq[tower]["blocks"][key][part]))
            else:
                assert w is tparams[tower]["blocks"][key]
    assert tq["visual"]["proj"] is tparams["visual"]["proj"]
    assert quant.maybe_quantize_clip(tparams, "none") is tparams
    with pytest.raises(ValueError, match="unknown --quant-towers mode"):
        quant.maybe_quantize_clip(tparams, "int4")


def test_quantize_clip_blocks_on_rn_skips_the_visual_tower(caplog):
    sd = rn_state_dict((1, 1, 1, 1), 8, 64)
    tparams, _ = clip_from_state_dict(sd, device="cpu")
    jparams, _ = clip_state_dict_to_pytree(sd)
    with caplog.at_level(logging.WARNING):
        tq = quant.quantize_clip_blocks(tparams)
    assert "leaving it unquantized" in caplog.text
    assert tq["visual"] is tparams["visual"]
    jq = jquant.quantize_clip_blocks(jax.tree.map(jnp.asarray, jparams))
    for key in ("qkv_w", "out_w", "fc_w", "proj_w"):
        np.testing.assert_array_equal(tq["text"]["blocks"][key]["q"].numpy(),
                                      np.asarray(jq["text"]["blocks"][key]["q"]))


def test_cast_floating_keeps_int8_weights_and_their_scales():
    tq = quant.quantize_clip_blocks(port_models(*jax_models())[0])
    cast = cast_floating(tq, torch.bfloat16, "cpu")
    w = cast["text"]["blocks"]["qkv_w"]
    assert w["q"].dtype == torch.int8 and w["s"].dtype == torch.float32
    assert cast["text"]["blocks"]["ln1_g"].dtype == torch.bfloat16


def test_a_quantized_tree_is_not_saved():
    tq = quant.quantize_clip_blocks(port_models(*jax_models())[0])
    with pytest.raises(ValueError, match="quantized"):
        clip_to_state_dict(tq, TCFG)


@pytest.mark.parametrize("tower", ["image", "text"])
def test_tiny_int8_towers_match_jax(tower):
    jparams, jheads = jax_models()
    tq = quant.quantize_clip_blocks(port_models(jparams, jheads)[0])
    jq = jquant.quantize_clip_blocks(jparams)
    if tower == "image":
        x = np.random.default_rng(0).standard_normal((3, 32, 32, 3)).astype(np.float32)
        out = tclip.encode_image(tq, TCFG, torch.from_numpy(x))
        ref = jclip.encode_image(jq, JCFG, jnp.asarray(x))
        unq = jclip.encode_image(jparams, JCFG, jnp.asarray(x))
    else:
        text = prompt_tokens(3, 14, seed=2)
        out = tclip.encode_text(tq, TCFG, torch.from_numpy(text))
        ref = jclip.encode_text(jq, JCFG, jnp.asarray(text))
        unq = jclip.encode_text(jparams, JCFG, jnp.asarray(text))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=TOWER_TOL, rtol=0)
    # and the int8 tower is close to, not equal to, the unquantized one
    diff = np.abs(out.numpy() - np.asarray(unq)).max()
    assert 0 < diff < 0.1 * np.abs(np.asarray(unq)).max()


def test_ste_gradient_equals_jax_grad():
    x, w, b = _w((4, 64), 9, 1.0), _w((64, 32), 10), _w((32,), 11)
    jwq = jquant.quantize_weight(jnp.asarray(w))
    jg = jax.grad(lambda x_, b_: jnp.sum(jnp.tanh(jquant.int8_linear(x_, jwq, b_))),
                  argnums=(0, 1))(jnp.asarray(x), jnp.asarray(b))
    tx = torch.from_numpy(x).requires_grad_(True)
    tb = torch.from_numpy(b).requires_grad_(True)
    wq = quant.quantize_weight(torch.from_numpy(w))
    torch.tanh(quant.int8_linear(tx, wq, tb)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jg[0]), atol=1e-5)
    np.testing.assert_allclose(tb.grad.numpy(), np.asarray(jg[1]), atol=1e-5)
    assert wq["q"].grad is None
