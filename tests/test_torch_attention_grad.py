"""Port attention gradients (CPU) vs the JAX op's custom_vjp: the Pallas
kernel in interpret mode, whose backward is the VJP of the plain reference;
and pseudo-token gradients through a tiny text tower vs jax.grad."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from keds_tpu.models import clip as jclip
from keds_tpu.ops.attention import attention_reference as jax_reference
from keds_tpu.ops.attention import flash_attention

from keds_tpu_torch.models import clip as tclip
from keds_tpu_torch.ops.attention import attention, attention_backward

from torch_port_helpers import D, JCFG, TCFG, jax_models, port_models

torch.set_num_threads(1)
TOL = 1e-5   # f32 on both sides; sums in another order


@pytest.mark.parametrize("shape", [(0, 2, 5, 64), (2, 0, 5, 64), (0, 1, 8, 32)])
@pytest.mark.parametrize("causal", [False, True])
def test_attention_grad_empty_batch_matches_jax_vjp(shape, causal):
    """B = 0 or H = 0: empty gradients of the inputs' shape and dtype, as
    the VJP of keds_tpu's attention_reference gives, through autograd and
    through attention_backward."""
    q = np.zeros(shape, np.float32)
    _, vjp = jax.vjp(lambda a, b, c: jax_reference(a, b, c, causal),
                     *(jnp.asarray(q),) * 3)
    ref = [np.asarray(t) for t in vjp(jnp.asarray(q))]
    tq, tk, tv = (torch.from_numpy(q.copy()).requires_grad_(True) for _ in range(3))
    grads = torch.autograd.grad(attention(tq, tk, tv, causal), (tq, tk, tv),
                                torch.from_numpy(q), allow_unused=True)
    plain = attention_backward(*(torch.from_numpy(q),) * 4, causal)
    for got, pl, want in zip(grads, plain, ref):
        for t in (got, pl):
            assert t is not None and t.shape == want.shape == shape
            assert t.numpy().dtype == want.dtype


@pytest.mark.parametrize("s", [1, 5, 8, 33, 77])
@pytest.mark.parametrize("causal", [False, True])
def test_attention_grad_matches_jax_vjp(s, causal):
    rng = np.random.default_rng(s)
    B, H, Dh = 2, 2, 64
    q, k, v, g = (rng.standard_normal((B, H, s, Dh)).astype(np.float32) for _ in range(4))
    _, vjp = jax.vjp(lambda a, b, c: flash_attention(a, b, c, causal, True),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    ref = [np.asarray(t) for t in vjp(jnp.asarray(g))]
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    grads = torch.autograd.grad(attention(tq, tk, tv, causal), (tq, tk, tv),
                                torch.from_numpy(g))
    plain = attention_backward(*(torch.from_numpy(a) for a in (q, k, v, g)), causal)
    for got, pl, want in zip(grads, plain, ref):
        np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)
        np.testing.assert_allclose(pl.numpy(), want, atol=TOL, rtol=TOL)


def test_pseudo_token_grads_through_text_tower_match_jax():
    """encode_text_img over the S=8 image-stream prompt: the gradient of a
    weighted sum of the pooled features w.r.t. the spliced pseudo-tokens,
    through a 2-layer causal tower whose parameters take no gradient."""
    params, heads = jax_models()
    tparams = port_models(params, heads)[0]
    rng = np.random.default_rng(0)
    text = np.zeros((4, 8), np.int32)
    text[:, :5] = [49406, 320, 1125, 539, 49407]
    tok = rng.standard_normal((4, 3, D)).astype(np.float32)
    w = rng.standard_normal((4, D)).astype(np.float32)

    def jloss(t):
        return jnp.sum(jclip.encode_text_img(params, JCFG, jnp.asarray(text), t) * w)

    ref = np.asarray(jax.grad(jloss)(jnp.asarray(tok)))
    t = torch.from_numpy(tok).requires_grad_(True)
    out = tclip.encode_text_img(tparams, TCFG, torch.from_numpy(text), t)
    (out * torch.from_numpy(w)).sum().backward()
    assert not any(p.requires_grad for p in tparams["text"]["blocks"].values())
    assert np.abs(ref).max() > 0
    np.testing.assert_allclose(t.grad.numpy(), ref, atol=TOL, rtol=1e-4)


# bf16: the JAX VJP (of attention_reference on bf16 arrays) rounds q * scale,
# the probabilities' cotangent and the gradients' products to bf16 where the
# port's (autograd through its plain version) keeps f32 until the gradients
# round to bf16: a few bf16 steps of an O(1) gradient apart (at most 0.0157
# on these inputs).  The card tests' bf16 backward tolerance.
BF16_GRAD_TOL = (3e-2, 2e-2)    # (atol, rtol)


@pytest.mark.parametrize("dh", [64, 80, 128, 160, 256])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("s", [8, 37])
@pytest.mark.parametrize("causal", [False, True])
def test_attention_grad_every_head_width_matches_jax_vjp(dh, dtype, s, causal):
    """The VJP at Dh off 64 (the card's wide-head routes above 64), f32 and
    bf16: autograd through the port's attention and its attention_backward
    against jax.vjp of flash_attention in interpret mode."""
    rng = np.random.default_rng(dh * s)
    arrays = [rng.standard_normal((1, 2, s, dh)).astype(np.float32) for _ in range(4)]
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16,
                                                                     torch.bfloat16)
    jq, jk, jv, jg = (jnp.asarray(a, jdt) for a in arrays)
    _, vjp = jax.vjp(lambda a, b, c: flash_attention(a, b, c, causal, True), jq, jk, jv)
    ref = [np.asarray(t.astype(jnp.float32)) for t in vjp(jg)]
    tq, tk, tv, tg = (torch.from_numpy(np.array(a.astype(jnp.float32))).to(tdt)
                      for a in (jq, jk, jv, jg))
    leaves = [t.clone().requires_grad_(True) for t in (tq, tk, tv)]
    grads = torch.autograd.grad(attention(*leaves, causal), leaves, tg)
    plain = attention_backward(tq, tk, tv, tg, causal)
    atol, rtol = (TOL, TOL) if dtype == "f32" else BF16_GRAD_TOL
    for got, pl, want in zip(grads, plain, ref):
        assert got.dtype == tdt and torch.equal(got, pl)
        np.testing.assert_allclose(got.float().numpy(), want, atol=atol, rtol=rtol)
