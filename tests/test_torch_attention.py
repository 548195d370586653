"""Port attention (plain version, CPU) vs the JAX Pallas kernel in
interpret mode and the JAX plain reference."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from keds_tpu.ops.attention import attention_reference as jax_reference
from keds_tpu.ops.attention import flash_attention

from keds_tpu_torch.ops import attention as att_mod
from keds_tpu_torch.ops.attention import attention, attention_reference

torch.set_num_threads(1)


@pytest.mark.parametrize("s", [10, 60, 77, 257, 1, 32])
@pytest.mark.parametrize("causal", [False, True])
def test_attention_matches_jax(s, causal):
    rng = np.random.default_rng(s)
    B, H, Dh = 2, 2, 64
    q, k, v = (rng.standard_normal((B, H, s, Dh)).astype(np.float32) for _ in range(3))
    ref_kernel = np.asarray(flash_attention(jnp.asarray(q), jnp.asarray(k),
                                            jnp.asarray(v), causal, True))
    ref_plain = np.asarray(jax_reference(jnp.asarray(q), jnp.asarray(k),
                                         jnp.asarray(v), causal))
    out = attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                    causal).numpy()
    np.testing.assert_allclose(out, ref_kernel, atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(out, ref_plain, atol=2e-5, rtol=2e-5)


def test_attention_takes_strided_qkv_views():
    """The towers pass strided (B, S, H, Dh) views of the fused projection."""
    rng = np.random.default_rng(0)
    B, S, H, Dh = 2, 17, 3, 64
    qkv = torch.from_numpy(rng.standard_normal((B, S, 3, H, Dh)).astype(np.float32))
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    out = attention(q, k, v, True)
    ref = attention_reference(q.contiguous(), k.contiguous(), v.contiguous(), True)
    torch.testing.assert_close(out, ref, atol=0, rtol=0)


def test_attention_bf16_rounds_probs_to_v_dtype():
    rng = np.random.default_rng(1)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 2, 33, 64)).astype(np.float32))
               .to(torch.bfloat16) for _ in range(3))
    out = attention(q, k, v, False)
    assert out.dtype == torch.bfloat16
    ref = np.asarray(flash_attention(*(jnp.asarray(t.float().numpy(), jnp.bfloat16)
                                       for t in (q, k, v)), False, True), np.float32)
    np.testing.assert_allclose(out.float().numpy(), ref, atol=2e-2, rtol=2e-2)


# Every head width the port routes apart on the card (64: the tuned kernels;
# above it the wide-head kernels, 128 columns a chunk in bf16, 64 in f32),
# in f32 and bf16; 256: the f32 wide-head kernels' timed rows.
WIDE_HEAD_WIDTHS = [64, 80, 128, 160, 256]
# bf16: the two round P to bf16 after f32 sums taken in another order, so a
# probability may round the other way (one bf16 step of P), and the output
# rounds to bf16 (a step of 2^-8 relative)
BF16_TOL = 2e-2


@pytest.mark.parametrize("dh", WIDE_HEAD_WIDTHS)
@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"], ids=["f32", "bf16"])
@pytest.mark.parametrize("s", [8, 37])
@pytest.mark.parametrize("causal", [False, True])
def test_attention_every_head_width_matches_jax(dh, dtype, s, causal):
    """The port's plain attention at Dh off 64 against flash_attention in
    interpret mode (f32: and the JAX plain reference), on the same inputs."""
    rng = np.random.default_rng(dh + s)
    q, k, v = (rng.standard_normal((1, 2, s, dh)).astype(np.float32) for _ in range(3))
    if dtype == "bfloat16":
        jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
        tq, tk, tv = (torch.from_numpy(np.array(a.astype(jnp.float32))).to(torch.bfloat16)
                      for a in (jq, jk, jv))
        want = np.asarray(flash_attention(jq, jk, jv, causal, True).astype(jnp.float32))
        out = attention(tq, tk, tv, causal)
        assert out.dtype == torch.bfloat16
        np.testing.assert_allclose(out.float().numpy(), want, atol=BF16_TOL, rtol=BF16_TOL)
        return
    want = np.asarray(flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal,
                                      True))
    plain = np.asarray(jax_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal))
    out = attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                    causal).numpy()
    np.testing.assert_allclose(out, want, atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(out, plain, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("shape", [(0, 2, 5, 64), (2, 0, 5, 64), (0, 0, 1, 24)])
@pytest.mark.parametrize("causal", [False, True])
def test_attention_empty_batch_matches_jax(shape, causal):
    """B = 0 or H = 0: an empty result of the inputs' shape and dtype, as
    keds_tpu's attention_reference (its default attention) gives."""
    q = np.zeros(shape, np.float32)
    want = np.asarray(jax_reference(jnp.asarray(q), jnp.asarray(q), jnp.asarray(q), causal))
    got = attention(*(torch.from_numpy(q),) * 3, causal).numpy()
    assert got.shape == want.shape == shape and got.dtype == want.dtype


@pytest.mark.parametrize("shape", [(0, 2, 5, 64), (2, 0, 5, 24), (0, 3, 300, 32),
                                   (0, 1, 9, 80)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_attention_kernel_wrapper_empty_batch_launches_nothing(monkeypatch, shape, dtype):
    """The card wrappers at B * H = 0 reach no library and count nothing:
    the forward's result is a (B, H, S, Dh) view of a (B, S, H, Dh) buffer,
    the backward's three gradients views of one (B, S, 3, H, Dh) buffer.
    S < 1 keeps its refusal."""
    def no_library():
        raise AssertionError("an empty batch must not reach the library")

    monkeypatch.setattr(att_mod, "require_cuda", lambda *t: None)
    monkeypatch.setattr(att_mod.KERNEL, "lib", no_library)
    monkeypatch.setattr(att_mod.BWD_KERNEL, "lib", no_library)
    counts = [dict(c) for c in (att_mod.KERNEL.launches, att_mod.KERNEL.pads,
                                att_mod.BWD_KERNEL.launches, att_mod.BWD_KERNEL.pads)]
    B, H, S, Dh = shape
    qkv = torch.zeros((B, S, 3, H, Dh), dtype=dtype)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    out = att_mod._forward_kernel(q, k, v, True)
    assert out.shape == shape and out.dtype == dtype
    assert out.stride() == torch.empty((B, S, H, Dh)).transpose(1, 2).stride()
    grads = att_mod._backward_kernel(q, k, v, out, True)
    buffer = torch.empty((B, S, 3, H, Dh))
    for i, g in enumerate(grads):
        want = buffer[:, :, i].transpose(1, 2)
        assert g.shape == shape and g.dtype == dtype
        assert g._base is grads[0]._base and g._base.shape == buffer.shape
        assert (g.stride(), g.storage_offset()) == (want.stride(), want.storage_offset())
    assert counts == [dict(c) for c in (att_mod.KERNEL.launches, att_mod.KERNEL.pads,
                                        att_mod.BWD_KERNEL.launches, att_mod.BWD_KERNEL.pads)]
    empty_s = torch.zeros((B, H, 0, Dh), dtype=dtype)
    with pytest.raises(ValueError, match="S >= 1"):
        att_mod._forward_kernel(empty_s, empty_s, empty_s, False)
    with pytest.raises(ValueError, match="S >= 1"):
        att_mod._backward_kernel(empty_s, empty_s, empty_s, empty_s, False)
