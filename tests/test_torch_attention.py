"""Port attention (plain version, CPU) vs the JAX Pallas kernel in
interpret mode and the JAX plain reference."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from keds_tpu.ops.attention import attention_reference as jax_reference
from keds_tpu.ops.attention import flash_attention

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
