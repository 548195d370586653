"""Port attention (plain version, CPU) vs the JAX Pallas kernel in
interpret mode and the JAX plain reference."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from keds_tpu.ops.attention import attention_reference as jax_reference
from keds_tpu.ops.attention import flash_attention

from keds_tpu_torch.ops.attention import attention, attention_reference, bwd_plan

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


@pytest.mark.parametrize("bh", [1, 3, 4, 5, 15, 1536])
def test_backward_plan_fits_and_covers_every_slice(bh):
    """The bf16 backward kernel's launch plan at every S it takes: a block
    fits the H100's 227 KB of shared memory, has a warp per 16-row tile (or
    per slice at S <= 16), and the blocks' slices cover each (batch, head)
    exactly once."""
    for s in range(1, 1100):
        p = bwd_plan(s)
        assert (p.key_tiles - 1) * 16 < s <= p.key_tiles * 16
        assert p.smem_bytes <= 227 * 1024
        if s > 128:     # the streamed launches: blocks of 64 rows, a warp per 16,
            # a three-stage ring, a workspace row per query row of the warps
            assert (p.slices, p.warps, p.smem_bytes) == (1, 4, 70_936)
            assert p.workspace_rows == 16 * p.key_tiles
            assert 3 * (p.smem_bytes + 1024) <= 228 * 1024
            continue
        assert p.workspace_rows == 0
        assert p.warps == (p.slices if p.key_tiles == 1 else p.key_tiles)
        slices = [blk * p.slices + w for blk in range(p.blocks(bh)) for w in range(p.slices)]
        assert sorted(x for x in slices if x < bh) == list(range(bh))
        assert len(slices) - bh < p.slices
    assert bwd_plan(77).smem_bytes == 47_040 and bwd_plan(128).smem_bytes == 75_264


def test_backward_plan_f32_fits_every_sequence():
    """The f32 backward kernel's launch plan at every S: a warp per 16-row
    tile, at most four a block and as many as make a (batch, head)'s blocks
    even; one launch and no workspace at S <= 64, else a workspace row per
    query row; and shared memory that lets two blocks share an SM (the split
    launches of small grids aside)."""
    for s in range(1, 1100):
        p = bwd_plan(s, torch.float32)
        assert (p.key_tiles - 1) * 16 < s <= p.key_tiles * 16
        assert p.slices == 1 and 1 <= p.warps <= 4
        blocks = -(-p.key_tiles // p.warps)
        assert (blocks - 1) * p.warps < p.key_tiles and blocks == -(-p.key_tiles // 4)
        assert 2 * (p.smem_bytes + 1024) <= 228 * 1024
        assert p.workspace_rows == (0 if s <= 64 else 16 * p.key_tiles)
    assert bwd_plan(64, torch.float32).smem_bytes == 70_400
    assert bwd_plan(577, torch.float32).smem_bytes == 105_984
