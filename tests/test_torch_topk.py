"""Port exact top-k (plain version, CPU) vs the JAX Pallas kernel in
interpret mode and the JAX XLA search, including exact ties; the kernel's
split plan at the main-path shapes."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from keds_tpu.ops.pallas_topk import mips_topk_pallas
from keds_tpu.ops.topk import mips_topk as jax_mips_topk

from keds_tpu_torch.ops import topk as topk_mod
from keds_tpu_torch.ops.topk import mips_topk

torch.set_num_threads(1)


@pytest.mark.parametrize("n,b,k", [(1000, 7, 16), (3001, 33, 10), (517, 33, 16)])
def test_topk_matches_jax(n, b, k):
    rng = np.random.default_rng(n)
    db = rng.standard_normal((n, 64)).astype(np.float32)
    q = rng.standard_normal((b, 64)).astype(np.float32)
    pv, pi = mips_topk_pallas(jnp.asarray(q), jnp.asarray(db), k,
                              block_q=32, block_n=256, interpret=True)
    xv, xi = jax_mips_topk(jnp.asarray(q), jnp.asarray(db), k)
    vals, idx = mips_topk(torch.from_numpy(q), torch.from_numpy(db), k)
    assert vals.dtype == torch.float32 and idx.dtype == torch.int32
    for rv, ri in ((pv, pi), (xv, xi)):
        np.testing.assert_allclose(vals.numpy(), np.asarray(rv), atol=1e-5, rtol=1e-5)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(ri))


def test_topk_ties_go_to_lower_index():
    rng = np.random.default_rng(7)
    base = rng.standard_normal((40, 64)).astype(np.float32)
    db = np.concatenate([base, base, base[:13]])      # every row duplicated
    q = rng.standard_normal((5, 64)).astype(np.float32)
    pv, pi = mips_topk_pallas(jnp.asarray(q), jnp.asarray(db), 16,
                              block_q=16, block_n=32, interpret=True)
    vals, idx = mips_topk(torch.from_numpy(q), torch.from_numpy(db), 16)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(pi))
    np.testing.assert_allclose(vals.numpy(), np.asarray(pv), atol=1e-5, rtol=1e-5)
    # tied pairs appear lower index first
    i = idx.numpy()
    for row in i:
        for a, b_ in zip(row[:-1], row[1:]):
            if a % 40 == b_ % 40 and a < 93 and b_ < 93:
                assert a < b_


def test_topk_rejects_k_above_n():
    with pytest.raises(ValueError, match="k <= N"):
        mips_topk(torch.zeros(2, 32), torch.zeros(5, 32), 6)


# split_plan needs no library and no card: its tiles mirror csrc/topk.cu.
H100_SMS = 132


@pytest.mark.parametrize("b,n,dtype", [(64, 500_000, torch.bfloat16),    # retrieval
                                       (256, 500_000, torch.bfloat16),
                                       (1, 1, torch.bfloat16),
                                       (64, 256, torch.float32),           # ranking
                                       (64, 10_000, torch.float32),
                                       (130, 129, torch.float32)])
def test_split_plan_fills_the_card(b, n, dtype):
    tiling, n_splits = topk_mod.split_plan(b, n, H100_SMS, dtype)
    n_chunks = -(-n // tiling.chunk_rows)
    blocks = -(-b // tiling.query_tile) * n_splits
    assert tiling.variant == ("bf16_tc" if dtype == torch.bfloat16 else "f32")
    assert 1 <= n_splits <= n_chunks                     # no empty slice
    if n_chunks >= H100_SMS:
        assert blocks >= tiling.blocks_per_sm * H100_SMS


def test_split_plan_main_path_shapes():
    tiling, n_splits = topk_mod.split_plan(64, 500_000, H100_SMS, torch.bfloat16)
    assert tiling is topk_mod.TC and n_splits == topk_mod.TC.blocks_per_sm * H100_SMS
    # the 256-row ranking spreads over tens of blocks, not the two of 64x128 tiles
    tiling, n_splits = topk_mod.split_plan(64, 256, H100_SMS, torch.float32)
    assert tiling is topk_mod.F32_SMALL and 4 * n_splits == 32


@pytest.mark.parametrize("b,n,k,dtype", [(4181, 2297, 101, torch.float32),    # CIRR ranking
                                         (2048, 4096, 100, torch.float32),
                                         (1024, 10_000, 200, torch.float32),
                                         (64, 500_000, 64, torch.bfloat16),
                                         (5, 33, 33, torch.bfloat16)])
def test_split_plan_wide_k(b, n, k, dtype):
    """Above k = 32 both dtypes take the 32-query CUDA-core tiling, counted
    as f32 or bf16; slices stay non-empty."""
    tiling, n_splits = topk_mod.split_plan(b, n, H100_SMS, dtype, k)
    assert tiling is (topk_mod.BF16_WIDE if dtype == torch.bfloat16 else topk_mod.F32_WIDE)
    assert tiling.variant == ("bf16" if dtype == torch.bfloat16 else "f32")
    assert 1 <= n_splits <= -(-n // tiling.chunk_rows)
    assert topk_mod.split_plan(b, n, H100_SMS, dtype, 32)[0] in (topk_mod.TC, topk_mod.F32,
                                                                topk_mod.F32_SMALL)
