"""Port exact top-k (plain version, CPU) vs the JAX Pallas kernel in
interpret mode and the JAX XLA search, including exact ties and k up to N;
the kernels' plan at the main-path shapes and their (score, row) key
order."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from keds_tpu.ops import topk as jtopk
from keds_tpu.ops.pallas_topk import mips_topk_pallas
from keds_tpu.ops.topk import mips_topk as jax_mips_topk

from keds_tpu_torch.ops import topk as topk_mod
from keds_tpu_torch.ops.topk import mips_topk

torch.set_num_threads(1)


# k above 32 (101, 300 and N): the Pallas kernel's lax.top_k merge (its
# k-round argmax would unroll k rounds), with tiles of at least k rows.
@pytest.mark.parametrize("n,b,k,block_n,lax_topk", [(1000, 7, 16, 256, False),
                                                    (3001, 33, 10, 256, False),
                                                    (517, 33, 16, 256, False),
                                                    (1000, 7, 101, 256, True),
                                                    (3001, 33, 300, 512, True),
                                                    (517, 9, 517, 1024, True)])
def test_topk_matches_jax(n, b, k, block_n, lax_topk):
    rng = np.random.default_rng(n)
    db = rng.standard_normal((n, 64)).astype(np.float32)
    q = rng.standard_normal((b, 64)).astype(np.float32)
    pv, pi = mips_topk_pallas(jnp.asarray(q), jnp.asarray(db), k, block_q=32,
                              block_n=block_n, interpret=True, use_lax_topk=lax_topk)
    xv, xi = jax_mips_topk(jnp.asarray(q), jnp.asarray(db), k)
    vals, idx = mips_topk(torch.from_numpy(q), torch.from_numpy(db), k)
    assert vals.dtype == torch.float32 and idx.dtype == torch.int32
    for rv, ri in ((pv, pi), (xv, xi)):
        np.testing.assert_allclose(vals.numpy(), np.asarray(rv), atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(pi))
    # XLA's product rounds otherwise than the Pallas tiles': at large k two
    # entries within rounding of each other may swap, nowhere else
    sep = np.ones(idx.shape, bool)
    gaps = np.abs(np.diff(np.asarray(xv), axis=1)) > 1e-5
    sep[:, 1:] &= gaps
    sep[:, :-1] &= gaps
    np.testing.assert_array_equal(idx.numpy()[sep], np.asarray(xi)[sep])
    if k <= 32:
        np.testing.assert_array_equal(idx.numpy(), np.asarray(xi))


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


@pytest.mark.parametrize("k", [101, 300, 413])
def test_topk_ties_go_to_lower_index_at_large_k(k):
    """Every row duplicated, k at 101, 300 and N = 413: the Pallas kernel's
    order, tied pairs lower index first."""
    rng = np.random.default_rng(k)
    base = rng.standard_normal((200, 64)).astype(np.float32)
    db = np.concatenate([base, base, base[:13]])
    q = rng.standard_normal((5, 64)).astype(np.float32)
    pv, pi = mips_topk_pallas(jnp.asarray(q), jnp.asarray(db), k, block_q=16,
                              block_n=512, interpret=True, use_lax_topk=True)
    vals, idx = mips_topk(torch.from_numpy(q), torch.from_numpy(db), k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(pi))
    np.testing.assert_allclose(vals.numpy(), np.asarray(pv), atol=1e-5, rtol=1e-5)
    i = idx.numpy()
    for row in i:
        for a, b_ in zip(row[:-1], row[1:]):
            if a % 200 == b_ % 200 and a < 400 and b_ < 400:
                assert a < b_


def test_topk_rejects_k_above_n():
    with pytest.raises(ValueError, match="k <= N"):
        mips_topk(torch.zeros(2, 32), torch.zeros(5, 32), 6)


def _searches(k):
    """(name, JAX search, port search) of every backend at k: exact,
    int8 with the true rows, the dequantized rows and no re-rank, and
    approx."""
    int8 = [(f"int8_{tag}", kw) for tag, kw in (("true", {"db": True}), ("deq", {}),
                                                 ("stage1", {"oversample": 1}))]
    out = [("exact", lambda q, d: jtopk.mips_topk(q, d, k),
            lambda q, d: mips_topk(q, d, k)),
           ("approx", lambda q, d: jtopk.mips_topk_approx(q, d, k),
            lambda q, d: topk_mod.mips_topk_approx(q, d, k))]
    for name, kw in int8:
        def jax_fn(q, d, kw=kw):
            extra = dict(kw, db=d) if "db" in kw else kw
            return jtopk.mips_topk_int8(q, *jtopk.quantize_int8(d), k, **extra)

        def port_fn(q, d, kw=kw):
            extra = dict(kw, db=d) if "db" in kw else kw
            return topk_mod.mips_topk_int8(q, *topk_mod.quantize_int8(d), k, **extra)
        out.append((name, jax_fn, port_fn))
    return out


@pytest.mark.parametrize("b,k", [(3, 0), (0, 4), (0, 0), (0, 9)])
def test_topk_empty_matches_jax(b, k):
    """k = 0 (the serve CLI's --topn 0) and no query, as keds_tpu answers
    them: (B, k) f32 values and int32 indices from the exact, int8 and
    approx searches; approx refuses k = 0 as lax.approx_max_k does."""
    rng = np.random.default_rng(b * 10 + k)
    q = rng.standard_normal((b, 16)).astype(np.float32)
    db = rng.standard_normal((9, 16)).astype(np.float32)
    for name, jax_fn, port_fn in _searches(k):
        if name == "approx" and k == 0:
            with pytest.raises(ValueError):
                jax_fn(jnp.asarray(q), jnp.asarray(db))
            with pytest.raises(ValueError, match="k >= 1"):
                port_fn(torch.from_numpy(q), torch.from_numpy(db))
            continue
        jv, ji = (np.asarray(t) for t in jax_fn(jnp.asarray(q), jnp.asarray(db)))
        pv, pi = (t.numpy() for t in port_fn(torch.from_numpy(q), torch.from_numpy(db)))
        assert pv.shape == pi.shape == jv.shape == ji.shape == (b, k), name
        assert (pv.dtype, pi.dtype) == (jv.dtype, ji.dtype) == (np.float32, np.int32), name
        np.testing.assert_array_equal(pi, ji)
        np.testing.assert_array_equal(pv, jv)


@pytest.mark.parametrize("tiling", topk_mod.TILINGS, ids=lambda t: f"code{t.code}")
@pytest.mark.parametrize("b,k", [(4, 0), (0, 4), (0, 0)])
def test_topk_kernel_wrapper_launches_nothing_when_empty(monkeypatch, tiling, b, k):
    """The card wrapper at k = 0 or B = 0: empty (B, k) results, with no
    launch, no pad and no library, through every tiling (D = 100 is off
    every depth step)."""
    def no_library():
        raise AssertionError("an empty search must not reach the library")

    monkeypatch.setattr(topk_mod.KERNEL, "lib", no_library)
    monkeypatch.setattr(topk_mod, "require_cuda", lambda *t: None)
    monkeypatch.setattr(topk_mod, "sm_count", lambda t: H100_SMS)
    dtype = torch.bfloat16 if tiling.variant.startswith("bf16") else torch.float32
    q, db = torch.zeros((b, 100), dtype=dtype), torch.zeros((50, 100), dtype=dtype)
    launches, grid, pads = (dict(c) for c in (topk_mod.KERNEL.launches, topk_mod.GRID_LAUNCHES,
                                               topk_mod.KERNEL.pads))
    for vals, idx in (topk_mod.launch(q, db, k, tiling, 1), topk_mod.mips_topk(q, db, k)):
        assert vals.shape == idx.shape == (b, k)
        assert (vals.dtype, idx.dtype) == (torch.float32, torch.int32)
    assert topk_mod.KERNEL.launches == launches and topk_mod.GRID_LAUNCHES == grid
    assert topk_mod.KERNEL.pads == pads


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
@pytest.mark.parametrize("k", [0, 16, 33])
@pytest.mark.parametrize("n", [256, 500_000])
def test_split_plan_takes_no_queries(dtype, k, n):
    """No query divides by nothing: the plan is one query's."""
    assert topk_mod.split_plan(0, n, H100_SMS, dtype, k, 768) == \
        topk_mod.split_plan(1, n, H100_SMS, dtype, k, 768)


# split_plan needs no library and no card: its tiles mirror csrc/topk.cu.
H100_SMS = 132


@pytest.mark.parametrize("b,n,dtype", [(64, 500_000, torch.bfloat16),    # retrieval
                                       (256, 500_000, torch.bfloat16),
                                       (1, 1, torch.bfloat16),
                                       (64, 256, torch.float32),           # ranking
                                       (64, 10_000, torch.float32),
                                       (130, 129, torch.float32)])
def test_split_plan_fills_the_card(b, n, dtype):
    """TC splits the database into one slice an SM for each query tile (no
    slice empty); the score routes fill the card with their tiles, and cut
    rows longer than SEGMENT_ROWS into segments."""
    tiling, n_splits = topk_mod.split_plan(b, n, H100_SMS, dtype)
    assert tiling.variant == ("bf16_tc" if dtype == torch.bfloat16 else "f32")
    if tiling is topk_mod.TC:
        n_chunks = -(-n // tiling.chunk_rows)
        blocks = -(-b // tiling.query_tile) * n_splits
        assert 1 <= n_splits <= n_chunks
        if n_chunks >= H100_SMS:
            assert blocks >= H100_SMS
    else:
        assert n_splits == -(-n // topk_mod.SEGMENT_ROWS)
        if tiling is topk_mod.F32:
            assert -(-b // 128) * -(-n // 128) >= 2 * H100_SMS


def test_split_plan_main_path_shapes():
    tiling, n_splits = topk_mod.split_plan(64, 500_000, H100_SMS, torch.bfloat16)
    assert tiling is topk_mod.TC and n_splits == H100_SMS
    # the 256-row ranking: score and select in one launch
    assert topk_mod.split_plan(64, 256, H100_SMS, torch.float32) == (topk_mod.F32_FUSED, 1)
    # the CIRR ranking: 128 x 128 tiles (594 blocks), one segment
    assert topk_mod.split_plan(4181, 2297, H100_SMS, torch.float32, 101) == (topk_mod.F32, 1)
    # serve --topn 300 over 4096 images: 64 x 64 tiles, the big ones would be 32
    assert topk_mod.split_plan(64, 4096, H100_SMS, torch.float32, 300) == (topk_mod.F32_MID, 1)


@pytest.mark.parametrize("b,n,k,dtype", [(4181, 2297, 101, torch.float32),    # CIRR ranking
                                         (2048, 4096, 100, torch.float32),
                                         (1024, 10_000, 200, torch.float32),
                                         (64, 500_000, 64, torch.bfloat16),
                                         (5, 33, 33, torch.bfloat16)])
def test_split_plan_wide_k(b, n, k, dtype):
    """Above k = 32 bf16 takes the BF16 score route, counted as bf16; f32
    takes the same route at every k; segments follow N alone, none empty."""
    tiling, n_splits = topk_mod.split_plan(b, n, H100_SMS, dtype, k)
    assert tiling.variant == ("bf16" if dtype == torch.bfloat16 else "f32")
    assert tiling is not topk_mod.TC
    assert n_splits == -(-n // topk_mod.SEGMENT_ROWS)
    assert (n_splits - 1) * -(-n // n_splits) < n                       # no empty segment
    for kk in (1, 32, 300, n):
        if kk <= n and not (dtype == torch.bfloat16 and kk <= topk_mod.LANE_K):
            assert topk_mod.split_plan(b, n, H100_SMS, dtype, kk) == (tiling, n_splits)
    assert topk_mod.split_plan(b, n, H100_SMS, dtype, 32)[0] in (
        topk_mod.TC, topk_mod.F32, topk_mod.F32_MID, topk_mod.F32_FUSED)


@pytest.mark.parametrize("b,n", [(1, 1024), (1024, 1024), (1025, 1024), (8, 1025)])
def test_split_plan_fused_bounds(b, n):
    """f32 scores and selects in one launch over at most FUSED_MAX_ROWS rows
    and FUSED_MAX_SCORES scores, whatever k."""
    fused = n <= topk_mod.FUSED_MAX_ROWS and b * n <= topk_mod.FUSED_MAX_SCORES
    for k in (1, 101, n):
        tiling, n_splits = topk_mod.split_plan(b, n, H100_SMS, torch.float32, k)
        assert (tiling is topk_mod.F32_FUSED) == fused and n_splits == 1


def test_entry_keys_order_as_the_plain_sort():
    """The kernels' 64-bit (score, row) keys, largest first, give the plain
    version's order: descending score, ties (-0.0 with +0.0 among them) to
    the lower row; -inf last."""
    scores = torch.tensor([[0.5, -0.0, 1.0, 0.0, -1.0, 0.5, -0.0, float("-inf"), -1e-30,
                            1e-30, 0.0, -1.0]])
    keys = topk_mod.entry_keys(scores)
    assert len(set(keys[0].tolist())) == scores.shape[1]            # no two keys equal
    order = torch.sort(keys, dim=1, descending=True).indices
    want = torch.sort(scores, dim=1, descending=True, stable=True).indices
    assert order.tolist() == want.tolist()
    assert order.tolist()[0] == [2, 0, 5, 9, 1, 3, 6, 10, 8, 4, 11, 7]
