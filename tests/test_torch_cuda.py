"""keds_tpu_torch's CUDA kernels against their plain PyTorch versions on the
card: tile edges, exact ties, the launch counters, the attention backward
(strided views, non-contiguous output gradients, every text-bucket length),
and a tiny composed query, text-tower gradient and train step on the card
vs the CPU.

These tests need a CUDA device and nvcc; elsewhere they skip.  They import
neither jax nor keds_tpu, so on a machine without JAX they run with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from keds_tpu_torch.ops import attention as att_mod, topk as topk_mod
from keds_tpu_torch.ops.attention import attention, attention_reference
from keds_tpu_torch.ops.topk import mips_topk, mips_topk_plain, split_plan

pytestmark = pytest.mark.cuda
torch.set_num_threads(1)

# Kernel vs plain version, both on the card.  f32: the same products summed
# in another order.  bf16: the output is rounded to bf16 (8 bits of
# mantissa) and a probability may round the other way.
ATT_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
TOPK_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-4}
VARIANT = {torch.float32: "f32", torch.bfloat16: "bf16_tc"}
WIDE_VARIANT = {torch.float32: "f32", torch.bfloat16: "bf16"}    # k > 32


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (and nvcc) to build and run the kernels")
    return torch.device("cuda")


def _gen(dev, seed):
    return torch.Generator(device=dev).manual_seed(seed)


def _qkv(dev, b, h, s, dtype, seed):
    """Strided q/k/v views of one (B, S, 3, H, Dh) buffer, as the towers pass them."""
    qkv = torch.randn((b, s, 3, h, 64), generator=_gen(dev, seed), device=dev).to(dtype)
    return tuple(qkv[:, :, i].transpose(1, 2) for i in range(3))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("s", [1, 15, 16, 17, 33, 63, 64, 65, 77, 197, 257, 288,
                               289, 320, 321, 384, 385, 577, 640, 641, 1025, 1089])
@pytest.mark.parametrize("causal", [False, True])
def test_attention_kernel_matches_plain(cuda, dtype, s, causal):
    B, H, Dh = 3, 5, 64        # B*H = 15: not a multiple of any tile
    q, k, v = _qkv(cuda, B, H, s, dtype, s)
    before = att_mod.KERNEL.launches[VARIANT[dtype]]
    out = attention(q, k, v, causal)
    torch.cuda.synchronize()
    assert att_mod.KERNEL.launches[VARIANT[dtype]] == before + 1
    assert out.shape == (B, H, s, Dh) and out.dtype == dtype
    ref = attention_reference(q, k, v, causal)
    torch.testing.assert_close(out.float(), ref.float(), atol=ATT_TOL[dtype], rtol=0)


@pytest.mark.parametrize("s", [289, 577, 1025])
@pytest.mark.parametrize("causal", [False, True])
def test_attention_streamed_near_one_hot_softmax(cuda, s, causal):
    """q scaled by 8: each row's softmax is nearly one-hot.  The streamed
    bf16 forward rounds each probability before normalising it (one pass),
    the plain version after; both are one bf16 rounding a probability."""
    qkv = torch.randn((2, s, 3, 6, 64), generator=_gen(cuda, s), device=cuda)
    qkv[:, :, 0] *= 8
    q, k, v = (qkv.to(torch.bfloat16)[:, :, i].transpose(1, 2) for i in range(3))
    out = attention(q, k, v, causal)
    torch.cuda.synchronize()
    ref = attention_reference(q, k, v, causal)
    torch.testing.assert_close(out.float(), ref.float(), atol=ATT_TOL[torch.bfloat16], rtol=0)


@pytest.mark.parametrize("b,h,s", [(7, 19, 577), (16, 16, 577), (4, 12, 1025)])
@pytest.mark.parametrize("causal", [False, True])
def test_attention_streams_partial_waves(cuda, b, h, s, causal):
    """The streamed bf16 forward at grids that leave the card's last wave
    partly empty (B*H = 133) and at the ViT-L/14 336 px and 1025-token
    shapes, where the launch takes 8 consumer warps a block."""
    q, k, v = _qkv(cuda, b, h, s, torch.bfloat16, b * h)
    out = attention(q, k, v, causal)
    torch.cuda.synchronize()
    ref = attention_reference(q, k, v, causal)
    torch.testing.assert_close(out.float(), ref.float(), atol=ATT_TOL[torch.bfloat16], rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("causal", [False, True])
def test_attention_strided_views_match_contiguous(cuda, dtype, causal):
    q, k, v = _qkv(cuda, 2, 3, 77, dtype, 9)
    out = attention(q, k, v, causal)
    ref = attention(q.contiguous(), k.contiguous(), v.contiguous(), causal)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref, atol=0, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_attention_many_batch_heads(cuda, dtype):
    """B*H above 65535 (a large encode batch in one call) fits the grid."""
    q, k, v = _qkv(cuda, 4097, 16, 1, dtype, 7)
    out = attention(q, k, v)
    torch.cuda.synchronize()
    ref = attention_reference(q, k, v)
    torch.testing.assert_close(out.float(), ref.float(), atol=ATT_TOL[dtype], rtol=0)


def _unit(n, d, dtype, dev, seed):
    a = torch.randn((n, d), generator=_gen(dev, seed), device=dev)
    return (a / a.norm(dim=1, keepdim=True)).to(dtype)


def _sms(dev):
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _check_topk(q, db, k, dtype):
    tiling, _ = split_plan(q.shape[0], db.shape[0], _sms(q.device), dtype, k, q.shape[1])
    before = topk_mod.KERNEL.launches[tiling.variant]
    vals, idx = mips_topk(q, db, k)
    torch.cuda.synchronize()
    wide = k > topk_mod.LANE_K or q.shape[1] > topk_mod.TC_MAX_DIM
    assert tiling.variant == (WIDE_VARIANT if wide else VARIANT)[dtype]
    assert topk_mod.KERNEL.launches[tiling.variant] == before + 1
    _assert_topk_agrees(vals, idx, q, db, k, TOPK_TOL[dtype])
    return tiling


def _assert_topk_agrees(vals, idx, q, db, k, tol):
    """Values within ``tol`` of the plain version's; an index must agree
    wherever its plain score is apart from both neighbours (the (k+1)-th
    included) by more than ``tol``."""
    assert vals.shape == idx.shape == (q.shape[0], k)
    assert vals.dtype == torch.float32 and idx.dtype == torch.int32
    kk = min(k + 1, db.shape[0])
    pv, pi = mips_topk_plain(q, db, kk)
    torch.testing.assert_close(vals, pv[:, :k], atol=tol, rtol=0)
    gaps = pv[:, :-1] - pv[:, 1:]
    sep = torch.ones_like(idx, dtype=torch.bool)
    sep[:, :gaps.shape[1]] &= gaps[:, :k] > tol
    sep[:, 1:] &= gaps[:, :k - 1] > tol
    assert bool(((idx == pi[:, :k]) | ~sep).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("b,n,k", [(1, 1, 1), (7, 1000, 16), (33, 3001, 10),
                                   (65, 20_000, 32), (130, 129, 16)])
def test_topk_kernel_matches_plain(cuda, dtype, b, n, k):
    _check_topk(_unit(b, 64, dtype, cuda, b + 1), _unit(n, 64, dtype, cuda, n), k, dtype)


# N at and one past a chunk (32 rows for small f32 tiles, 128 otherwise) and
# a slice boundary (132 slices of 2 chunks at B <= 64 in bf16); every B from
# one query to four tiles; k cycling through 1, 16 and 32.
_EDGES = [(b, n, (1, 16, 32)[i % 3]) for i, (b, n) in enumerate(
    (b, n) for b in (1, 63, 64, 65, 129, 256)
    for n in (32, 33, 128, 129, 33_792, 33_793))]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("b,n,k", _EDGES)
def test_topk_kernel_tile_edges(cuda, dtype, b, n, k):
    _check_topk(_unit(b, 64, dtype, cuda, b + 3), _unit(n, 64, dtype, cuda, n + 1), k, dtype)


def test_topk_bf16_main_path_width(cuda):
    """D = 768 and a DB of many slices through the tensor-core kernel."""
    db, q = _unit(60_001, 768, torch.bfloat16, cuda, 1), _unit(64, 768, torch.bfloat16, cuda, 2)
    _check_topk(q, db, 16, torch.bfloat16)


def test_topk_f32_small_rank_shape(cuda):
    """The corpus ranking (64, 256, 768) k=10 scores and selects in one
    launch and stays exact f32."""
    db, q = _unit(256, 768, torch.float32, cuda, 11), _unit(64, 768, torch.float32, cuda, 12)
    assert _check_topk(q, db, 10, torch.float32) is topk_mod.F32_FUSED
    vals, _ = mips_topk(q, db, 10)
    pv, _ = mips_topk_plain(q, db, 10)
    assert (vals - pv).abs().max().item() <= 1e-5


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_topk_kernel_ties_go_to_lower_index(cuda, dtype):
    """Every row appears three times, far apart, so the candidates of one
    query tie exactly and cross DB slices and both passes."""
    base = _unit(700, 64, dtype, cuda, 5)
    db = torch.cat([base, base, base]).contiguous()
    q = _unit(70, 64, dtype, cuda, 6)
    before = topk_mod.KERNEL.launches[VARIANT[dtype]]
    vals, idx = mips_topk(q, db, 30)
    pv, pi = mips_topk_plain(q, db, 30)
    torch.cuda.synchronize()
    assert topk_mod.KERNEL.launches[VARIANT[dtype]] == before + 1
    torch.testing.assert_close(idx, pi, atol=0, rtol=0)
    torch.testing.assert_close(vals, pv, atol=TOPK_TOL[dtype], rtol=0)
    assert bool((idx[:, 0::3] < idx[:, 1::3]).all() and (idx[:, 1::3] < idx[:, 2::3]).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("k", [33, 64, 100, 101, 200, 256])
@pytest.mark.parametrize("b,n", [(1, 300), (33, 3001), (70, 20_011)])
def test_topk_wide_k_matches_plain(cuda, dtype, k, b, n):
    """k above 32 (the score routes' selection) at ragged N and B off the
    query tiles."""
    _check_topk(_unit(b, 64, dtype, cuda, b + 7), _unit(n, 64, dtype, cuda, n + 2), k, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("k", [33, 100, 256])
def test_topk_wide_k_whole_db(cuda, dtype, k):
    """N = k: every row comes back, in order."""
    _check_topk(_unit(5, 64, dtype, cuda, 3), _unit(k, 64, dtype, cuda, k), k, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("b,n,k", [(300, 2297, 101), (64, 60_001, 64), (2048, 4096, 100)])
def test_topk_wide_k_main_path_width(cuda, dtype, b, n, k):
    """D = 768: the CIRR ranking's k = 101, a --db-topk of 64 and the
    Fashion-IQ-like ranking (a warp a query over 4096 rows: the selection's
    largest shared memory)."""
    _check_topk(_unit(b, 768, dtype, cuda, b), _unit(n, 768, dtype, cuda, n), k, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("k", [99, 240])
def test_topk_wide_k_ties_go_to_lower_index(cuda, dtype, k):
    """Every row three times, far apart: equal scores across the selection's
    groups, its bound and its sort keep the lower index first."""
    base = _unit(700, 64, dtype, cuda, 15)
    db = torch.cat([base, base, base]).contiguous()
    q = _unit(45, 64, dtype, cuda, 16)
    vals, idx = mips_topk(q, db, k)
    pv, pi = mips_topk_plain(q, db, k)
    torch.cuda.synchronize()
    torch.testing.assert_close(idx, pi, atol=0, rtol=0)
    torch.testing.assert_close(vals, pv, atol=TOPK_TOL[dtype], rtol=0)
    assert bool((idx[:, 0::3] < idx[:, 1::3]).all() and (idx[:, 1::3] < idx[:, 2::3]).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("k", [16, 200])
def test_topk_slices_shorter_than_k(cuda, dtype, k):
    """TC's slices or the score routes' segments shorter than k: TC at
    k = 16 over one slice per chunk (the last 104 rows), the others over
    eight segments of 125 rows (every one shorter than k = 200); the
    selection skips the empty slots they leave."""
    q, db = _unit(40, 64, dtype, cuda, 21), _unit(1000, 64, dtype, cuda, 22)
    tiling = topk_mod.split_plan(40, 1000, 132, dtype, k, 64)[0]
    if tiling is topk_mod.F32_FUSED:      # one launch, no segments: take the 2-launch route
        tiling = topk_mod.F32
    n_splits = -(-1000 // tiling.chunk_rows) if tiling is topk_mod.TC else 8
    vals, idx = topk_mod.launch(q, db, k, tiling, n_splits)
    torch.cuda.synchronize()
    assert bool((idx >= 0).all())
    _assert_topk_agrees(vals, idx, q, db, k, TOPK_TOL[dtype])


def test_python_mirrors_match_the_library(cuda):
    lib = topk_mod.KERNEL.lib()
    assert lib.keds_topk_fused_max_rows() == topk_mod.FUSED_MAX_ROWS
    assert lib.keds_topk_tc_max_dim() == topk_mod.TC_MAX_DIM
    for t in topk_mod.TILINGS:
        assert (lib.keds_topk_query_tile(t.code), lib.keds_topk_chunk_rows(t.code),
                lib.keds_topk_depth_step(t.code)) == (t.query_tile, t.chunk_rows, t.depth_step)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("k", [257, 300, 512, 513, 800])
@pytest.mark.parametrize("b,n", [(1, 1000), (33, 3001), (70, 20_011)])
def test_topk_multi_pass_matches_plain(cuda, dtype, k, b, n):
    """k above 256, up to 800 (one read of the database, one round of the
    selection's sort)."""
    _check_topk(_unit(b, 64, dtype, cuda, b + 9), _unit(n, 64, dtype, cuda, n + 4), k, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("b,n,k", [(64, 10_000, 300), (8, 1000, 1000), (64, 4096, 300)])
def test_topk_multi_pass_main_path_width(cuda, dtype, b, n, k):
    """D = 768: a --topn of 300 over a served corpus, and k = N."""
    _check_topk(_unit(b, 768, dtype, cuda, b + 2), _unit(n, 768, dtype, cuda, n), k, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("k", [255, 256, 257, 300, 512, 702, 2100])
def test_topk_multi_pass_ties_cross_passes(cuda, dtype, k):
    """Every row three times: runs of equal scores straddle k itself (255,
    256, 257 and 512 are not multiples of 3), which must keep the lower
    index first and drop none; k = 2100 is the whole DB."""
    base = _unit(700, 64, dtype, cuda, 25)
    db = torch.cat([base, base, base]).contiguous()
    q = _unit(45, 64, dtype, cuda, 26)
    vals, idx = mips_topk(q, db, k)
    torch.cuda.synchronize()
    _assert_topk_agrees(vals, idx, q, db, k, TOPK_TOL[dtype])
    full = k - k % 3                    # whole triples; the last may be cut by k
    vals, idx = vals[:, :full], idx[:, :full]
    assert bool((idx[:, 0::3] < idx[:, 1::3]).all() and (idx[:, 1::3] < idx[:, 2::3]).all())
    assert bool((idx[:, 0::3] % 700 == idx[:, 2::3] % 700).all())
    assert bool((vals[:, 0::3] == vals[:, 2::3]).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("n", [1000, 4097])
def test_topk_k_equals_n(cuda, dtype, n):
    """k = N: every row comes back in order (f32 at N = 1000 in one launch;
    N = 4097, one key past a round of the selection's sort, in two rounds)."""
    _check_topk(_unit(19, 128, dtype, cuda, n + 5), _unit(n, 128, dtype, cuda, n), n, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("n,k", [(300, 40), (3001, 101), (20_011, 300)])
def test_topk_signed_zero_scores_tie(cuda, dtype, n, k):
    """Scores of exactly -0.0 and +0.0 (and other exact ties): queries +-e0
    over rows whose first entry is one of -1, -0.5, -0.0, +0.0, 0.5, 1, so
    each score is that entry or its negation.  The plain version ranks -0.0
    and +0.0 as equal, lower row first, and so must the kernel: the order of
    ``entry_keys`` on the plain scores, index for index."""
    gen = np.random.default_rng(n)
    db = gen.standard_normal((n, 64)).astype(np.float32)
    db[:, 0] = gen.choice(np.array([-1.0, -0.5, -0.0, 0.0, 0.5, 1.0], np.float32), n)
    q = np.zeros((6, 64), np.float32)
    q[::2, 0], q[1::2, 0] = 1.0, -1.0
    db, q = torch.from_numpy(db).to(cuda, dtype), torch.from_numpy(q).to(cuda, dtype)
    vals, idx = mips_topk(q, db, k)
    pv, pi = mips_topk_plain(q, db, k)
    torch.cuda.synchronize()
    assert bool((vals == pv).all())                      # -0.0 == +0.0
    torch.testing.assert_close(idx, pi, atol=0, rtol=0)
    scores = (q.float() @ db.float().T).cpu()
    order = torch.sort(topk_mod.entry_keys(scores), dim=1, descending=True).indices[:, :k]
    assert order.to(torch.int32).tolist() == idx.cpu().tolist()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("b", [1, 5, 17, 65, 129, 257])
@pytest.mark.parametrize("d", [100, 1280])
@pytest.mark.parametrize("k", [16, 300])
def test_topk_queries_off_every_tile(cuda, dtype, b, d, k):
    """B one past each route's query tile (4 fused, 64, 128) and D off the
    depth step (100) or above TC_MAX_DIM (1280), zero-padded by the wrapper."""
    n = 700 if b < 65 else 12_001    # f32: fused below 1024 rows; B = 257 takes F32
    _check_topk(_unit(b, d, dtype, cuda, b + d), _unit(n, d, dtype, cuda, d + k), k, dtype)


def _kernel_names(fn):
    """Names of the CUDA kernels of csrc/topk.cu that ``fn`` launches, from
    torch.profiler's trace of the card."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sorted(e.name for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and "topk_" in e.name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("b,n", [(64, 256), (8, 1000), (33, 3001), (64, 20_011)])
def test_topk_launches_same_for_every_k(cuda, dtype, b, n):
    """One search launches the same kernels at k = 16, 101, 300 and N: f32
    over at most 1024 rows one, every other route two (bf16 at k = 16 is
    topk_tc and the selection; above, the score kernel and the selection),
    counted by the wrapper and seen in the profiler's trace."""
    q, db = _unit(b, 128, dtype, cuda, b), _unit(n, 128, dtype, cuda, n)
    counts = set()
    for k in (16, 101, 300, n):
        if k > n:
            continue
        tiling, _ = split_plan(b, n, _sms(cuda), dtype, k, 128)
        mips_topk(q, db, k)                         # built, counters allocated
        before = topk_mod.GRID_LAUNCHES[tiling.variant]
        names = _kernel_names(lambda: mips_topk(q, db, k))
        assert topk_mod.GRID_LAUNCHES[tiling.variant] - before == len(names), names
        counts.add(len(names))
    fused = dtype == torch.float32 and n <= topk_mod.FUSED_MAX_ROWS
    assert counts == {1 if fused else 2}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_topk_scratch_cap_splits_the_queries(cuda, dtype, monkeypatch):
    """A score matrix above SCORE_BYTES takes one launch for each share of
    the queries that fits (here 7 of 40 rows a share: 6 launches)."""
    q, db = _unit(40, 64, dtype, cuda, 41), _unit(3001, 64, dtype, cuda, 42)
    monkeypatch.setattr(topk_mod, "SCORE_BYTES", 7 * 3004 * 4)
    tiling = split_plan(40, 3001, _sms(cuda), dtype, 101, 64)[0]
    before = topk_mod.KERNEL.launches[tiling.variant]
    vals, idx = mips_topk(q, db, 101)
    torch.cuda.synchronize()
    assert topk_mod.KERNEL.launches[tiling.variant] == before + 6
    _assert_topk_agrees(vals, idx, q, db, 101, TOPK_TOL[dtype])


def test_kernels_reject_what_they_do_not_take(cuda):
    q = torch.zeros((2, 64), device=cuda)
    with pytest.raises(ValueError, match="k <= N"):
        mips_topk(q, torch.zeros((5, 64), device=cuda), 6)
    # k = 257 and k = N
    for n, k in ((300, 257), (300, 300)):
        db = _unit(n, 64, torch.float32, cuda, n + k)
        qq = _unit(2, 64, torch.float32, cuda, k)
        vals, idx = mips_topk(qq, db, k)
        pv, pi = mips_topk_plain(qq, db, k)
        torch.cuda.synchronize()
        torch.testing.assert_close(idx, pi, atol=0, rtol=0)
        torch.testing.assert_close(vals, pv, atol=TOPK_TOL[torch.float32], rtol=0)
    with pytest.raises(ValueError, match="one dtype"):
        mips_topk(q, torch.zeros((50, 64), device=cuda, dtype=torch.bfloat16), 3)
    # bf16 at D = 96 is zero-padded to the tensor-core step (its refusal is gone)
    qb, dbb = _unit(2, 96, torch.bfloat16, cuda, 96), _unit(50, 96, torch.bfloat16, cuda, 97)
    vals, idx = mips_topk(qb, dbb, 3)
    pv, pi = mips_topk_plain(qb, dbb, 3)
    torch.cuda.synchronize()
    torch.testing.assert_close(idx, pi, atol=0, rtol=0)
    torch.testing.assert_close(vals, pv, atol=TOPK_TOL[torch.bfloat16], rtol=0)
    with pytest.raises(ValueError, match="one D"):
        mips_topk(qb, torch.zeros((50, 64), device=cuda, dtype=torch.bfloat16), 3)
    # S above 288 streams K and V (its S <= 288 refusal is gone)
    q, k, v = _qkv(cuda, 1, 2, 300, torch.float32, 300)
    torch.testing.assert_close(attention(q, k, v), attention_reference(q, k, v),
                               atol=ATT_TOL[torch.float32], rtol=0)
    with pytest.raises(ValueError, match="S >= 1"):
        attention(*(torch.zeros((1, 1, 0, 64), device=cuda),) * 3)
    # bf16 at Dh = 32 runs the tensor-core kernel at its own width (no pad;
    # its refusal is gone)
    y = torch.randn((1, 1, 10, 32), generator=_gen(cuda, 10), device=cuda).to(torch.bfloat16)
    pads = att_mod.KERNEL.pads["bf16_tc"]
    out = attention(y, 0.5 * y, y.flip(-1))
    torch.cuda.synchronize()
    assert att_mod.KERNEL.pads["bf16_tc"] == pads and out.shape == y.shape
    torch.testing.assert_close(out.float(), attention_reference(y, 0.5 * y, y.flip(-1)).float(),
                               atol=ATT_TOL[torch.bfloat16], rtol=0)
    with pytest.raises(ValueError, match="Dh >= 1"):
        attention(*(torch.zeros((1, 1, 4, 0), device=cuda),) * 3)


def test_tiny_composed_query_card_matches_cpu(cuda):
    """The whole engine at a tiny size in f32: card (both kernels) vs CPU
    (their plain versions), same weights and DB."""
    from keds_tpu_torch import synth
    from keds_tpu_torch.engine import ComposedQueryEngine
    from keds_tpu_torch.models.clip import ClipConfig
    from keds_tpu_torch.models.convert import cast_floating
    from keds_tpu_torch.retrieval.database import KnowledgeDB

    cfg = ClipConfig(embed_dim=64, image_resolution=32, vision_layers=2,
                     vision_width=128, vision_patch_size=16, transformer_width=64,
                     transformer_heads=1, transformer_layers=2)
    params, heads, db = synth.build(cfg, db_rows=300, dtype=torch.float32, seed=3,
                                    device="cpu")
    rng = np.random.default_rng(0)
    images = [rng.integers(0, 256, (4, 32, 32, 3), dtype=np.uint8)]
    text = np.zeros((4, 77), np.int32)
    text[:, :6] = [49406, 320, 1125, 539, 265, 267]
    text[:, 6:12] = rng.integers(1000, 40000, (4, 6))
    text[:, 12] = 49407
    out = {}
    for dev in ("cpu", cuda):
        ddb = KnowledgeDB(db.image_db.to(dev), db.text_db.to(dev), db.names)
        eng = ComposedQueryEngine(cast_floating(params, torch.float32, dev), cfg,
                                  cast_floating(heads, torch.float32, dev), ddb,
                                  split_id=265, compute_dtype=torch.float32,
                                  db_topk=8, encode_chunk=2, device=dev)
        corpus = eng.encode_corpus(images)
        out[str(dev)] = (corpus, eng.compose(images, [text]),
                         eng.search(images, [text], eng.corpus_to_device(corpus), topn=3))
    cpu, gpu = out["cpu"], out["cuda"]
    np.testing.assert_allclose(gpu[0], cpu[0], atol=1e-4)
    np.testing.assert_allclose(gpu[1], cpu[1], atol=1e-4)
    np.testing.assert_array_equal(gpu[2][1], cpu[2][1])


def test_engine_ranks_topn_above_32_on_card(cuda):
    """ComposedQueryEngine.rank and search with topn = 50 over a device
    corpus: the card's ranking of the CPU's composed features equals the
    CPU's, and search returns 50 descending entries per query."""
    from keds_tpu_torch import synth
    from keds_tpu_torch.engine import ComposedQueryEngine
    from keds_tpu_torch.models.clip import ClipConfig
    from keds_tpu_torch.models.convert import cast_floating
    from keds_tpu_torch.retrieval.database import KnowledgeDB

    cfg = ClipConfig(embed_dim=64, image_resolution=32, vision_layers=2,
                     vision_width=128, vision_patch_size=16, transformer_width=64,
                     transformer_heads=1, transformer_layers=2)
    params, heads, db = synth.build(cfg, db_rows=300, dtype=torch.float32, seed=4,
                                    device="cpu")
    rng = np.random.default_rng(1)
    corpus_images = [rng.integers(0, 256, (16, 32, 32, 3), dtype=np.uint8) for _ in range(5)]
    images = [rng.integers(0, 256, (6, 32, 32, 3), dtype=np.uint8)]
    text = np.zeros((6, 77), np.int32)
    text[:, :6] = [49406, 320, 1125, 539, 265, 267]
    text[:, 6:12] = rng.integers(1000, 40000, (6, 6))
    text[:, 12] = 49407
    engines = {}
    for dev in ("cpu", cuda):
        ddb = KnowledgeDB(db.image_db.to(dev), db.text_db.to(dev), db.names)
        engines[str(dev)] = ComposedQueryEngine(
            cast_floating(params, torch.float32, dev), cfg,
            cast_floating(heads, torch.float32, dev), ddb, split_id=265,
            compute_dtype=torch.float32, db_topk=8, encode_chunk=2, device=dev)
    cpu, gpu = engines["cpu"], engines["cuda"]
    corpus = cpu.encode_corpus(corpus_images)
    q = cpu.compose(images, [text])
    s_cpu, i_cpu = cpu.rank(torch.from_numpy(q), cpu.corpus_to_device(corpus), 50)
    s_gpu, i_gpu = gpu.rank(torch.from_numpy(q).to(cuda), gpu.corpus_to_device(corpus), 50)
    scores, idx = gpu.search(images, [text], gpu.corpus_to_device(corpus), topn=50)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(i_gpu.cpu().numpy(), i_cpu.numpy())
    np.testing.assert_allclose(s_gpu.cpu().numpy(), s_cpu.numpy(), atol=1e-5)
    assert scores.shape == idx.shape == (6, 50)
    assert (np.diff(scores, axis=1) <= 0).all() and ((idx >= 0) & (idx < 80)).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_retriever_k48_on_card_matches_plain(cuda, dtype):
    """Retriever.retrieve_features at k = 48 (a --db-topk above 32): the
    neighbour rows of the card's search are the plain search's."""
    from keds_tpu_torch.retrieval.database import KnowledgeDB, Retriever, unit_rows

    rng = np.random.default_rng(2)
    db = KnowledgeDB.from_arrays(rng.standard_normal((3001, 64)),
                                 rng.standard_normal((3001, 64)), dtype=dtype, device=cuda)
    f = torch.from_numpy(rng.standard_normal((10, 64)).astype(np.float32)).to(cuda)
    retr = Retriever(db)
    ti, tt = retr.retrieve_features(f, k=48)
    img_idx, txt_idx = retr.neighbour_indices(f, 48)
    torch.cuda.synchronize()
    q = unit_rows(f).to(dtype)
    for table, got, rows in ((db.image_db, img_idx, ti), (db.text_db, txt_idx, tt)):
        vals = (q.float() @ table.float().T).gather(1, got.long())
        _assert_topk_agrees(vals, got, q, table, 48, TOPK_TOL[dtype])
        torch.testing.assert_close(rows, table[got.long()].to(f.dtype), atol=0, rtol=0)


def _grad_inputs(dev, b, h, s, dtype, seed):
    """Strided q/k/v views of one qkv buffer that requires grad, and a
    non-contiguous output gradient (a (B, H, S, Dh) view of (B, S, H, Dh))."""
    qkv = torch.randn((b, s, 3, h, 64), generator=_gen(dev, seed), device=dev).to(dtype)
    qkv.requires_grad_(True)
    dout = torch.randn((b, s, h, 64), generator=_gen(dev, seed + 1),
                       device=dev).to(dtype).transpose(1, 2)
    return qkv, tuple(qkv[:, :, i].transpose(1, 2) for i in range(3)), dout


# Backward kernel vs plain version.  f32: sums of up to S*Dh products in
# another order.  bf16: the gradients
# are rounded to bf16, and a probability or dP = dO V^T, which both round to
# bf16, may round the other way.
BWD_TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (3e-2, 2e-2)}   # (atol, rtol)
BWD_VARIANT = {torch.float32: "f32", torch.bfloat16: "bf16"}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("s", [1, 5, 7, 8, 9, 15, 16, 17, 31, 32, 33, 63, 64, 65, 76, 77, 128])
@pytest.mark.parametrize("causal", [False, True])
def test_attention_backward_matches_plain(cuda, dtype, s, causal):
    qkv, (q, k, v), dout = _grad_inputs(cuda, 3, 5, s, dtype, s)
    before = dict(att_mod.BWD_KERNEL.launches)
    out = attention(q, k, v, causal)
    grads = torch.autograd.grad(out, (q, k, v), dout)
    torch.cuda.synchronize()
    assert att_mod.BWD_KERNEL.launches[BWD_VARIANT[dtype]] == before[BWD_VARIANT[dtype]] + 1
    ref = att_mod.attention_reference_backward(q, k, v, dout, causal)
    atol, rtol = BWD_TOL[dtype]
    for g, r in zip(grads, ref):
        assert g.shape == r.shape and g.dtype == dtype
        torch.testing.assert_close(g.float(), r.float(), atol=atol, rtol=rtol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_attention_backward_many_batch_heads(cuda, dtype):
    """B*H = 65 552, past grid.y's 65 535."""
    _, (q, k, v), dout = _grad_inputs(cuda, 4097, 16, 8, dtype, 3)
    grads = att_mod.attention_backward(q, k, v, dout, True)
    ref = att_mod.attention_reference_backward(q, k, v, dout, True)
    torch.cuda.synchronize()
    atol, rtol = BWD_TOL[dtype]
    for g, r in zip(grads, ref):
        torch.testing.assert_close(g.float(), r.float(), atol=atol, rtol=rtol)


def test_attention_backward_accumulates_into_qkv(cuda):
    """The fused qkv buffer's gradient through the three strided views equals
    the plain version's, contiguous output gradient or not."""
    qkv, (q, k, v), dout = _grad_inputs(cuda, 2, 3, 33, torch.float32, 5)
    attention(q, k, v, True).backward(dout)
    ref_qkv = qkv.detach().clone().requires_grad_(True)
    rq, rk, rv = (ref_qkv[:, :, i].transpose(1, 2) for i in range(3))
    attention_reference(rq, rk, rv, True).backward(dout.contiguous())
    torch.cuda.synchronize()
    torch.testing.assert_close(qkv.grad, ref_qkv.grad, atol=1e-4, rtol=1e-4)


def test_attention_serving_saves_nothing(cuda):
    """Under inference_mode (and under no_grad with inputs that require
    grad) the forward kernel runs alone: no graph, no backward launch."""
    qkv, (q, k, v), _ = _grad_inputs(cuda, 2, 3, 16, torch.bfloat16, 8)
    fwd0, bwd0 = dict(att_mod.KERNEL.launches), dict(att_mod.BWD_KERNEL.launches)
    with torch.inference_mode():
        x = qkv.detach()
        out = attention(*(x[:, :, i].transpose(1, 2) for i in range(3)), True)
    assert out.grad_fn is None
    with torch.no_grad():
        assert attention(q, k, v, True).grad_fn is None
    torch.cuda.synchronize()
    assert att_mod.KERNEL.launches["bf16_tc"] == fwd0["bf16_tc"] + 2
    assert att_mod.BWD_KERNEL.launches == bwd0
    assert attention(q, k, v, True).grad_fn is not None


def _check_backward(q, k, v, dout, causal):
    grads = att_mod.attention_backward(q, k, v, dout, causal)
    ref = att_mod.attention_reference_backward(q, k, v, dout, causal)
    torch.cuda.synchronize()
    atol, rtol = BWD_TOL[q.dtype]
    for g, r in zip(grads, ref):
        torch.testing.assert_close(g.float(), r.float(), atol=atol, rtol=rtol)
    return grads


@pytest.mark.parametrize("s", [8, 16, 77])
@pytest.mark.parametrize("b,h", [(1, 1), (1, 2), (1, 3), (2, 3), (7, 1), (3, 7)])
def test_attention_backward_partial_head_groups(cuda, s, b, h):
    """B*H not a multiple of the slices a block takes at S <= 16."""
    _, (q, k, v), dout = _grad_inputs(cuda, b, h, s, torch.bfloat16, 20 + b * h)
    before = att_mod.BWD_KERNEL.launches["bf16"]
    _check_backward(q, k, v, dout, True)
    assert att_mod.BWD_KERNEL.launches["bf16"] == before + 1


@pytest.mark.parametrize("s", [8, 32, 77, 128])
@pytest.mark.parametrize("causal", [False, True])
def test_attention_backward_near_one_hot_softmax(cuda, s, causal):
    """q scaled by 8: each row's softmax is nearly one-hot, so dS = P(dP - D)
    is a small difference, where its rounding to bf16 matters most."""
    qkv = torch.randn((2, s, 3, 6, 64), generator=_gen(cuda, s), device=cuda)
    qkv[:, :, 0] *= 8
    q, k, v = (qkv.to(torch.bfloat16)[:, :, i].transpose(1, 2) for i in range(3))
    dout = torch.randn((2, 6, s, 64), generator=_gen(cuda, s + 1), device=cuda).to(torch.bfloat16)
    _check_backward(q, k, v, dout, causal)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("s", [8, 77])
def test_attention_backward_zero_output_gradient(cuda, dtype, s):
    _, (q, k, v), dout = _grad_inputs(cuda, 2, 3, s, dtype, 30)
    for g in att_mod.attention_backward(q, k, v, torch.zeros_like(dout), True):
        assert g.abs().max().item() == 0
    torch.cuda.synchronize()


@pytest.mark.parametrize("s", [8, 77, 128])
def test_attention_backward_is_deterministic(cuda, s):
    """No atomics: two calls agree bit for bit."""
    _, (q, k, v), dout = _grad_inputs(cuda, 4, 12, s, torch.bfloat16, 40)
    first = att_mod.attention_backward(q, k, v, dout, True)
    second = att_mod.attention_backward(q, k, v, dout, True)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def _bwd_plan(s, dtype, dh=64):
    """keds_attention_bwd_plan at S = ``s`` for a head of ``dh``: (16-row
    tiles, slices a block, warps a block, shared bytes a block, workspace
    rows a statistic)."""
    import ctypes

    out = (ctypes.c_int * 5)()
    code = 1 if dtype == torch.bfloat16 else 0
    assert att_mod.BWD_KERNEL.lib().keds_attention_bwd_plan(
        s, code, dh, ctypes.cast(out, ctypes.c_void_p)) == 0
    return tuple(out)


@pytest.mark.parametrize("bh", [1, 3, 4, 5, 15, 1536])
def test_backward_plan_fits_and_covers_every_slice(cuda, bh):
    """The bf16 backward kernel's launch plan at every S it takes: a block
    fits the H100's 227 KB of shared memory, has a warp per 16-row tile (or
    per slice at S <= 16), and the blocks' slices cover each (batch, head)
    exactly once."""
    import ctypes

    for s in range(1, 1100):
        tiles, slices, warps, smem, rows = _bwd_plan(s, torch.bfloat16)
        assert (tiles - 1) * 16 < s <= tiles * 16
        assert smem <= 227 * 1024
        if s > 128:     # the streamed launches: blocks of 64 rows, a warp per 16,
            # a three-stage ring, a workspace row per query row of the warps
            assert (slices, warps, smem) == (1, 4, 70_936)
            assert rows == 16 * tiles
            assert 3 * (smem + 1024) <= 228 * 1024
            continue
        assert rows == 0
        assert warps == (slices if tiles == 1 else tiles)
        got = [blk * slices + w for blk in range(-(-bh // slices)) for w in range(slices)]
        assert sorted(x for x in got if x < bh) == list(range(bh))
        assert len(got) - bh < slices
    assert _bwd_plan(77, torch.bfloat16)[3] == 47_040
    assert _bwd_plan(128, torch.bfloat16)[3] == 75_264
    # narrower heads stage rows of Dh rounded up to 16, + 8 (S = 77: 5 tiles)
    for dh, dh16 in ((1, 16), (24, 32), (32, 32), (48, 48), (63, 64)):
        assert _bwd_plan(77, torch.bfloat16, dh)[3] == 80 * (4 * (dh16 + 8) * 2 + 12)
    out = (ctypes.c_int * 5)()
    for code in (0, 1):
        for s, dh in ((0, 64), (8, 0), (8, 65)):
            assert att_mod.BWD_KERNEL.lib().keds_attention_bwd_plan(
                s, code, dh, ctypes.cast(out, ctypes.c_void_p)) != 0


def test_backward_plan_f32_fits_every_sequence(cuda):
    """The f32 backward kernel's launch plan at every S: a warp per 16-row
    tile, at most four a block and as many as make a (batch, head)'s blocks
    even; one launch and no workspace at S <= 64, else a workspace row per
    query row; and shared memory that lets two blocks share an SM (the split
    launches of small grids aside)."""
    for s in range(1, 1100):
        tiles, slices, warps, smem, rows = _bwd_plan(s, torch.float32)
        assert (tiles - 1) * 16 < s <= tiles * 16
        assert slices == 1 and 1 <= warps <= 4
        blocks = -(-tiles // warps)
        assert (blocks - 1) * warps < tiles and blocks == -(-tiles // 4)
        assert 2 * (smem + 1024) <= 228 * 1024
        assert rows == (0 if s <= 64 else 16 * tiles)
    assert _bwd_plan(64, torch.float32)[3] == 70_400
    assert _bwd_plan(577, torch.float32)[3] == 105_984


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("s", [129, 145, 192, 193, 257, 320, 321, 577, 640, 641, 1025])
@pytest.mark.parametrize("causal", [False, True])
def test_attention_backward_streams_long_sequences(cuda, dtype, s, causal):
    """Above 128 the two launches (dq, then dk and dv; f32 takes them at
    every S), through autograd as the towers reach them; two calls agree
    bit for bit."""
    qkv, (q, k, v), dout = _grad_inputs(cuda, 2, 3, s, dtype, s)
    variant = "bf16_stream" if dtype == torch.bfloat16 else "f32"   # f32: one design at any S
    before = dict(att_mod.BWD_KERNEL.launches)
    grads = torch.autograd.grad(attention(q, k, v, causal), (q, k, v), dout)
    again = att_mod.attention_backward(q, k, v, dout, causal)
    torch.cuda.synchronize()
    assert att_mod.BWD_KERNEL.launches == dict(before, **{variant: before[variant] + 2})
    ref = att_mod.attention_reference_backward(q, k, v, dout, causal)
    atol, rtol = BWD_TOL[dtype]
    for g, a, r in zip(grads, again, ref):
        assert g.shape == r.shape and g.dtype == dtype
        assert torch.equal(g, a)
        torch.testing.assert_close(g.float(), r.float(), atol=atol, rtol=rtol)


@pytest.mark.parametrize("s", [257, 577])
def test_attention_backward_streamed_near_one_hot_softmax(cuda, s):
    qkv = torch.randn((2, s, 3, 4, 64), generator=_gen(cuda, s), device=cuda)
    qkv[:, :, 0] *= 8
    q, k, v = (qkv.to(torch.bfloat16)[:, :, i].transpose(1, 2) for i in range(3))
    dout = torch.randn((2, 4, s, 64), generator=_gen(cuda, s + 1), device=cuda).to(torch.bfloat16)
    for causal in (False, True):
        _check_backward(q, k, v, dout, causal)


@pytest.mark.parametrize("b,h,s", [(7, 19, 577), (4, 12, 1025)])
@pytest.mark.parametrize("causal", [False, True])
def test_attention_backward_streams_partial_waves(cuda, b, h, s, causal):
    """The streamed bf16 backward at a grid that leaves the card's last wave
    partly empty (B*H = 133) and at (4, 12, 1025), where both launches take
    8 consumer warps a block; two calls agree bit for bit."""
    _, (q, k, v), dout = _grad_inputs(cuda, b, h, s, torch.bfloat16, b * h)
    grads = _check_backward(q, k, v, dout, causal)
    again = att_mod.attention_backward(q, k, v, dout, causal)
    torch.cuda.synchronize()
    for g, a in zip(grads, again):
        assert torch.equal(g, a)


def test_attention_backward_copies_unaligned_rows(cuda):
    """bf16 rows that are not 16-byte aligned (an odd offset into a buffer)
    are copied before the kernel's 16-byte loads."""
    buf = torch.randn((2 * 5 * 64 * 3 + 1,), generator=_gen(cuda, 50), device=cuda)
    buf = buf.to(torch.bfloat16)
    q, k, v = (buf[1 + i * 640:1 + (i + 1) * 640].view(1, 2, 5, 64) for i in range(3))
    dout = torch.randn((1, 2, 5, 64), generator=_gen(cuda, 51), device=cuda).to(torch.bfloat16)
    assert q.data_ptr() % 16
    _check_backward(q, k, v, dout, True)


def test_attention_backward_rejects_what_it_does_not_take(cuda):
    # S = 129 is taken since the streamed kernels: it runs against the plain version
    x = torch.randn((1, 1, 129, 64), generator=_gen(cuda, 60), device=cuda)
    _check_backward(x, x * 0.5, x * 0.25, x.flip(2), False)
    # Dh = 32 (its refusal is gone): f32 is zero-padded to the tuned kernels'
    # 64, bf16 runs the resident kernel at its own width
    y = torch.randn((1, 1, 8, 32), generator=_gen(cuda, 61), device=cuda)
    for t, variant, padded in ((y, "f32", 1), (y.to(torch.bfloat16), "bf16", 0)):
        pads = att_mod.BWD_KERNEL.pads[variant]
        grads = _check_backward(t, t * 0.5, t * 0.25, t.flip(2), True)
        assert att_mod.BWD_KERNEL.pads[variant] == pads + padded
        assert all(g.shape == y.shape for g in grads)
    with pytest.raises(ValueError, match="S >= 1"):
        att_mod.attention_backward(*(torch.zeros((1, 1, 0, 64), device=cuda),) * 4)
    z = torch.zeros((1, 1, 8, 64), device=cuda, dtype=torch.float16)
    with pytest.raises(ValueError, match="f32 or bf16"):
        att_mod.attention_backward(z, z, z, z)
    w = torch.zeros((1, 1, 8, 64), device=cuda)
    with pytest.raises(ValueError, match="output gradient"):
        att_mod.attention_backward(w, w, w, w.to(torch.bfloat16))


def test_tiny_text_tower_gradients_card_match_cpu(cuda):
    """Pseudo-token gradients through a 2-layer text tower (the image-stream
    splice) on the card, through both attention kernels, equal the CPU's."""
    from keds_tpu_torch import synth
    from keds_tpu_torch.models import clip as mclip
    from keds_tpu_torch.models.convert import cast_floating

    cfg = mclip.ClipConfig(embed_dim=64, image_resolution=32, vision_layers=1,
                           vision_width=64, vision_patch_size=16, transformer_width=128,
                           transformer_heads=2, transformer_layers=2)
    params = synth.init_clip(cfg, 4, torch.device("cpu"), torch.float32)
    text = torch.zeros((6, 16), dtype=torch.long)
    text[:, :5] = torch.tensor([49406, 320, 1125, 539, 49407])
    tok = torch.randn((6, 3, 128), generator=torch.Generator().manual_seed(0))
    w = torch.randn((6, 64), generator=torch.Generator().manual_seed(1))
    grads = {}
    for dev in ("cpu", cuda):
        p = cast_floating(params, torch.float32, dev)
        t = tok.to(dev).detach().requires_grad_(True)
        bwd0 = att_mod.BWD_KERNEL.launches["f32"]
        out = mclip.encode_text_img(p, cfg, text.to(dev), t)
        (out * w.to(dev)).sum().backward()
        grads[str(dev)] = t.grad.cpu()
        if dev != "cpu":
            torch.cuda.synchronize()
            assert att_mod.BWD_KERNEL.launches["f32"] == bwd0 + cfg.transformer_layers
    torch.testing.assert_close(grads["cuda"], grads["cpu"], atol=1e-4, rtol=1e-4)
    assert grads["cpu"].abs().max() > 0


def test_tiny_text_tower_bf16_gradients_at_77_match_cpu(cuda):
    """Pseudo-token gradients through a 2-layer text tower at the S=77 bucket
    on the card in bf16 (the tensor-core backward, launch counted) point as
    the CPU's f32 ones do: cosine >= 0.99, train_check's limit."""
    from keds_tpu_torch import synth
    from keds_tpu_torch.models import clip as mclip
    from keds_tpu_torch.models.convert import cast_floating

    cfg = mclip.ClipConfig(embed_dim=64, image_resolution=32, vision_layers=1,
                           vision_width=64, vision_patch_size=16, transformer_width=128,
                           transformer_heads=2, transformer_layers=2)
    params = synth.init_clip(cfg, 6, torch.device("cpu"), torch.float32)
    gen = torch.Generator().manual_seed(2)
    text = torch.randint(1000, 40000, (6, 77), generator=gen)
    text[:, 0], text[:, 70:] = 49406, 0
    text[:, 69] = 49407
    tok = torch.randn((6, 3, 128), generator=gen)
    w = torch.randn((6, 64), generator=gen)
    grads = {}
    for dev, dtype in (("cpu", torch.float32), (cuda, torch.bfloat16)):
        t = tok.to(dev, dtype).detach().requires_grad_(True)
        bwd0 = dict(att_mod.BWD_KERNEL.launches)
        out = mclip.encode_text_img(cast_floating(params, dtype, dev), cfg, text.to(dev), t)
        (out.float() * w.to(dev)).sum().backward()
        grads[str(dev)] = t.grad.double().cpu().flatten()
        if dev != "cpu":
            torch.cuda.synchronize()
            assert att_mod.BWD_KERNEL.launches["bf16"] == bwd0["bf16"] + cfg.transformer_layers
            assert att_mod.BWD_KERNEL.launches["f32"] == bwd0["f32"]
    cpu, card = grads["cpu"], grads["cuda"]
    assert float(card @ cpu) / float(card.norm() * cpu.norm()) >= 0.99


def test_tiny_train_step_card_matches_cpu(cuda):
    """One image-stream train step at a tiny size in f32 (dropout 0): loss
    and updated heads on the card equal the CPU's."""
    from types import SimpleNamespace

    from keds_tpu_torch import synth
    from keds_tpu_torch.models.clip import ClipConfig
    from keds_tpu_torch.models.convert import cast_floating
    from keds_tpu_torch.retrieval.database import KnowledgeDB, Retriever
    from keds_tpu_torch.train.losses import TrainBatch
    from keds_tpu_torch.train.trainer import make_optimizer, make_train_step

    cfg = ClipConfig(embed_dim=64, image_resolution=32, vision_layers=1,
                     vision_width=64, vision_patch_size=16, transformer_width=64,
                     transformer_heads=1, transformer_layers=2)
    params, heads, db = synth.build(cfg, db_rows=300, dtype=torch.float32, seed=5,
                                    device="cpu")
    img, cap = synth.feature_pairs(16, 64, 6, torch.device("cpu"))
    ocfg = SimpleNamespace(lr=1e-3, beta1=0.9, beta2=0.98, eps=1e-6, wd=0.1, warmup=2,
                           skip_scheduler=False)
    prompt = np.zeros((1, 77), np.int64)
    prompt[0, :5] = [49406, 320, 1125, 539, 49407]
    out = {}
    for dev in (cuda, "cpu"):   # the CPU run trains `heads` itself, in place
        h = cast_floating(heads, torch.float32, dev)
        ddb = KnowledgeDB(db.image_db.to(dev), db.text_db.to(dev), db.names)
        opt, sched = make_optimizer(ocfg, 10, h)
        step = make_train_step(params, cfg, Retriever(ddb), opt, sched, stream="image",
                               prompt_tokens=prompt, split_id=265, dropout=0.0,
                               db_topk=8, compute_dtype=torch.float32, device=dev)
        losses = [float(step(h, TrainBatch(img.to(dev), cap.to(dev)), t)) for t in range(2)]
        out[str(dev)] = (losses, [t.detach().cpu() for t in h.img2text["layers"][0].values()])
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=1e-5)
    for a, b in zip(out["cuda"][1], out["cpu"][1]):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-4)


def test_topk_bf16_widest_db(cuda):
    """D = 1024 (ViT-H-14's width): the bf16 kernel's 16-slice instantiation
    (query fragments for 1024 depths in registers) on its 8-stage ring."""
    db, q = _unit(5_000, 1024, torch.bfloat16, cuda, 21), _unit(65, 1024, torch.bfloat16, cuda, 22)
    _check_topk(q, db, 32, torch.bfloat16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("b", [1, 128, 256])
def test_topk_k2_main_path_width(cuda, dtype, b):
    """k=2, the text stream's caption neighbours: D = 768 over a DB of many
    slices."""
    db, q = _unit(60_001, 768, dtype, cuda, 31), _unit(b, 768, dtype, cuda, b + 32)
    _check_topk(q, db, 2, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("b,n", sorted({(b, n) for b, n, _ in _EDGES}))
def test_topk_k2_tile_edges(cuda, dtype, b, n):
    _check_topk(_unit(b, 64, dtype, cuda, b + 5), _unit(n, 64, dtype, cuda, n + 2), 2, dtype)


def _templates(rng, n, n_stars):
    """(n, 77) "a photo of" + stars + 1 to 12 seeded ids + EOT."""
    out = np.zeros((n, 77), np.int64)
    for r in range(n):
        row = ([49406, 320, 1125, 539] + [265] * n_stars
               + rng.integers(1000, 40000, int(rng.integers(1, 13))).tolist() + [49407])
        out[r, :len(row)] = row
    return out


_TEXT_CFG = dict(embed_dim=128, image_resolution=32, vision_layers=1, vision_width=64,
                 vision_patch_size=16, transformer_width=128, transformer_heads=2,
                 transformer_layers=2)


def _tiny_text(db_rows=500, b=16):
    """Tiny CLIP, heads and DB (f32, CPU), the DB rows' neighbour templates,
    and a batch: feature pairs and own templates."""
    from keds_tpu_torch import synth
    from keds_tpu_torch.models.clip import ClipConfig

    cfg = ClipConfig(**_TEXT_CFG)
    params, heads, db = synth.build(cfg, db_rows=db_rows, dtype=torch.float32, seed=7,
                                    device="cpu")
    rng = np.random.default_rng(7)
    img, cap = synth.feature_pairs(b, cfg.embed_dim, 8, torch.device("cpu"))
    return cfg, params, heads, db, _templates(rng, db_rows, 2), (img, cap, _templates(rng, b, 3))


def _text_step(cfg, params, heads, db, table, dev, dtype, dropout=0.0, seed=0):
    import copy
    from types import SimpleNamespace

    from keds_tpu_torch.models.convert import cast_floating
    from keds_tpu_torch.retrieval.database import KnowledgeDB, Retriever
    from keds_tpu_torch.train.trainer import make_optimizer, make_train_step

    h = cast_floating(copy.deepcopy(heads), torch.float32, dev)   # trained in place
    ddb = KnowledgeDB(db.image_db.to(dev, dtype), db.text_db.to(dev, dtype), db.names)
    ocfg = SimpleNamespace(lr=1e-3, beta1=0.9, beta2=0.98, eps=1e-6, wd=0.1, warmup=2,
                           skip_scheduler=False)
    opt, sched = make_optimizer(ocfg, 10, h)
    step = make_train_step(cast_floating(params, dtype, dev), cfg, Retriever(ddb), opt, sched,
                           stream="text", prompt_tokens=np.zeros((1, 77), np.int64),
                           split_id=265, dropout=dropout, seed=seed, db_topk=8,
                           db_other_tokens=table, compute_dtype=dtype, device=dev)
    return h, opt, step, Retriever(ddb)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_tiny_text_train_step_card_matches_cpu(cuda, dtype):
    """One text-stream step on the card (the tensor-core kernels in bf16)
    against the CPU's f32 step, the card's index triple fed to both,
    dropout 0: loss within 1 %, head-gradient cosine >= 0.99 over img2text
    and retrieval_fuse (chip_smoke.py's train_check limits); text_condition
    gets no gradient on either side."""
    from keds_tpu_torch.models.convert import head_parameters
    from keds_tpu_torch.retrieval.database import unit_rows
    from keds_tpu_torch.train.losses import TrainBatch

    cfg, params, heads, db, table, (img, cap, own) = _tiny_text()
    _, _, _, retr = _text_step(cfg, params, heads, db, table, cuda, dtype)
    idx = (retr.neighbour_indices(img.to(cuda), 8)
           + (retr.caption_indices(unit_rows(cap.to(cuda)), 2),))
    readings = {}
    for dev, dt in ((cuda, dtype), ("cpu", torch.float32)):
        h, _, step, _ = _text_step(cfg, params, heads, db, table, dev, dt)
        batch = TrainBatch(img.to(dev), cap.to(dev), *(i.to(dev) for i in idx[:2]),
                           other_tokens=torch.from_numpy(own).to(dev),
                           cap2_idx=idx[2].to(dev))
        loss = float(step(h, batch, 0))
        params_ = head_parameters(h)
        assert all(p.grad is None for mod, _, p in params_ if mod == "text_condition")
        readings[str(dev)] = (loss, torch.cat([p.grad.flatten().double().cpu()
                                               for mod, _, p in params_
                                               if mod != "text_condition"]))
    (l_card, g_card), (l_cpu, g_cpu) = readings["cuda"], readings["cpu"]
    assert abs(l_card - l_cpu) <= 0.01 * abs(l_cpu)
    assert float(g_card @ g_cpu) / float(g_card.norm() * g_cpu.norm()) >= 0.99
    if dtype == torch.float32:
        assert l_card == pytest.approx(l_cpu, rel=1e-5)


def test_text_condition_unchanged_after_card_steps(cuda):
    """Three bf16 text-stream steps on the card (dropout on): text_condition
    bit-equal to its initial values and without AdamW state, IM2TEXT and the
    retrieval CrossFormer moved (a key bias shifts every score of a softmax
    alike and gets no gradient to speak of, so not every tensor moves), and
    B1 launched twice a step (k=8 image DB, k=2 captions)."""
    from keds_tpu_torch.models.convert import head_parameters
    from keds_tpu_torch.train.losses import TrainBatch

    cfg, params, heads, db, table, (img, cap, own) = _tiny_text()
    h, opt, step, _ = _text_step(cfg, params, heads, db, table, cuda, torch.bfloat16,
                                 dropout=0.1)
    before = [(mod, p, p.detach().clone()) for mod, _, p in head_parameters(h)]
    b1 = topk_mod.KERNEL.launches["bf16_tc"]
    bwd = att_mod.BWD_KERNEL.launches["bf16"]
    batch = TrainBatch(img.to(cuda), cap.to(cuda), other_tokens=torch.from_numpy(own).to(cuda))
    losses = [float(step(h, batch, t)) for t in range(3)]
    torch.cuda.synchronize()
    assert np.isfinite(losses).all()
    assert topk_mod.KERNEL.launches["bf16_tc"] == b1 + 2 * 3
    assert att_mod.BWD_KERNEL.launches["bf16"] > bwd
    moved = {}
    for mod, p, p0 in before:
        if mod == "text_condition":
            assert torch.equal(p, p0) and p not in opt.state
        moved.setdefault(mod, []).append(not torch.equal(p, p0))
    assert all(moved["img2text"]) and any(moved["retrieval_fuse"])
    assert not any(moved["text_condition"])


def test_neighbour_tool_on_card_matches_in_step_search(cuda, tmp_path):
    """The port's tool on the card (bf16) writes the rows the in-step search
    finds: the step fed its pack gives the searched step's loss and heads
    bit for bit at the same generator, dropout on."""
    import json

    from keds_tpu_torch.models.convert import head_parameters
    from keds_tpu_torch.retrieval.database import KnowledgeDB
    from keds_tpu_torch.tools import precompute_neighbors as tool
    from keds_tpu_torch.train.losses import TrainBatch

    cfg, params, heads, db, table, (img, cap, own) = _tiny_text()
    data, dbdir = tmp_path / "features", tmp_path / "db"
    data.mkdir()
    dbdir.mkdir()
    np.save(data / "image_features.npy", img.numpy())
    np.save(data / "text_features.npy", cap.numpy())
    (data / "names.json").write_text(json.dumps([f"s{i}" for i in range(len(img))]))
    np.save(dbdir / "image_db.npy", db.image_db.numpy())
    np.save(dbdir / "text_db.npy", db.text_db.numpy())
    tool.main(["--train-data", str(data), "--database-path", str(dbdir), "--db-topk", "8",
               "--batch", "5", "--device", "cuda"])
    img_idx, txt_idx, cap2_idx, meta = tool.load_neighbors(str(data / "neighbors.npz"))
    assert meta["backend"] == "cuda" and meta["precision"] == "bf16"
    loaded = KnowledgeDB.from_directory(str(dbdir), torch.float32, "cpu")
    runs = []
    for pack in (None, (img_idx, txt_idx, cap2_idx)):
        h, _, step, _ = _text_step(cfg, params, heads, loaded, table, cuda, torch.bfloat16,
                                   dropout=0.1, seed=3)
        idx = {}
        if pack is not None:
            idx = {n: torch.from_numpy(a).to(cuda)
                   for n, a in zip(("img_idx", "txt_idx", "cap2_idx"), pack)}
        loss = step(h, TrainBatch(img.to(cuda), cap.to(cuda),
                                  other_tokens=torch.from_numpy(own).to(cuda), **idx), 2)
        runs.append((loss, [p for _, _, p in head_parameters(h)]))
    (l0, h0), (l1, h1) = runs
    assert torch.equal(l0, l1)
    for a, b in zip(h0, h1):
        assert torch.equal(a, b)


def test_tiny_raw_train_step_card_matches_cpu(cuda):
    """Two image-stream steps on raw uint8 images at a tiny size in f32
    (dropout 0): the frozen encode, the search, the loss and the updated
    heads on the card equal the CPU's; B1 and B2 launch on the card."""
    from types import SimpleNamespace

    from keds_tpu_torch import synth
    from keds_tpu_torch.models.clip import ClipConfig
    from keds_tpu_torch.models.convert import cast_floating
    from keds_tpu_torch.retrieval.database import KnowledgeDB, Retriever
    from keds_tpu_torch.train.losses import RawBatch
    from keds_tpu_torch.train.trainer import make_optimizer, make_train_step

    cfg = ClipConfig(embed_dim=64, image_resolution=32, vision_layers=2,
                     vision_width=128, vision_patch_size=16, transformer_width=64,
                     transformer_heads=1, transformer_layers=2)
    params, heads, db = synth.build(cfg, db_rows=300, dtype=torch.float32, seed=7,
                                    device="cpu")
    rng = np.random.default_rng(3)
    images = torch.from_numpy(rng.integers(0, 256, (12, 32, 32, 3), dtype=np.uint8))
    caps = torch.zeros((12, 16), dtype=torch.int64)
    caps[:, :3] = torch.tensor([49406, 320, 49407])
    ocfg = SimpleNamespace(lr=1e-3, beta1=0.9, beta2=0.98, eps=1e-6, wd=0.1, warmup=2,
                           skip_scheduler=False)
    prompt = np.zeros((1, 77), np.int64)
    prompt[0, :5] = [49406, 320, 1125, 539, 49407]
    out = {}
    for dev in (cuda, "cpu"):   # the CPU run trains `heads` itself, in place
        h = cast_floating(heads, torch.float32, dev)
        ddb = KnowledgeDB(db.image_db.to(dev), db.text_db.to(dev), db.names)
        opt, sched = make_optimizer(ocfg, 10, h)
        step = make_train_step(params, cfg, Retriever(ddb), opt, sched, stream="image",
                               prompt_tokens=prompt, split_id=265, dropout=0.0,
                               db_topk=8, compute_dtype=torch.float32, encode_chunk=4,
                               device=dev)
        before = {k: dict(m.launches) for k, m in (("att", att_mod.KERNEL),
                                                   ("top", topk_mod.KERNEL))}
        losses = [float(step(h, RawBatch(images.to(dev), caps.to(dev)), t)) for t in range(2)]
        if dev != "cpu":
            assert att_mod.KERNEL.launches["f32"] > before["att"]["f32"]
            assert topk_mod.KERNEL.launches["f32"] == before["top"]["f32"] + 4
        out[str(dev)] = (losses, [t.detach().cpu() for t in h.img2text["layers"][0].values()])
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=1e-5)
    for a, b in zip(out["cuda"][1], out["cpu"][1]):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-4)


def test_serve_cli_topn_above_256_on_card(cuda, tmp_path, monkeypatch):
    """The serve CLI at --topn 280 over 300 images, ranked on the device
    (k above 256): the card's results equal the CPU run's, but
    for swaps between entries within 1e-4 of each other."""
    import json

    from PIL import Image

    from keds_tpu_torch import synth
    from keds_tpu_torch.cli import serve
    from keds_tpu_torch.io.checkpoint import save_train_checkpoint
    from keds_tpu_torch.models.clip import ClipConfig

    cfg = ClipConfig(embed_dim=64, image_resolution=32, vision_layers=2,
                     vision_width=128, vision_patch_size=16, transformer_width=64,
                     transformer_heads=1, transformer_layers=2)
    params, heads, db = synth.build(cfg, db_rows=300, dtype=torch.float32, seed=8,
                                    device="cpu")
    save_train_checkpoint(str(tmp_path / "ckpt.pt"), epoch=1, name="t", clip_params=params,
                          clip_cfg=cfg, heads=heads)
    (tmp_path / "db").mkdir()
    np.save(tmp_path / "db" / "image_db.npy", db.image_db.numpy())
    np.save(tmp_path / "db" / "text_db.npy", db.text_db.numpy())
    rng = np.random.default_rng(4)
    (tmp_path / "corpus").mkdir()
    for i in range(300):
        Image.fromarray(rng.integers(0, 255, (36, 40, 3), np.uint8)).save(
            tmp_path / "corpus" / f"c{i:03d}.png")
    (tmp_path / "q.jsonl").write_text("\n".join(
        json.dumps({"image": str(tmp_path / "corpus" / f"c{i:03d}.png"),
                    "text": "a photo of * , red"}) for i in range(5)))
    import gzip

    with gzip.open(tmp_path / "merges.txt.gz", "wt") as f:   # no merges: bytes only
        f.write("#version: test\n")
    monkeypatch.setenv("KEDS_TPU_BPE_VOCAB", str(tmp_path / "merges.txt.gz"))
    monkeypatch.setattr(serve, "DEVICE_RANK_MIN_ROWS", 1)
    results = {}
    for dev in ("cuda", "cpu"):
        before = topk_mod.KERNEL.launches["f32"]
        out = serve.main(["--resume", str(tmp_path / "ckpt.pt"), "--database-path",
                          str(tmp_path / "db"), "--target-data", str(tmp_path / "corpus"),
                          "--query_file", str(tmp_path / "q.jsonl"), "--demo-out",
                          str(tmp_path / dev), "--batch-size", "4", "--db-topk", "8",
                          "--topn", "280", "--precision", "fp32", "--device", dev,
                          "--logs", str(tmp_path / "logs"), "--name", dev])
        assert out["device_ranking"] and out["topn"] == 280
        if dev == "cuda":
            # 2 batches: the ranking and the two DB searches (fp32) each
            assert topk_mod.KERNEL.launches["f32"] == before + 3 * 2
        results[dev] = [json.loads(x) for x in open(out["out_path"])]
    for g, c in zip(results["cuda"], results["cpu"]):
        gs = np.array([r["score"] for r in g["results"]])
        cs = np.array([r["score"] for r in c["results"]])
        assert len(gs) == len(cs) == 280
        np.testing.assert_allclose(gs, cs, atol=1e-4, rtol=0)
        gn = [r["name"] for r in g["results"]]
        cn = [r["name"] for r in c["results"]]
        for r in (i for i in range(280) if gn[i] != cn[i]):
            j = cn.index(gn[r]) if gn[r] in cn else 279
            assert abs(cs[j] - cs[r]) <= 1e-4


def test_sharded_topk_two_ranks_sharing_the_card(cuda, tmp_path):
    """Two gloo ranks on cuda:0 (NCCL refuses two ranks on one device), each
    running B1 over its 250 000 rows of a 500 000 x 768 bf16 DB at k=16 and
    merging the candidates: the result equals B1 over the whole DB, on both
    ranks, but for entries whose scores lie within 1e-6 of a neighbour's."""
    from torch_dist_worker import run_ranks

    outs = run_ranks("cuda_topk", tmp_path, timeout=600)
    for o in outs:
        assert (str(o["backend"]), str(o["device"])) == ("gloo", "cuda:0")
        assert int(o["shard_rows"]) == 250_000 and int(o["launches"]) == 1
    np.testing.assert_array_equal(outs[0]["idx"], outs[1]["idx"])
    np.testing.assert_array_equal(outs[0]["vals"], outs[1]["vals"])
    vals, whole = outs[0]["vals"], outs[0]["whole_vals"]
    np.testing.assert_allclose(vals, whole, rtol=0, atol=TOPK_TOL[torch.bfloat16])
    apart = np.abs(np.diff(whole, axis=1, prepend=np.inf)) > 1e-6
    apart &= np.abs(np.diff(whole, axis=1, append=-np.inf)) > 1e-6
    np.testing.assert_array_equal(outs[0]["idx"][apart], outs[0]["whole_idx"][apart])


def test_attention_head_dim_128_f32_streams_past_the_resident_limit(cuda):
    """f32 at Dh = 128 streams K and V through the ring at S = 288 and 577."""
    for s in (288, 577):
        q = torch.randn((2, 3, s, 128), generator=_gen(cuda, s), device=cuda)
        out = attention(q, 0.5 * q, q.flip(-1))
        torch.testing.assert_close(out, attention_reference(q, 0.5 * q, q.flip(-1)),
                                   atol=ATT_TOL[torch.float32], rtol=0)


def _rn_tiny():
    from keds_tpu_torch.models.clip import ClipConfig

    return ClipConfig(embed_dim=32, image_resolution=64, vision_layers=(2, 1, 1, 1),
                      vision_width=16, vision_patch_size=0, transformer_width=64,
                      transformer_heads=1, transformer_layers=1)


def test_rn_tower_bf16_on_card_matches_cpu_f32(cuda):
    """The ModifiedResNet tower (calibrated synthetic weights): the card's
    bf16 and f32 encodes against the CPU's f32 encode (cuDNN TF32 off)."""
    from keds_tpu_torch import synth
    from keds_tpu_torch.models import clip as mclip
    from keds_tpu_torch.models.convert import cast_floating

    cfg = _rn_tiny()
    params = synth.init_clip(cfg, 5, torch.device("cpu"), torch.float32)
    x = torch.randn((6, 64, 64, 3), generator=torch.Generator().manual_seed(1))
    cpu = mclip.encode_image(params, cfg, x)
    f32 = mclip.encode_image(cast_floating(params, torch.float32, cuda), cfg, x.to(cuda))
    bf16 = mclip.encode_image(cast_floating(params, torch.bfloat16, cuda), cfg, x.to(cuda))
    torch.cuda.synchronize()
    assert not torch.backends.cudnn.allow_tf32
    torch.testing.assert_close(f32.cpu(), cpu, atol=1e-4, rtol=1e-4)
    cos = torch.nn.functional.cosine_similarity(bf16.float().cpu(), cpu, dim=1)
    assert float(cos.min()) > 0.995


def test_model_surface_at_one_token_on_card_matches_cpu(cuda):
    """The visual-invert composition at mask_ratio 1 runs the vision blocks
    over the CLS token alone: B2 at S = 1 on the card, in both dtypes,
    against the CPU's f32."""
    from keds_tpu_torch import synth
    from keds_tpu_torch.models import clip as mclip, heads as mheads
    from keds_tpu_torch.models.clip import ClipConfig
    from keds_tpu_torch.models.convert import cast_floating

    cfg = ClipConfig(embed_dim=64, image_resolution=32, vision_layers=8, vision_width=128,
                     vision_patch_size=16, transformer_width=64, transformer_heads=1,
                     transformer_layers=2)
    params = synth.init_clip(cfg, 6, torch.device("cpu"), torch.float32)
    cross = synth.init_crossformer(128, 64, 1, seed=7, device=torch.device("cpu"),
                                   dtype=torch.float32)
    x = torch.randn((3, 32, 32, 3), generator=torch.Generator().manual_seed(2))
    tf = torch.randn((3, 64), generator=torch.Generator().manual_seed(3))

    def run(dev, dtype):
        p, c = cast_floating(params, dtype, dev), cast_floating(cross, dtype, dev)
        return mclip.get_visual_composed_features(
            p, cfg, tf.to(dev, dtype), x.to(dev),
            lambda q, k, v: mheads.crossformer_apply(c, q, k, v), None, 1.0)

    cpu = run("cpu", torch.float32)
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, None)):
        before = att_mod.KERNEL.launches[VARIANT[dtype]]
        out = run(cuda, dtype)
        torch.cuda.synchronize()
        assert att_mod.KERNEL.launches[VARIANT[dtype]] == before + 8
        if tol:
            torch.testing.assert_close(out.cpu(), cpu, atol=tol, rtol=tol)
        else:
            cos = torch.nn.functional.cosine_similarity(out.float().cpu(), cpu, dim=1)
            assert float(cos.min()) > 0.995


# --- int8 retrieval and W8A8 towers (library products, held to their plain versions) ---

@pytest.mark.parametrize("b", [1, 2, 16, 17])
@pytest.mark.parametrize("n", [4096, 4101])
@pytest.mark.parametrize("true_rows", [True, False])
def test_int8_search_matches_plain(cuda, b, n, true_rows):
    """torch._int_mm with its rows (B <= 16) and ragged columns (N % 8)
    padded equals the float64 plain product; the whole search agrees index
    for index."""
    from keds_tpu_torch.ops.quant import INT8_MM

    db = _unit(n, 768, torch.bfloat16, cuda, n)
    q = _unit(b, 768, torch.bfloat16, cuda, b + 7)
    q8, sc = topk_mod.quantize_int8(db)
    before = INT8_MM.launches["retrieval"]
    for k in (16, 2):
        got = topk_mod.mips_topk_int8(q.float(), q8, sc, k, db=db if true_rows else None)
        want = topk_mod.mips_topk_int8(q.float(), q8, sc, k, db=db if true_rows else None,
                                       plain=True)
        torch.cuda.synchronize()
        assert torch.equal(got[1], want[1])
        assert torch.equal(got[0], want[0])
    assert INT8_MM.launches["retrieval"] == before + 2 * (1 + (n % 8 > 0))


def test_int8_search_duplicated_rows_keep_the_lower_index(cuda):
    half = _unit(2048, 768, torch.bfloat16, cuda, 1)
    db = torch.cat([half, half])
    q = _unit(9, 768, torch.bfloat16, cuda, 2)
    q8, sc = topk_mod.quantize_int8(db)
    for oversample in (1, 4):
        vals, idx = topk_mod.mips_topk_int8(q.float(), q8, sc, 16, oversample, db=db)
        pv, pidx = topk_mod.mips_topk_int8(q.float(), q8, sc, 16, oversample, db=db,
                                           plain=True)
        torch.cuda.synchronize()
        assert torch.equal(idx, pidx)
        # a row and its copy tie: the lower index comes first, the copy next
        assert (idx[:, 0::2] < 2048).all() and torch.equal(idx[:, 1::2], idx[:, 0::2] + 2048)


def test_quantize_int8_card_equals_cpu(cuda):
    db = _unit(5000, 768, torch.bfloat16, cuda, 3)
    q8, sc = topk_mod.quantize_int8(db)
    c8, csc = topk_mod.quantize_int8(db.cpu())
    assert torch.equal(q8.cpu(), c8) and torch.equal(sc.cpu(), csc)


@pytest.mark.parametrize("depth", [100, 7])
def test_int8_matmul_takes_any_depth(cuda, depth):
    """A depth off torch._int_mm's step of 8 is zero-padded: the integer
    product equals the float64 plain one exactly, and the pad is counted."""
    from keds_tpu_torch.ops.quant import INT8_MM, int8_matmul, int8_matmul_plain

    gen = _gen(cuda, depth)
    a = torch.randint(-127, 128, (32, depth), generator=gen, device=cuda).to(torch.int8)
    b = torch.randint(-127, 128, (61, depth), generator=gen, device=cuda).to(torch.int8)
    pads = INT8_MM.pads["linear"]
    got = int8_matmul(a, b.T)
    torch.cuda.synchronize()
    assert torch.equal(got, int8_matmul_plain(a, b.T))
    assert INT8_MM.pads["linear"] == pads + 1


def test_int8_retriever_at_depth_100_equals_cpu(cuda):
    """The int8 Retriever pads its tables once (depth 104), so its searches
    pad only the queries; neighbours equal the CPU's."""
    import numpy as np

    from keds_tpu_torch.ops.quant import INT8_MM
    from keds_tpu_torch.retrieval.database import KnowledgeDB, Retriever

    rng = np.random.default_rng(5)
    img, txt = (rng.standard_normal((4096, 100)).astype(np.float32) for _ in range(2))
    q = torch.from_numpy(rng.standard_normal((32, 100)).astype(np.float32))
    card = Retriever(KnowledgeDB.from_arrays(img, txt, dtype=torch.float32, device=cuda),
                     "int8")
    cpu = Retriever(KnowledgeDB.from_arrays(img, txt, dtype=torch.float32, device="cpu"),
                    "int8")
    assert card.quant_arrays()[0][0].shape == (4096, 104)
    INT8_MM.reset()
    for name in ("image", "text"):
        table = getattr(card.db, f"{name}_db")
        vals, idx = card.search(q.to(cuda), table, 16, name)
        pv, pi = cpu.search(q, getattr(cpu.db, f"{name}_db"), 16, name)
        torch.cuda.synchronize()
        # the re-rank sums 100 f32 products in another order on the CPU
        torch.testing.assert_close(vals.cpu(), pv, atol=1e-5, rtol=0)
        gaps = pv[:, :-1] - pv[:, 1:] > 1e-5
        sep = torch.ones_like(pi, dtype=torch.bool)
        sep[:, :-1] &= gaps
        sep[:, 1:] &= gaps
        assert bool(((idx.cpu() == pi) | ~sep).all())
    assert INT8_MM.launches["retrieval"] == 2 and INT8_MM.pads["queries"] == 2
    assert INT8_MM.pads["retrieval"] == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("d", [100, 96, 1280])
@pytest.mark.parametrize("k", [1, 16, 32, 101])
def test_topk_any_depth_matches_plain(cuda, dtype, d, k):
    """Any D on the card: off the kernel's depth step the wrapper zero-pads
    (counted in KERNEL.pads), and bf16 above TC_MAX_DIM takes the wide
    CUDA-core kernel at any k; held to the plain version on the unpadded
    inputs."""
    q, db = _unit(37, d, dtype, cuda, d + k), _unit(3001, d, dtype, cuda, d)
    tiling, _ = split_plan(37, 3001, _sms(cuda), dtype, k, d)
    wide = k > topk_mod.LANE_K or (dtype == torch.bfloat16 and d > topk_mod.TC_MAX_DIM)
    assert tiling.variant == (WIDE_VARIANT if wide else VARIANT)[dtype]
    padded = topk_mod.kernel_depth(tiling, d) != d
    assert padded == (d % (64 if dtype == torch.bfloat16 else 16) != 0)
    launches, pads = topk_mod.KERNEL.launches[tiling.variant], topk_mod.KERNEL.pads[tiling.variant]
    vals, idx = mips_topk(q, db, k)
    torch.cuda.synchronize()
    assert topk_mod.KERNEL.launches[tiling.variant] == launches + 1
    assert topk_mod.KERNEL.pads[tiling.variant] == pads + padded
    _assert_topk_agrees(vals, idx, q, db, k, TOPK_TOL[dtype])


def test_topk_sharded_any_depth(cuda):
    """mips_topk_sharded passes a D of 100 through to B1 on its shard."""
    from keds_tpu_torch.ops.topk import mips_topk_sharded
    from keds_tpu_torch.parallel.mesh import Mesh

    q, db = _unit(9, 100, torch.bfloat16, cuda, 1), _unit(2000, 100, torch.bfloat16, cuda, 2)
    pads = topk_mod.KERNEL.pads["bf16_tc"]
    vals, idx = mips_topk_sharded(q, db, 16, Mesh(0, 1, cuda), n_real=1990)
    torch.cuda.synchronize()
    assert topk_mod.KERNEL.pads["bf16_tc"] == pads + 1
    _assert_topk_agrees(vals, idx, q, db[:1990], 16, TOPK_TOL[torch.bfloat16])


@pytest.mark.parametrize("rows", [5, 77 * 4, 257 * 2])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_int8_linear_card_equals_cpu(cuda, rows, dtype):
    """The same input on the card and the CPU: the activation quantization,
    the integer product and the f32 dequantization are the same operations,
    so the results agree bit for bit."""
    from keds_tpu_torch.ops.quant import INT8_MM, int8_linear, quantize_weight

    x = torch.randn((rows, 1024), generator=_gen(cuda, rows), device=cuda).to(dtype)
    w = torch.randn((1024, 3072), generator=_gen(cuda, 1), device=cuda) * 0.03
    b = torch.randn((3072,), generator=_gen(cuda, 2), device=cuda)
    wq = quantize_weight(w)
    before = INT8_MM.launches["linear"]
    got = int8_linear(x, wq, b)
    want = int8_linear(x.cpu(), {k: t.cpu() for k, t in wq.items()}, b.cpu())
    torch.cuda.synchronize()
    assert INT8_MM.launches["linear"] == before + 1
    assert torch.equal(got.cpu(), want)


def test_tiny_int8_tower_engine_card_matches_cpu(cuda):
    """The engine with W8A8 towers and the int8 retriever at a tiny size in
    f32, card vs CPU.  Activations at a rounding boundary of their token's
    int8 grid may round one step the other way (the f32 sums before them run
    in another order), hence 2e-3."""
    from keds_tpu_torch import synth
    from keds_tpu_torch.engine import ComposedQueryEngine
    from keds_tpu_torch.models.clip import ClipConfig
    from keds_tpu_torch.models.convert import cast_floating
    from keds_tpu_torch.ops.quant import INT8_MM
    from keds_tpu_torch.retrieval.database import KnowledgeDB, Retriever

    cfg = ClipConfig(embed_dim=64, image_resolution=32, vision_layers=2,
                     vision_width=128, vision_patch_size=16, transformer_width=64,
                     transformer_heads=1, transformer_layers=2)
    params, heads, db = synth.build(cfg, db_rows=300, dtype=torch.float32, seed=3,
                                    device="cpu")
    rng = np.random.default_rng(0)
    images = [rng.integers(0, 256, (4, 32, 32, 3), dtype=np.uint8)]
    text = np.zeros((4, 77), np.int32)
    text[:, :6] = [49406, 320, 1125, 539, 265, 267]
    text[:, 6:12] = rng.integers(1000, 40000, (4, 6))
    text[:, 12] = 49407
    out = {}
    before = dict(INT8_MM.launches)
    for dev in ("cpu", cuda):
        ddb = KnowledgeDB(db.image_db.to(dev), db.text_db.to(dev), db.names)
        eng = ComposedQueryEngine(cast_floating(params, torch.float32, dev), cfg,
                                  cast_floating(heads, torch.float32, dev), ddb,
                                  retriever=Retriever(ddb, "int8"), quant_towers="int8",
                                  split_id=265, compute_dtype=torch.float32,
                                  db_topk=8, encode_chunk=2, device=dev)
        out[str(dev)] = (eng.encode_corpus(images), eng.compose(images, [text]))
    torch.cuda.synchronize()
    assert INT8_MM.launches["linear"] > before["linear"]
    assert INT8_MM.launches["retrieval"] > before["retrieval"]
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], atol=2e-3)
    np.testing.assert_allclose(out["cuda"][1], out["cpu"][1], atol=2e-3)


@pytest.mark.parametrize("tool,ranking", [("cirr", "device"), ("cirr", "host"),
                                          ("coco", "device"), ("coco", "host")])
def test_fullscale_benches_at_tiny_scale_card_equal_cpu(cuda, tmp_path, monkeypatch, tool,
                                                        ranking):
    """bench_cirr_fullscale and bench_coco_fullscale at the JAX tools' tiny
    scale (f32), staged once with the card's weights: the run on cuda:0
    launches B1 and B2 and gives the recall tables of the same files on the
    CPU."""
    import gzip

    from keds_tpu_torch.evalkit import evaluators as ev
    from keds_tpu_torch.tools import bench_cirr_fullscale, bench_coco_fullscale

    with gzip.open(tmp_path / "merges.txt.gz", "wt") as f:   # no merges: bytes only
        f.write("#version: test\n")
    monkeypatch.setenv("KEDS_TPU_BPE_VOCAB", str(tmp_path / "merges.txt.gz"))
    main = {"cirr": bench_cirr_fullscale, "coco": bench_coco_fullscale}[tool].main
    sizes = {"cirr": ["--queries", "6", "--corpus", "8"], "coco": ["--rows", "8"]}[tool]
    name = f"evaluate_{tool}"
    real, tables = getattr(ev, name), []

    def record(*args, **kw):
        tables.append(real(*args, **kw))
        return tables[-1]

    monkeypatch.setattr(ev, name, record)
    for dev in ("cuda", "cpu"):
        before = (sum(topk_mod.KERNEL.launches.values()),
                  sum(att_mod.KERNEL.launches.values()))
        main(["--workdir", str(tmp_path / "fs"), "--model-scale", "tiny", *sizes,
              "--db-rows", "64", "--epochs", "2", "--image-px", "32", "--batch-size", "4",
              "--workers", "0", "--precision", "fp32", "--eval-ranking", ranking,
              "--device", dev])
        torch.cuda.synchronize()
        if dev == "cuda":
            assert sum(topk_mod.KERNEL.launches.values()) > before[0]
            assert sum(att_mod.KERNEL.launches.values()) > before[1]
    assert len(tables) == 2 and tables[0] == tables[1]
    assert {j for j, _ in tables[0]} == {1, 2}


def _tf32(x):
    """x with its low 13 mantissa bits cleared: the operand a TF32 product sees."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


@pytest.mark.parametrize("dh", [1, 33, 100, 128])
@pytest.mark.parametrize("s", [288, 289, 577])
def test_attention_f32_head_dims_off_the_tile(cuda, dh, s):
    """f32 at a head dimension the kernel pads (to 32, 64 or 128, zero in
    shared memory), strided views of one qkv buffer, causal and not."""
    qkv = torch.randn((2, s, 3, 3, dh), generator=_gen(cuda, s + dh), device=cuda)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    for causal in (False, True):
        out = attention(q, k, v, causal)
        torch.cuda.synchronize()
        assert out.shape == (2, 3, s, dh)
        torch.testing.assert_close(out, attention_reference(q, k, v, causal),
                                   atol=ATT_TOL[torch.float32], rtol=0)


def _attention_f64(q, k, v, causal):
    q, k, v = q.double(), k.double(), v.double()
    s = q @ k.transpose(-1, -2) / q.shape[-1] ** 0.5
    if causal:
        s = s + att_mod.causal_mask(s.shape[-1], s.device).double()
    return torch.softmax(s, -1) @ v


@pytest.mark.parametrize("s", [77, 289, 577])
@pytest.mark.parametrize("causal", [False, True])
def test_attention_f32_near_one_hot_softmax(cuda, s, causal):
    """q scaled by 8: each row's softmax is nearly one-hot, so a score's
    rounding moves the output most: f32 math in any order is 1e-5 to 3e-5
    off float64 here, the plain version too.  So both are held to float64:
    the kernel's products keep about 22 bits where f32's keep 24, and its
    sums run in another order, so it stays within three times the plain
    version's error (measured up to twice on the H100)."""
    qkv = torch.randn((2, s, 3, 4, 64), generator=_gen(cuda, s), device=cuda)
    qkv[:, :, 0] *= 8
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    out = attention(q, k, v, causal)
    exact = _attention_f64(q, k, v, causal)
    plain = attention_reference(q, k, v, causal)
    torch.cuda.synchronize()
    err, plain_err = ((x.double() - exact).abs().max().item() for x in (out, plain))
    assert err <= 3 * plain_err + 1e-6, (err, plain_err)


@pytest.mark.parametrize("s", [129, 257, 577])
def test_attention_backward_f32_streamed_near_one_hot_softmax(cuda, s):
    qkv = torch.randn((2, s, 3, 4, 64), generator=_gen(cuda, s), device=cuda)
    qkv[:, :, 0] *= 8
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    dout = torch.randn((2, 4, s, 64), generator=_gen(cuda, s + 1), device=cuda)
    for causal in (False, True):
        _check_backward(q, k, v, dout, causal)


@pytest.mark.parametrize("b,h,s,dh,causal", [
    *((b, h, s, 64, True) for b, h in ((1, 1), (40, 16)) for s in (8, 77, 289)),
    # the f32 wide-head kernels' timed rows: ViT-L/14's vision chunk in
    # 256-wide heads, the image stream's prompt and the neighbour templates
    # in 128-wide heads (forward on the tuned kernel there)
    (16, 4, 257, 256, False), (128, 6, 8, 128, True), (256, 6, 32, 128, True)])
def test_attention_f32_batch_heads(cuda, b, h, s, dh, causal):
    """B*H = 1 (the keys split over four warps) and 640, above 132 SMs x 4
    warps (one warp a tile), and the f32 rows of kernel_sweeps.py off Dh =
    64, forward and backward."""
    _, (q, k, v), dout = _head_qkv(cuda, b, h, s, dh, torch.float32, 70 + s)
    out = attention(q, k, v, causal)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, attention_reference(q, k, v, causal),
                               atol=ATT_TOL[torch.float32], rtol=0)
    _check_backward(q, k, v, dout, causal)


@pytest.mark.parametrize("s", [8, 77, 289, 577])
def test_attention_backward_f32_is_deterministic(cuda, s):
    """No atomics, and the splits merge in a fixed order: two calls agree
    bit for bit."""
    _, (q, k, v), dout = _grad_inputs(cuda, 4, 12, s, torch.float32, 80)
    first = att_mod.attention_backward(q, k, v, dout, s % 2 == 1)
    second = att_mod.attention_backward(q, k, v, dout, s % 2 == 1)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dh", [64, 80, 128, 160, 256])
@pytest.mark.parametrize("s", [77, 257, 577])
def test_attention_f32_is_not_tf32(cuda, s, dh):
    """The f32 kernels keep f32's precision where TF32 would not: on inputs
    whose low mantissa bits matter (uniform in [1, 2), so that TF32 keeps
    only 10 of 23 fraction bits), the kernels' error against the plain
    version is at most a tenth of the error of the plain version run on the
    same inputs cut to TF32, forward and backward, at every f32 route (the
    wide-head kernels above Dh = 128 forward, 64 backward)."""
    gen = _gen(cuda, s)
    q, k, v, dout = (1 + torch.rand((2, 4, s, dh), generator=gen, device=cuda)
                     for _ in range(4))
    q = q - 1.5                          # scores of both signs
    out = attention(q, k, v, True)
    ref = attention_reference(q, k, v, True)
    cut = attention_reference(_tf32(q), _tf32(k), _tf32(v), True)
    grads = att_mod.attention_backward(q, k, v, dout, True)
    gref = att_mod.attention_reference_backward(q, k, v, dout, True)
    gcut = att_mod.attention_reference_backward(*map(_tf32, (q, k, v, dout)), True)
    torch.cuda.synchronize()
    assert (out - ref).abs().max() <= 0.1 * (cut - ref).abs().max()
    for g, r, c in zip(grads, gref, gcut):
        assert (g - r).abs().max() <= 0.1 * (c - r).abs().max()


# --- every head width (B2 and B2' at Dh != 64, unaligned rows) ----------------

# past the tuned width (65, 72), widths that are no multiple of 16 (72, 100,
# 200, 1000), rows that are not 16-byte aligned (65, 100: bf16 copies them),
# and more than one 128-column chunk of the bf16 wide kernels (160 and up;
# 1000: eight)
HEAD_WIDTHS = [1, 32, 48, 65, 72, 80, 96, 100, 128, 160, 200, 256, 320, 1000]


def _fwd_variant(dtype, dh, s):
    """The forward route the library gives (its card test below) and
    whether the wrapper pads: bf16 Dh <= 64 runs the tensor-core kernels at
    its own width up to 288 keys, padded to 64 above them; f32 runs Dh <=
    128 itself; wider heads take the wide-head kernel."""
    if dtype == torch.bfloat16:
        return ("bf16_tc", dh < 64 and s > 288) if dh <= 64 else ("bf16_wide", False)
    return ("f32", False) if dh <= 128 else ("f32_wide", False)


def _bwd_variant(dtype, dh, s):
    """As _fwd_variant for the backward: bf16 Dh < 64 pads above 128 keys
    (the streamed pair), f32 Dh < 64 at every S."""
    name = "bf16" if dtype == torch.bfloat16 else "f32"
    if dh > 64:
        return name + "_wide", False
    stream = name == "bf16" and s > 128
    return name + ("_stream" if stream else ""), dh < 64 and (stream or name == "f32")


def _runs_at(dtype, dh, padded, f32_widths=(32, 64, 128)):
    """The head width a route runs at: 64 where padded; bf16 at Dh rounded
    up to 16; f32 at 32, 64 or 128 (the forward's tuned kernel; the
    backward's 64), wider f32 heads at Dh rounded up to 8."""
    if padded:
        return 64
    if dtype == torch.bfloat16:
        return -(-dh // 16) * 16
    return next((w for w in f32_widths if dh <= w), -(-dh // 8) * 8)


def _head_qkv(dev, b, h, s, dh, dtype, seed, grad=False):
    """Strided q/k/v views of one (B, S, 3, H, Dh) buffer, and a (B, H, S,
    Dh) view of a (B, S, H, Dh) output gradient."""
    qkv = torch.randn((b, s, 3, h, dh), generator=_gen(dev, seed), device=dev).to(dtype)
    qkv.requires_grad_(grad)
    dout = torch.randn((b, s, h, dh), generator=_gen(dev, seed + 1),
                       device=dev).to(dtype).transpose(1, 2)
    return qkv, tuple(qkv[:, :, i].transpose(1, 2) for i in range(3)), dout


def test_attention_routes_by_head_width(cuda):
    """The libraries' routes and widths are the ones the tests expect."""
    import ctypes

    out = (ctypes.c_int * 3)()
    ptr = ctypes.cast(out, ctypes.c_void_p)
    fwd, bwd = att_mod.KERNEL.lib(), att_mod.BWD_KERNEL.lib()
    for dtype, code in ((torch.float32, 0), (torch.bfloat16, 1)):
        for dh in range(1, 300):
            for s in (1, 77, 128, 129, 288, 289):
                route = fwd.keds_attention_fwd_route(code, dh, s, ptr)
                variant, padded = _fwd_variant(dtype, dh, s)
                assert ("f32", "bf16_tc", variant)[route] == variant
                assert out[0] == (64 if padded else dh)
                assert out[1] == _runs_at(dtype, dh, padded)
                route = bwd.keds_attention_bwd_route(code, dh, s, ptr)
                variant, padded = _bwd_variant(dtype, dh, s)
                assert route == int(dh > 64) and out[0] == (64 if padded else dh)
                assert out[1] == _runs_at(dtype, dh, padded, (64,))
                assert out[2] == (s if dh > 64 else _bwd_plan(s, dtype, out[0])[4])
        assert fwd.keds_attention_fwd_route(code, 0, 8, ptr) < 0
        assert fwd.keds_attention_fwd_route(code, 64, 0, ptr) < 0
        assert bwd.keds_attention_bwd_route(code, 0, 8, ptr) < 0
        assert bwd.keds_attention_bwd_route(code, 64, 0, ptr) < 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("dh", HEAD_WIDTHS)
@pytest.mark.parametrize("s", [1, 8, 77, 300])
@pytest.mark.parametrize("causal", [False, True])
def test_attention_every_head_width_matches_plain(cuda, dtype, dh, s, causal):
    """B2 at every head width: strided views of one qkv buffer, one launch of
    the route's variant (a pad counted below Dh = 64 in bf16)."""
    _, (q, k, v), _ = _head_qkv(cuda, 2, 3, s, dh, dtype, s + dh)
    variant, padded = _fwd_variant(dtype, dh, s)
    launches, pads = dict(att_mod.KERNEL.launches), dict(att_mod.KERNEL.pads)
    out = attention(q, k, v, causal)
    torch.cuda.synchronize()
    assert att_mod.KERNEL.launches == dict(launches, **{variant: launches[variant] + 1})
    assert att_mod.KERNEL.pads[variant] == pads[variant] + padded
    assert out.shape == q.shape and out.dtype == dtype
    torch.testing.assert_close(out.float(), attention_reference(q, k, v, causal).float(),
                               atol=ATT_TOL[dtype], rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("dh", HEAD_WIDTHS)
@pytest.mark.parametrize("s", [1, 8, 77, 300])
@pytest.mark.parametrize("causal", [False, True])
def test_attention_backward_every_head_width_matches_plain(cuda, dtype, dh, s, causal):
    """B2' at every head width through autograd, as the towers reach it; two
    calls agree bit for bit (no atomics on any route)."""
    qkv, (q, k, v), dout = _head_qkv(cuda, 2, 3, s, dh, dtype, s + dh, grad=True)
    variant, padded = _bwd_variant(dtype, dh, s)
    launches, pads = dict(att_mod.BWD_KERNEL.launches), dict(att_mod.BWD_KERNEL.pads)
    grads = torch.autograd.grad(attention(q, k, v, causal), (q, k, v), dout)
    again = att_mod.attention_backward(q, k, v, dout, causal)
    torch.cuda.synchronize()
    assert att_mod.BWD_KERNEL.launches == dict(launches, **{variant: launches[variant] + 2})
    assert att_mod.BWD_KERNEL.pads[variant] == pads[variant] + 2 * padded
    ref = att_mod.attention_reference_backward(q, k, v, dout, causal)
    atol, rtol = BWD_TOL[dtype]
    for g, a, r in zip(grads, again, ref):
        assert g.shape == r.shape and g.dtype == dtype
        assert torch.equal(g, a)
        torch.testing.assert_close(g.float(), r.float(), atol=atol, rtol=rtol)


# bf16 heads narrower than 64 on the resident kernels, at Dh rounded up to
# 16: every width class (8 and 63 off any 16-column step, 63 off the 16-byte
# rows too), keys up to each resident kernel's limit
NARROW_WIDTHS = [8, 16, 24, 32, 40, 48, 56, 63]


@pytest.mark.parametrize("dh", NARROW_WIDTHS)
@pytest.mark.parametrize("s", [1, 8, 32, 77, 128])
@pytest.mark.parametrize("causal", [False, True])
def test_attention_narrow_heads_match_plain(cuda, dh, s, causal):
    """B2 and B2' in bf16 at Dh < 64: one launch each, nothing padded, the
    results views of (B, S, H, Dh) and (B, S, 3, H, Dh) buffers, held to
    the plain version at ATT_TOL and BWD_TOL; two backward calls agree bit
    for bit."""
    qkv, (q, k, v), dout = _head_qkv(cuda, 3, 5, s, dh, torch.bfloat16, 7 * s + dh, grad=True)
    counts = [dict(c) for c in (att_mod.KERNEL.launches, att_mod.KERNEL.pads,
                                att_mod.BWD_KERNEL.launches, att_mod.BWD_KERNEL.pads)]
    out = attention(q, k, v, causal)
    grads = torch.autograd.grad(out, (q, k, v), dout)
    again = att_mod.attention_backward(q, k, v, dout, causal)
    torch.cuda.synchronize()
    fl, fp, bl, bp = counts
    assert att_mod.KERNEL.launches == dict(fl, bf16_tc=fl["bf16_tc"] + 1)
    assert att_mod.BWD_KERNEL.launches == dict(bl, bf16=bl["bf16"] + 2)
    assert (att_mod.KERNEL.pads, att_mod.BWD_KERNEL.pads) == (fp, bp)
    assert out.stride() == (s * 5 * dh, dh, 5 * dh, 1)
    torch.testing.assert_close(out.float(), attention_reference(q, k, v, causal).float(),
                               atol=ATT_TOL[torch.bfloat16], rtol=0)
    ref = att_mod.attention_reference_backward(q, k, v, dout, causal)
    atol, rtol = BWD_TOL[torch.bfloat16]
    for g, a, r in zip(again, grads, ref):
        assert g.shape == r.shape and g.stride() == (s * 15 * dh, dh, 15 * dh, 1)
        assert torch.equal(g, a)
        torch.testing.assert_close(g.float(), r.float(), atol=atol, rtol=rtol)


@pytest.mark.parametrize("shape", [(0, 2, 5, 64), (2, 0, 77, 32), (0, 3, 300, 24),
                                   (0, 1, 9, 80)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_attention_empty_batch_launches_nothing(cuda, shape, dtype):
    """B * H = 0 on the card: empty results of the usual layout on the
    device, nothing launched, forward, backward and through autograd."""
    counts = [dict(c) for c in (att_mod.KERNEL.launches, att_mod.BWD_KERNEL.launches)]
    B, H, S, Dh = shape
    qkv = torch.zeros((B, S, 3, H, Dh), device=cuda, dtype=dtype, requires_grad=True)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    out = attention(q, k, v, True)
    grads = att_mod.attention_backward(q, k, v, out, True)
    out.sum().backward()
    torch.cuda.synchronize()
    for t in (out, *grads):
        assert t.shape == shape and t.dtype == dtype and t.device.type == "cuda"
    assert qkv.grad.shape == qkv.shape
    assert counts == [dict(c) for c in (att_mod.KERNEL.launches, att_mod.BWD_KERNEL.launches)]


@pytest.mark.parametrize("tiling", topk_mod.TILINGS, ids=lambda t: f"code{t.code}")
@pytest.mark.parametrize("b,k", [(4, 0), (0, 4), (0, 0)])
def test_topk_empty_launches_nothing(cuda, tiling, b, k):
    """k = 0 and B = 0 in every tiling, and through mips_topk (D = 100, off
    every depth step): (B, k) f32 values and int32 indices on the device, no
    launch, no pad."""
    dtype = torch.bfloat16 if tiling.variant.startswith("bf16") else torch.float32
    q, db = _unit(4, 128, dtype, cuda, 5)[:b], _unit(300, 128, dtype, cuda, 6)
    counts = [dict(c) for c in (topk_mod.KERNEL.launches, topk_mod.GRID_LAUNCHES,
                                topk_mod.KERNEL.pads)]
    results = [topk_mod.launch(q, db, k, tiling, 2 if tiling is topk_mod.TC else 1),
               mips_topk(q[:, :100].contiguous(), db[:, :100].contiguous(), k)]
    torch.cuda.synchronize()
    for vals, idx in results:
        assert vals.shape == idx.shape == (b, k)
        assert (vals.dtype, idx.dtype) == (torch.float32, torch.int32)
        assert vals.device.type == idx.device.type == "cuda"
    assert counts == [dict(c) for c in (topk_mod.KERNEL.launches, topk_mod.GRID_LAUNCHES,
                                        topk_mod.KERNEL.pads)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("dh", [32, 64, 80])
@pytest.mark.parametrize("s", [77, 300])
def test_attention_unaligned_rows_every_route(cuda, dtype, dh, s):
    """x[..., :Dh] views of (..., Dh + 1) tensors: rows that are not 16-byte
    aligned (every bf16 kernel takes a copy with aligned rows; the f32
    routes read them in place), forward and backward."""
    base = torch.randn((3, 2, 3, s, dh + 1), generator=_gen(cuda, s * dh), device=cuda)
    q, k, v = (base[i].to(dtype)[..., :dh] for i in range(3))
    assert k.stride(2) * k.element_size() % 16
    for causal in (False, True):
        out = attention(q, k, v, causal)
        torch.testing.assert_close(out.float(), attention_reference(q, k, v, causal).float(),
                                   atol=ATT_TOL[dtype], rtol=0)
        _check_backward(q, k, v, v.flip(2), causal)


def test_attention_padded_head_grad_reaches_the_qkv_projection(cuda):
    """One autograd run from a loss back to a bf16 qkv projection's weight
    at Dh = 32 (the resident kernels at their own width) and Dh = 80
    (wide): the qkv activations' gradient
    equals the plain version's at BWD_TOL, and the weight's points as its
    does (cosine >= 0.999)."""
    for dh, variant in ((32, "bf16"), (80, "bf16_wide")):
        h, width = 2, 2 * dh
        gen = _gen(cuda, dh)
        x = torch.randn((4, 77, width), generator=gen, device=cuda).to(torch.bfloat16)
        w0 = (torch.randn((3 * width, width), generator=gen, device=cuda)
              / width ** 0.5).to(torch.bfloat16)
        target = torch.randn((4, 77, width), generator=gen, device=cuda)
        grads = []
        for fn in (attention, attention_reference):
            w = w0.clone().requires_grad_(True)
            qkv = (x @ w.t()).view(4, 77, 3, h, dh)
            qkv.retain_grad()
            out = fn(*(qkv[:, :, i].transpose(1, 2) for i in range(3)), True)
            bwd0 = att_mod.BWD_KERNEL.launches[variant]
            (out.transpose(1, 2).reshape(4, 77, width).float() * target).sum().backward()
            torch.cuda.synchronize()
            assert att_mod.BWD_KERNEL.launches[variant] == bwd0 + (fn is attention)
            grads.append((qkv.grad.float(), w.grad.float()))
        (g_qkv, g_w), (r_qkv, r_w) = grads
        atol, rtol = BWD_TOL[torch.bfloat16]
        torch.testing.assert_close(g_qkv, r_qkv, atol=atol, rtol=rtol)
        cos = float((g_w * r_w).sum() / (g_w.norm() * r_w.norm()))
        assert cos >= 0.999, (dh, cos)


# tests/test_api_surface.py's tiny config: text width 64 over 2 heads (Dh =
# 32), vision width 64 (one head of 64)
_API_CFG = dict(embed_dim=64, image_resolution=32, vision_layers=2, vision_width=64,
                vision_patch_size=16, transformer_width=64, transformer_heads=2,
                transformer_layers=2)


def test_api_surface_tiny_config_engine_card_matches_cpu(cuda):
    """The JAX tests' tiny config, whose text tower has Dh = 32, through
    ComposedQueryEngine on the card: f32 (the f32 kernel takes Dh = 32
    itself) equals the CPU's f32, and bf16 (the tensor-core kernel at Dh =
    32, launched, nothing padded) points as it does."""
    from keds_tpu_torch import synth
    from keds_tpu_torch.engine import ComposedQueryEngine
    from keds_tpu_torch.models.clip import ClipConfig
    from keds_tpu_torch.models.convert import cast_floating
    from keds_tpu_torch.retrieval.database import KnowledgeDB

    cfg = ClipConfig(**_API_CFG)
    params, heads, db = synth.build(cfg, db_rows=300, dtype=torch.float32, seed=7,
                                    device="cpu")
    rng = np.random.default_rng(1)
    images = [rng.integers(0, 256, (4, 32, 32, 3), dtype=np.uint8)]
    text = np.zeros((4, 77), np.int32)
    text[:, :6] = [49406, 320, 1125, 539, 265, 267]
    text[:, 6:12] = rng.integers(1000, 40000, (4, 6))
    text[:, 12] = 49407
    out = {}
    for dev, dtype in (("cpu", torch.float32), (cuda, torch.float32), (cuda, torch.bfloat16)):
        ddb = KnowledgeDB(db.image_db.to(dev, dtype), db.text_db.to(dev, dtype), db.names)
        eng = ComposedQueryEngine(cast_floating(params, dtype, dev), cfg,
                                  cast_floating(heads, torch.float32, dev), ddb,
                                  split_id=265, compute_dtype=dtype, db_topk=8,
                                  encode_chunk=2, device=dev)
        pads, launches = att_mod.KERNEL.pads["bf16_tc"], att_mod.KERNEL.launches["bf16_tc"]
        out[(str(dev), dtype)] = eng.compose(images, [text])
        if dtype == torch.bfloat16:
            torch.cuda.synchronize()
            assert att_mod.KERNEL.pads["bf16_tc"] == pads
            assert att_mod.KERNEL.launches["bf16_tc"] > launches
    cpu = out[("cpu", torch.float32)]
    np.testing.assert_allclose(out[("cuda", torch.float32)], cpu, atol=1e-4)
    card = np.asarray(out[("cuda", torch.bfloat16)], np.float64)
    cos = (card * cpu).sum(-1) / np.linalg.norm(card, axis=-1) / np.linalg.norm(cpu, axis=-1)
    assert cos.min() >= 0.99, cos


def test_api_surface_tiny_config_bf16_train_step_card_matches_cpu(cuda):
    """One bf16 image-stream train step of the tiny config on the card (the
    text tower's forward and backward at Dh = 32, nothing padded) against
    the CPU's f32 step: loss within 1 %, head gradients' cosine >= 0.99
    (train_check's limits)."""
    from types import SimpleNamespace

    from keds_tpu_torch import synth
    from keds_tpu_torch.models.clip import ClipConfig
    from keds_tpu_torch.models.convert import cast_floating
    from keds_tpu_torch.retrieval.database import KnowledgeDB, Retriever
    from keds_tpu_torch.train.losses import TrainBatch
    from keds_tpu_torch.train.trainer import make_optimizer, make_train_step

    cfg = ClipConfig(**_API_CFG)
    params, heads, db = synth.build(cfg, db_rows=300, dtype=torch.float32, seed=9,
                                    device="cpu")
    img, cap = synth.feature_pairs(16, 64, 11, torch.device("cpu"))
    # one neighbour set for both devices (a bf16 search may order near-ties
    # otherwise)
    q = img / img.norm(dim=1, keepdim=True)
    idx = [mips_topk(q, a, 8)[1] for a in (db.image_db, db.text_db)]
    ocfg = SimpleNamespace(lr=1e-3, beta1=0.9, beta2=0.98, eps=1e-6, wd=0.1, warmup=2,
                           skip_scheduler=False)
    prompt = np.zeros((1, 77), np.int64)
    prompt[0, :5] = [49406, 320, 1125, 539, 49407]
    out = {}
    for dev, dtype in ((cuda, torch.bfloat16), ("cpu", torch.float32)):
        h = cast_floating(heads, torch.float32, dev)
        ddb = KnowledgeDB(db.image_db.to(dev, dtype), db.text_db.to(dev, dtype), db.names)
        opt, sched = make_optimizer(ocfg, 10, h)
        step = make_train_step(cast_floating(params, dtype, dev), cfg, Retriever(ddb), opt,
                               sched, stream="image", prompt_tokens=prompt, split_id=265,
                               dropout=0.0, db_topk=8, compute_dtype=dtype, device=dev)
        fwd, bwd = att_mod.KERNEL.launches["bf16_tc"], att_mod.BWD_KERNEL.launches["bf16"]
        pads = att_mod.KERNEL.pads["bf16_tc"], att_mod.BWD_KERNEL.pads["bf16"]
        loss = float(step(h, TrainBatch(img.to(dev), cap.to(dev), img_idx=idx[0].to(dev),
                                        txt_idx=idx[1].to(dev)), 0))
        grad = torch.cat([p.grad.detach().double().cpu().flatten()
                          for p in h.img2text["layers"][0].values()])
        if dev != "cpu":
            torch.cuda.synchronize()
            assert att_mod.KERNEL.launches["bf16_tc"] > fwd
            assert att_mod.BWD_KERNEL.launches["bf16"] == bwd + cfg.transformer_layers
            assert (att_mod.KERNEL.pads["bf16_tc"], att_mod.BWD_KERNEL.pads["bf16"]) == pads
        out[str(dev)] = loss, grad
    (l_card, g_card), (l_cpu, g_cpu) = out["cuda"], out["cpu"]
    assert abs(l_card - l_cpu) <= 0.01 * abs(l_cpu)
    assert float(g_card @ g_cpu) / float(g_card.norm() * g_cpu.norm()) >= 0.99


@pytest.mark.parametrize("images_dtype", [torch.bfloat16, torch.uint8], ids=str)
def test_composed_step_replays_from_a_cuda_graph(cuda, images_dtype):
    """bench_torch.py's composed step (its --latency device reading)
    captured in a CUDA graph: nothing in it copies from the host, and a
    replay after new images are copied into the captured input gives the
    eager step's rows on those images."""
    import bench_torch as bt
    from keds_tpu_torch import synth
    from keds_tpu_torch.models.clip import ClipConfig
    from keds_tpu_torch.retrieval.database import Retriever

    cfg = ClipConfig(**_API_CFG)
    params, heads, db = synth.build(cfg, db_rows=300, dtype=torch.bfloat16, seed=7,
                                    device=cuda)
    retriever = Retriever(db)
    rng = np.random.default_rng(2)
    shape = (32, cfg.image_resolution, cfg.image_resolution, 3)

    def draw():
        if images_dtype == torch.uint8:
            return torch.from_numpy(rng.integers(0, 256, shape).astype(np.uint8)).to(cuda)
        return torch.from_numpy(rng.standard_normal(shape)).to(torch.bfloat16).to(cuda)

    images, other = draw(), draw()
    text = torch.as_tensor(bt.tokenizer.bucket_text(bt.query_text(rng, 32, 14)), device=cuda)

    def step():
        """bt.composed_step's two parts, the features kept to check the replay."""
        f = bt.mclip.encode_image_chunked(params, cfg, images, 16)
        return f, bt.rest_body(params, cfg, heads, retriever, f, text)

    with torch.inference_mode():
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            bt.composed_step(params, cfg, heads, retriever, images, text, 16)
            step()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            composed = bt.composed_step(params, cfg, heads, retriever, images, text, 16)
            f_out, out = step()
        f_first, _ = step()
        images.copy_(other)
        graph.replay()
        f_eager, eager = step()
        torch.cuda.synchronize()
    assert out.shape == (32, cfg.embed_dim) and bool(torch.isfinite(out).all())
    # bf16: a couple of ulps for another GEMM order (unit rows: 2^-8 near 1)
    torch.testing.assert_close(out.float(), eager.float(), atol=1e-2, rtol=0)
    torch.testing.assert_close(composed.float(), eager.float(), atol=1e-2, rtol=0)
    scale = float(f_eager.float().abs().max())
    torch.testing.assert_close(f_out.float(), f_eager.float(), atol=1e-2 * scale, rtol=0)
    # the replay read the new images: their features are not the first ones
    assert float((f_first.float() - f_eager.float()).abs().max()) > 0.1 * scale


def test_a_span_and_the_device_trace_share_one_clock(cuda):
    """Under a device-only profile (the benchmark's), a span around one B1
    search and a synchronise holds the search's kernel launch calls, and
    the kernel starts on the card after the span opens and within 1 ms of
    it: the program's spans and the device trace share one clock."""
    import re

    from torch.profiler import ProfilerActivity, profile

    from keds_tpu_torch.profiling import SPANS, span

    q, db = _unit(64, 768, torch.bfloat16, cuda, 1), _unit(20_000, 768, torch.bfloat16, cuda, 2)
    mips_topk(q, db, 16)                                # built and warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        with span("b1_search"):
            mips_topk(q, db, 16)
            torch.cuda.synchronize()
    s = next(s for s in reversed(SPANS) if s.name == "b1_search")
    events = [(e.name(), e.device_type() == torch.autograd.DeviceType.CUDA, e.start_ns(),
               e.start_ns() + e.duration_ns()) for e in prof.profiler.kineto_results.events()]
    launches = [(a, b) for n, dev, a, b in events
                if not dev and re.match(r"cu(da)?LaunchKernel", n)]
    kernels = [a for n, dev, a, _ in events if dev and "topk_" in n]
    assert launches and kernels, events
    assert all(s.start_ns <= a and b <= s.end_ns for a, b in launches), (s, launches)
    assert s.start_ns < min(kernels) < s.start_ns + 1_000_000, (s, kernels)
