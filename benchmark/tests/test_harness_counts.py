"""The work counts of harness/counts.py against hand counts at the cells'
shapes."""

import pytest

from benchmark.harness import core, counts

VITL14 = core.config("vitl14")
VITL14_336 = core.config("vitl14_336")


def test_vit_l14_blocks_at_224():
    # 24 x (24 S W^2 + 4 S^2 W), S = 257, W = 1024: 161.7 GFLOP an image
    assert counts.vit_block_flops(VITL14) == pytest.approx(161.7e9, rel=1e-3)


def test_vit_l14_blocks_at_336():
    # S = 577: 24 x (24 x 577 x 1024^2 + 4 x 577^2 x 1024)
    assert counts.vit_block_flops(VITL14_336) == pytest.approx(381.2e9, rel=1e-3)


@pytest.mark.parametrize("cfg, per_query", [(VITL14, 167e9), (VITL14_336, 387e9)])
def test_composed_query_flops(cfg, per_query):
    lengths = [9 + n for n in range(4, 21)]          # "a photo of * , <n words>", * as 3
    B, db = len(lengths), cfg["db"]
    step = {"images": B, "encode_chunk": B, "heads": [B, 16], "text": lengths,
            "searches": [[B, db["rows"], db["dim"], 16, db["dtype"]]] * 2}
    assert counts.step_flops(cfg, step) / B == pytest.approx(per_query, rel=0.01)


def test_a_training_step_counts_the_backward():
    fwd = {"images": 0, "heads": [128, 16], "text": [8] * 128}
    back = dict(fwd, backward=True)
    assert counts.step_flops(VITL14, back) == pytest.approx(
        3 * 128 * counts.heads_flops(VITL14, 16) + 2 * counts.text_flops(VITL14, [8] * 128))
    assert counts.step_flops(VITL14, back) > 2 * counts.step_flops(VITL14, fwd)


def test_b1_at_the_serving_batch_is_bound_by_bytes():
    c = counts.b1_call(256, 500_000, 768, 16, "bfloat16")
    assert c.bound_s * 1e3 == pytest.approx(0.229, abs=0.0005)
    assert c.bytes / counts.HBM_BYTES_PER_S > c.flops / c.peak


def test_b1_f32_rank_uses_the_cuda_core_peak():
    c = counts.b1_call(32, 100_000, 768, 10, "float32")
    assert c.peak == counts.PEAK_F32_FMA
    assert c.bound_s * 1e3 == pytest.approx(0.0918, abs=0.0005)


@pytest.mark.parametrize("call, ms", [
    (counts.b2_call(16, 16, 257, 64, False, "bfloat16"), 0.0101),   # a vision chunk
    (counts.b2_call(64, 12, 32, 64, True, "bfloat16"), 0.0038),     # a text bucket
    (counts.b2bwd_call(128, 12, 8, 64, True, "bfloat16"), 0.00329),  # the train prompt
])
def test_attention_bounds_match_the_kernel_table(call, ms):
    assert call.bound_s * 1e3 == pytest.approx(ms, rel=0.02)   # the table rounds


def test_causal_rows_count_their_own_keys():
    c = counts.b2_rows([1, 2, 3], 1, 64, "bfloat16")
    assert c.flops == 4.0 * (1 + 3 + 6) * 64
    assert c.bytes == 4.0 * 6 * 64 * 2


def test_backward_rows_of_one_length_are_one_call():
    assert counts.b2bwd_rows([8] * 128, 12, 64, "bfloat16") == counts.b2bwd_call(
        128, 12, 8, 64, True, "bfloat16")


def test_heads_flops_by_hand():
    # IM2TEXT 768-512-512-768 on 33 vectors; two CrossFormers of 3 layers,
    # each layer q (1 row) and k, v (16 rows) into 512, out back to 768,
    # attention 4 x 16 x 512
    i2t = 2 * (768 * 512 + 512 * 512 + 512 * 768)
    layer = 2 * 768 * 512 * 33 + 2 * 512 * 768 + 4 * 16 * 512
    assert counts.heads_flops(VITL14, 16) == 33 * i2t + 6 * layer
