"""The benchmark's frozen arithmetic, and the decoder family's counts,
against counts worked out by hand at each cell's shapes."""
import json
from pathlib import Path

import pytest

from rrfp_bench.families import decoder
from rrfp_bench.yardstick import categories, flops

ROOT = Path(__file__).resolve().parents[2]


def _config(name):
    return json.loads((ROOT / "rrfp_bench" / "configs" / f"{name}.json")
                      .read_text())


def test_gpt3_large_model_flops_at_32_x_2048():
    c = _config("paper-gpt3-large")
    # 24 x (4 d^2 + 2 d d_ff + 2 d) + d + 50304 d, d = 1536, d_ff = 6144
    assert decoder.active_params(c) == 756_819_456
    dense = 6 * 756_819_456 * 65_536
    attn = 6 * 32 * 2048 * 24 * 1024 * 2 * 16 * 96
    assert (dense, attn) == (297_593_519_210_496, 29_686_813_949_952)
    assert decoder.model_flops(c, 32, 2048) == dense + attn
    assert decoder.model_flops(c, 32, 2048) == pytest.approx(3.27e14, rel=1e-3)


def test_deepseek_moe_4_layers_model_flops_at_8_x_4096():
    c = _config("deepseek-moe-16b-l4")
    # dense layer (d_ff 10944) + 3 MoE layers (6 routed + 2 shared experts
    # of 1408, a 64-wide router) + final norm + LM head
    assert decoder.active_params(c) == 552_093_696
    assert decoder.model_flops(c, 8, 4096) == (
        6 * 552_093_696 * 32_768 + 6 * 8 * 4096 * 4 * 2048 * 2 * 16 * 128)
    assert decoder.model_flops(c, 8, 4096) == pytest.approx(1.15e14, rel=2e-3)


def test_qwen2_vl_2b_language_model_flops_at_16_x_2048():
    c = _config("qwen2-vl-2b-lm")
    # 28 x (attention 2 d^2 + 2 d (2 x 128) + (12 + 2 x 2) x 128 biases
    # + 3 d d_ff + 2 d) + d + 151936 d, d = 1536, d_ff = 8960
    layer = (2 * 1536 ** 2 + 2 * 1536 * 256 + 16 * 128 + 3 * 1536 * 8960
             + 2 * 1536)
    assert layer == 46_797_824
    assert decoder.active_params(c) == 28 * layer + 1536 + 151_936 * 1536
    assert decoder.active_params(c) == 1_543_714_304
    assert decoder.model_flops(c, 16, 2048) == (
        6 * 1_543_714_304 * 32_768 + 6 * 16 * 2048 * 28 * 1024 * 2 * 12 * 128)
    assert decoder.model_flops(c, 16, 2048) == pytest.approx(3.208e14,
                                                           rel=1e-3)


@pytest.mark.parametrize("shape,want", [
    # qwen2-vl: q [2, 12, 2048, 128], k and v [2, 2, 2048, 128] bf16, causal
    ((2, 12, 2048, 2, 2048, 128), (25_782_386_688, 29_556_736)),
    # gpt3: q [4, 16, 2048, 96] bf16, causal
    ((4, 16, 2048, 16, 2048, 96), (51_564_773_376, 101_187_584)),
    # deepseek-moe: q [1, 16, 4096, 128] bf16, causal
    ((1, 16, 4096, 16, 4096, 128), (68_736_253_952, 67_371_008)),
])
def test_k1_work(shape, want):
    assert flops.k1_work(*shape, itemsize=2) == want


@pytest.mark.parametrize("rows,d,want", [
    (2 * 2048, 1536, (25_165_824, 25_168_896)),
    (4 * 2048, 1536, (50_331_648, 50_334_720)),
    (4096, 2048, (33_554_432, 33_558_528)),
])
def test_k2_work(rows, d, want):
    assert flops.k2_work(rows, d, 2) == want


def test_bound_takes_the_larger_term():
    assert flops.bound_seconds(989e12, 0) == pytest.approx(1.0)
    assert flops.bound_seconds(0, 3.35e12) == pytest.approx(1.0)
    assert flops.bound_seconds(989e9, 3.35e12) == pytest.approx(1.0)
    assert flops.bound_seconds(67e12, 0, "float32") == pytest.approx(1.0)


def test_causal_pairs():
    assert flops.causal_pairs(4, 4) == 10
    assert flops.causal_pairs(4, 4, causal=False) == 16
    assert flops.causal_pairs(6, 6, window=2) == 3 + 4 * 2


@pytest.mark.parametrize("name,cat", [
    ("flash_fwd_kernel<96, 64, 64>", categories.K1),
    ("_rmsnorm_kernel", categories.K2),
    ("cutlass_80_simt_sgemm_128x128_8x4_nn_align1", categories.FP32_GEMM),
    ("sm80_xmma_gemm_f32f32_f32f32_f32_nn_n", categories.FP32_GEMM),
    ("nvjet_hsh_128x224_64x4_2x1_v_bz_coopA_NNT", "matmul (tensor cores)"),
    ("void at::native::tensor_kernel_scan_outer_dim<long>", categories.SORT_SCAN),
    ("void at::native::indexing_backward_kernel<>", categories.INDEXING),
    ("void at::native::vectorized_elementwise_kernel<4>", "elementwise"),
    ("something else", "other"),
])
def test_categories(name, cat):
    assert categories.category(name) == cat
