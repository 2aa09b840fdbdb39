"""``k1_bwd_roofline_pct`` on a fabricated kernel list at the qwen2-vl
cell's shapes, against a value worked out by hand; nothing where no
backward kernel ran; and the backward's kernels, as the source names them,
in no frozen category (so that no other per-layer metric reads them)."""
import json
import re
from pathlib import Path

import pytest

from rrfp_bench.harness import manifest
from rrfp_bench.yardstick import categories

ROOT = Path(__file__).resolve().parents[2]
SOURCE = (ROOT / "src" / "repro_torch" / "kernels" / "csrc"
          / "flash_attention.cu")


def _ctx(kernels):
    config = json.loads((ROOT / "rrfp_bench" / "configs" /
                         "qwen2-vl-2b-lm.json").read_text())
    traffic = json.loads((ROOT / "rrfp_bench" / "traffic" /
                          "bf-16x2048.json").read_text())
    return {"config": config, "traffic": traffic, "kernels": kernels,
            "steps": 2}


def _names(tmpl):
    """The demangled names the profiler shows for each head dim."""
    return [f"void (anonymous namespace)::bwd::{tmpl}<{hd}>(__nv_bfloat16 "
            f"const*, float const*, int, (anonymous namespace)::bwd::"
            f"BwdStrides, int, int)" for hd in (32, 64, 96, 128, 256)]


def test_the_share_of_two_calls():
    dq, dkdv = _names("flash_bwd_dq_kernel")[3], _names(
        "flash_bwd_dkdv_kernel")[3]
    kernels = [("void (anonymous namespace)::tc::flash_fwd_kernel<128>",
                0.0, 70.0),
               (dq, 100.0, 200.0), (dkdv, 200.0, 400.0),
               (dq, 500.0, 600.0), (dkdv, 600.0, 800.0)]
    # q [2, 12, 2048, 128], k [2, 2, 2048, 128] bf16, causal: 2,098,176
    # pairs a head, 2.5 x 4 x 2 x 12 x 2,098,176 x 128 FLOP; q, out, dout,
    # dq 4 x 6,291,456 B, k, v, dk, dv 4 x 1,048,576 B, lse 196,608 B
    flops = 2.5 * 4 * 2 * 12 * 2_098_176 * 128
    assert flops == 64_455_966_720
    nbytes = 4 * 2 * (6_291_456 + 1_048_576) + 196_608
    bound = max(flops / 989e12, nbytes / 3.35e12)  # operations bound it
    want = 100.0 * 2 * bound / 600e-6
    got = manifest.reader("k1_bwd_roofline_pct")(_ctx(kernels))
    assert got == pytest.approx(want) and got == pytest.approx(21.7243,
                                                               rel=1e-5)


def test_nothing_without_the_backward_kernels():
    kernels = [("sm80_xmma_gemm_f32f32_f32f32_f32_nt_n_tilesize32x32x8",
                0.0, 431.0)]
    assert manifest.reader("k1_bwd_roofline_pct")(_ctx(kernels)) is None
    assert manifest.reader("k1_bwd_roofline_pct")(_ctx([])) is None


def test_the_backward_kernels_fall_in_no_frozen_category():
    source = SOURCE.read_text()
    found = set(re.findall(r"\n(flash_bwd_\w+)\(", source))
    assert found == {"flash_bwd_dq_kernel", "flash_bwd_dkdv_kernel",
                     "flash_bwd_group_sum_kernel"}
    for tmpl in sorted(found):
        for name in _names(tmpl):
            assert categories.category(name) == "other", name
