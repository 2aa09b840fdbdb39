"""Values the benchmark read before its models moved behind the family
seam (``rrfp_bench/families/``), recorded from the harness as it stood
then and held bitwise: each cell's ``model_flops`` and the K1, K1b, K2 and
MFU readers on a fabricated trace at its traffic; every leaf the weights
draw at the toy cut; and the losses, the gradient and change norms and the
compared gaps of a toy run of ``run_cell`` on the CPU (torch's CPU
kernels, at any thread count this model size uses)."""
import hashlib
import json
import time

import pytest
import torch

from rrfp_bench.harness import cell as cell_run
from rrfp_bench.harness import manifest, program, weights
from rrfp_bench.reference import train as reference
from rrfp_bench.tests._small import CELLS, any_cell, small_cell

SEED = 2 ** 31 + 101

MODEL_FLOPS = {"qwen2vl-rrfp-bf": 320823890018304.0,
               "gpt3-rrfp-bf": 327280333160448.0,
               "moe-rrfp-bf": 115143107149824.0,
               "gpt3-rrfp-bfw": 327280333160448.0}

#: two K1 calls, one K1b call (its two passes), two K2 calls and a GEMM, in
#: two traced steps (microseconds)
KERNELS = [("void (anonymous namespace)::tc::flash_fwd_kernel<128>", 0.0,
            71.0),
           ("void (anonymous namespace)::tc::flash_fwd_kernel<128>", 100.0,
            173.0),
           ("void (anonymous namespace)::bwd::flash_bwd_dq_kernel<128>",
            200.0, 301.0),
           ("void (anonymous namespace)::bwd::flash_bwd_dkdv_kernel<128>",
            301.0, 499.0),
           ("_rmsnorm_kernel", 500.0, 505.5),
           ("_rmsnorm_kernel", 600.0, 605.25),
           ("nvjet_gemm", 700.0, 1700.0)]

_GPT3 = {"k1_roofline_pct": "0x1.21a83dc16e208p+6",
         "k1_bwd_roofline_pct": "0x1.5cc04a5ac3f3dp+5",
         "k2_roofline_pct": "0x1.178a4f2ee464cp+8",
         "step_mfu": "0x1.432a1d5328d74p+15",
         "mfu": "0x1.08bc8284d751cp+5"}
READINGS = {
    "qwen2vl-rrfp-bf": {"k1_roofline_pct": "0x1.21a83dc16e208p+5",
                        "k1_bwd_roofline_pct": "0x1.5cc04a5ac3f3dp+4",
                        "k2_roofline_pct": "0x1.178ead46a8c14p+7",
                        "step_mfu": "0x1.3cca0d12ae6f7p+15",
                        "mfu": "0x1.038385ffbd2eap+5"},
    "gpt3-rrfp-bf": _GPT3,
    "moe-rrfp-bf": {"k1_roofline_pct": "0x1.821d875622dadp+6",
                    "k1_bwd_roofline_pct": "0x1.d0e356bf0a496p+5",
                    "k2_roofline_pct": "0x1.74be3c5e36570p+7",
                    "step_mfu": "0x1.c6c7c4c343440p+13",
                    "mfu": "0x1.748e59eaea824p+3"},
    "gpt3-rrfp-bfw": _GPT3,
}

#: sha256 of every leaf's path, dtype, shape and bytes, in the leaves' order
LEAVES = {
    ("qwen2vl-rrfp-bf", "float32"):
        "8ff4a080f335823b2f005fe3cc6eda16379e9385fe690298ada0da28c3087ab8",
    ("qwen2vl-rrfp-bf", "bfloat16"):
        "e5134996fd4af04e7a9555dd7f86907ee8c76def4079156451b9691237fb3e13",
    ("gpt3-rrfp-bf", "float32"):
        "be6ba7b22f5692b61776df2d19786fa71977123c98ea17fb7a5bc3c47c73893a",
    ("gpt3-rrfp-bf", "bfloat16"):
        "1eab1c0a14d32eed03eb80eadde1f49f19961bf0b0194d8c79ff0a6cadc4bd5b",
    ("moe-rrfp-bf", "float32"):
        "10a5f333a40cf91ecd956753e7385b82cf7fc382da0a91ef9e05820bd26899b1",
    ("moe-rrfp-bf", "bfloat16"):
        "003597a7951db4adc947622f375f8f6e529bb3316ba3750d726de1828b60426a",
}

#: a float32 toy run: each side's step losses; sha256 of each side's
#: gradient and change norms (every slice's ``float.hex``, sorted by key);
#: the gaps compared
RUNS = {
    "qwen2vl-rrfp-bf": {
        "program_losses": ["0x1.8793e00000000p+2", "0x1.8beca00000000p+2"],
        "reference_losses": ["0x1.8793e00000000p+2",
                             "0x1.8bec9e0000000p+2"],
        "program_grads":
            "cee3464f01946d0465cd8c160066b82ca6d49aa5d2248a82974e8f66fe48a36f",
        "program_change":
            "3dd2c80274f9a29c6fb5a8e3a27d89168feb36ec66ece49960164ef968656bed",
        "reference_grads":
            "25bc833fb0423eaa64338f02042afd1b54582d3563bf10138d9c5f557f630100",
        "reference_change":
            "0dc60c5112fbcd46d516a5e5c6222fc3c5754f8339920456b1df0c958f1677b7",
        "checks": {"loss_gap": "0x1.0000000000000p-21",
                   "grad_gap": "0x1.133d67ef99eb9p-23",
                   "change_gap": "0x1.06d2b731acad3p-13"},
    },
    "gpt3-rrfp-bf": {
        "program_losses": ["0x1.89ee0e0000000p+2", "0x1.9371940000000p+2"],
        "reference_losses": ["0x1.89ee0c0000000p+2",
                             "0x1.9371960000000p+2"],
        "program_grads":
            "2385029f67bdc09175b0e67af63733e2bc093aa956eaff8c90fea1f7d1d054f4",
        "program_change":
            "e0eec032238d55cff780d9481513f85b9a7b8eb5b8de66c75b4b863cc3d5ba64",
        "reference_grads":
            "b21f2d0c6b8df1874fe3bd2156be8b0b593455d7278ef136cdbbb8e7538a3bdc",
        "reference_change":
            "1b494741735688b8fe0ff7413506fc310448e0a7b86a3185848a0139c265a06e",
        "checks": {"loss_gap": "0x1.0000000000000p-21",
                   "grad_gap": "0x1.9df21c07df483p-24",
                   "change_gap": "0x1.6aed4570c40a7p-21"},
    },
    "moe-rrfp-bf": {
        "program_losses": ["0x1.82f20c0000000p+2", "0x1.8939840000000p+2"],
        "reference_losses": ["0x1.82f20c0000000p+2",
                             "0x1.8939840000000p+2"],
        "program_grads":
            "d464d8a7536cfed006a757209be1fe7e5f71d70c55be44cce1725bad5f1ab12f",
        "program_change":
            "ec1f0d5aa01a2b0e823b0434cc3f2f2090b5688a28d14508dee72c5dc2b92eaa",
        "reference_grads":
            "bb475daaceb9e949f72a32f16e0dfc0f61b04b06ecbfe2f268cfd64bc38445f6",
        "reference_change":
            "215b1b4720e18931f1ecaa7867be78261f6d9f06f9e5edefc458bc6295265d3b",
        "checks": {"loss_gap": "0x0.0p+0",
                   "grad_gap": "0x1.a777102b3f80dp-23",
                   "change_gap": "0x1.d3fee574134fbp-19"},
    },
}


@pytest.mark.parametrize("name", CELLS)
def test_model_flops_and_the_kernel_readers(name):
    cell = any_cell(name)
    c, t = cell.config, cell.traffic
    flops = manifest.family(c).model_flops(c, t["microbatches"]
                                           * t["mb_rows"], t["seq"])
    assert flops == MODEL_FLOPS[name]
    ctx = {"config": c, "traffic": t, "kernels": KERNELS, "steps": 2,
           "flops_per_step": flops, "busy_s": 1.6e-3, "window_s": 2.0,
           "window_steps": [1.0, 1.0]}
    got = {m: manifest.reader(m)(ctx).hex() for m in READINGS[name]}
    assert got == READINGS[name]


def _leaves_digest(tensors: dict) -> str:
    h = hashlib.sha256()
    for k, v in tensors.items():
        h.update(k.encode())
        h.update(str(v.dtype).encode())
        h.update(repr(tuple(v.shape)).encode())
        bits = torch.int16 if v.dtype == torch.bfloat16 else torch.uint8
        h.update(v.contiguous().view(bits).numpy().tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("name,dtype", sorted(LEAVES))
def test_every_leaf_drawn_at_the_toy_cut(name, dtype):
    cell, _ = small_cell(name, dtype)
    got = _leaves_digest(weights.draw_all(cell.config, SEED, "cpu"))
    assert got == LEAVES[name, dtype]


def _norms_digest(norms: dict) -> str:
    return hashlib.sha256(json.dumps(
        {k: float(v).hex() for k, v in sorted(norms.items())}).encode()
    ).hexdigest()


@pytest.mark.parametrize("name", sorted(RUNS))
def test_a_toy_run_of_the_cell(name, monkeypatch):
    """The program's and the reference's readings that ``run_cell`` hands
    the comparison, and its gaps."""
    seen = {}
    run, train = program.run, reference.train
    monkeypatch.setattr(program, "run", lambda *a, **kw: seen.setdefault(
        "ran", run(*a, **kw)))
    monkeypatch.setattr(reference, "train", lambda *a, **kw: seen.setdefault(
        "ref", train(*a, **kw)))
    cell, cfg = small_cell(name)
    res, _ = cell_run.run_cell(cell, seed=SEED, seconds=0.5, trace_on=False,
                               device="cpu", t_start=time.perf_counter(),
                               cfg=cfg)
    prog, ref = seen["ran"].readings, seen["ref"]
    got = {"program_losses": [x.hex() for x in prog.losses],
           "reference_losses": [x.hex() for x in ref.losses],
           "program_grads": _norms_digest(prog.grad_norms),
           "program_change": _norms_digest(prog.change_norms),
           "reference_grads": _norms_digest(ref.grad_norms),
           "reference_change": _norms_digest(ref.change_norms),
           "checks": {k: v["value"].hex() for k, v in res["checks"].items()}}
    assert got == RUNS[name]
    assert res["correct"]
