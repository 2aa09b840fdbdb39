"""A configuration brings its own model: a family that lives only in this
test, the decoder with a sliding window on its local layers, in a manifest
root of its own (its configuration, traffic mix, limits and family file
there and nowhere else), run by ``run_cell`` against the program's CPU path
at a reduced config with windowed layers; the same family with a planted
wrong window reads ``correct`` false.  The K1 readers price each layer's
own window; a configuration that names no family, or a family with no
file, stops the run."""
import importlib
import json
import sys
import time
from pathlib import Path

import pytest

import rrfp_bench.families
from rrfp_bench.harness import cell as cell_run
from rrfp_bench.harness import manifest
from rrfp_bench.yardstick.flops import PEAK_BF16_FLOPS

ROOT = Path(__file__).resolve().parents[2]
SEED = 2 ** 31 + 307

FAMILY = '''"""The decoder with a sliding window on its local layers."""
import dataclasses

import torch

from rrfp_bench.families import decoder

model_flops = decoder.model_flops
per_microbatch = decoder.per_microbatch


def window(c, g):
    """Layer ``g``'s window: every ``local_global_period``-th is global."""
    return 0 if (g + 1) % c["local_global_period"] == 0 else (
        c["sliding_window"])


def pattern(c):
    return ["attn_local" if window(c, g) else "attn_global"
            for g in range(c["num_layers"])]


def layer_leaves(c, kind):
    return decoder.layer_leaves(c, "attn")


class Reference(decoder.Reference):
    def mask(self, g, s, device):
        m = super().mask(g, s, device)
        w = REFERENCE_WINDOW
        if w:
            pos = torch.arange(s, device=device)
            m &= pos[:, None] - pos[None, :] < w
        return m


def attention_calls(c):
    return [(window(c, g), True) for g in range(c["num_layers"])]


def check_program(c, cfg):
    bad = decoder.check_program(c, dataclasses.replace(
        cfg, sliding_window=0, local_global_period=0))
    got = (cfg.sliding_window, cfg.local_global_period, list(cfg.pattern))
    want = (c["sliding_window"], c["local_global_period"], pattern(c))
    if got != want:
        bad["window"] = (got, want)
    return bad
'''
#: the windows the family's reference applies: the configuration's, and a
#: planted wrong one
RIGHT, WRONG = 'window(self.c, g)', 'window(self.c, g) // 2'

#: reduced_config("gemma3-4b")'s widths, as the configuration states them
CONFIG = {"name": "windowed-toy", "arch": "gemma3-4b", "family": "windowed",
          "num_layers": 4, "d_model": 64, "num_heads": 4, "num_kv_heads": 2,
          "head_dim": 16, "d_ff": 128, "vocab_size": 256, "act": "geglu",
          "norm_eps": 1e-05, "rope_theta": 1000000.0, "sliding_window": 8,
          "local_global_period": 2, "dtype": "float32",
          "train": {"lr": 0.0003}}
TRAFFIC = {"runtime": "actor", "hint": "bf", "split_backward": False,
           "w_defer_cap": 4, "stages": 2, "microbatches": 4, "mb_rows": 2,
           "seq": 32, "trace_steps": 1}
LIMITS = {"loss_gap": 1e-4, "grad_gap": 1e-3, "change_gap": 1e-2}


def _write(path: Path, text: str) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(text)


@pytest.fixture
def root(tmp_path, monkeypatch):
    """A manifest root of one cell, ``windowed-toy-bf``, whose family
    ``windowed`` is importable only while the test runs; the reference's
    window is set by ``root(window)``."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    _write(tmp_path / "BENCHMARK.json", json.dumps(dict(
        bench,
        configs=[{"name": "windowed-toy", "source": "a test",
                  "file": "rrfp_bench/configs/windowed-toy.json",
                  "reduced": [], "why": "a test"}],
        workloads=[{"name": "windowed-toy-bf", "config": "windowed-toy",
                    "traffic": "toy-bf", "chips": 1, "why": "a test"}])))
    files = tmp_path / "rrfp_bench"
    _write(files / "configs" / "windowed-toy.json", json.dumps(CONFIG))
    _write(files / "traffic" / "toy-bf.json", json.dumps(TRAFFIC))
    _write(files / "limits" / "windowed-toy-bf.json", json.dumps(LIMITS))
    monkeypatch.setattr(rrfp_bench.families, "__path__", [
        *rrfp_bench.families.__path__, str(files / "families")])
    monkeypatch.delitem(sys.modules, "rrfp_bench.families.windowed",
                        raising=False)

    def make(window: str = RIGHT) -> Path:
        _write(files / "families" / "windowed.py",
               FAMILY.replace("REFERENCE_WINDOW", window))
        importlib.invalidate_caches()
        return tmp_path

    yield make
    sys.modules.pop("rrfp_bench.families.windowed", None)


def _run(root: Path) -> dict:
    from repro_torch.configs import registry

    cell = manifest.cell(root, "windowed-toy-bf")
    return cell_run.run_cell(cell, seed=SEED, seconds=0.5, trace_on=False,
                             device="cpu", t_start=time.perf_counter(),
                             cfg=registry.reduced_config("gemma3-4b"))[0]


def test_a_family_of_the_test_runs_the_program_correctly(root):
    res = _run(root())
    assert res["correct"], res["checks"]
    assert res["checks"]["loss_gap"]["value"] < 1e-5


def test_a_wrong_window_in_the_family_is_not_correct(root):
    res = _run(root(WRONG))
    assert not res["correct"], res["checks"]


def test_the_family_checks_the_programs_window(root):
    from repro_torch.configs import registry

    cell = manifest.cell(root(), "windowed-toy-bf")
    cfg = registry.reduced_config("gemma3-4b")
    fam = manifest.family(cell.config)
    assert fam.check_program(cell.config, cfg) == {}
    assert fam.check_program(dict(cell.config, sliding_window=16), cfg)


def test_the_k1_readers_price_each_layers_window(root):
    """Five windowed layers of 1,024 and one global layer, q [1, 8, 4096,
    256] and k, v [1, 4, 4096, 256] in bf16: the mean of the layers'
    bounds."""
    root()
    c = {"family": "windowed", "num_layers": 6, "local_global_period": 6,
         "sliding_window": 1024, "num_heads": 8, "num_kv_heads": 4,
         "head_dim": 256, "d_model": 2560, "dtype": "bfloat16"}
    ctx = {"config": c, "traffic": {"mb_rows": 1, "seq": 4096},
           "kernels": [("flash_fwd_kernel<256>", 0.0, 400.0),
                       ("flash_bwd_dq_kernel<256>", 400.0, 700.0),
                       ("flash_bwd_dkdv_kernel<256>", 700.0, 1200.0)],
           "steps": 1}
    # causal pairs: 4096 x 4097 / 2 over the whole sequence; windowed,
    # 1024 x 1025 / 2 + 3072 x 1024
    full, local = 8_390_656, 3_670_528
    flops = {p: 4 * 8 * p * 256 for p in (full, local)}
    # q and out 2 x 16,777,216 B, k and v 2 x 8,388,608 B, lse 131,072 B
    fwd_bytes = 50_462_720
    # q, out, dout, dq and k, v, dk, dv, lse
    bwd_bytes = 4 * (8_388_608 + 4_194_304) * 2 + 131_072
    fwd = [max(flops[p] / PEAK_BF16_FLOPS, fwd_bytes / 3.35e12)
           for p in (local, full)]
    bwd = [max(2.5 * flops[p] / PEAK_BF16_FLOPS, bwd_bytes / 3.35e12)
           for p in (local, full)]
    want_fwd = 100.0 * (5 * fwd[0] + fwd[1]) / 6 / 400e-6
    want_bwd = 100.0 * (5 * bwd[0] + bwd[1]) / 6 / 800e-6
    assert manifest.reader("k1_roofline_pct")(ctx) == pytest.approx(
        want_fwd, rel=1e-12)
    assert manifest.reader("k1_bwd_roofline_pct")(ctx) == pytest.approx(
        want_bwd, rel=1e-12)
    # operations bound every call; priced as a whole sequence each, the
    # six calls would read 17.38 % and 21.72 %, not 9.23 % and 11.54 %
    assert (want_fwd, want_bwd) == pytest.approx((9.2299, 11.5374),
                                                 rel=1e-4)


def test_a_configuration_without_a_family_stops_the_run(root, tmp_path):
    r = root()
    conf = r / "rrfp_bench" / "configs" / "windowed-toy.json"
    conf.write_text(json.dumps({k: v for k, v in CONFIG.items()
                                if k != "family"}))
    with pytest.raises(SystemExit, match="windowed-toy.json"):
        manifest.cell(r, "windowed-toy-bf")
    conf.write_text(json.dumps(dict(CONFIG, family="nonesuch")))
    with pytest.raises(SystemExit,
                       match="rrfp_bench/families/nonesuch.py"):
        manifest.cell(r, "windowed-toy-bf")
