"""The port's framework-free half and host pieces against the reference.

* ``synth_batch`` gives identical arrays for the same (seed, step);
* the copied actor runtime's sim substrate (``ActorDriver.run``) gives the
  reference's makespan for every hint kind and baseline order;
* AdamW (``lr_at``, ``_adamw_update``) and the elastic remap agree;
* import hygiene: the port and ``chip_smoke.py`` import neither ``jax``
  nor ``repro``.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.core import CostModel as JCostModel
from repro.core import HintKind as JHintKind
from repro.core import PipelineSpec as JPipelineSpec
from repro.data import synthetic as jsynth
from repro.optim import adamw as jadamw
from repro.runtime import elastic as jelastic
from repro.runtime.rrfp import ActorConfig as JActorConfig
from repro.runtime.rrfp import ActorDriver as JActorDriver
from repro_torch.configs import registry
from repro_torch.core import CostModel, HintKind, PipelineSpec
from repro_torch.data import synthetic
from repro_torch.optim import adamw
from repro_torch.runtime import elastic
from repro_torch.runtime.rrfp import ActorConfig, ActorDriver

ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("arch", ["paper-gpt3-large", "deepseek-7b",
                                  "qwen2-vl-2b", "seamless-m4t-large-v2"])
@pytest.mark.parametrize("seed,step", [(0, 0), (3, 7)])
def test_synth_batch_identical(arch, seed, step):
    want = jsynth.synth_batch(jreg.reduced_config(arch), 4, 32, seed=seed,
                              step=step)
    got = synthetic.synth_batch(registry.reduced_config(arch), 4, 32,
                                seed=seed, step=step)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        assert np.array_equal(got[k], want[k]), k


def test_prefetch_iterator_yields_the_same_stream():
    cfg = registry.reduced_config("paper-gpt3-large")
    it = synthetic.PrefetchIterator(
        lambda s: synthetic.synth_batch(cfg, 2, 8, step=s), start_step=2)
    try:
        for want_step in (2, 3, 4):
            step, batch = next(it)
            assert step == want_step
            ref = jsynth.synth_batch(jreg.reduced_config("paper-gpt3-large"),
                                     2, 8, step=step)
            assert np.array_equal(batch["tokens"], ref["tokens"])
    finally:
        it.close()


@pytest.mark.parametrize("mode,order", [
    ("hint", "bf"), ("hint", "fb"), ("hint", "b_priority"),
    ("hint", "f_priority"), ("hint", "bfw"), ("precommitted", "1f1b"),
    ("precommitted", "gpipe"), ("precommitted", "zb")])
def test_sim_makespan_matches_reference(mode, order):
    split = order in ("bfw", "zb")
    results = []
    for Spec, Costs, Cfg, Driver, Hint in (
            (JPipelineSpec, JCostModel, JActorConfig, JActorDriver,
             JHintKind),
            (PipelineSpec, CostModel, ActorConfig, ActorDriver, HintKind)):
        spec = Spec(4, 8, split_backward=split)
        costs = Costs.uniform(4)
        if split:
            costs = costs.with_split_backward()
        if mode == "hint":
            cfg = Cfg(mode="hint", hint=Hint(order), seed=11)
        else:
            cfg = Cfg(mode="precommitted", fixed_order=order, seed=11)
        results.append(Driver(spec, costs, cfg).run())
    want, got = results
    assert got.makespan == want.makespan
    assert {(t.stage, t.kind.value, t.mb): v for t, v in got.end.items()} \
        == {(t.stage, t.kind.value, t.mb): v for t, v in want.end.items()}


@pytest.mark.parametrize("step", [0, 1, 5, 19, 20, 500])
def test_lr_schedule_matches_reference(step):
    for cfg_kw in ({}, {"warmup_steps": 3, "total_steps": 3, "lr": 1e-3}):
        want = float(jadamw.lr_at(jadamw.AdamWConfig(**cfg_kw),
                                  jnp.asarray(step, jnp.int32)))
        got = adamw.lr_at(adamw.AdamWConfig(**cfg_kw), step)
        assert got == pytest.approx(want, rel=1e-6)


def test_adamw_update_matches_reference():
    rng = np.random.default_rng(0)
    p, g = (rng.standard_normal((64, 32)).astype(np.float32)
            for _ in range(2))
    m = rng.standard_normal((64, 32)).astype(np.float32) * 0.1
    v = np.abs(rng.standard_normal((64, 32))).astype(np.float32) * 0.01
    cfg_j, cfg_t = jadamw.AdamWConfig(), adamw.AdamWConfig()
    for step in (0, 3):
        want = jadamw._adamw_update(cfg_j, jnp.asarray(p), jnp.asarray(g),
                                    jnp.asarray(m), jnp.asarray(v),
                                    jnp.asarray(step), 1e-3)
        got = adamw._adamw_update(cfg_t, *(torch.from_numpy(a)
                                           for a in (p, g, m, v)), step, 1e-3)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-7)


def test_host_update_is_in_place_and_casts_back():
    upd = adamw.make_host_update(adamw.AdamWConfig(lr=1e-2, warmup_steps=1))
    p = torch.ones(8, dtype=torch.bfloat16)
    m, v = torch.zeros(8), torch.zeros(8)
    lr = upd([p], [torch.full((8,), 0.5, dtype=torch.bfloat16)], [m], [v], 0)
    assert lr == pytest.approx(1e-2)
    assert p.dtype == torch.bfloat16 and float(p[0]) < 1.0
    assert float(m[0]) == pytest.approx(0.05)
    q = torch.ones(4)
    upd([q], [None], [torch.zeros(4)], [torch.zeros(4)], 0)
    assert float(q[0]) == pytest.approx(1.0 - 1e-2 * 0.1)  # decay only


@pytest.mark.parametrize("dead", [0, 2, (1, 2), (0, 3)])
def test_remap_stages_matches_reference(dead):
    assert elastic.remap_stages(4, dead) == jelastic.remap_stages(4, dead)
    for n in (3, 7, 16):
        assert elastic.plan_remesh(n) == elastic.MeshPlan(
            **vars(jelastic.plan_remesh(n)))


def test_port_imports_neither_jax_nor_repro():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    repro_torch.__path__, 'repro_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "sys.path.insert(0, sys.argv[1])\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or\n"
        "             m.startswith('jax.') or m == 'repro' or\n"
        "             m.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "assert len(names) > 30, names\n"
        "for want in ('multimodal.model', 'multimodal.stagefn',\n"
        "             'multimodal.costs', 'runtime.rrfp.conformance',\n"
        "             'core.bounds', 'data.synthetic'):\n"
        "    assert 'repro_torch.' + want in names, want\n"
        "print(len(names))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code, str(ROOT)], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) > 30


def test_trace_perfetto_export_equals_the_reference():
    """``Trace.to_perfetto`` delegates to the copied ``obs`` exporter: a
    sim run's document equals the reference's and validates."""
    from repro.obs import validate_chrome_trace as jvalidate
    from repro_torch.obs import validate_chrome_trace

    docs = []
    for spec_cls, cost_cls, cfg_cls, driver_cls in (
            (PipelineSpec, CostModel, ActorConfig, ActorDriver),
            (JPipelineSpec, JCostModel, JActorConfig, JActorDriver)):
        driver = driver_cls(spec_cls(3, 6), cost_cls.uniform(3),
                            cfg_cls(mode="hint", seed=2, record_trace=True))
        driver.run()
        docs.append(driver.trace.to_perfetto())
    validate_chrome_trace(docs[0])
    jvalidate(docs[0])
    assert docs[0] == docs[1]
    assert any(e.get("ph") == "X" for e in docs[0]["traceEvents"])
