"""Stage re-layout (``runtime/elastic.relayout_stage_params``) against the
reference's, and its round trips through the port's checkpoints.

* On the same numpy trees (the port's seeded weights exported with
  ``convert.params_to_reference``), the port's re-layout gives the
  reference's models and leaves bit for bit: reduced deepseek-7b with 6
  layers, 4 -> 2 -> 4 stages (and 4 -> 3), and reduced zamba2-1.2b whose
  shared-block flags move with the layers.
* Shrink -> checkpoint -> restore -> regrow -> checkpoint -> restore through
  ``CheckpointStore`` is bitwise on every live slot (the reference's
  ``tests/test_fault_tolerance.py`` property).
* The port's 4-stage and 2-stage forwards of the same weights agree within
  2e-4, as the reference's test requires of its own.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models.build import build as jbuild
from repro.runtime.elastic import relayout_stage_params as jrelayout
from repro_torch.ckpt.store import CheckpointStore, _leaves_with_path
from repro_torch.configs import registry
from repro_torch.models.build import build
from repro_torch.models.common import global_layer_index
from repro_torch.models.convert import (
    params_from_reference,
    params_to_reference,
)
from repro_torch.runtime.elastic import relayout_stage_params

#: the reference's test: the same function on another stage count
TOL_FORWARD = 2e-4
LAYERS = 6


def _configs(arch):
    """The port's and the reference's reduced config of ``arch`` (zamba2
    with Mamba layers, its shared block every 2nd layer)."""
    cfg = registry.reduced_config(arch, num_layers=LAYERS)
    jcfg = jreg.reduced_config(arch, num_layers=LAYERS)
    if arch == "zamba2-1.2b":
        kw = dict(layer_pattern=("mamba",) * LAYERS, shared_attn_period=2)
        cfg = dataclasses.replace(cfg, **kw)
        jcfg = dataclasses.replace(jcfg, **kw)
    return cfg, jcfg


def _seeded(cfg, stages):
    model = build(cfg, num_stages=stages)
    sp = [model.init_stage_params(s, seed=7, device="cpu")
          for s in range(stages)]
    io = model.init_io_params(seed=7, device="cpu")
    return model, sp, io


def _leaves(tree):
    return [(k, np.asarray(v)) for k, v in _leaves_with_path(tree)]


def _same_model(m, jm):
    assert m.num_stages == jm.num_stages and m.l_max == jm.l_max
    for k in ("counts", "type_ids", "shared_flags"):
        np.testing.assert_array_equal(getattr(m, k), getattr(jm, k))


@pytest.mark.parametrize("arch,path", [("deepseek-7b", (4, 2, 4)),
                                       ("deepseek-7b", (4, 3)),
                                       ("zamba2-1.2b", (4, 2, 4))])
def test_relayout_is_the_references_bit_for_bit(arch, path):
    cfg, jcfg = _configs(arch)
    model, sp, io = _seeded(cfg, path[0])
    tree, _ = params_to_reference(model, sp, io)
    jmodel = jbuild(jcfg, num_stages=path[0])
    for n in path[1:]:
        model, got = relayout_stage_params(model, n, tree)
        jmodel, want = jrelayout(jmodel, n, tree)
        _same_model(model, jmodel)
        g, w = _leaves(got), _leaves(want)
        assert [k for k, _ in g] == [k for k, _ in w]
        for (k, a), (_, b) in zip(g, w):
            assert a.dtype == b.dtype and a.shape == b.shape, k
            assert np.array_equal(a, b), k
        tree = got
    if arch == "zamba2-1.2b":  # the flags follow the global layer index
        gli = global_layer_index(model.counts)
        np.testing.assert_array_equal(
            model.shared_flags, (gli >= 0) & (gli % 2 == 0))


@pytest.mark.parametrize("arch", ["deepseek-7b", "zamba2-1.2b"])
def test_shrink_restore_regrow_restore_is_bitwise(tmp_path, arch):
    cfg, _ = _configs(arch)
    m4, sp, io = _seeded(cfg, 4)
    sp4, _ = params_to_reference(m4, sp, io)
    store = CheckpointStore(str(tmp_path))
    store.save(1, {"sp": sp4}, meta={"stages": 4})
    host1, meta1 = store.restore_host(1, {"sp": sp4})
    assert meta1["stages"] == 4
    m2, sp2 = relayout_stage_params(m4, 2, host1["sp"])  # shrink
    store.save(2, {"sp": sp2}, meta={"stages": 2})
    host2, _ = store.restore_host(2, {"sp": sp2})
    m4b, sp4b = relayout_stage_params(m2, 4, host2["sp"])  # regrow
    store.save(3, {"sp": sp4b}, meta={"stages": 4})
    host3, _ = store.restore_host(3, {"sp": sp4b})
    live = global_layer_index(m4.counts) >= 0
    orig, back = _leaves(sp4), _leaves(host3["sp"])
    assert [k for k, _ in orig] == [k for k, _ in back]
    for (k, a), (_, b) in zip(orig, back):
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert np.array_equal(a[live], b[live]), k
        assert not b[~live].any(), k  # a padding slot carries nothing


@pytest.mark.parametrize("arch", ["deepseek-7b", "zamba2-1.2b"])
def test_relaid_forward_computes_the_same_function(arch):
    cfg, _ = _configs(arch)
    m4, sp, io = _seeded(cfg, 4)
    sp_np, io_np = params_to_reference(m4, sp, io)
    m2, sp2_np = relayout_stage_params(m4, 2, sp_np)
    sp2, io2 = params_from_reference(m2, sp2_np, io_np, "cpu")
    g = torch.Generator().manual_seed(2)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 16),
                                     generator=g)}
    aux = {"positions": torch.arange(16, dtype=torch.int32)[None]
           .expand(2, 16), "data_size": 1, "moe_layout": "none"}
    with torch.no_grad():
        y4 = m4.reference_forward(sp, io, batch, aux)
        y2 = m2.reference_forward(sp2, io2, batch, aux)
    assert torch.isfinite(y4).all()
    torch.testing.assert_close(y2.float(), y4.float(), atol=TOL_FORWARD,
                               rtol=0)
