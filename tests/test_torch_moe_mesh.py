"""The MoE ``ep`` and ``tp`` layouts over two data ranks of the port's mesh.

For the reduced deepseek-moe-16b, ``ep`` with 16 experts (8 a rank) and
``tp`` with its 8 experts (``d_ff`` 32 split 16 + 16), float32: every
rank holds its shard of weights drawn whole from a numpy seed, and the
layer's phases (``moe.moe_phases``) on the mesh, forward and through the
phased backward (``models/phases.py``: the exchanges and their transposes
called by the rank threads between autograd calls), equal on each rank
``layout="none"``
on that rank's tokens with the whole weights: the output, the input's
gradient, the router's and the shared expert's gradients (this rank's
tokens), and the routed experts' (every rank's tokens, then this rank's
shard), each within 1e-5 of its max.  The forward without autograd gives
the phased forward's bits, two runs give the same bits, a layout whose
``E`` (``ep``) or ``f`` (``tp``) does not divide by the data size raises,
and ``moe_ffn``, which cannot exchange, refuses a layout that must.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import registry
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import moe
from repro_torch.models.phases import phased_grads, run_forward

DATA, ROWS, SEQ = 2, 2, 16
TOL = 1e-5
LAYOUTS = {"ep": 16, "tp": 8}  # layout -> experts


def _config(experts: int):
    cfg = registry.reduced_config("deepseek-moe-16b", 4)
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, num_experts=experts))


def _whole_layer(cfg, seed: int = 0) -> moe.MoEFFN:
    rng = np.random.default_rng(seed)
    layer = moe.MoEFFN(cfg, None, "cpu")
    with torch.no_grad():
        for _, p in layer.named_parameters():
            p.copy_(torch.from_numpy(rng.standard_normal(tuple(p.shape))
                                     .astype(np.float32) * 0.3))
    return layer


def _shard(cfg, whole, layout: str, index: int) -> moe.MoEFFN:
    part = moe.MoEFFN(cfg, None, "cpu", layout=layout, data_size=DATA)
    with torch.no_grad():
        for (name, p), q in zip(part.named_parameters(), whole.parameters()):
            dim = moe.expert_shard_dim(name, layout)
            p.copy_(q if dim is None else moe.take_shard(q, dim, DATA,
                                                         index))
    return part


def _inputs(cfg, seed: int = 1):
    rng = np.random.default_rng(seed)

    def draw():
        return torch.from_numpy(rng.standard_normal(
            (ROWS, SEQ, cfg.d_model)).astype(np.float32))

    return [draw() for _ in range(DATA)], [draw() for _ in range(DATA)]


def _mesh_run(cfg, whole, layout, xs, gys):
    """Each rank's (y, dx, param grads by name) through the phased
    backward, and its forward without autograd."""
    mesh = make_mesh(DATA, 1, device="cpu")
    exchange = mesh.exchange_over("data")
    shards = [_shard(cfg, whole, layout, i) for i in range(DATA)]

    def rank(r):
        p = shards[r]
        phases, cuts = moe.moe_phases(p, cfg, layout, DATA)
        gx, grads, out = phased_grads(phases, cuts, {"h": xs[r]}, exchange,
                                      list(p.parameters()), {"h": gys[r]},
                                      ("h",))
        y_plain = run_forward(phases, cuts, {"h": xs[r]}, exchange)["h"]
        names = [n for n, _ in p.named_parameters()]
        return out["h"].detach(), gx["h"], dict(zip(names, grads)), y_plain

    return mesh.run(rank, [(r,) for r in range(DATA)])


def _whole_run(cfg, whole, x, gy):
    """``layout="none"`` on one rank's tokens with the whole weights."""
    x = x.clone().requires_grad_()
    params = list(whole.parameters())
    y = moe.moe_ffn(whole, x, cfg)
    grads = torch.autograd.grad(y, [x] + params, gy)
    names = [n for n, _ in whole.named_parameters()]
    return y.detach(), grads[0], dict(zip(names, grads[1:]))


def _close(got, want, what):
    scale = max(float(want.abs().max()), 1e-30)
    err = float((got - want).abs().max())
    assert err <= TOL * scale, f"{what}: {err:.3e} of max {scale:.3e}"


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_layout_equals_none_on_each_ranks_tokens(layout):
    cfg = _config(LAYOUTS[layout])
    whole = _whole_layer(cfg)
    xs, gys = _inputs(cfg)
    got = _mesh_run(cfg, whole, layout, xs, gys)
    want = [_whole_run(cfg, whole, xs[r], gys[r]) for r in range(DATA)]
    for r in range(DATA):
        y, dx, grads, y_plain = got[r]
        y_w, dx_w, grads_w = want[r]
        _close(y, y_w, f"rank {r} y")
        assert torch.equal(y_plain, y), "the forward without autograd"
        _close(dx, dx_w, f"rank {r} dx")
        for name, g in grads.items():
            dim = moe.expert_shard_dim(name, layout)
            if dim is None:  # router, shared expert: this rank's tokens
                _close(g, grads_w[name], f"rank {r} {name}")
            else:  # routed experts: every rank's tokens, this rank's shard
                total = sum(w[2][name] for w in want)
                _close(g, moe.take_shard(total, dim, DATA, r),
                       f"rank {r} {name}")


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_two_runs_give_the_same_bits(layout):
    cfg = _config(LAYOUTS[layout])
    whole = _whole_layer(cfg, seed=4)
    xs, gys = _inputs(cfg, seed=5)
    a = _mesh_run(cfg, whole, layout, xs, gys)
    b = _mesh_run(cfg, whole, layout, xs, gys)
    for ra, rb in zip(a, b):
        assert torch.equal(ra[0], rb[0]) and torch.equal(ra[1], rb[1])
        assert all(torch.equal(ra[2][n], rb[2][n]) for n in ra[2])


@pytest.mark.parametrize("layout,experts,d_ff", [("ep", 12, 32),
                                                 ("tp", 8, 36)])
def test_a_shard_that_does_not_divide_raises(layout, experts, d_ff):
    cfg = dataclasses.replace(_config(experts), d_ff=d_ff)
    with pytest.raises(ValueError, match="does not divide by 8"):
        moe.MoEFFN(cfg, None, "cpu", layout=layout, data_size=8)
    moe.MoEFFN(cfg, None, "cpu", layout=layout, data_size=4)  # divides


@pytest.mark.parametrize("grad", [False, True])
def test_the_exchanging_forward_refuses_autograd(grad):
    """``moe_ffn`` has no exchange: a layout over more than one rank is
    run only cut at its exchanges, with or without autograd."""
    cfg = _config(16)
    part = _shard(cfg, _whole_layer(cfg), "ep", 0)
    with torch.set_grad_enabled(grad), pytest.raises(
            ValueError, match="moe_phases"):
        moe.moe_ffn(part, torch.zeros(1, 4, cfg.d_model), cfg, layout="ep",
                    axis_size=DATA)
