"""The port's MoE FFN against the reference's ``repro.models.moe``.

Routing, static-capacity dispatch (with a capacity drop), combine and the
whole ``moe_ffn``, forward and gradients, on identical weights (the
reference's ``init_moe_ffn``, loaded by name) and numpy-seeded inputs, for
the reduced deepseek-moe-16b (shared experts, SwiGLU) and grok-1-314b
(GEGLU, no shared expert).  float32, tolerance 1e-4 (1e-5 for single
functions); slots, validity and routed experts exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import moe as jmoe
from repro.models.common import keygen
from repro_torch.configs import registry
from repro_torch.models import moe

TOL = 1e-5
TOL_FFN = 1e-4
ARCHS = ["deepseek-moe-16b", "grok-1-314b"]


def configs(arch):
    return jreg.reduced_config(arch, 4), registry.reduced_config(arch, 4)


def load(cfg_t, p_np) -> moe.MoEFFN:
    layer = moe.MoEFFN(cfg_t, None, "cpu")
    with torch.no_grad():
        for name, t in layer.named_parameters():
            node = p_np
            for part in name.split("."):
                node = node[part]
            t.copy_(torch.from_numpy(np.array(node)))
    return layer


def layer_pair(arch, seed=0):
    cfg_j, cfg_t = configs(arch)
    p = jax.tree.map(np.asarray, jmoe.init_moe_ffn(
        keygen(jax.random.key(seed)), cfg_j))
    return cfg_j, cfg_t, p, load(cfg_t, p)


def close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("arch", ARCHS)
def test_layer_leaves_match_reference(arch):
    cfg_j, cfg_t, p, layer = layer_pair(arch)
    names = {n for n, _ in layer.named_parameters()}
    want = {jax.tree_util.keystr(k).replace("']['", ".").strip("[']")
            for k, _ in jax.tree_util.tree_leaves_with_path(p)}
    assert names == want
    glu = cfg_t.act in ("swiglu", "geglu")
    assert ("wg" in names) == glu
    assert sum(n.startswith("shared") for n in names) == \
        (3 if glu else 2) * cfg_t.moe.num_shared
    # the router stays float32 in a bf16 model, as the reference's
    bf16 = dataclasses.replace(cfg_t, dtype=torch.bfloat16)
    seeded = moe.MoEFFN(bf16, torch.Generator().manual_seed(0), "cpu")
    assert seeded.router.dtype == torch.float32
    assert seeded.wi.dtype == torch.bfloat16
    # the reference's scales: 1/sqrt(fan_in), fan_in = the leading dim
    assert abs(float(seeded.wi.detach().float().std())
               - cfg_t.moe.num_experts ** -0.5) < 0.05


@pytest.mark.parametrize("arch", ARCHS)
def test_route_matches_reference(arch):
    cfg_j, cfg_t, p, layer = layer_pair(arch)
    x = np.random.default_rng(1).standard_normal(
        (24, cfg_t.d_model)).astype(np.float32)
    w_j, idx_j = jmoe._route(jnp.asarray(x), jnp.asarray(p["router"]),
                             cfg_j.moe.top_k)
    w_t, idx_t = moe._route(torch.from_numpy(x), layer.router,
                            cfg_t.moe.top_k)
    assert np.array_equal(idx_t.numpy(), np.asarray(idx_j))
    close(w_t, w_j)


@pytest.mark.parametrize("capacity", [2, 3, 16], ids=["drop", "drop3",
                                                      "roomy"])
def test_dispatch_and_combine_match_reference(capacity):
    rng = np.random.default_rng(capacity)
    T, k, E, d = 12, 2, 4, 8
    x = rng.standard_normal((T, d)).astype(np.float32)
    # expert 0 chosen by every token: it overflows any capacity below T
    idx = np.stack([np.zeros(T, np.int64), rng.integers(1, E, T)], axis=1)
    want = jmoe._dispatch(jnp.asarray(x), jnp.asarray(idx), capacity, E)
    got = moe._dispatch(torch.from_numpy(x), torch.from_numpy(idx),
                        capacity, E)
    close(got[0], want[0], 0)  # every slot written once: exact
    assert np.array_equal(got[1].numpy(), np.asarray(want[1]))
    assert np.array_equal(got[2].numpy(), np.asarray(want[2]))
    if capacity < T:
        assert not got[2].all()  # the case drops tokens
    out = rng.standard_normal((E, capacity, d)).astype(np.float32)
    weights = rng.random((T, k)).astype(np.float32)
    want_y = jmoe._combine(jnp.asarray(out), jnp.asarray(idx), want[1],
                           want[2], jnp.asarray(weights))
    got_y = moe._combine(torch.from_numpy(out), torch.from_numpy(idx),
                         got[1], got[2], torch.from_numpy(weights))
    close(got_y, want_y)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("cf", [None, 0.5], ids=["config", "drop"])
def test_moe_ffn_forward_and_grads_match_reference(arch, cf):
    cfg_j, cfg_t, p, layer = layer_pair(arch)
    if cf is not None:  # a capacity below the load: tokens are dropped
        cfg_j = dataclasses.replace(cfg_j, moe=dataclasses.replace(
            cfg_j.moe, capacity_factor=cf))
        cfg_t = dataclasses.replace(cfg_t, moe=dataclasses.replace(
            cfg_t.moe, capacity_factor=cf))
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 10, cfg_t.d_model)).astype(np.float32)
    g = rng.standard_normal(x.shape).astype(np.float32)

    def loss_j(p, x):
        return jnp.sum(jmoe.moe_ffn(p, x, cfg_j) * g)

    pj = jax.tree.map(jnp.asarray, p)
    want = jmoe.moe_ffn(pj, jnp.asarray(x), cfg_j)
    dp_j, dx_j = jax.grad(loss_j, argnums=(0, 1))(pj, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    got = moe.moe_ffn(layer, xt, cfg_t)
    close(got, want, TOL_FFN)
    params = dict(layer.named_parameters())
    grads = torch.autograd.grad(torch.sum(got * torch.from_numpy(g)),
                                [xt, *params.values()])
    close(grads[0], dx_j, TOL_FFN)
    for (name, _), gt in zip(params.items(), grads[1:]):
        node = dp_j
        for part in name.split("."):
            node = node[part]
        close(gt, node, TOL_FFN)


@pytest.mark.parametrize("layout", ["ep", "tp"])
def test_one_device_layouts_are_the_none_function(layout):
    cfg_j, cfg_t, p, layer = layer_pair("deepseek-moe-16b")
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (1, 8, cfg_t.d_model)).astype(np.float32))
    with torch.no_grad():
        assert torch.equal(moe.moe_ffn(layer, x, cfg_t, layout=layout),
                           moe.moe_ffn(layer, x, cfg_t))
    with pytest.raises(ValueError):
        moe.moe_ffn(layer, x, cfg_t, layout="sideways")
