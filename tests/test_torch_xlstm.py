"""The port's xLSTM blocks against the reference's ``repro.models.xlstm``.

The mLSTM's parallel and chunked forms (forward and gradients, a padded
chunk included: 40 tokens in chunks of 16), the whole mLSTM and sLSTM
layers, and both decode steps over several tokens (caches updated in place
against the reference's returned ones), on identical weights (the
reference's ``init_*_layer``, loaded by name) and numpy-seeded inputs.
float32, tolerance 1e-4 (2e-5 for the decode steps); a gradient leaf
within 1e-4 of its own scale, max(1, max |grad|) (a weight's gradient sums
over every token, into tens).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import xlstm as jx
from repro.models.common import keygen
from repro_torch.configs import registry
from repro_torch.models import xlstm

TOL = 1e-4
TOL_STEP = 2e-5


def configs():
    """The registries' reduced xlstm-350m (the 3:1 pattern), d 64, 4 heads
    of 16."""
    return (jreg.reduced_config("xlstm-350m", 4),
            registry.reduced_config("xlstm-350m", 4))


def close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


def close_grad(got, want):
    want = np.asarray(want, np.float32)
    close(got, want, TOL * max(1.0, float(np.abs(want).max())))


def load(module, p_np):
    with torch.no_grad():
        for name, t in module.named_parameters():
            t.copy_(torch.from_numpy(np.array(p_np[name])))
    return module


def perturbed(p, rng):
    """The reference's init with its zero norms and biases perturbed, so
    every leaf matters."""
    p = dict(p)
    for k in ("ln", "gate_ln", "bi", "bf"):
        if k in p:
            p[k] = p[k] + (rng.standard_normal(p[k].shape) * 0.1).astype(
                p[k].dtype)
    return p


def gate_inputs(b, s, nh, hd, seed):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, s, nh, hd)).astype(np.float32)
               for _ in range(3))
    i_pre = rng.standard_normal((b, s, nh)).astype(np.float32)
    log_f = -np.log1p(np.exp(-(rng.standard_normal((b, s, nh)) + 2.0))
                      ).astype(np.float32)
    g = rng.standard_normal((b, s, nh, hd)).astype(np.float32)
    return (q, k, v, i_pre, log_f), g


def _value_and_grads_j(fn, args, g):
    args = tuple(map(jnp.asarray, args))
    out = fn(*args)
    grads = jax.grad(lambda *a: jnp.sum(fn(*a) * g),
                     argnums=tuple(range(len(args))))(*args)
    return out, grads


def _value_and_grads_t(fn, args, g):
    leaves = [torch.from_numpy(a.copy()).requires_grad_() for a in args]
    out = fn(*leaves)
    grads = torch.autograd.grad(torch.sum(out * torch.from_numpy(g)), leaves)
    return out, grads


@pytest.mark.parametrize("form", ["parallel", "chunked", "chunked-padded"])
def test_mlstm_forms_match_reference_forward_and_grads(form):
    s = {"parallel": 24, "chunked": 32, "chunked-padded": 40}[form]
    args, g = gate_inputs(2, s, 2, 8, seed=s)
    if form == "parallel":
        fj, ft = jx.mlstm_parallel, xlstm.mlstm_parallel
    else:
        fj = lambda *a: jx.mlstm_chunked(*a, chunk=16)  # noqa: E731
        ft = lambda *a: xlstm.mlstm_chunked(*a, chunk=16)  # noqa: E731
    want, want_g = _value_and_grads_j(fj, args, g)
    got, got_g = _value_and_grads_t(ft, args, g)
    close(got, want)
    for a, b in zip(got_g, want_g):
        assert torch.isfinite(a).all()  # no NaN through the -inf masks
        close_grad(a, b)
    if form != "parallel":  # the same function as the parallel form
        par, par_g = _value_and_grads_t(xlstm.mlstm_parallel, args, g)
        close(got, par.detach())
        for a, b in zip(got_g, par_g):
            close_grad(a, b.numpy())


@pytest.mark.parametrize("s,chunk", [(12, 128), (40, 16)],
                         ids=["parallel", "chunked"])
def test_mlstm_layer_matches_reference(s, chunk):
    cfg_j, cfg_t = configs()
    rng = np.random.default_rng(s)
    p = perturbed(jax.tree.map(np.asarray, jx.init_mlstm_layer(
        keygen(jax.random.key(1)), cfg_j)), rng)
    layer = load(xlstm.MLSTMLayer(cfg_t, None, "cpu"), p)
    assert layer.bi.dtype == torch.float32
    x = rng.standard_normal((2, s, cfg_t.d_model)).astype(np.float32)
    g = rng.standard_normal(x.shape).astype(np.float32)
    pj = jax.tree.map(jnp.asarray, p)
    want = jx.mlstm_layer(pj, jnp.asarray(x), cfg_j, chunk=chunk)
    dp = jax.grad(lambda p: jnp.sum(
        jx.mlstm_layer(p, jnp.asarray(x), cfg_j, chunk=chunk) * g))(pj)
    got = xlstm.mlstm_layer(layer, torch.from_numpy(x), cfg_t, chunk=chunk)
    close(got, want)
    params = dict(layer.named_parameters())
    grads = torch.autograd.grad(torch.sum(got * torch.from_numpy(g)),
                                list(params.values()))
    for name, gt in zip(params, grads):
        close_grad(gt, dp[name])


def test_slstm_layer_matches_reference_forward_and_grads():
    cfg_j, cfg_t = configs()
    rng = np.random.default_rng(7)
    p = perturbed(jax.tree.map(np.asarray, jx.init_slstm_layer(
        keygen(jax.random.key(2)), cfg_j)), rng)
    layer = load(xlstm.SLSTMLayer(cfg_t, None, "cpu"), p)
    assert tuple(layer.rz.shape) == (4, 16, 16)
    x = rng.standard_normal((2, 10, cfg_t.d_model)).astype(np.float32)
    g = rng.standard_normal(x.shape).astype(np.float32)
    pj = jax.tree.map(jnp.asarray, p)
    want = jx.slstm_layer(pj, jnp.asarray(x), cfg_j)
    dp = jax.grad(lambda p: jnp.sum(
        jx.slstm_layer(p, jnp.asarray(x), cfg_j) * g))(pj)
    got = xlstm.slstm_layer(layer, torch.from_numpy(x), cfg_t)
    close(got, want)
    params = dict(layer.named_parameters())
    grads = torch.autograd.grad(torch.sum(got * torch.from_numpy(g)),
                                list(params.values()))
    for name, gt in zip(params, grads):
        close_grad(gt, dp[name])


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_decode_steps_match_reference_over_tokens(kind):
    cfg_j, cfg_t = configs()
    rng = np.random.default_rng(9)
    init_j = jx.init_mlstm_layer if kind == "mlstm" else jx.init_slstm_layer
    p = perturbed(jax.tree.map(np.asarray, init_j(
        keygen(jax.random.key(3)), cfg_j)), rng)
    module = (xlstm.MLSTMLayer if kind == "mlstm" else xlstm.SLSTMLayer)(
        cfg_t, None, "cpu")
    layer = load(module, p)
    step_j = jx.mlstm_layer_decode if kind == "mlstm" else \
        jx.slstm_layer_decode
    step_t = xlstm.mlstm_layer_decode if kind == "mlstm" else \
        xlstm.slstm_layer_decode
    init_cj = jx.init_mlstm_cache if kind == "mlstm" else jx.init_slstm_cache
    init_ct = xlstm.init_mlstm_cache if kind == "mlstm" else \
        xlstm.init_slstm_cache
    cache_j = init_cj(2, cfg_j)
    cache_t = init_ct(2, cfg_t, device="cpu")
    for name, c in cache_j.items():  # the initial states, -inf included
        assert np.array_equal(cache_t[name].numpy(), np.asarray(c))
        assert cache_t[name].dtype == torch.float32
    pj = jax.tree.map(jnp.asarray, p)
    for _ in range(4):  # from the initial state on: the first m is -inf
        x = rng.standard_normal((2, 1, cfg_t.d_model)).astype(np.float32)
        want, cache_j = step_j(pj, jnp.asarray(x), cache_j, cfg_j)
        with torch.inference_mode():
            got, same = step_t(layer, torch.from_numpy(x), cache_t, cfg_t)
        assert same is cache_t  # updated in place
        close(got, want, TOL_STEP)
        for name in cache_t:
            close(cache_t[name], cache_j[name], TOL_STEP)


def test_mlstm_decode_continues_the_parallel_form():
    """The recurrent state after a prefix, stepped on, gives the parallel
    form's outputs (the port against itself: the two must be one
    function)."""
    _, cfg = configs()
    layer = xlstm.MLSTMLayer(cfg, torch.Generator().manual_seed(0), "cpu")
    x = torch.randn((1, 6, cfg.d_model),
                    generator=torch.Generator().manual_seed(1))
    with torch.inference_mode():
        full = xlstm.mlstm_layer(layer, x, cfg)
        cache = xlstm.init_mlstm_cache(1, cfg, device="cpu")
        steps = [xlstm.mlstm_layer_decode(layer, x[:, t:t + 1], cache,
                                          cfg)[0] for t in range(6)]
    close(torch.cat(steps, dim=1), full.numpy(), TOL_STEP)
