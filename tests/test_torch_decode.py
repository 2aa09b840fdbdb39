"""The port's decode half against the reference: layers, Mamba-2, stage_decode.

On the CPU the port's cross-attention decode runs kernel K3's plain version
and every other decode function is plain PyTorch, as in the reference.
Inputs, weights and warm caches come from numpy seeds (weights through the
reference's init, loaded by path) and go to both packages.  Tolerances:
float32 2e-5 for single functions (tests/test_kernels.py's ``TOL``), 1e-4
for a whole stage.  The port updates caches in place; each test compares
the port's cache after the call with the cache the reference returns.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.kernels import ops as jops
from repro.models import layers as jlayers
from repro.models import ssm as jssm
from repro.models.build import build as jbuild
from repro.models.common import keygen
from repro_torch.configs import registry
from repro_torch.kernels import ops
from repro_torch.models import layers, ssm
from repro_torch.models.build import build
from repro_torch.models.convert import (
    cache_from_reference,
    params_from_reference,
)

TOL = 2e-5
TOL_STAGE = 1e-4
#: (arch, layers, stages): dense with a disabled slot; gemma3's local and
#: global windows; seamless with an encoder-only stage, a mixed stage and a
#: disabled slot; zamba2's Mamba layers with shared-block slots;
#: deepseek-moe's dense and MoE layers (a disabled slot), grok's GEGLU
#: experts; xlstm's mLSTM and sLSTM states; qwen2-vl (plain RoPE at decode)
ARCHS = [("deepseek-7b", 5, 2), ("gemma3-4b", 4, 2),
         ("seamless-m4t-large-v2", 6, 4), ("zamba2-1.2b", 3, 2),
         ("deepseek-moe-16b", 3, 2), ("grok-1-314b", 3, 2),
         ("xlstm-350m", 4, 2), ("qwen2-vl-2b", 3, 2)]


def configs(arch: str, n_layers: int):
    """The reference's and the port's reduced config; zamba2 with its Mamba
    pattern (the registry's reduced hybrid config has no Mamba layer)."""
    cj, ct = jreg.reduced_config(arch, n_layers), registry.reduced_config(
        arch, n_layers)
    if arch == "zamba2-1.2b":
        cj = dataclasses.replace(cj, layer_pattern=("mamba",) * n_layers)
        ct = dataclasses.replace(ct, layer_pattern=("mamba",) * n_layers)
    return cj, ct


def close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


def warm(shape, rng, dtype=np.float32):
    return rng.standard_normal(shape).astype(dtype)


def jax_layer(cfg_j):
    return jlayers.init_decoder_layer(keygen(jax.random.key(1)), cfg_j)


def port_layer(cfg_t, p_np):
    layer = layers.DecoderLayer(cfg_t, None, "cpu")
    with torch.no_grad():
        for name, t in layer.named_parameters():
            node = p_np
            for part in name.split("."):
                node = node[part]
            t.copy_(torch.from_numpy(np.array(node)))
    return layer


# ---------------------------------------------------------------------------
# layers: decode_attention, decode_attention_block, decoder_layer_decode
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("window", [0, 4])
def test_decode_attention_matches_reference(window):
    rng = np.random.default_rng(window)
    q, k, v = warm((3, 1, 4, 16), rng), warm((3, 12, 2, 16), rng), warm(
        (3, 12, 2, 16), rng)
    lengths = np.array([1, 7, 12], np.int32)
    want = jlayers.decode_attention(*map(jnp.asarray, (q, k, v, lengths)),
                                    window=window)
    got = layers.decode_attention(*map(torch.from_numpy, (q, k, v, lengths)),
                                  window=window)
    close(got, want, TOL)


@pytest.mark.parametrize("arch,window,pos", [("deepseek-7b", 0, 0),
                                             ("deepseek-7b", 0, 9),
                                             ("gemma3-4b", 4, 9),
                                             ("qwen1.5-32b", 0, 5)])
def test_decoder_layer_decode_matches_reference(arch, window, pos):
    cfg_j, cfg_t = configs(arch, 2)
    p = jax.tree.map(np.asarray, jax_layer(cfg_j))
    rng = np.random.default_rng(pos)
    if "bq" in p["attn"]:  # qwen: non-zero biases
        for b in ("bq", "bk", "bv"):
            p["attn"][b] = warm(p["attn"][b].shape, rng)
    x = warm((2, 1, cfg_t.d_model), rng)
    shape = (2, 12, cfg_t.num_kv_heads, cfg_t.resolved_head_dim)
    cache = {"k": warm(shape, rng), "v": warm(shape, rng)}
    want, want_cache = jlayers.decoder_layer_decode(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x),
        jax.tree.map(jnp.asarray, cache), jnp.asarray(pos, jnp.int32), cfg_j,
        window=window)
    cache_t = {k: torch.from_numpy(v.copy()) for k, v in cache.items()}
    with torch.inference_mode():
        got, got_cache = layers.decoder_layer_decode(
            port_layer(cfg_t, p), torch.from_numpy(x), cache_t, pos, cfg_t,
            window=window)
    assert got_cache is cache_t  # updated in place
    close(got, want, TOL)
    for name in ("k", "v"):
        close(cache_t[name], want_cache[name], TOL)


def test_decode_attention_block_matches_reference_and_writes_one_row():
    cfg_j, cfg_t = configs("deepseek-7b", 2)
    p_layer = jax.tree.map(np.asarray, jax_layer(cfg_j))
    p = p_layer["attn"]
    rng = np.random.default_rng(5)
    x = warm((2, 1, cfg_t.d_model), rng)
    shape = (2, 8, cfg_t.num_kv_heads, cfg_t.resolved_head_dim)
    cache = {"k": warm(shape, rng), "v": warm(shape, rng)}
    want, want_cache = jlayers.decode_attention_block(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x),
        jax.tree.map(jnp.asarray, cache), jnp.asarray(3, jnp.int32), cfg_j)
    attn = port_layer(cfg_t, p_layer).attn
    cache_t = {k: torch.from_numpy(v.copy()) for k, v in cache.items()}
    with torch.inference_mode():
        got, _ = layers.decode_attention_block(attn, torch.from_numpy(x),
                                               cache_t, 3, cfg_t)
    close(got, want, TOL)
    for name in ("k", "v"):
        close(cache_t[name], want_cache[name], TOL)
        untouched = np.delete(np.arange(8), 3)
        assert np.array_equal(cache_t[name].numpy()[:, untouched],
                              cache[name][:, untouched])


def test_cross_attention_has_no_biases():
    cfg = registry.reduced_config("qwen1.5-32b", 2)
    assert cfg.qkv_bias
    names = {n for n, _ in layers.Attention(cfg, None, "cpu",
                                            cross=True).named_parameters()}
    assert names == {"wq", "wk", "wv", "wo"}
    assert "bq" in dict(layers.Attention(cfg, None, "cpu").named_parameters())


# ---------------------------------------------------------------------------
# Mamba-2 decode
# ---------------------------------------------------------------------------
def test_ssd_decode_step_matches_reference():
    rng = np.random.default_rng(0)
    b, nh, hd, ds = 2, 3, 8, 5
    args = (warm((b, nh, hd, ds), rng), warm((b, nh, hd), rng),
            np.abs(warm((b, nh), rng)) * np.float32(0.1),
            -np.abs(warm((nh,), rng)), warm((b, ds), rng), warm((b, ds), rng),
            warm((nh,), rng))
    want_y, want_state = jops.ssd_decode_step(*map(jnp.asarray, args))
    got_y, got_state = ops.ssd_decode_step(*map(torch.from_numpy, args))
    close(got_y, want_y, TOL)
    close(got_state, want_state, TOL)


def test_mamba_layer_decode_matches_reference_over_steps():
    cfg_j, cfg_t = configs("zamba2-1.2b", 2)
    p = jax.tree.map(np.asarray, jssm.init_mamba_layer(
        keygen(jax.random.key(4)), cfg_j))
    rng = np.random.default_rng(4)
    for k in ("ln", "conv_b", "a_log", "dt_bias", "d_skip", "gate_ln"):
        p[k] = p[k] + warm(p[k].shape, rng) * np.float32(0.1)
    port = ssm.MambaLayer(cfg_t, None, "cpu")
    with torch.no_grad():
        for name, t in port.named_parameters():
            t.copy_(torch.from_numpy(np.array(p[name])))
    cache_j = jax.tree.map(jnp.asarray, jssm.init_mamba_cache(2, cfg_j))
    cache_j = jax.tree.map(lambda c: jnp.asarray(warm(c.shape, rng)), cache_j)
    cache_t = {k: torch.from_numpy(np.array(v)) for k, v in cache_j.items()}
    for step in range(3):
        x = warm((2, 1, cfg_t.d_model), rng)
        want, cache_j = jssm.mamba_layer_decode(
            jax.tree.map(jnp.asarray, p), jnp.asarray(x), cache_j, cfg_j)
        with torch.inference_mode():
            got, _ = ssm.mamba_layer_decode(port, torch.from_numpy(x),
                                            cache_t, cfg_t)
        close(got, want, TOL)
        for name in ("conv", "ssm"):
            close(cache_t[name], cache_j[name], TOL)


def test_init_mamba_cache_matches_reference():
    cfg_j, cfg_t = configs("zamba2-1.2b", 2)
    want = jssm.init_mamba_cache(3, cfg_j)
    got = ssm.init_mamba_cache(3, cfg_t, device="cpu")
    for k in ("conv", "ssm"):
        assert tuple(got[k].shape) == want[k].shape
        assert str(got[k].dtype).split(".")[1] == want[k].dtype.name


# ---------------------------------------------------------------------------
# stage_decode on every stage, on identical weights and warm caches
# ---------------------------------------------------------------------------
def reference_model(arch, n_layers, stages):
    cfg_j, cfg_t = configs(arch, n_layers)
    model_j, model_t = jbuild(cfg_j, stages), build(cfg_t, stages)
    key = jax.random.key(0)
    sp = jax.tree.map(np.asarray, model_j.init_stage_params(key))
    io = jax.tree.map(np.asarray,
                      model_j.init_io_params(jax.random.fold_in(key, 1)))
    sp_t, io_t = params_from_reference(model_t, sp, io, "cpu")
    return model_j, model_t, sp, io, sp_t, io_t


def warm_caches(model_j, batch, seq, enc_len, seed):
    """A reference cache tree [S, l_max, ...] of seeded values."""
    rng = np.random.default_rng(seed)
    one = model_j.init_layer_cache(batch, seq, enc_len)
    lead = (model_j.num_stages, model_j.l_max)
    return jax.tree.map(lambda c: warm(lead + c.shape, rng, c.dtype), one)


@pytest.mark.parametrize("arch,n_layers,stages", ARCHS)
def test_stage_decode_matches_reference_on_every_stage(arch, n_layers,
                                                       stages):
    model_j, model_t, sp, io, sp_t, io_t = reference_model(arch, n_layers,
                                                           stages)
    cache_np = warm_caches(model_j, 2, 16, 6, seed=n_layers)
    caches_t = cache_from_reference(model_t, cache_np, "cpu")
    pos = 11  # past gemma3's reduced window of 8
    aux = {"data_size": 1, "moe_layout": "none"}
    for s in range(stages):
        x = warm((2, 1, model_t.cfg.d_model), np.random.default_rng(s))
        want, want_cache = model_j.stage_decode(
            jax.tree.map(lambda a: jnp.asarray(a[s]), sp),
            jax.tree.map(jnp.asarray, io), jnp.asarray(x),
            jax.tree.map(lambda a: jnp.asarray(a[s]), cache_np),
            jnp.asarray(pos, jnp.int32), aux, model_j.rows(s))
        with torch.inference_mode():
            got, got_cache = model_t.stage_decode(
                sp_t[s], io_t, torch.from_numpy(x), caches_t[s], pos, {},
                model_t.rows(s))
        assert got_cache is caches_t[s]
        close(got, want, TOL_STAGE)
        jax.tree.map(lambda g, w: close(g, w, TOL_STAGE), caches_t[s],
                     jax.tree.map(np.asarray, want_cache))


def test_cache_layout_matches_reference_and_rejects_mismatches():
    model_j, model_t, *_ = reference_model("seamless-m4t-large-v2", 4, 2)
    cache_np = warm_caches(model_j, 2, 8, 3, seed=0)
    caches = cache_from_reference(model_t, cache_np, "cpu")
    assert sorted(caches[1]) == ["k", "v", "xk", "xv"]
    assert tuple(caches[1]["xk"].shape) == (model_t.l_max, 2, 3, 4, 16)
    assert np.array_equal(caches[1]["xv"].numpy(), cache_np["xv"][1])
    bad = dict(cache_np, xk=cache_np["xk"].astype(np.float16))
    with pytest.raises(TypeError, match="does not match"):
        cache_from_reference(model_t, bad, "cpu")
    with pytest.raises(TypeError, match="keys"):
        cache_from_reference(model_t, {k: v for k, v in cache_np.items()
                                       if k != "xv"}, "cpu")


def test_enc_dec_forward_waits_for_the_spmd_executor():
    """The enc-dec forward, which the SPMD (table) executor runs: over
    ``concat(dec, enc)`` an ``enc`` stage changes only the frames after
    ``aux["dec_len"]`` and a ``dec`` stage only the tokens before it."""
    cfg = registry.reduced_config("seamless-m4t-large-v2", 4)
    model = build(cfg, 2)
    io = model.init_io_params(seed=0, device="cpu")
    x = torch.randn((1, 10, cfg.d_model),
                    generator=torch.Generator().manual_seed(3))
    aux = {"positions": torch.arange(10)[None], "dec_len": 4}
    for s, kept, changed in ((0, slice(0, 4), slice(4, 10)),
                             (1, slice(4, 10), slice(0, 4))):
        sp = model.init_stage_params(s, seed=0, device="cpu")
        assert hasattr(sp.slots[0], "cross")  # the union: cross everywhere
        with torch.no_grad():
            y = model.stage_forward(sp, io, x, aux, model.rows(s))
        assert y.shape == x.shape and torch.isfinite(y).all()
        assert torch.equal(y[:, kept], x[:, kept])
        assert not torch.equal(y[:, changed], x[:, changed])
