"""Port models against the reference: configs, layout, layers, forward.

Every config field and parameter count of every registered arch, full and
reduced; the stage layout; RoPE and the decoder layer; and the logits of
``reference_forward`` on identical weights (the reference's parameters
loaded by path through ``params_from_reference``).  float32, tolerance
1e-4 for whole-model outputs, 2e-5 for single functions.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models.build import build as jbuild
from repro.models import layers as jlayers
from repro_torch.configs import registry
from repro_torch.models.build import build as tbuild
from repro_torch.models import layers
from repro_torch.models.convert import params_from_reference

DTYPE_NAMES = {jnp.bfloat16: "bfloat16", jnp.float32: "float32",
               torch.bfloat16: "bfloat16", torch.float32: "float32"}


def _fields(cfg):
    out = dataclasses.asdict(cfg)
    out["dtype"] = DTYPE_NAMES[cfg.dtype]
    return out


@pytest.mark.parametrize("arch", jreg.ARCHS)
def test_configs_and_param_counts_match(arch):
    assert registry.ARCHS == jreg.ARCHS
    for port, ref in ((registry.get_arch(arch), jreg.get_arch(arch)),
                      (registry.reduced_config(arch, num_layers=4),
                       jreg.reduced_config(arch, num_layers=4))):
        assert _fields(port) == _fields(ref)
        assert port.pattern == ref.pattern
        assert port.param_count() == ref.param_count()
        assert port.active_param_count() == ref.active_param_count()


@pytest.mark.parametrize("arch", jreg.ARCHS)
@pytest.mark.parametrize("stages", [2, 4, 5])
def test_stage_layout_matches(arch, stages):
    ref = jbuild(jreg.get_arch(arch), num_stages=stages)
    port = tbuild(registry.get_arch(arch), num_stages=stages)
    assert np.array_equal(port.counts, ref.counts)
    assert port.l_max == ref.l_max and port.layer_types == ref.layer_types
    assert np.array_equal(port.type_ids, ref.type_ids)
    assert np.array_equal(port.shared_flags, ref.shared_flags)
    for s in range(stages):
        for k, v in ref.rows(s).items():
            assert np.array_equal(port.rows(s)[k], v)


def test_unported_layer_kinds_name_their_slice():
    model = tbuild(registry.reduced_config("deepseek-moe-16b"), 2)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        model.init_stage_params(0, device="cpu")
    model = tbuild(registry.reduced_config("zamba2-1.2b"), 2)
    with pytest.raises(NotImplementedError, match="SSM slice"):
        model.init_io_params(device="cpu")


def test_rope_matches_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 12, 3, 16)).astype(np.float32)
    pos = np.broadcast_to(np.arange(12, dtype=np.int32), (2, 12))
    want = jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e4)
    got = layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos.copy()),
                            1e4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)
    assert np.array_equal(layers.rope_freqs(16, 1e4),
                          jlayers.rope_freqs(16, 1e4))


def _reference_model(arch, stages, layers_n=4):
    cfg = jreg.reduced_config(arch, num_layers=layers_n)
    model = jbuild(cfg, num_stages=stages)
    key = jax.random.key(0)
    sp = model.init_stage_params(key)
    io = model.init_io_params(jax.random.fold_in(key, 1))
    return model, sp, io


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("act", ["gelu", "swiglu", "geglu"])
def test_decoder_layer_matches_reference(act):
    cfg_j = dataclasses.replace(jreg.reduced_config("deepseek-7b"), act=act)
    cfg_t = dataclasses.replace(registry.reduced_config("deepseek-7b"),
                                act=act)
    model_j = jbuild(cfg_j, num_stages=1)
    p = model_j.init_layer_params(jax.random.key(3))["blk"]
    port = layers.DecoderLayer(cfg_t, None, "cpu")
    with torch.no_grad():
        for name, t in port.named_parameters():
            node = p
            for part in name.split("."):
                node = node[part]
            t.copy_(torch.from_numpy(np.array(node)))
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 16, cfg_t.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(16, dtype=np.int32), (2, 16)).copy()
    want = jlayers.decoder_layer(p, jnp.asarray(x), jnp.asarray(pos), cfg_j)
    got = layers.decoder_layer(port, torch.from_numpy(x),
                               torch.from_numpy(pos), cfg_t)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("arch", ["paper-gpt3-large", "deepseek-7b",
                                  "qwen1.5-32b", "granite-34b", "gemma3-4b"])
def test_reference_forward_logits_match(arch):
    model_j, sp, io = _reference_model(arch, stages=2)
    model_t = tbuild(registry.reduced_config(arch, num_layers=4), 2)
    stages, io_t = params_from_reference(model_t, _np_tree(sp), _np_tree(io),
                                         "cpu")
    rng = np.random.default_rng(2)
    b, s = 2, 16
    tokens = rng.integers(0, model_j.cfg.vocab_size, (b, s)).astype(np.int32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s)).copy()
    want = model_j.reference_forward(sp, io, {"tokens": jnp.asarray(tokens)},
                                     {"positions": jnp.asarray(pos)})
    with torch.no_grad():
        got = model_t.reference_forward(
            stages, io_t, {"tokens": torch.from_numpy(tokens).long()},
            {"positions": torch.from_numpy(pos)})
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)


def test_params_from_reference_loads_every_leaf_by_path():
    model_j, sp, io = _reference_model("paper-gpt3-large", stages=2)
    model_t = tbuild(registry.reduced_config("paper-gpt3-large",
                                             num_layers=4), 2)
    stages, io_t = params_from_reference(model_t, _np_tree(sp), _np_tree(io),
                                         "cpu")
    n_ref = sum(x.size for x in jax.tree.leaves(sp)) + sum(
        x.size for x in jax.tree.leaves(io))
    n_port = sum(p.numel() for m in [*stages, io_t] for p in m.parameters())
    assert n_port == n_ref
    wq = np.asarray(sp["blk"]["attn"]["wq"])
    assert np.array_equal(stages[1].slots[0].blk.attn.wq.detach().numpy(),
                          wq[1, 0])


def test_bfloat16_leaves_convert_bit_for_bit():
    from repro_torch.models.convert import tensor_from_numpy

    a = jnp.asarray(np.random.default_rng(0).standard_normal(64),
                    jnp.bfloat16)
    t = tensor_from_numpy(np.asarray(a), "cpu")
    assert t.dtype == torch.bfloat16
    assert np.array_equal(t.float().numpy(), np.asarray(a, np.float32))


def test_seeded_init_is_reproducible_with_reference_scales():
    cfg = registry.reduced_config("paper-gpt3-large", num_layers=2)
    model = tbuild(cfg, num_stages=1)
    a = model.init_stage_params(0, seed=5, device="cpu")
    b = model.init_stage_params(0, seed=5, device="cpu")
    for (n, x), (_, y) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(x, y), n
    io = model.init_io_params(seed=5, device="cpu")
    assert abs(float(io.embed.detach().std()) - 0.02) < 0.005
    wq = a.slots[0].blk.attn.wq.detach()
    assert abs(float(wq.std()) - cfg.d_model ** -0.5) < 0.03
    assert float(a.slots[0].blk.ln1.detach().abs().sum()) == 0.0
