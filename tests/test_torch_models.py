"""Port models against the reference: configs, layout, layers, forward.

Every config field and parameter count of every registered arch, full and
reduced; the stage layout and MoE layout; RoPE, M-RoPE (three distinct
position streams) and the decoder layer; the logits of
``reference_forward`` on identical weights (the reference's parameters
loaded by path through ``params_from_reference``); and every arch's
forward, gradient step and decode step on the CPU.  float32, tolerance
1e-4 for whole-model outputs, 2e-5 for single functions (1e-5 M-RoPE).
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
from repro.models.common import keygen
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
    assert port.moe_layout == ref.moe_layout
    for s in range(stages):
        for k, v in ref.rows(s).items():
            assert np.array_equal(port.rows(s)[k], v)


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "grok-1-314b"])
def test_moe_layouts_over_devices_raise_naming_item_18(arch):
    """The reference's ``ep``/``tp`` layouts spread the experts over its
    data axis.  Over more than one data rank (ROADMAP item 18a, the table
    runtime's mesh) a stage holds its rank's expert shard and exchanges
    tokens through the data group's collectives: it runs only cut at its
    exchanges (``ArchModel.stage_phases``, ``models/phases.py``), so its
    plain forward, with or without autograd, raises, and so does its
    decode without the data group's exchange (``aux["exchange"]``)."""
    cfg = registry.reduced_config(arch, num_layers=2)
    model = tbuild(cfg, 1)
    sp = model.init_stage_params(0, seed=None, device="cpu", data_size=2)
    io = model.init_io_params(seed=0, device="cpu")
    x = torch.zeros((1, 4, cfg.d_model))
    aux = {"positions": torch.arange(4)[None], "data_size": 2,
           "moe_layout": model.moe_layout}
    assert model.exchanges(model.rows(0), aux)
    with torch.no_grad(), pytest.raises(ValueError, match="exchange"):
        model.stage_forward(sp, io, x, aux, model.rows(0))
    cache = model.init_stage_cache(1, 8, device="cpu")
    with torch.no_grad(), pytest.raises(ValueError, match="exchange"):
        model.stage_decode(sp, io, x[:, :1], cache, 0, aux, model.rows(0))
    with pytest.raises(ValueError, match="models/phases.py"):
        model.stage_forward(sp, io, x, aux, model.rows(0))


@pytest.mark.parametrize("layout", ["ep", "tp"])
@pytest.mark.parametrize("shared_period", [0, 2])
def test_stage_phases_are_the_stage_forward(layout, shared_period):
    """An exchanging stage's one definition, ``ArchModel.stage_phases``,
    over one data rank (its exchanges the identity) is the plain
    ``stage_forward`` bit for bit, a slot's shared block included
    (``shared_period`` 2 flags the first slot of each stage), and its
    phased gradients are autograd's of ``stage_forward`` (float32, within
    1e-5 of their max)."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.phases import phased_grads, run_forward

    cfg = dataclasses.replace(
        registry.reduced_config("deepseek-moe-16b", num_layers=4),
        shared_attn_period=shared_period)
    model = tbuild(cfg, 2)
    sp = model.init_stage_params(1, seed=0, device="cpu")
    io = model.init_io_params(seed=0, device="cpu")
    rows = model.rows(1)
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((2, 8, cfg.d_model), generator=gen)
    g = torch.randn((2, 8, cfg.d_model), generator=gen)
    aux = {"positions": torch.arange(8)[None].expand(2, 8), "data_size": 1,
           "moe_layout": layout}
    params = list(sp.parameters()) + list(io.parameters())
    xg = x.clone().requires_grad_()
    y = model.stage_forward(sp, io, xg, aux, rows)
    want = torch.autograd.grad(y, [xg] + params, g, allow_unused=True)
    mesh = make_mesh(1, 1, device="cpu")
    ex = mesh.exchange_over("data")

    def rank():
        fwd = run_forward(*model.stage_phases(sp, io, aux, rows,
                                              remat=False), {"x": x}, ex)
        phases, cuts = model.stage_phases(sp, io, aux, rows)
        gx, grads, _ = phased_grads(phases, cuts, {"x": x}, ex, params,
                                    {"x": g}, ("x",))
        return fwd["x"], [gx["x"], *grads]

    got_y, got = mesh.run(rank, [()])[0]
    assert torch.equal(got_y, y.detach())
    for a, b in zip(got, want, strict=True):
        assert (a is None) == (b is None)
        if b is not None:
            scale = max(float(b.abs().max()), 1e-30)
            assert float((a - b).abs().max()) <= 1e-5 * scale


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


def mrope_streams(b, s, seed=0):
    """Three distinct t/h/w position streams [3, b, s]: a time index that
    holds over image patches and a 2-D patch grid (equal streams would
    make M-RoPE plain RoPE)."""
    rng = np.random.default_rng(seed)
    t = np.cumsum(rng.integers(0, 2, (b, s)), axis=1)
    h = rng.integers(0, 6, (b, s))
    w = rng.integers(0, 9, (b, s))
    return np.stack([t, h, w]).astype(np.int32)


@pytest.mark.parametrize("hd", [16, 32, 128])
def test_mrope_matches_reference_on_distinct_streams(hd):
    """hd 128 takes the sections (16, 24, 24) as they are; 16 and 32
    rescale them as the reference does."""
    rng = np.random.default_rng(hd)
    x = rng.standard_normal((2, 12, 3, hd)).astype(np.float32)
    pos3 = mrope_streams(2, 12, seed=hd)
    want = jlayers.apply_mrope(jnp.asarray(x), jnp.asarray(pos3), 1e6)
    got = layers.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos3),
                             1e6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    plain = layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos3[0]),
                              1e6)
    assert (got - plain).abs().max() > 1e-2  # the h/w sections rotate apart
    # equal streams: M-RoPE is plain RoPE (why the synthetic data cannot
    # tell them apart)
    same = np.broadcast_to(pos3[:1], pos3.shape).copy()
    np.testing.assert_allclose(
        layers.apply_mrope(torch.from_numpy(x), torch.from_numpy(same),
                           1e6).numpy(), plain.numpy(), atol=1e-6)


def reduced_configs(arch, layers_n):
    """(reference, port) reduced configs; zamba2 keeps its Mamba pattern
    (the registries' reduced config has only attention layers for it)."""
    cfgs = (jreg.reduced_config(arch, num_layers=layers_n),
            registry.reduced_config(arch, num_layers=layers_n))
    if arch == "zamba2-1.2b":
        cfgs = tuple(dataclasses.replace(c, layer_pattern=("mamba",) * layers_n)
                     for c in cfgs)
    return cfgs


def _reference_model(arch, stages, layers_n=4):
    cfg = reduced_configs(arch, layers_n)[0]
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


def model_inputs(cfg, b, s, seed=2):
    """numpy (batch, aux) of a reduced config: tokens or, for an
    ``embed_input`` arch, embeddings; M-RoPE streams for qwen2-vl; for an
    enc-dec arch ``dec_len = s // 2`` (a Python int), the rest of the
    sequence the encoder's frames, as tests/test_archs.py gives it."""
    rng = np.random.default_rng(seed)
    if cfg.embed_input:
        batch = {"embeds": rng.standard_normal((b, s, cfg.d_model)).astype(
            np.float32)}
    else:
        batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(
            np.int32)}
    aux = {"positions": np.broadcast_to(np.arange(s, dtype=np.int32),
                                        (b, s)).copy()}
    if cfg.mrope:
        aux["mrope"] = mrope_streams(b, s, seed)
    if cfg.encoder_layers:
        aux["dec_len"] = s // 2
    return batch, aux


def torch_inputs(batch, aux):
    return ({k: torch.from_numpy(v).long() if k == "tokens"
             else torch.from_numpy(v) for k, v in batch.items()},
            {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
             for k, v in aux.items()})


def jax_inputs(batch, aux):
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
             for k, v in aux.items()})


@pytest.mark.parametrize("arch", ["paper-gpt3-large", "deepseek-7b",
                                  "qwen1.5-32b", "granite-34b", "gemma3-4b",
                                  "zamba2-1.2b", "deepseek-moe-16b",
                                  "grok-1-314b", "xlstm-350m",
                                  "qwen2-vl-2b", "seamless-m4t-large-v2"])
def test_reference_forward_logits_match(arch):
    # zamba2: 5 Mamba layers on 2 stages (a disabled slot, shared-block
    # slots on both stages); seq 40 = two full chunks of 16 and a padded
    # one.  deepseek-moe: its dense first layer and MoE layers (shared
    # experts); grok: GEGLU experts; xlstm: the reduced 3:1 pattern;
    # qwen2-vl: embeddings in, three distinct M-RoPE streams; seamless: 2
    # enc + 2 dec layers over 8 decoder tokens and 8 encoder positions
    layers_n, s = (5, 40) if arch == "zamba2-1.2b" else (4, 16)
    model_j, sp, io = _reference_model(arch, stages=2, layers_n=layers_n)
    model_t = tbuild(reduced_configs(arch, layers_n)[1], 2)
    stages, io_t = params_from_reference(model_t, _np_tree(sp), _np_tree(io),
                                         "cpu")
    batch, aux = model_inputs(model_t.cfg, 2, s)
    batch_j, aux_j = jax_inputs(batch, aux)
    want = model_j.reference_forward(
        sp, io, batch_j, {**aux_j, "data_size": 1, "moe_layout": "none"})
    with torch.no_grad():
        got = model_t.reference_forward(stages, io_t,
                                        *torch_inputs(batch, aux))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)


@pytest.mark.parametrize("arch", jreg.ARCHS)
def test_every_arch_forward_grad_step_and_decode(arch):
    """The port's counterpart of tests/test_archs.py on every registered
    arch (reduced, 6 layers on 4 stages, seeded weights): finite logits of
    the right shape, finite gradients with some nonzero (seamless: its
    encoder's and cross-attention's among them, ``dec_len`` 16 of 32), and
    one decode step against a cache on every stage."""
    cfg = registry.reduced_config(arch, num_layers=6)
    model = tbuild(cfg, 4)
    sp = [model.init_stage_params(s, seed=1, device="cpu") for s in range(4)]
    io = model.init_io_params(seed=1, device="cpu")
    batch, aux = torch_inputs(*model_inputs(cfg, 2, 32))
    logits = model.reference_forward(sp, io, batch, aux)
    assert logits.shape == (2, 32, cfg.padded_vocab())
    assert torch.isfinite(logits).all()
    lse = torch.logsumexp(logits.float(), dim=-1)
    named = [(n, p) for m in (*sp, io) for n, p in m.named_parameters()]
    grads = torch.autograd.grad(lse.mean(), [p for _, p in named],
                                allow_unused=True)
    nonzero = {n for (n, _), g in zip(named, grads)
               if g is not None and float(g.abs().max()) > 0}
    assert all(torch.isfinite(g).all() for g in grads if g is not None)
    assert nonzero
    if cfg.encoder_layers:  # the encoder and the cross-attention train
        assert any(n.endswith("cross.wk") for n in nonzero)
        assert any(n.endswith("blk.attn.wq") for n in nonzero)
    x = torch.randn((2, 1, cfg.d_model),
                    generator=torch.Generator().manual_seed(5)) * 0.1
    with torch.inference_mode():
        for s in range(4):
            cache = model.init_stage_cache(2, 16, 4, device="cpu")
            y, _ = model.stage_decode(sp[s], io, x, cache, 3, {},
                                      model.rows(s))
            assert y.shape == x.shape and torch.isfinite(y).all()


@pytest.mark.parametrize("rope", [True, False])
def test_cross_attention_block_matches_reference(rope):
    """``attention_block`` with ``kv_src``: q from 12 decoder positions, k
    and v from 20 encoder frames (sq != sk), non-causal; with ``rope`` the
    keys rotate by ``arange(sk)``.  GQA 4/2, weights without biases."""
    cfg_j = jreg.reduced_config("seamless-m4t-large-v2")
    cfg_t = registry.reduced_config("seamless-m4t-large-v2")
    cfg_j, cfg_t = (dataclasses.replace(c, num_kv_heads=2)
                    for c in (cfg_j, cfg_t))
    p = jlayers.init_attention(keygen(jax.random.key(4)), cfg_j, cross=True)
    port = layers.Attention(cfg_t, None, "cpu", cross=True)
    with torch.no_grad():
        for name, t in port.named_parameters():
            t.copy_(torch.from_numpy(np.array(p[name])))
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 12, cfg_t.d_model)).astype(np.float32)
    enc = rng.standard_normal((2, 20, cfg_t.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(12, dtype=np.int32), (2, 12)).copy()
    want = jlayers.attention_block(p, jnp.asarray(x), jnp.asarray(pos),
                                   cfg_j, causal=False,
                                   kv_src=jnp.asarray(enc), rope=rope)
    got = layers.attention_block(port, torch.from_numpy(x),
                                 torch.from_numpy(pos), cfg_t, causal=False,
                                 kv_src=torch.from_numpy(enc), rope=rope)
    assert got.shape == (2, 12, cfg_t.d_model)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=2e-5, rtol=2e-5)


def test_cut_depth_halves_an_enc_dec_config():
    """``cut_depth`` of seamless keeps equal encoder and decoder halves (the
    full config's 24 encoder layers would leave no decoder)."""
    for n in (2, 8, 48):
        cfg = registry.cut_depth("seamless-m4t-large-v2", n)
        assert cfg.d_model == 1024 and cfg.num_layers == n
        assert cfg.pattern == ("enc",) * (n // 2) + ("dec",) * (n // 2)
    assert (registry.cut_depth("seamless-m4t-large-v2", 48)
            == registry.get_arch("seamless-m4t-large-v2"))
    assert registry.cut_depth("paper-gpt3-large", 4).encoder_layers == 0


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
