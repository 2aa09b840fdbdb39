"""The port's serve path against the reference's: greedy tokens equal.

The port's ``launch/serve.py`` loop (``pipeline/decode.py``'s staircase of
``stage_decode`` over stage-local caches, greedy float32 head) runs on the
reference's weights and seeded warm caches, against a loop of the
reference's ``stage_decode`` plus its greedy head, and against the
reference's own serve step (``repro.launch.serve.build_server``, its
shard_map executor on two host devices, in a subprocess).  float32, reduced
configs; tokens must be equal and the final caches agree within 1e-4.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import layers as jlayers
from repro.models.build import build as jbuild
from repro_torch.configs import registry
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.models.build import build
from repro_torch.models.convert import (
    cache_from_reference,
    params_from_reference,
)
from repro_torch.pipeline.decode import DecodeOptions, make_staircase_fn

ROOT = Path(__file__).resolve().parents[1]
TOKENS = 4
#: (arch, layers, stages), as in tests/test_torch_decode.py
ARCHS = [("deepseek-7b", 5, 2), ("gemma3-4b", 4, 2),
         ("seamless-m4t-large-v2", 6, 4), ("zamba2-1.2b", 3, 2),
         ("deepseek-moe-16b", 3, 2), ("grok-1-314b", 3, 2),
         ("xlstm-350m", 4, 2), ("qwen2-vl-2b", 3, 2)]


def configs(arch: str, n_layers: int):
    cj, ct = jreg.reduced_config(arch, n_layers), registry.reduced_config(
        arch, n_layers)
    if arch == "zamba2-1.2b":  # the reduced hybrid config has no Mamba layer
        cj = dataclasses.replace(cj, layer_pattern=("mamba",) * n_layers)
        ct = dataclasses.replace(ct, layer_pattern=("mamba",) * n_layers)
    return cj, ct


def reference_server(arch, n_layers, stages, batch, cache_len, enc_len):
    """The reference's model, weights and seeded warm caches (numpy), and the
    port's server holding the same."""
    cfg_j, cfg_t = configs(arch, n_layers)
    model_j, model_t = jbuild(cfg_j, stages), build(cfg_t, stages)
    key = jax.random.key(0)
    sp = jax.tree.map(np.asarray, model_j.init_stage_params(key))
    io = jax.tree.map(np.asarray,
                      model_j.init_io_params(jax.random.fold_in(key, 1)))
    rng = np.random.default_rng(stages)
    lead = (stages, model_j.l_max)
    cache = jax.tree.map(
        lambda c: rng.standard_normal(lead + c.shape).astype(c.dtype),
        model_j.init_layer_cache(batch, cache_len, enc_len))
    if "slstm" in cache:
        # the sLSTM's normaliser starts at 1 and only adds positive terms:
        # a reachable n is >= its decayed start, never near 0, where
        # h = c / max(n, 1e-6) would blow up to 1e6 and both packages'
        # float32 roundings with it
        n = cache["slstm"]["n"]
        cache["slstm"]["n"] = (1.0 + np.abs(n)).astype(n.dtype)
    sp_t, io_t = params_from_reference(model_t, sp, io, "cpu")
    opts = DecodeOptions(mb_rows=1, cache_len=cache_len, enc_len=enc_len)
    server = dict(cfg=cfg_t, model=model_t, sp=sp_t, io=io_t,
                  serve_step=make_staircase_fn(model_t, opts,
                                               num_groups=batch),
                  caches=cache_from_reference(model_t, cache, "cpu"))
    return model_j, sp, io, cache, server


def jax_serve(model_j, sp, io, cache, first_tokens, steps):
    """The reference's decode on one device: each one-row micro-group
    through every stage's ``stage_decode``, then the greedy float32 head.
    An ``embed_input`` arch is fed the embeddings the port's ``serve``
    draws for each step."""
    S, cfg = model_j.num_stages, model_j.cfg
    aux = {"data_size": 1, "moe_layout": "none"}
    fns = [jax.jit(lambda p, io_, x, c, pos, s=s: model_j.stage_decode(
        p, io_, x, c, pos, aux, model_j.rows(s))) for s in range(S)]
    sps = [jax.tree.map(lambda a: jnp.asarray(a[s]), sp) for s in range(S)]
    caches = [jax.tree.map(lambda a: jnp.asarray(a[s]), cache)
              for s in range(S)]
    io = jax.tree.map(jnp.asarray, io)
    seqs = [np.asarray(first_tokens)]
    for pos in range(steps):
        nxt = []
        embeds = (torch.randn((len(first_tokens), 1, cfg.d_model),
                              generator=torch.Generator().manual_seed(pos))
                  * 0.02).numpy()
        for mb in range(len(first_tokens)):
            x = (jnp.asarray(embeds[mb:mb + 1]) if cfg.embed_input else
                 io["embed"][jnp.asarray(seqs[-1][mb:mb + 1])][:, None])
            for s in range(S):
                c = jax.tree.map(lambda a: a[:, mb:mb + 1], caches[s])
                x, c = fns[s](sps[s], io, x, c, jnp.asarray(pos, jnp.int32))
                caches[s] = jax.tree.map(
                    lambda a, u: a.at[:, mb:mb + 1].set(u), caches[s], c)
            h = jlayers.rmsnorm(x, io["final_ln"], cfg.norm_eps)
            logits = (h @ io["head"].T).astype(jnp.float32)
            nxt.append(int(jnp.argmax(logits[0, 0])))
        seqs.append(np.array(nxt))
    return np.stack(seqs, 1), caches


@pytest.mark.parametrize("arch,n_layers,stages", ARCHS)
def test_serve_loop_matches_reference_stage_decode_loop(arch, n_layers,
                                                        stages):
    model_j, sp, io, cache, server = reference_server(
        arch, n_layers, stages, batch=2, cache_len=16, enc_len=6)
    args = serve.parser().parse_args(
        ["--device", "cpu", "--arch", arch, "--batch", "2", "--tokens",
         str(TOKENS)])
    ops.reset_launch_counts()
    run = serve.serve(args, server=server)
    assert not any(ops.launch_counts().values())  # plain versions only
    got = np.array(run.tokens)
    assert got.shape == (2, TOKENS + 1) and len(run.step_seconds) == TOKENS
    want, want_caches = jax_serve(model_j, sp, io, cache, got[:, 0], TOKENS)
    assert np.array_equal(got, want), (got, want)
    for s in range(stages):
        jax.tree.map(lambda g, w: np.testing.assert_allclose(
            g.numpy(), np.asarray(w), atol=1e-4, rtol=1e-4),
            server["caches"][s], want_caches[s])


#: runs in a subprocess with two host devices: the reference's serve step
#: (1 data x 2 stages) and the port's loop on its weights and caches
REFERENCE_SERVE = r"""
import json
import jax, jax.numpy as jnp, numpy as np, torch
from repro.launch.serve import build_server
from repro_torch.configs import registry
from repro_torch.models.build import build
from repro_torch.models.convert import cache_from_reference, params_from_reference
from repro_torch.pipeline.decode import DecodeOptions, make_staircase_fn

arch, batch, cache_len, steps = "seamless-m4t-large-v2", 2, 16, 3
s = build_server(arch, data=1, stages=2, layers=4, batch=batch,
                 cache_len=cache_len)
rng = np.random.default_rng(0)
cache = jax.tree.map(np.asarray, s["caches"])
for name in ("xk", "xv"):  # seeded encoder keys and values
    cache[name] = rng.standard_normal(cache[name].shape).astype(np.float32)
first = np.array([3, 200], np.int32)
toks, c = jnp.asarray(first), jax.tree.map(jnp.asarray, cache)
ref = [first.tolist()]
for pos in range(steps):
    toks, c = s["serve_step"](s["sp"], s["io"], c, {"tokens": toks},
                              jnp.asarray(pos, jnp.int32))
    ref.append(np.asarray(toks).tolist())

model = build(registry.reduced_config(arch, num_layers=4), num_stages=2)
sp, io = params_from_reference(model, jax.tree.map(np.asarray, s["sp"]),
                               jax.tree.map(np.asarray, s["io"]), "cpu")
caches = cache_from_reference(model, cache, "cpu")
step = make_staircase_fn(model, DecodeOptions(
    mb_rows=1, cache_len=cache_len, enc_len=cache_len // 4), batch)
toks, port = torch.from_numpy(first).long(), [first.tolist()]
for pos in range(steps):
    toks = step(sp, io, caches, {"tokens": toks}, pos)
    port.append(toks.tolist())
print(json.dumps({"reference": ref, "port": port}))
"""


def test_serve_matches_reference_serve_step_in_subprocess():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=2")
    out = subprocess.run([sys.executable, "-c", REFERENCE_SERVE], env=env,
                         capture_output=True, text=True, timeout=280,
                         cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["port"] == res["reference"], res


def test_build_server_leaves_the_encoder_cache_zero_like_the_reference():
    s = serve.build_server("seamless-m4t-large-v2", stages=2, layers=4,
                           batch=2, cache_len=32, device="cpu")
    c = s["caches"][1]
    assert tuple(c["xk"].shape)[1:3] == (2, 8)  # enc_len = cache_len // 4
    assert not c["xk"].any() and not c["xv"].any()


def test_serve_cli_on_the_cpu():
    run = serve.main(["--device", "cpu", "--arch", "seamless-m4t-large-v2",
                      "--stages", "2", "--layers", "4", "--batch", "2",
                      "--tokens", "3", "--cache-len", "32"])
    toks = np.array(run.tokens)
    assert toks.shape == (2, 4) and len(run.step_seconds) == 3
    cfg = registry.reduced_config("seamless-m4t-large-v2", 4)
    assert ((toks >= 0) & (toks < cfg.padded_vocab())).all()


def test_serve_needs_cuda_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device works")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--arch", "deepseek-7b", "--layers", "2", "--tokens",
                    "1"])
