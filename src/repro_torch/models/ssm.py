"""Mamba-2 block (zamba2's backbone layer) in PyTorch, training half.

Port of ``repro.models.ssm``: pre-norm RMSNorm (kernel K2) -> in_proj ->
depthwise causal conv -> SiLU -> chunked SSD (kernel K4, ``ops.ssd``) ->
gated RMSNorm (K2) -> out_proj, with the residual added here.  Parameter
names, shapes and dtypes are the reference's ``init_mamba_layer`` leaves:
``a_log``, ``dt_bias`` and ``d_skip`` are float32 whatever the model dtype.
Decode keeps a (conv, ssm) state pair per layer (``init_mamba_cache``,
``mamba_layer_decode``, the plain ``ops.ssd_decode_step``), updated in
place, so decode is O(1) in the sequence length.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels import ops
from repro_torch.models.common import ArchConfig
from repro_torch.models.layers import dense_param, rmsnorm, zeros_param


class MambaLayer(nn.Module):
    def __init__(self, cfg: ArchConfig, gen: torch.Generator | None, device):
        super().__init__()
        ssm = cfg.ssm
        d = cfg.d_model
        di = ssm.d_inner(d)
        nh = ssm.num_heads(d)
        ds = ssm.d_state
        conv_dim = di + 2 * ds
        self.ln = zeros_param((d,), cfg.dtype, device)
        self.in_proj = dense_param(gen, (d, 2 * di + 2 * ds + nh), cfg.dtype,
                                   device)
        self.conv_w = dense_param(gen, (ssm.d_conv, conv_dim), cfg.dtype,
                                  device)
        self.conv_b = zeros_param((conv_dim,), cfg.dtype, device)
        # A = -exp(a_log); a_log, dt_bias and d_skip stay float32
        self.a_log = zeros_param((nh,), torch.float32, device)
        self.dt_bias = zeros_param((nh,), torch.float32, device)
        self.d_skip = nn.Parameter(torch.ones((nh,), dtype=torch.float32,
                                              device=device))
        self.gate_ln = zeros_param((di,), cfg.dtype, device)
        self.out_proj = dense_param(gen, (di, d), cfg.dtype, device)


def _causal_conv(x, w, b):
    """Depthwise causal conv over seq.  x: [b, s, c]; w: [k, c].

    The reference's sum of k shifted products, not ``F.conv1d``: cuDNN
    runs float32 convolutions in TF32 by default and sums in another order.
    """
    k = w.shape[0]
    xp = F.pad(x, (0, 0, k - 1, 0))
    out = sum(xp[:, i:i + x.shape[1]] * w[i][None, None, :] for i in range(k))
    return out + b[None, None, :]


def _split_proj(proj, cfg: ArchConfig):
    ssm = cfg.ssm
    di = ssm.d_inner(cfg.d_model)
    nh = ssm.num_heads(cfg.d_model)
    ds = ssm.d_state
    z, xbc, dt = torch.split(proj, [di, di + 2 * ds, nh], dim=-1)
    return z, xbc, dt, (di, nh, ds)


def _softplus(x):
    """``jax.nn.softplus`` exactly (``F.softplus`` is the identity above 20)."""
    return torch.logaddexp(x, x.new_zeros(()))


def mamba_layer(p: MambaLayer, x, cfg: ArchConfig):
    """x: [b, s, d] -> [b, s, d] (pre-norm residual handled here)."""
    b, s, _ = x.shape
    ssm = cfg.ssm
    h = rmsnorm(x, p.ln, cfg.norm_eps)
    proj = h @ p.in_proj
    z, xbc, dt, (di, nh, ds) = _split_proj(proj, cfg)
    xbc = F.silu(_causal_conv(xbc, p.conv_w, p.conv_b))
    xs, B, C = torch.split(xbc, [di, ds, ds], dim=-1)
    dt = _softplus(dt.float() + p.dt_bias)
    A = -torch.exp(p.a_log)
    y = ops.ssd(xs.reshape(b, s, nh, ssm.head_dim), dt, A, B, C, p.d_skip,
                chunk=ssm.chunk).reshape(b, s, di)
    y = rmsnorm(y * F.silu(z), p.gate_ln, cfg.norm_eps)
    return x + y @ p.out_proj


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------
def init_mamba_cache(batch: int, cfg: ArchConfig, device="cuda"):
    ssm = cfg.ssm
    d = cfg.d_model
    di = ssm.d_inner(d)
    nh = ssm.num_heads(d)
    ds = ssm.d_state
    return {
        "conv": torch.zeros((batch, ssm.d_conv - 1, di + 2 * ds),
                            dtype=cfg.dtype, device=device),
        "ssm": torch.zeros((batch, nh, ssm.head_dim, ds), dtype=torch.float32,
                           device=device),
    }


def mamba_layer_decode(p: MambaLayer, x, cache: dict, cfg: ArchConfig):
    """x: [b, 1, d]; cache: {conv [b, k-1, c], ssm [b, nh, hd, ds]}, both
    updated in place (the reference returns new ones).  Returns
    ``(out [b, 1, d], cache)``."""
    b = x.shape[0]
    ssm = cfg.ssm
    h = rmsnorm(x, p.ln, cfg.norm_eps)
    proj = h @ p.in_proj
    z, xbc, dt, (di, nh, ds) = _split_proj(proj[:, 0], cfg)
    # rolling conv state
    window = torch.cat([cache["conv"], xbc[:, None]], dim=1)  # [b, k, c]
    conv_out = torch.einsum("bkc,kc->bc", window, p.conv_w) + p.conv_b
    xs, B, C = torch.split(F.silu(conv_out), [di, ds, ds], dim=-1)
    dt_t = _softplus(dt.float() + p.dt_bias)
    A = -torch.exp(p.a_log)
    y, ssm_state = ops.ssd_decode_step(
        cache["ssm"], xs.reshape(b, nh, ssm.head_dim), dt_t, A, B, C,
        p.d_skip)
    y = rmsnorm(y.reshape(b, di) * F.silu(z), p.gate_ln, cfg.norm_eps)
    cache["conv"].copy_(window[:, 1:])
    cache["ssm"].copy_(ssm_state)
    return x + (y @ p.out_proj)[:, None], cache
