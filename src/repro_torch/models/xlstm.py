"""xLSTM blocks (mLSTM matrix memory, sLSTM scalar memory) in PyTorch.

Port of ``repro.models.xlstm``.  The mLSTM trains with the stabilised
parallel (quadratic) form up to ``2 * chunk`` tokens and the chunkwise form
above (intra-chunk quadratic, inter-chunk ``(C, n, m)`` state passing), and
decodes with its O(1) recurrent state (``C [hd, hd]``, ``n [hd]``, ``m`` per
head).  The sLSTM is sequential (block-diagonal recurrent weights): a
Python loop over time steps where the reference runs a ``lax.scan``, one
step's launches after another.  Both norms of each block are kernel K2
(``layers.rmsnorm``); the rest is plain PyTorch, as in the reference,
which reaches no Pallas kernel here.  Decode states are updated in place
where the reference returns new ones.

The forget gates' ``log sigmoid`` is ``F.logsigmoid``: the reference's
``-softplus(-f)`` is ``-logaddexp(-f, 0)`` = ``min(f, 0) - log1p(exp(-|f|))``,
the same formula; ``F.softplus`` would switch to its linear branch past
its threshold of 20 and differ there by about 2e-9.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.common import ArchConfig
from repro_torch.models.layers import dense_param, rmsnorm, zeros_param

#: input-gate pre-activation of the chunked form's padding: exp() of it
#: underflows to 0, so padded steps add nothing to the state
NEG_INF_GATE = -1e30


def _full(shape, value, device) -> nn.Parameter:
    return nn.Parameter(torch.full(shape, value, dtype=torch.float32,
                                   device=device))


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------
class MLSTMLayer(nn.Module):
    """The reference's ``init_mlstm_layer`` leaves: float32 gate biases
    (``bf = 3``: forget gates open at init) in a model of any dtype."""

    def __init__(self, cfg: ArchConfig, gen: torch.Generator | None, device):
        super().__init__()
        d, nh = cfg.d_model, cfg.num_heads
        self.ln = zeros_param((d,), cfg.dtype, device)
        self.wq = dense_param(gen, (d, d), cfg.dtype, device)
        self.wk = dense_param(gen, (d, d), cfg.dtype, device)
        self.wv = dense_param(gen, (d, d), cfg.dtype, device)
        self.wi = dense_param(gen, (d, nh), cfg.dtype, device)
        self.wf = dense_param(gen, (d, nh), cfg.dtype, device)
        self.bi = _full((nh,), 0.0, device)
        self.bf = _full((nh,), 3.0, device)
        self.gate_ln = zeros_param((d,), cfg.dtype, device)
        self.wo = dense_param(gen, (d, d), cfg.dtype, device)


def _mlstm_gates(p: MLSTMLayer, h):
    """h: [b, s, d] -> (i_pre, log_f): [b, s, nh] in float32."""
    i_pre = (h @ p.wi).float() + p.bi
    f_pre = (h @ p.wf).float() + p.bf
    return i_pre, F.logsigmoid(f_pre)


def _causal(n: int, device):
    t = torch.arange(n, device=device)
    return t[:, None] >= t[None, :]


def mlstm_parallel(q, k, v, i_pre, log_f):
    """Stabilised parallel mLSTM.

    q, k, v: [b, s, nh, hd]; i_pre, log_f: [b, s, nh].
    D[t, j] = sum_{j<u<=t} log_f[u] + i_pre[j] (j <= t), -inf otherwise;
    h_t = sum_j exp(D[t, j] - m_t) (q_t . k_j / sqrt(hd)) v_j
          / max(|sum_j exp(D - m) q.k|, exp(-m_t)).
    """
    b, s, nh, hd = q.shape
    qf = q.float() * hd ** -0.5
    kf, vf = k.float(), v.float()
    cum_f = torch.cumsum(log_f, dim=1)  # [b, s, nh]
    dmat = cum_f[:, :, None] - cum_f[:, None] + i_pre[:, None]  # [b,t,j,nh]
    mask = _causal(s, q.device)[None, :, :, None]
    dmat = torch.where(mask, dmat, -torch.inf)
    m = dmat.amax(dim=2)  # [b, t, nh] row stabiliser
    w = torch.exp(dmat - m[:, :, None])
    scores = torch.einsum("btnd,bjnd->btjn", qf, kf) * w
    num = torch.einsum("btjn,bjnd->btnd", scores, vf)
    den = torch.maximum(scores.sum(dim=2).abs(), torch.exp(-m))
    return (num / den[..., None]).to(q.dtype)


def mlstm_chunked(q, k, v, i_pre, log_f, chunk: int = 128):
    """Chunkwise-stabilised mLSTM: intra-chunk quadratic + inter-chunk
    (C, n, m) state passing, O(s * chunk) memory; the same function as
    :func:`mlstm_parallel`.  The reference's ``lax.scan`` over chunks is a
    loop here; a length not a multiple of ``chunk`` is padded with input
    gates of ``NEG_INF_GATE`` (they add nothing) and sliced back.
    """
    b, s, nh, hd = q.shape
    pad = (-s) % chunk
    if pad:
        q, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v))
        i_pre = F.pad(i_pre, (0, 0, 0, pad), value=NEG_INF_GATE)
        log_f = F.pad(log_f, (0, 0, 0, pad))
    sp = q.shape[1]
    nc = sp // chunk
    qf = (q.float() * hd ** -0.5).reshape(b, nc, chunk, nh, hd)
    kf = k.float().reshape(b, nc, chunk, nh, hd)
    vf = v.float().reshape(b, nc, chunk, nh, hd)
    ip = i_pre.reshape(b, nc, chunk, nh)
    A = torch.cumsum(log_f.reshape(b, nc, chunk, nh), dim=2)  # inclusive
    A_last = A[:, :, -1]  # [b, nc, nh]

    # ---- intra-chunk: D[t, j] = A_t - A_j + i_j (j <= t) ------------------
    tri = _causal(chunk, q.device)[None, None, :, :, None]
    dmat = A[:, :, :, None] - A[:, :, None] + ip[:, :, None]
    dmat = torch.where(tri, dmat, -torch.inf)
    m_intra = dmat.amax(dim=3)  # [b, nc, Q, nh]
    # per-chunk boundary input magnitude: max_j (A_last - A_j + i_j)
    m_in = (A_last[:, :, None] - A + ip).amax(dim=2)  # [b, nc, nh]

    # ---- inter-chunk state: the state entering each chunk -----------------
    C = torch.zeros((b, nh, hd, hd), dtype=torch.float32, device=q.device)
    n = torch.zeros((b, nh, hd), dtype=torch.float32, device=q.device)
    m = torch.full((b, nh), -torch.inf, dtype=torch.float32, device=q.device)
    C_in, n_in, m_prev = [], [], []
    for c in range(nc):
        C_in.append(C)
        n_in.append(n)
        m_prev.append(m)
        if c == nc - 1:
            break  # the state after the last chunk is not read
        a_last = A_last[:, c]
        m_new = torch.maximum(a_last + m, m_in[:, c])  # [b, nh]
        w_old = torch.exp(a_last + m - m_new)
        wj = torch.exp(a_last[:, None] - A[:, c] + ip[:, c]
                       - m_new[:, None])  # [b, Q, nh]
        C = C * w_old[..., None, None] + torch.einsum(
            "bjnd,bjne,bjn->bnde", vf[:, c], kf[:, c], wj)
        n = n * w_old[..., None] + torch.einsum("bjne,bjn->bne", kf[:, c], wj)
        m = m_new
    C_in = torch.stack(C_in, dim=1)  # [b, nc, nh, hd, hd]
    n_in = torch.stack(n_in, dim=1)
    m_prev = torch.stack(m_prev, dim=1)  # [b, nc, nh]

    # ---- combine ----------------------------------------------------------
    m_inter = m_prev[:, :, None] + A  # [b, nc, Q, nh]
    m_tot = torch.maximum(m_intra, m_inter)
    m_tot = torch.clamp_min(m_tot, -1e30)  # guard -inf - -inf
    w_intra = torch.where(tri, torch.exp(dmat - m_tot[:, :, :, None]), 0.0)
    scores = torch.einsum("bctnd,bcjnd->bctjn", qf, kf) * w_intra
    num = torch.einsum("bctjn,bcjnd->bctnd", scores, vf)
    den = scores.sum(dim=3)  # [b, nc, Q, nh]
    w_int = torch.exp(m_inter - m_tot)
    num = num + torch.einsum("bctne,bcnde,bctn->bctnd", qf, C_in, w_int)
    den = den + torch.einsum("bctnd,bcnd->bctn", qf, n_in) * w_int
    den = torch.maximum(den.abs(), torch.exp(-m_tot))
    y = (num / den[..., None]).reshape(b, sp, nh, hd)
    return y[:, :s].to(q.dtype)


def mlstm_layer(p: MLSTMLayer, x, cfg: ArchConfig, chunk: int = 128):
    b, s, d = x.shape
    nh = cfg.num_heads
    hd = d // nh
    h = rmsnorm(x, p.ln, cfg.norm_eps)
    q = (h @ p.wq).reshape(b, s, nh, hd)
    k = (h @ p.wk).reshape(b, s, nh, hd)
    v = (h @ p.wv).reshape(b, s, nh, hd)
    i_pre, log_f = _mlstm_gates(p, h)
    if s <= 2 * chunk:
        y = mlstm_parallel(q, k, v, i_pre, log_f)
    else:
        y = mlstm_chunked(q, k, v, i_pre, log_f, chunk=chunk)
    y = rmsnorm(y.reshape(b, s, d), p.gate_ln, cfg.norm_eps)
    return x + y @ p.wo


def init_mlstm_cache(batch: int, cfg: ArchConfig, device="cuda") -> dict:
    nh = cfg.num_heads
    hd = cfg.d_model // nh
    f32 = dict(dtype=torch.float32, device=device)
    return {"C": torch.zeros((batch, nh, hd, hd), **f32),
            "n": torch.zeros((batch, nh, hd), **f32),
            "m": torch.full((batch, nh), -torch.inf, **f32)}


def mlstm_layer_decode(p: MLSTMLayer, x, cache: dict, cfg: ArchConfig):
    """Recurrent mLSTM step.  x: [b, 1, d]; ``cache`` (C, n, m) is updated
    in place.  Returns ``(out [b, 1, d], cache)``."""
    b, _, d = x.shape
    nh = cfg.num_heads
    hd = d // nh
    h = rmsnorm(x, p.ln, cfg.norm_eps)[:, 0]
    q = (h @ p.wq).reshape(b, nh, hd).float() * hd ** -0.5
    k = (h @ p.wk).reshape(b, nh, hd).float()
    v = (h @ p.wv).reshape(b, nh, hd).float()
    i_pre, log_f = _mlstm_gates(p, h)  # [b, nh]
    m_prev, C_prev, n_prev = cache["m"], cache["C"], cache["n"]
    m_new = torch.maximum(log_f + m_prev, i_pre)
    f_sc = torch.exp(log_f + m_prev - m_new)[..., None]
    i_sc = torch.exp(i_pre - m_new)[..., None]
    C_new = f_sc[..., None] * C_prev + i_sc[..., None] * torch.einsum(
        "bnd,bne->bnde", v, k)
    n_new = f_sc * n_prev + i_sc * k
    num = torch.einsum("bnde,bne->bnd", C_new, q)
    den = torch.maximum(torch.einsum("bnd,bnd->bn", n_new, q).abs(),
                        torch.exp(-m_new))
    y = (num / den[..., None]).reshape(b, d).to(x.dtype)
    y = rmsnorm(y, p.gate_ln, cfg.norm_eps)
    cache["C"].copy_(C_new)
    cache["n"].copy_(n_new)
    cache["m"].copy_(m_new)
    return x + (y @ p.wo)[:, None], cache


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------
class SLSTMLayer(nn.Module):
    """The reference's ``init_slstm_layer`` leaves: input projections
    ``w*``, block-diagonal recurrent weights ``r*`` ``[nh, hd, hd]`` at init
    scale 0.02, and the float32 forget bias ``bf = 3``."""

    def __init__(self, cfg: ArchConfig, gen: torch.Generator | None, device):
        super().__init__()
        d, nh = cfg.d_model, cfg.num_heads
        hd = d // nh
        self.ln = zeros_param((d,), cfg.dtype, device)
        for name in ("wz", "wi", "wf", "wo_gate"):
            setattr(self, name, dense_param(gen, (d, d), cfg.dtype, device))
        for name in ("rz", "ri", "rf", "ro"):
            setattr(self, name, dense_param(gen, (nh, hd, hd), cfg.dtype,
                                            device, scale=0.02))
        self.bf = _full((d,), 3.0, device)
        self.gate_ln = zeros_param((d,), cfg.dtype, device)
        self.wo = dense_param(gen, (d, d), cfg.dtype, device)


def init_slstm_cache(batch: int, cfg: ArchConfig, device="cuda") -> dict:
    f32 = dict(dtype=torch.float32, device=device)
    d = cfg.d_model
    return {"c": torch.zeros((batch, d), **f32),
            "n": torch.ones((batch, d), **f32),
            "h": torch.zeros((batch, d), **f32),
            "m": torch.zeros((batch, d), **f32)}


def _recurrent(p: SLSTMLayer):
    """The four recurrent weights side by side in float32, [nh, hd, 4 hd]:
    one batched product per step gives every gate's ``h @ r`` per head
    (the reference's ``einsum('bnd,nde->bne', h, r)`` for each gate)."""
    return torch.cat([p.rz, p.ri, p.rf, p.ro], dim=-1).float()


def _slstm_step(p: SLSTMLayer, rec_w, state, inp):
    """One recurrence step in the heads-major layout [nh, b, hd], where the
    recurrent product is one ``bmm`` with no copies.  inp: the step's
    input projections [nh, b, 4 hd] (gates z, i, f, o); rec_w:
    :func:`_recurrent`.  Returns ``(state, h)``."""
    c, n, h, m = state
    hd = h.shape[-1]
    pre = inp + torch.bmm(h, rec_w)  # [nh, b, 4 hd]
    z = torch.tanh(pre[..., :hd])
    i_pre = pre[..., hd:2 * hd]
    log_f = F.logsigmoid(pre[..., 2 * hd:3 * hd]
                         + p.bf.reshape(h.shape[0], 1, hd))
    o_pre = pre[..., 3 * hd:]
    decayed = log_f + m
    m_new = torch.maximum(decayed, i_pre)
    i_sc = torch.exp(i_pre - m_new)
    f_sc = torch.exp(decayed - m_new)
    c_new = f_sc * c + i_sc * z
    n_new = f_sc * n + i_sc
    h_new = torch.sigmoid(o_pre) * c_new / torch.clamp_min(n_new, 1e-6)
    return (c_new, n_new, h_new, m_new), h_new


def _slstm_inputs(p: SLSTMLayer, h0, nh: int):
    """Input projections of h0 [..., d] in the step's layout
    [..., nh, 4 hd], float32."""
    proj = torch.stack([h0 @ p.wz, h0 @ p.wi, h0 @ p.wf, h0 @ p.wo_gate],
                       dim=-2).float()  # [..., 4, d]
    lead = proj.shape[:-2]
    return proj.reshape(*lead, 4, nh, -1).transpose(-3, -2).reshape(
        *lead, nh, -1)


def _heads_major(t, nh: int):
    """[b, d] -> the step layout [nh, b, hd] (a view)."""
    return t.reshape(t.shape[0], nh, -1).transpose(0, 1)


def slstm_layer(p: SLSTMLayer, x, cfg: ArchConfig):
    b, s, d = x.shape
    nh = cfg.num_heads
    h0 = rmsnorm(x, p.ln, cfg.norm_eps)
    # [s, nh, b, 4 hd]: each step's inputs contiguous, once for the loop
    inp = _slstm_inputs(p, h0, nh).permute(1, 2, 0, 3).contiguous()
    cache = init_slstm_cache(b, cfg, device=x.device)
    state = tuple(_heads_major(cache[k], nh) for k in "cnhm")
    rec_w = _recurrent(p)
    hs = []
    for t in range(s):
        state, h = _slstm_step(p, rec_w, state, inp[t])
        hs.append(h)
    y = torch.stack(hs).permute(2, 0, 1, 3).reshape(b, s, d).to(x.dtype)
    y = rmsnorm(y, p.gate_ln, cfg.norm_eps)
    return x + y @ p.wo


def slstm_layer_decode(p: SLSTMLayer, x, cache: dict, cfg: ArchConfig):
    """One sLSTM step.  x: [b, 1, d]; ``cache`` (c, n, h, m) is updated in
    place.  Returns ``(out [b, 1, d], cache)``."""
    nh = cfg.num_heads
    h0 = rmsnorm(x, p.ln, cfg.norm_eps)[:, 0]
    inp = _slstm_inputs(p, h0, nh).transpose(0, 1)  # [nh, b, 4 hd]
    state = tuple(_heads_major(cache[k], nh) for k in "cnhm")
    state, _ = _slstm_step(p, _recurrent(p), state, inp)
    for name, t in zip("cnhm", state):
        cache[name].copy_(t.transpose(0, 1).reshape(cache[name].shape))
    y = rmsnorm(cache["h"].to(x.dtype), p.gate_ln, cfg.norm_eps)
    return x + (y @ p.wo)[:, None], cache
