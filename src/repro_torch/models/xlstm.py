"""xLSTM blocks (arXiv:2405.04517), as ``repro.models.xlstm`` computes
them: the mLSTM (matrix memory, chunkwise-parallel over a sequence) and the
sLSTM (scalar memory, a strictly sequential scan with exponential gating).

Every tensor carries the leading branch dim G of ``models.transformer``:
x [G, B, S, d] with weights [G, ...].  The mLSTM's per-head q/k/v
projections are block-diagonal ([H, hd, hd]); each runs as one
``block_diag_matmul`` over x [G*H, B*S, hd] and w [G*H, hd, hd] through
:class:`BlockDiagMatmul`, whose backward is the same kernel on the
transposed operands, so training through this mixer on the card meets no
kernel without a gradient.  Decode states: the mLSTM's ``(C [B, H, hd,
hd], n [B, H, hd], m [B, H])`` and the sLSTM's ``(c, n, h, m)`` each
[B, d], all f32.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.block_diag_matmul import block_diag_matmul
from repro_torch.models.layers import _dense

SCAN_CHUNK = 64
NEG = -1e30


class BlockDiagMatmul(torch.autograd.Function):
    """``block_diag_matmul`` (x [Bb, T, d] @ w [Bb, d, e]) with its
    gradient: dx = dy @ w^T and dw = x^T @ dy, each one more call of the
    same kernel (operands made dense in their last dim, as the kernel
    reads them)."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return block_diag_matmul(x, w)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dy = dy.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = block_diag_matmul(dy, w.transpose(1, 2).contiguous())
        if ctx.needs_input_grad[1]:
            dw = block_diag_matmul(x.transpose(1, 2).contiguous(), dy)
        return dx, dw


def mlstm_shapes(cfg: ArchConfig) -> dict:
    d = cfg.d_model
    din = cfg.ssm_expand * d
    h = cfg.n_heads
    hd = din // h
    return {"up": (d, 2 * din), "wq": (h, hd, hd), "wk": (h, hd, hd),
            "wv": (h, hd, hd), "wi": (din, h), "wf": (din, h),
            "gn_w": (din,), "down": (din, d)}


def slstm_shapes(cfg: ArchConfig) -> dict:
    d = cfg.d_model
    dff = int(4 * d / 3)
    return {"wx": (d, 4 * d), "wh": (d, 4 * d), "ff_u": (d, dff),
            "ff_d": (dff, d)}


def _heads_proj(uh: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The per-head projection ``einsum("bshd,hde->bshe")`` of uh [G, B, S,
    H, hd] by w [G, H, hd, hd], as one block-diagonal product over the
    G*H heads."""
    g, b, s, h, hd = uh.shape
    x = uh.permute(0, 3, 1, 2, 4).reshape(g * h, b * s, hd)
    out = BlockDiagMatmul.apply(x, w.reshape(g * h, hd, w.shape[-1]))
    return out.reshape(g, h, b, s, -1).permute(0, 2, 3, 1, 4)


# ------------------------------------------------------------------- mLSTM
def mlstm_chunkwise(q, k, v, i_pre, f_pre, *, chunk: int = SCAN_CHUNK):
    """Chunkwise-parallel mLSTM: inside a chunk the gated outer-product
    recurrence is masked attention ([c, c] products); the [hd, hd] matrix
    state crosses chunk boundaries only.  q, k, v: [B, S, H, hd] (q
    pre-scaled); i_pre, f_pre: [B, S, H].  Returns (state, h [B, S, H,
    hd])."""
    bsz, s, nh, hd = q.shape
    c = chunk if s % chunk == 0 else s
    n = s // c

    def split(x):  # [B, S, H, ...] -> [n, B, H, c, ...]
        x = x.reshape((bsz, n, c) + x.shape[2:])
        return x.movedim(1, 0).movedim(3, 2)

    qs, ks, vs, is_ = split(q), split(k), split(v), split(i_pre)
    fcum = torch.cumsum(F.logsigmoid(split(f_pre)), dim=-1)   # inclusive
    tril = torch.ones(c, c, dtype=torch.bool, device=q.device).tril()
    c_st = q.new_zeros(bsz, nh, hd, hd)
    n_st = q.new_zeros(bsz, nh, hd)
    m_st = q.new_full((bsz, nh), NEG)
    hs = []
    for j in range(n):
        qc, kc, vc, ic, fc = qs[j], ks[j], vs[j], is_[j], fcum[j]
        ftot = fc[..., -1]                                    # [B, H]
        # intra-chunk gates D[t, j] = F_t - F_j + i_j  (j <= t)
        dmat = fc[..., :, None] - fc[..., None, :] + ic[..., None, :]
        dmat = torch.where(tril, dmat, torch.full_like(dmat, NEG))
        m_intra = dmat.amax(-1)                               # [B, H, c]
        m_inter = m_st[..., None] + fc
        m_t = torch.maximum(m_inter, m_intra)
        gates = torch.exp(dmat - m_t[..., None])
        scores = torch.einsum("bhtd,bhjd->bhtj", qc, kc)
        inter_scale = torch.exp(m_inter - m_t)[..., None]
        num = torch.einsum("bhtj,bhjd->bhtd", scores * gates, vc) \
            + torch.einsum("bhtd,bhde->bhte", qc, c_st) * inter_scale
        nvec = torch.einsum("bhtj,bhjd->bhtd", gates, kc) \
            + n_st[..., None, :] * inter_scale
        den = torch.clamp((qc * nvec).sum(-1).abs(), min=1.0)
        hs.append(num / den[..., None])
        # the chunk's outgoing state
        gexp = ftot[..., None] - fc + ic                      # decay to end
        m_out = torch.maximum(m_st + ftot, gexp.amax(-1))
        carry = torch.exp(m_st + ftot - m_out)
        wgt = torch.exp(gexp - m_out[..., None])              # [B, H, c]
        c_st = c_st * carry[..., None, None] \
            + torch.einsum("bhj,bhjd,bhje->bhde", wgt, kc, vc)
        n_st = n_st * carry[..., None] \
            + torch.einsum("bhj,bhjd->bhd", wgt, kc)
        m_st = m_out
    h = torch.stack(hs).movedim(2, 3).movedim(0, 1).reshape(bsz, s, nh, hd)
    return (c_st, n_st, m_st), h


def _mlstm_step(carry, inputs):
    """One timestep.  carry: (C [..., H, hd, hd], n [..., H, hd], m [...,
    H]); inputs q, k, v [..., H, hd], i_pre, f_pre [..., H]."""
    c_st, n_st, m_st = carry
    q, k, v, i_pre, f_pre = inputs
    f_log = F.logsigmoid(f_pre)
    m_new = torch.maximum(f_log + m_st, i_pre)
    i_g = torch.exp(i_pre - m_new)
    f_g = torch.exp(f_log + m_st - m_new)
    c_st = f_g[..., None, None] * c_st + i_g[..., None, None] * (
        k[..., :, None] * v[..., None, :])
    n_st = f_g[..., None] * n_st + i_g[..., None] * k
    num = torch.einsum("...hd,...hde->...he", q, c_st)
    den = torch.clamp(torch.einsum("...hd,...hd->...h", q, n_st).abs(),
                      min=1.0)
    return (c_st, n_st, m_new), num / den[..., None]


def mlstm_apply(params, x: torch.Tensor, cfg: ArchConfig, state=None):
    """x: [G, B, S, d].  ``state`` None for a full-sequence forward, else
    the decode state (S = 1).  Returns (out, new_state)."""
    g, b, s, d = x.shape
    din = cfg.ssm_expand * d
    nh = cfg.n_heads
    hd = din // nh
    u, z = _dense(x, params["up"]).chunk(2, dim=-1)          # [G,B,S,din]
    uh = u.unflatten(-1, (nh, hd))
    q = _heads_proj(uh, params["wq"]).float() / math.sqrt(hd)
    k = _heads_proj(uh, params["wk"]).float()
    v = _heads_proj(uh, params["wv"]).float()
    i_pre = _dense(u, params["wi"]).float()                  # [G,B,S,H]
    f_pre = _dense(u, params["wf"]).float()
    if state is None:
        fold = lambda t: t.flatten(0, 1)
        _, h = mlstm_chunkwise(fold(q), fold(k), fold(v), fold(i_pre),
                               fold(f_pre))
        h = h.unflatten(0, (g, b))
        new_state = None
    else:
        new_state, h = _mlstm_step(state, (q[:, :, 0], k[:, :, 0],
                                           v[:, :, 0], i_pre[:, :, 0],
                                           f_pre[:, :, 0]))
        h = h[:, :, None]
    # per-head group norm
    h = h * torch.rsqrt(h.square().mean(-1, keepdim=True) + 1e-6)
    h = h.flatten(-2) * params["gn_w"].float()[:, None, None, :]
    out = _dense(h.to(x.dtype) * F.silu(z), params["down"])
    return out, new_state


def mlstm_init_state(cfg: ArchConfig, batch: int, lead: tuple, device):
    din = cfg.ssm_expand * cfg.d_model
    nh = cfg.n_heads
    hd = din // nh
    z = lambda *s: torch.zeros(lead + (batch,) + s, dtype=torch.float32,
                               device=device)
    return (z(nh, hd, hd), z(nh, hd),
            torch.full(lead + (batch, nh), NEG, dtype=torch.float32,
                       device=device))


# ------------------------------------------------------------------- sLSTM
def _slstm_step(params, carry, xt):
    """carry: (c, n, h, m) each [G, B, d]; xt [G, B, 4d] the input's
    pre-activations."""
    c_st, n_st, h, m_st = carry
    pre = xt + torch.matmul(h, params["wh"].float())
    i_pre, f_pre, z_pre, o_pre = pre.chunk(4, dim=-1)
    f_log = F.logsigmoid(f_pre)
    m_new = torch.maximum(f_log + m_st, i_pre)
    i_g = torch.exp(i_pre - m_new)
    f_g = torch.exp(f_log + m_st - m_new)
    c_st = f_g * c_st + i_g * torch.tanh(z_pre)
    n_st = f_g * n_st + i_g
    h_new = torch.sigmoid(o_pre) * c_st / torch.clamp(n_st, min=1.0)
    return (c_st, n_st, h_new, m_new), h_new


def slstm_apply(params, x: torch.Tensor, cfg: ArchConfig, state=None):
    """x: [G, B, S, d].  A full-sequence forward scans the S steps from
    the zero state; a decode step advances ``state`` by one.  Returns
    (out, new_state)."""
    g, b, s, d = x.shape
    xp = _dense(x, params["wx"]).float()                     # [G,B,S,4d]
    if state is None:
        carry = slstm_init_state(cfg, b, (g,), x.device)
        hs = []
        for t in range(s):
            carry, h = _slstm_step(params, carry, xp[:, :, t])
            hs.append(h)
        h = torch.stack(hs, dim=2)
        new_state = None
    else:
        new_state, h = _slstm_step(params, state, xp[:, :, 0])
        h = h[:, :, None]
    h = h.to(x.dtype)
    up = F.gelu(_dense(h, params["ff_u"]), approximate="tanh")
    return _dense(up, params["ff_d"]), new_state


def slstm_init_state(cfg: ArchConfig, batch: int, lead: tuple, device):
    z = lambda: torch.zeros(lead + (batch, cfg.d_model), dtype=torch.float32,
                            device=device)
    return (z(), z(), z(), torch.full(lead + (batch, cfg.d_model), NEG,
                                      dtype=torch.float32, device=device))
