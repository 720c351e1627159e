"""Mamba-style selective state-space mixer (Jamba's SSM layers), as
``repro.models.ssm`` computes it.

Every tensor carries the leading branch dim G of ``models.transformer``:
x [G, B, S, d] with weights [G, ...].  Training and full-sequence forwards
run the linear recurrence h_t = a_t h_{t-1} + bx_t a chunk at a time (the
[B, S, d_inner, d_state] gate tensors exist one chunk at a time), each chunk
by the reference's associative scan at log depth; a decode
step carries ``{"ssm": [B, d_inner, d_state] f32, "conv": [B, d_conv - 1,
d_inner]}``.  Serving never reaches the chunked scan (recurrent mixers
prefill token by token), and the reference's Mamba does not call its
``ssm_scan`` kernel, so neither does this one: the scan is plain PyTorch.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import _dense

DEFAULT_SCAN_CHUNK = 512


def mamba_shapes(cfg: ArchConfig) -> dict:
    """Leaf shapes of ``repro.models.ssm.mamba_init`` (``A_log`` and ``D``
    are f32 whatever the model's dtype)."""
    d = cfg.d_model
    din = cfg.ssm_expand * d
    ds, dc = cfg.ssm_d_state, cfg.ssm_d_conv
    return {"in_proj": (d, 2 * din), "conv_w": (dc, din), "conv_b": (din,),
            "x_proj": (din, 2 * ds + 1), "dt_bias": (din,),
            "A_log": (din, ds), "D": (din,), "out_proj": (din, d)}


def _bcast(w: torch.Tensor, nd: int) -> torch.Tensor:
    """A [G, ...] leaf with ``nd`` unit dims after G (to broadcast against
    [G, B, S, ...] activations)."""
    return w.reshape(w.shape[:1] + (1,) * nd + w.shape[1:])


def _ssm_params(params, x: torch.Tensor, cfg: ArchConfig):
    """x [G, B, S, din] -> the recurrence's per-step gates a and inputs bx
    [G, B, S, din, ds] (f32) and the readout C [G, B, S, ds] (f32)."""
    ds = cfg.ssm_d_state
    proj = _dense(x, params["x_proj"])                     # [G,B,S,2ds+1]
    b_, c_, dt_raw = proj[..., :ds], proj[..., ds:2 * ds], proj[..., -1:]
    dt_bias = params["dt_bias"].float().mean(-1)           # [G]
    dt = F.softplus(dt_raw.float() + _bcast(dt_bias, 3))   # [G,B,S,1]
    a_mat = -torch.exp(params["A_log"].float())            # [G, din, ds]
    a = torch.exp(dt[..., None] * _bcast(a_mat, 2))
    bx = dt[..., None] * b_[..., None, :].float() * x[..., None].float()
    return a, bx, c_.float()


def _conv1d(params, x: torch.Tensor, cfg: ArchConfig, conv_state=None):
    """Depthwise causal conv of kernel d_conv, then SiLU.  x: [G, B, S,
    din]; with ``conv_state`` [G, B, d_conv - 1, din] (decode, S = 1) also
    returns the shifted state."""
    w, bias = params["conv_w"], _bcast(params["conv_b"], 2)
    if conv_state is not None:
        buf = torch.cat([conv_state, x], dim=2)           # [G,B,dc,din]
        y = torch.einsum("gbkd,gkd->gbd", buf, w) + bias[:, 0]
        return F.silu(y)[:, :, None], buf[:, :, 1:]
    dc = cfg.ssm_d_conv
    xp = F.pad(x, (0, 0, dc - 1, 0))                       # [G,B,S+dc-1,din]
    windows = xp.unfold(2, dc, 1)                          # [G,B,S,din,dc]
    y = torch.einsum("gbsdk,gkd->gbsd", windows, w) + bias
    return F.silu(y), None


def _combine(c1, c2):
    """The recurrence's monoid on (gate, input) pairs, the reference's
    ``combine``: applying c1 then c2 is (a1 a2, a2 b1 + b2)."""
    (a1, b1), (a2, b2) = c1, c2
    return a1 * a2, a2 * b1 + b2


def _interleave(even, odd):
    """[.., e, ..] and [.., o, ..] along dim 2 (e = o or o + 1) ->
    even[0], odd[0], even[1], ..."""
    k = odd.shape[2]
    out = torch.stack([even[:, :, :k], odd], dim=3).flatten(2, 3)
    return torch.cat([out, even[:, :, k:]], dim=2) if even.shape[2] > k \
        else out


def _associative_scan(a, b):
    """The inclusive scan of the pairs (a_t, b_t) along dim 2 under
    :func:`_combine`, by the odd/even recursion of
    ``jax.lax.associative_scan``: combine adjacent pairs, scan the
    half-length sequence (the odd positions' results), then fix up the even
    positions from their left neighbours; an odd length keeps its last
    element for the fix-up, as lax does.  Depth log2(S), a constant number
    of ops a level."""
    n = a.shape[2]
    if n < 2:
        return a, b
    at = lambda s: (a[:, :, s], b[:, :, s])
    odd = _associative_scan(*_combine(at(slice(0, -1, 2)),
                                      at(slice(1, None, 2))))
    left = odd if n % 2 else (odd[0][:, :, :-1], odd[1][:, :, :-1])
    even = _combine(left, at(slice(2, None, 2)))
    return tuple(_interleave(torch.cat([x[:, :, :1], e], dim=2), o)
                 for x, e, o in zip((a, b), even, odd))


def _scan_chunk(params, h0, xc_c, cfg: ArchConfig):
    """One chunk: h = a_cum h0 + h_in, where (a_cum, h_in) is the
    associative scan of the (gate, input) pairs, as in the reference;
    y_t = <h_t, C_t>."""
    a, bx, c_ = _ssm_params(params, xc_c, cfg)
    a_cum, h_in = _associative_scan(a, bx)
    h = a_cum * h0[:, :, None] + h_in
    return h[:, :, -1], torch.einsum("gbsdn,gbsn->gbsd", h, c_)


def _scan_chunk_steps(params, h0, xc_c, cfg: ArchConfig):
    """:func:`_scan_chunk` walked a time step at a time: its plain
    version, which the tests and the chip check hold the scan to."""
    a, bx, c_ = _ssm_params(params, xc_c, cfg)
    h, hs = h0, []
    for t in range(a.shape[2]):
        h = a[:, :, t] * h + bx[:, :, t]
        hs.append(h)
    h = torch.stack(hs, dim=2)
    return h[:, :, -1], torch.einsum("gbsdn,gbsn->gbsd", h, c_)


def mamba_chunked_scan(params, xc: torch.Tensor, cfg: ArchConfig, *,
                       chunk: int = DEFAULT_SCAN_CHUNK) -> torch.Tensor:
    """y_t = <h_t, C_t> with h_t = a_t h_{t-1} + bx_t over xc [G, B, S,
    din], a chunk of the sequence at a time (the whole sequence where the
    chunk does not divide it, as the reference falls back); under autograd
    each chunk is checkpointed, as the reference's scan body is."""
    g, b, s, din = xc.shape
    chunk = min(chunk, s)
    if s % chunk:
        chunk = s
    h = torch.zeros(g, b, din, cfg.ssm_d_state, dtype=torch.float32,
                    device=xc.device)
    ys = []
    for c0 in range(0, s, chunk):
        xc_c = xc[:, :, c0:c0 + chunk]
        if torch.is_grad_enabled():
            h, y = checkpoint(lambda h0, x: _scan_chunk(params, h0, x, cfg),
                              h, xc_c, use_reentrant=False)
        else:
            h, y = _scan_chunk(params, h, xc_c, cfg)
        ys.append(y)
    return torch.cat(ys, dim=2)


def mamba_apply(params, x: torch.Tensor, cfg: ArchConfig, state=None):
    """x: [G, B, S, d].  ``state`` None for a full-sequence forward, else
    the decode state (S = 1).  Returns (y, new_state)."""
    xin, z = _dense(x, params["in_proj"]).chunk(2, dim=-1)
    if state is None:
        xc, _ = _conv1d(params, xin, cfg)
        y = mamba_chunked_scan(params, xc, cfg)
        new_state = None
    else:
        xc, conv_new = _conv1d(params, xin, cfg, conv_state=state["conv"])
        a, bx, c_ = _ssm_params(params, xc, cfg)
        h = a[:, :, 0] * state["ssm"] + bx[:, :, 0]       # [G,B,din,ds]
        y = torch.einsum("gbdn,gbn->gbd", h, c_[:, :, 0])[:, :, None]
        new_state = {"ssm": h, "conv": conv_new}
    y = y.to(x.dtype) + _bcast(params["D"].to(x.dtype), 2) * xc
    y = y * F.silu(z)
    return _dense(y, params["out_proj"]), new_state


def mamba_init_state(cfg: ArchConfig, batch: int, dtype, lead: tuple,
                     device):
    din = cfg.ssm_expand * cfg.d_model
    return {"ssm": torch.zeros(lead + (batch, din, cfg.ssm_d_state),
                               dtype=torch.float32, device=device),
            "conv": torch.zeros(lead + (batch, cfg.ssm_d_conv - 1, din),
                                dtype=dtype, device=device)}
