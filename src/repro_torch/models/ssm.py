"""Mamba2 / SSD (state-space duality) mixer — port of ``repro.models.ssm``.

Shapes follow the Mamba2 paper: d_inner = expand * d_model, heads of size
``head_dim`` (p), state size n, B/C shared per group (n_groups).  The
chunked scan of a prefill goes through kernel B8
(:func:`repro_torch.kernels.ssd.ssd_fused`, whose plain version builds
its decay matrix with the reference's ``_segsum``, here
:func:`repro_torch.kernels.ssd.segsum`); ragged lengths and decode steps
(l = 1) run the exact per-token recurrence :func:`ssd_reference`, as in
the reference.

Decode keeps an :class:`SSMState` (recurrent state + conv ring) instead of
a KV cache: O(1) memory per token.

Parameters live in :class:`SSMMixer`, an ``nn.Module`` whose tensors keep
the reference's names and layouts (``in_proj`` is (d, e), ``conv_w`` is
(channels, d_conv)), so the reference's weights move over as they are
(:mod:`repro_torch.models.convert`).  They carry a gradient once the model
is made trainable: kernel B8 then records a graph whose backward is a
kernel too (:func:`repro_torch.kernels.ssd.ssd_fused_bwd`).

**On a mesh** (:func:`ssm_forward_tp`, a data replica's model devices;
the reference's ``ssm.py:186-232`` under GSPMD) the mixer follows the
partition rules: ``in_proj``'s column blocks straddle z / x / B / C / dt,
so the per-device products are joined on the replica's lead before the
split at the global offsets; the depthwise conv runs per channel block
(``conv_w`` / ``conv_b`` and the conv ring's pieces), joined on the lead
in channel order; kernel B8 runs on each device for its heads (its x, dt,
``A_log`` / ``dt_bias`` / ``D`` slices, and the B / C groups its heads
read: mamba2's one group whole); the gated RMSNorm over the whole d_inner
sums each device's partial sums of squares on the lead and hands the scale
back; ``out_proj``'s head-aligned row blocks then take each device's y,
their partial products summed on the lead.  Where the model axis does not
divide the heads, or a device's heads and the groups cut each other, the
scan runs whole on the lead (:func:`head_split` says which runs).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn
from torch.nn import functional as Fn

from repro_torch.kernels import ssd as ssd_k
from repro_torch.kernels.execspec import resolve_device
from repro_torch.models import sharding as shrd
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import he_init, param, rms_norm

__all__ = ["SSMMixer", "SSMState", "SSD_BF16", "head_split", "init_ssm_params",
           "init_ssm_state", "ssd_chunked", "ssd_reference", "ssm_forward",
           "ssm_forward_tp"]


class SSMState(NamedTuple):
    """Decode cache: recurrent state (B, h, p, n) + conv ring (B, d_conv-1, C)."""

    state: torch.Tensor
    conv: torch.Tensor


#: The reference's mixed-precision switch: the scan's xd, B and C in bf16,
#: ad and the carried state in float32 (``ssm.py:214-217``).  Kernel B8's
#: bf16 form takes that mix (sums in float32, y rounded once to bf16) where
#: the reference runs ``ssd_chunked``'s bf16 einsums; decode steps and
#: ragged tails run the recurrence on the same dtypes, as the reference's.
SSD_BF16: bool = False


class SSMMixer(nn.Module):
    """The parameters of one Mamba2 mixer (see :func:`init_ssm_params`)."""

    def __init__(self, tensors: dict[str, torch.Tensor]):
        super().__init__()
        for name in ("in_proj", "conv_w", "conv_b", "A_log", "dt_bias", "D",
                     "gate_norm", "out_proj"):
            self.register_parameter(name, param(tensors[name]))


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def init_ssm_params(gen: torch.Generator, cfg: ModelConfig) -> SSMMixer:
    """Random init on the generator's device, the reference's scheme."""
    s = cfg.ssm
    d, di = cfg.d_model, cfg.d_inner
    h, n, g = cfg.n_ssm_heads, s.d_state, s.n_groups
    d_xbc = di + 2 * g * n
    dev = gen.device
    return SSMMixer({
        # order: [z (di), x (di), B (g*n), C (g*n), dt (h)]
        "in_proj": he_init(gen, (d, 2 * di + 2 * g * n + h)),
        "conv_w": he_init(gen, (d_xbc, s.d_conv)),
        "conv_b": torch.zeros((d_xbc,), device=dev),
        "A_log": torch.log(torch.linspace(1.0, 16.0, h, device=dev)),
        "dt_bias": torch.full((h,), -4.6, device=dev),    # softplus^-1(0.01)
        "D": torch.ones((h,), device=dev),
        "gate_norm": torch.ones((di,), device=dev),
        "out_proj": he_init(gen, (di, d)),
    })


# ---------------------------------------------------------------------------
# SSD core
# ---------------------------------------------------------------------------


def ssd_chunked(xd: torch.Tensor, ad: torch.Tensor, B: torch.Tensor,
                C: torch.Tensor, chunk: int,
                init_state: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunked state-space dual scan: kernel B8 on the card, its plain
    version on the CPU.  Returns (y (b, l, h, p) in xd's dtype,
    final_state in promote(xd, float32))."""
    return ssd_k.ssd_fused(xd, ad, B, C, chunk=chunk, init_state=init_state)


def ssd_reference(xd, ad, B, C, init_state=None):
    """Naive per-token recurrence (ragged tails and decode steps), in the
    reference's dtypes: the state starts in xd's dtype and is promoted by
    ``exp(ad)`` (bf16 xd, float32 ad: a float32 state, the bf16 outer
    product added to it, y in float32)."""
    b, l, h, p = xd.shape
    g = B.shape[2]
    grp = torch.arange(h, device=xd.device) // (h // g)
    Bh = B[:, :, grp]
    Ch = C[:, :, grp]
    n = B.shape[3]
    st = (torch.zeros((b, h, p, n), dtype=xd.dtype, device=xd.device)
          if init_state is None else init_state.to(xd.dtype))
    ys = []
    for t in range(l):
        st = st * torch.exp(ad[:, t])[..., None, None] \
            + Bh[:, t][:, :, None, :] * xd[:, t][..., None]
        ys.append(torch.einsum("bhpn,bhn->bhp", st, Ch[:, t].to(st.dtype)))
    return torch.stack(ys, dim=1), st


# ---------------------------------------------------------------------------
# Full mixer forward
# ---------------------------------------------------------------------------


def _causal_conv(u: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 conv_state: torch.Tensor | None):
    """Depthwise causal conv1d.  u: (B, L, C); w: (C, K).  Returns (y, ring)."""
    k = w.shape[1]
    if conv_state is None:
        pad = torch.zeros((u.shape[0], k - 1, u.shape[2]), dtype=u.dtype,
                          device=u.device)
    else:
        pad = conv_state.to(u.dtype)
    up = torch.cat([pad, u], dim=1)                          # (B, L+K-1, C)
    y = sum(up[:, i: i + u.shape[1]] * w[:, i].to(u.dtype) for i in range(k))
    y = y + b.to(u.dtype)
    new_ring = up[:, -(k - 1):] if k > 1 else pad
    return Fn.silu(y), new_ring


def _scan(xin, dt, Bc, Cc, A_log, dt_bias, D, s_cfg, init, dtype):
    """The SSD core over some heads: ``xin`` (b, l, hh p), ``dt`` (b, l,
    hh) raw, ``Bc`` / ``Cc`` (b, l, gg n) of the groups those heads read,
    their ``A_log`` / ``dt_bias`` / ``D`` (hh,).  Kernel B8 on a chunk
    multiple, else the exact recurrence (ragged tails, decode steps), the
    reference's dtypes (``ssm.py:210-227``): xd, B and C in bf16 under
    :data:`SSD_BF16`, else float32; ad float32.
    Returns (y (b, l, hh p) in ``dtype``, the final state)."""
    b, l, _ = xin.shape
    hh, n = dt.shape[-1], s_cfg.d_state
    dt = Fn.softplus(dt.float() + dt_bias)                         # (b, l, hh)
    A = -torch.exp(A_log)                                          # (hh,)
    xh = xin.reshape(b, l, hh, s_cfg.head_dim)
    ssd_dtype = torch.bfloat16 if SSD_BF16 else torch.float32
    Bg = Bc.reshape(b, l, -1, n).to(ssd_dtype)
    Cg = Cc.reshape(b, l, -1, n).to(ssd_dtype)
    xd = (xh.float() * dt[..., None]).to(ssd_dtype)
    ad = dt * A                                                    # (b, l, hh) f32
    if l % s_cfg.chunk == 0 and l >= s_cfg.chunk:
        y, final = ssd_chunked(xd, ad, Bg, Cg, s_cfg.chunk, init)
    else:
        # ragged tails and decode steps (l == 1): exact recurrence
        y, final = ssd_reference(xd, ad, Bg, Cg, init)
    y = y + D.to(y.dtype)[None, None, :, None] * xh.to(y.dtype)
    return y.reshape(b, l, -1).to(dtype), final


def _split_proj(proj: torch.Tensor, cfg: ModelConfig):
    """z, xBC (x, B, C joined: the conv's input) and dt of ``in_proj``'s
    output, at the global offsets."""
    di, h, gn = cfg.d_inner, cfg.n_ssm_heads, cfg.ssm.n_groups * cfg.ssm.d_state
    z, xin, Bc, Cc, dt = torch.split(proj, [di, di, gn, gn, h], dim=-1)
    return z, torch.cat([xin, Bc, Cc], dim=-1), dt


def ssm_forward(p: SSMMixer, cfg: ModelConfig, x: torch.Tensor,
                state: SSMState | None = None
                ) -> tuple[torch.Tensor, SSMState | None]:
    """Mamba2 mixer.  x: (B, S, d).  ``state=None`` -> a pass without
    caches (no state returned); ``state`` given -> a prefill or decode step
    from it, returning the new state."""
    di, gn = cfg.d_inner, cfg.ssm.n_groups * cfg.ssm.d_state
    z, xbc, dt = _split_proj(x @ p.in_proj.to(x.dtype), cfg)
    conv_state = state.conv if state is not None else None
    xbc, new_conv = _causal_conv(xbc, p.conv_w, p.conv_b, conv_state)
    xin, Bc, Cc = torch.split(xbc, [di, gn, gn], dim=-1)
    init = state.state if state is not None else None
    y, final = _scan(xin, dt, Bc, Cc, p.A_log, p.dt_bias, p.D, cfg.ssm, init,
                     x.dtype)
    # gated RMSNorm then down-projection
    y = rms_norm(y * Fn.silu(z), p.gate_norm, cfg.norm_eps)
    out = y @ p.out_proj.to(x.dtype)
    new_state = (SSMState(state=final.float(), conv=new_conv)
                 if state is not None else None)
    return out, new_state


def _conv_tp(xbc: torch.Tensor, p: shrd.PlacedParams, row: shrd.Row,
             rings: list | None):
    """The depthwise conv of ``xbc`` (on the lead) per ``conv_w``'s channel
    block on its device, with its ring piece; the outputs joined on the
    lead in channel order.  Returns (xbc, each device's new ring or
    None)."""
    w, bias = row.pieces(p["conv_w"]), row.pieces(p["conv_b"])
    if p["conv_w"].tp_dim() is None:
        y, ring = _causal_conv(xbc, w[0], bias[0],
                               None if rings is None else rings[0])
        return y, None if rings is None else (
            [ring] + [ring.to(dev, copy=True) for dev in row.devices[1:]])
    cb = xbc.shape[-1] // row.size
    parts = [_causal_conv(xbc[..., m * cb:(m + 1) * cb].to(dev), wm, bm,
                          None if rings is None else rings[m])
             for m, (dev, wm, bm) in enumerate(zip(row.devices, w, bias))]
    return (shrd.cat_on([y for y, _ in parts], row.lead, dim=-1),
            None if rings is None else [r for _, r in parts])


def head_split(cfg: ModelConfig, m_size: int) -> int | None:
    """Heads a device of an ``m_size``-way model axis scans in
    :func:`ssm_forward_tp` (kernel B8 a head shard), or None where the
    scan runs whole on the lead: the model axis must divide the heads, and
    a device's heads must hold whole groups or lie inside one (mamba2's
    one group: B and C whole on every device)."""
    h, g = cfg.n_ssm_heads, cfg.ssm.n_groups
    if h % m_size:
        return None
    hd, hg = h // m_size, h // g
    return hd if hd % hg == 0 or hg % hd == 0 else None


def ssm_forward_tp(p: shrd.PlacedParams, cfg: ModelConfig, x: torch.Tensor,
                   row: shrd.Row, state: list[SSMState] | None = None
                   ) -> tuple[torch.Tensor, list[SSMState] | None]:
    """:func:`ssm_forward` over a data replica's model devices (``row``;
    ``p``: the mixer's placed parameters; ``x`` on the replica's lead;
    ``state``: each device's pieces of the layer's state (heads split
    where the model axis divides them) and conv ring (channels split where
    it divides them)).  Returns (out on the lead, each device's new state
    pieces, or None without ``state``)."""
    s_cfg, lead = cfg.ssm, row.lead
    di, h, ph = cfg.d_inner, cfg.n_ssm_heads, s_cfg.head_dim
    n, gn = s_cfg.d_state, s_cfg.n_groups * s_cfg.d_state
    w_in = row.pieces(p["in_proj"])
    if p["in_proj"].tp_dim() is None:
        proj = x @ w_in[0].to(x.dtype)
    else:                      # the all-gather GSPMD puts after ssm.py:202
        proj = shrd.cat_on([x.to(dev) @ w.to(x.dtype)
                            for dev, w in zip(row.devices, w_in)], lead, dim=-1)
    z, xbc, dt = _split_proj(proj, cfg)
    xbc, rings = _conv_tp(xbc, p, row, None if state is None
                          else [st.conv for st in state])
    xin, Bc, Cc = torch.split(xbc, [di, gn, gn], dim=-1)
    a_log, dt_bias, d_skip, gate = (row.pieces(p[k]) for k in
                                    ("A_log", "dt_bias", "D", "gate_norm"))
    w_out = row.pieces(p["out_proj"])
    hd = head_split(cfg, row.size)
    states_split = state is not None and state[0].state.shape[1] < h
    if hd is None:
        init = None
        if state is not None:
            init = (shrd.cat_on([st.state for st in state], lead, dim=1)
                    if states_split else state[0].state)
        y, final = _scan(xin, dt, Bc, Cc, a_log[0], dt_bias[0], d_skip[0],
                         s_cfg, init, x.dtype)
        y = rms_norm(y * Fn.silu(z), gate[0], cfg.norm_eps)
        if p["out_proj"].tp_dim() is None:
            out = y @ w_out[0].to(x.dtype)
        else:
            rb = di // row.size
            out = shrd.sum_on([y[..., m * rb:(m + 1) * rb].to(dev) @ w.to(x.dtype)
                               for m, (dev, w) in enumerate(zip(row.devices, w_out))],
                              lead)
        if state is None:
            return out, None
        final = final.float()
        if states_split:
            hs = h // row.size
            finals = [final[:, m * hs:(m + 1) * hs].to(dev, copy=True)
                      for m, dev in enumerate(row.devices)]
        else:
            finals = [final] + [final.to(dev, copy=True) for dev in row.devices[1:]]
        return out, [SSMState(state=f, conv=r) for f, r in zip(finals, rings)]
    hg = h // s_cfg.n_groups
    us, finals = [], []
    for m, dev in enumerate(row.devices):
        hs = slice(m * hd, (m + 1) * hd)
        cs = slice(m * hd * ph, (m + 1) * hd * ph)
        g0, g1 = m * hd // hg, max((m + 1) * hd // hg, m * hd // hg + 1)
        gs = slice(g0 * n, g1 * n)
        y, final = _scan(xin[..., cs].to(dev), dt[..., hs].to(dev),
                         Bc[..., gs].to(dev), Cc[..., gs].to(dev),
                         a_log[m][hs], dt_bias[m][hs], d_skip[m][hs], s_cfg,
                         None if state is None else state[m].state, x.dtype)
        us.append(y * Fn.silu(z[..., cs].to(dev)))
        finals.append(final)
    # the gated RMSNorm over the whole d_inner: partial sums of squares
    # summed on the lead, the scale handed back to every device
    ss = shrd.sum_on([u.float().square().sum(dim=-1, keepdim=True) for u in us],
                     lead)
    r = torch.rsqrt(ss / di + cfg.norm_eps)
    outs = []
    for m, (dev, u) in enumerate(zip(row.devices, us)):
        cs = slice(m * hd * ph, (m + 1) * hd * ph)
        y = (u.float() * r.to(dev) * gate[m][cs].float()).to(x.dtype)
        outs.append(y @ w_out[m].to(x.dtype))
    out = shrd.sum_on(outs, lead)
    if state is None:
        return out, None
    return out, [SSMState(state=f.float(), conv=c) for f, c in zip(finals, rings)]


def init_ssm_state(cfg: ModelConfig, batch: int, dtype=torch.float32,
                   device=None) -> SSMState:
    """Zero SSM state and conv ring on ``device`` (``None``: the card)."""
    device = resolve_device(device)
    s = cfg.ssm
    d_xbc = cfg.d_inner + 2 * s.n_groups * s.d_state
    return SSMState(
        state=torch.zeros((batch, cfg.n_ssm_heads, s.head_dim, s.d_state),
                          dtype=torch.float32, device=device),
        conv=torch.zeros((batch, s.d_conv - 1, d_xbc), dtype=dtype,
                         device=device),
    )
