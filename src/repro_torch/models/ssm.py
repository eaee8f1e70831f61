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
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn
from torch.nn import functional as Fn

from repro_torch.kernels import ssd as ssd_k
from repro_torch.kernels.execspec import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import he_init, param, rms_norm

__all__ = ["SSMMixer", "SSMState", "SSD_BF16", "init_ssm_params",
           "init_ssm_state", "ssd_chunked", "ssd_reference", "ssm_forward"]


class SSMState(NamedTuple):
    """Decode cache: recurrent state (B, h, p, n) + conv ring (B, d_conv-1, C)."""

    state: torch.Tensor
    conv: torch.Tensor


#: The reference's mixed-precision switch (bf16 einsums in the chunked
#: scan).  Kernel B8 has no bf16 form: setting it raises in
#: :func:`ssm_forward` (ROADMAP C).
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
    version on the CPU.  Returns (y (b, l, h, p), final_state float32 or
    float64, as the inputs)."""
    return ssd_k.ssd_fused(xd, ad, B, C, chunk=chunk, init_state=init_state)


def ssd_reference(xd, ad, B, C, init_state=None):
    """Naive per-token recurrence (ragged tails and decode steps)."""
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
        ys.append(torch.einsum("bhpn,bhn->bhp", st, Ch[:, t]))
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


def ssm_forward(p: SSMMixer, cfg: ModelConfig, x: torch.Tensor,
                state: SSMState | None = None
                ) -> tuple[torch.Tensor, SSMState | None]:
    """Mamba2 mixer.  x: (B, S, d).  ``state=None`` -> a pass without
    caches (no state returned); ``state`` given -> a prefill or decode step
    from it, returning the new state."""
    if SSD_BF16:
        raise NotImplementedError(
            "SSD_BF16: kernel B8 has no bf16 form (ROADMAP C)")
    s_cfg = cfg.ssm
    b, l, _ = x.shape
    di, h, n, g = cfg.d_inner, cfg.n_ssm_heads, s_cfg.d_state, s_cfg.n_groups
    ph = s_cfg.head_dim

    proj = x @ p.in_proj.to(x.dtype)
    z, xin, Bc, Cc, dt = torch.split(proj, [di, di, g * n, g * n, h], dim=-1)
    xbc = torch.cat([xin, Bc, Cc], dim=-1)
    conv_state = state.conv if state is not None else None
    xbc, new_conv = _causal_conv(xbc, p.conv_w, p.conv_b, conv_state)
    xin, Bc, Cc = torch.split(xbc, [di, g * n, g * n], dim=-1)

    dt = Fn.softplus(dt.float() + p.dt_bias)                       # (b, l, h)
    A = -torch.exp(p.A_log)                                        # (h,)
    xh = xin.reshape(b, l, h, ph)
    Bg = Bc.reshape(b, l, g, n).float()
    Cg = Cc.reshape(b, l, g, n).float()
    xd = xh.float() * dt[..., None]
    ad = dt * A                                                    # (b, l, h) f32

    init = state.state if state is not None else None
    if l % s_cfg.chunk == 0 and l >= s_cfg.chunk:
        y, final = ssd_chunked(xd, ad, Bg, Cg, s_cfg.chunk, init)
    else:
        # ragged tails and decode steps (l == 1): exact recurrence
        y, final = ssd_reference(xd, ad, Bg, Cg, init)
    y = y + p.D.to(y.dtype)[None, None, :, None] * xh.to(y.dtype)
    y = y.reshape(b, l, di).to(x.dtype)

    # gated RMSNorm then down-projection
    y = rms_norm(y * Fn.silu(z), p.gate_norm, cfg.norm_eps)
    out = y @ p.out_proj.to(x.dtype)
    new_state = (SSMState(state=final.float(), conv=new_conv)
                 if state is not None else None)
    return out, new_state


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
