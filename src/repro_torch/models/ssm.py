"""Mamba (S6) selective state-space block — used standalone and in Jamba.

The port of the JAX package's ``models/ssm.py``: in_proj → depthwise
causal conv1d (stacked shifts) → selective (input-dependent) dt/B/C →
diagonal SSM scan over time → gated out_proj.  The state ``(B, d_inner,
d_state)`` (f32) and the conv window are the decode cache.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_init, torch_dtype
from repro_torch.models.scan_utils import chunked_scan

__all__ = ["mamba_init", "mamba_conv", "mamba_scan", "mamba_apply"]


def mamba_init(gen, d_model: int, d_inner: int, d_state: int, d_conv: int,
               dtype):
    dev = gen.device
    dt_rank = max(1, math.ceil(d_model / 16))
    A = torch.arange(1, d_state + 1, dtype=torch.float32,
                     device=dev)[None, :].repeat(d_inner, 1)
    return {
        "in_proj": dense_init(gen, (d_model, 2 * d_inner), dtype),
        "conv_w": dense_init(gen, (d_conv, d_inner), dtype, scale=0.5),
        "conv_b": torch.zeros((d_inner,), dtype=torch_dtype(dtype),
                              device=dev),
        "x_proj": dense_init(gen, (d_inner, dt_rank + 2 * d_state), dtype),
        "dt_proj": dense_init(gen, (dt_rank, d_inner), dtype, scale=0.1),
        "dt_bias": torch.zeros((d_inner,), dtype=torch.float32,
                               device=dev) - 4.0,
        "A_log": torch.log(A),
        "D": torch.ones((d_inner,), dtype=torch.float32, device=dev),
        "out_proj": dense_init(gen, (d_inner, d_model), dtype),
    }


def _softplus(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.softplus is logaddexp(x, 0) everywhere; F.softplus switches
    # to the identity above its threshold
    return torch.logaddexp(x, torch.zeros_like(x))


def _selective(p, proj):
    """dt, B, C from the post-conv activations' ``x_proj`` product
    ``proj`` (B, S, dt_rank + 2 d_state)."""
    d_state = p["A_log"].shape[1]
    dt_rank = p["x_proj"].shape[1] - 2 * d_state
    dt_in, Bm, Cm = torch.split(proj, [dt_rank, d_state, d_state], dim=-1)
    dt = _softplus((dt_in @ p["dt_proj"]).float() + p["dt_bias"])
    return dt, Bm.float(), Cm.float()


def mamba_conv(p, xin: torch.Tensor, conv_prev: torch.Tensor) -> tuple:
    """The causal depthwise conv (stacked shifts; d_conv is tiny) and its
    SiLU over ``xin`` (B, S, di) after the window ``conv_prev``: ``(xin,
    new window)``.  Each channel on its own."""
    S = xin.shape[1]
    d_conv = p["conv_w"].shape[0]
    xpad = torch.cat([conv_prev, xin], dim=1)  # (B, S+c-1, di)
    conv_out = sum(xpad[:, i:i + S, :] * p["conv_w"][i] for i in range(d_conv))
    new_conv = xpad[:, -(d_conv - 1):, :] if d_conv > 1 else conv_prev
    return F.silu(conv_out + p["conv_b"]), new_conv


def mamba_scan(p, xin, z, proj, ssm0) -> tuple:
    """The selective scan from the conv's output ``xin`` and the gate
    ``z`` (B, S, di), the ``x_proj`` product ``proj`` and the f32 state
    ``ssm0`` (B, di, ds): ``(y, last state)``, ``y`` (B, S, di) in
    ``xin``'s dtype before ``out_proj``.  Each channel on its own."""
    dt, Bm, Cm = _selective(p, proj)                # (B,S,di),(B,S,ds)x2
    A = -torch.exp(p["A_log"])                       # (di, ds)
    xf = xin.float()

    def step(h, inp):
        xt, dtt, Bt_, Ct = inp                      # (B,di),(B,di),(B,ds),(B,ds)
        da = torch.exp(dtt[..., None] * A)          # (B, di, ds)
        h = da * h + (dtt * xt)[..., None] * Bt_[:, None, :]
        y = torch.einsum("bds,bs->bd", h, Ct)
        return h, y

    xs = (xf.transpose(0, 1), dt.transpose(0, 1),
          Bm.transpose(0, 1), Cm.transpose(0, 1))
    h_last, ys = chunked_scan(step, ssm0, xs)
    y = ys.transpose(0, 1) + xf * p["D"]             # (B, S, di)
    return y.to(xin.dtype) * F.silu(z), h_last


def mamba_apply(p, x: torch.Tensor, state=None):
    """x: (B, S, d) → (y, new_state).

    state (decode cache): {"conv": (B, d_conv-1, d_inner),
    "ssm": (B, d_inner, d_state)}; None for a fresh sequence.
    """
    Bt = x.shape[0]
    d_inner = p["D"].shape[0]
    d_state = p["A_log"].shape[1]
    d_conv = p["conv_w"].shape[0]

    xin, z = torch.chunk(x @ p["in_proj"], 2, dim=-1)

    if state is None:
        conv_prev = torch.zeros((Bt, d_conv - 1, d_inner), dtype=x.dtype,
                                device=x.device)
        ssm0 = torch.zeros((Bt, d_inner, d_state), dtype=torch.float32,
                           device=x.device)
    else:
        conv_prev, ssm0 = state["conv"], state["ssm"]

    xin, new_conv = mamba_conv(p, xin, conv_prev)
    y, h_last = mamba_scan(p, xin, z, xin @ p["x_proj"], ssm0)
    out = y @ p["out_proj"]
    return out, {"conv": new_conv, "ssm": h_last}
