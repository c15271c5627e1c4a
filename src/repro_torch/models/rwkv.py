"""RWKV-6 "Finch" block: token shift + data-dependent decay WKV (attn-free).

The port of the JAX package's ``models/rwkv.py``: per-channel
data-dependent decay ``w_t = exp(-exp(w0 + lora(x)))``, token-shift input
mixing, a matrix-valued per-head state ``S ∈ (hd, hd)`` with bonus ``u``,
and a gated, group-normalized readout.  Time mixing is a loop over time;
the state (S, last token) is the decode cache.  The channel-mix FFN is
RWKV's squared-ReLU form.  :func:`time_mix` and :func:`channel_mix` run
on any slice of the heads or of ``d_ff`` (the mesh's split forms,
:mod:`repro_torch.models.tensor_parallel`).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_init, torch_dtype
from repro_torch.models.scan_utils import chunked_scan

__all__ = ["rwkv_init", "rwkv_apply", "rwkv_ffn_init", "rwkv_ffn_apply",
           "shift", "time_mix", "channel_mix"]


def rwkv_init(gen, d_model: int, head_dim: int, dtype, lora_rank: int = 64):
    dev = gen.device
    dt = torch_dtype(dtype)
    H = d_model // head_dim
    # per-channel ramps (the reference RWKV-6 init): decay speeds span
    # [-6, -1] across channels and the bonus starts O(1)
    ar = torch.arange(d_model, dtype=torch.float32, device=dev)
    chan = ar / max(d_model - 1, 1)
    zigzag = (ar + 1) % 3 - 1.0
    p = {"mu": 0.5 * torch.ones((5, d_model), dtype=dt, device=dev)}
    for w in ("wr", "wk", "wv", "wg", "wo"):
        p[w] = dense_init(gen, (d_model, d_model), dtype)
    p["w0"] = -6.0 + 5.0 * chan ** 1.35
    p["wA"] = dense_init(gen, (d_model, lora_rank), dtype, scale=0.01)
    p["wB"] = dense_init(gen, (lora_rank, d_model), dtype, scale=0.01)
    p["u"] = (0.5 * (1.0 - chan) + 0.1 * zigzag).reshape(H, head_dim)
    p["ln_g"] = torch.ones((d_model,), dtype=dt, device=dev)
    return p


def rwkv_apply(p, x: torch.Tensor, state=None):
    """x: (B, S, d) → (y, new_state).

    state: {"S": (B, H, hd, hd) f32, "last": (B, d)} (decode cache).
    """
    B, S, d = x.shape
    hd = p["u"].shape[1]
    H = d // hd

    if state is None:
        last = torch.zeros((B, d), dtype=x.dtype, device=x.device)
        S0 = torch.zeros((B, H, hd, hd), dtype=torch.float32, device=x.device)
    else:
        last, S0 = state["last"], state["S"]
    out, S_last = time_mix(p, x, shift(x, last), S0)
    return out, {"S": S_last, "last": x[:, -1, :]}


def shift(x: torch.Tensor, last: torch.Tensor) -> torch.Tensor:
    """The token shift: x_{t-1} per position (``last`` before the first)."""
    return torch.cat([last[:, None, :], x[:, :-1, :]], dim=1)


def time_mix(p, x: torch.Tensor, xprev: torch.Tensor, S0: torch.Tensor):
    """The time mix of the heads ``p`` holds: ``(y @ wo, S_last)``.

    ``p``'s ``wr``/``wk``/``wv``/``wg`` and ``wB`` hold the heads' ``H
    hd`` columns, ``w0`` and ``ln_g`` their channels, ``u`` their rows,
    ``wo`` their rows (all heads: the whole block; a slice of the heads:
    that slice's partial output); ``mu`` and ``wA`` are whole.
    """
    B, S, _ = x.shape
    dtype = x.dtype
    H, hd = p["u"].shape

    def mix(i):
        return x + (xprev - x) * p["mu"][i]

    def headed(i, w):
        return (mix(i) @ p[w]).reshape(B, S, H, hd)

    r, k, v = headed(0, "wr"), headed(1, "wk"), headed(2, "wv")
    g = mix(3) @ p["wg"]
    # data-dependent decay (f32 for the double exponential)
    wln = p["w0"] + (torch.tanh(mix(4) @ p["wA"]) @ p["wB"]).float()
    w = torch.exp(-torch.exp(wln)).reshape(B, S, H, hd)

    rf, kf, vf = (a.float() for a in (r, k, v))
    u = p["u"][..., None]

    def step(Sm, inp):
        rt, kt, vt, wt = inp                       # (B,H,hd) each
        kv = kt[..., :, None] * vt[..., None, :]   # (B,H,hd,hd)
        y = torch.einsum("bhk,bhkv->bhv", rt, Sm + u * kv)
        Sm = wt[..., :, None] * Sm + kv
        return Sm, y

    xs = (rf.transpose(0, 1), kf.transpose(0, 1), vf.transpose(0, 1),
          w.transpose(0, 1))
    S_last, ys = chunked_scan(step, S0, xs)
    # group-norm per head (population variance, as jnp.var), then gate;
    # eps scales with the head dim
    y = ys.transpose(0, 1).reshape(B, S, H, hd)
    mean = y.mean(-1, keepdim=True)
    var = y.var(-1, keepdim=True, correction=0)
    y = ((y - mean) * torch.rsqrt(var + 1e-5 * hd)).reshape(B, S, H * hd)
    y = (y.to(dtype) * p["ln_g"]) * F.silu(g)
    return y @ p["wo"], S_last


# ---- channel mix (RWKV FFN): squared-relu K, sigmoid receptance gate -------

def rwkv_ffn_init(gen, d_model: int, d_ff: int, dtype):
    return {
        "mu": 0.5 * torch.ones((2, d_model), dtype=torch_dtype(dtype),
                               device=gen.device),
        "wk": dense_init(gen, (d_model, d_ff), dtype),
        "wv": dense_init(gen, (d_ff, d_model), dtype),
        "wr": dense_init(gen, (d_model, d_model), dtype),
    }


def rwkv_ffn_apply(p, x: torch.Tensor, state=None):
    B, S, d = x.shape
    if state is None:
        last = torch.zeros((B, d), dtype=x.dtype, device=x.device)
    else:
        last = state["last"]
    vv, rr = channel_mix(p, x, shift(x, last))
    return rr * vv, {"last": x[:, -1, :]}


def channel_mix(p, x: torch.Tensor, xprev: torch.Tensor) -> tuple:
    """``(kk @ wv, sigmoid(xr @ wr))`` of the channel mix, ``kk`` the
    squared ReLU of ``xk @ wk``: on ``p``'s ``d_ff`` columns of ``wk``
    with the matching rows of ``wv`` (all of them: the whole product; a
    slice: its partial) and its columns of ``wr``."""
    xk = x + (xprev - x) * p["mu"][0]
    xr = x + (xprev - x) * p["mu"][1]
    kk = torch.square(F.relu(xk @ p["wk"]))
    return kk @ p["wv"], torch.sigmoid(xr @ p["wr"])
