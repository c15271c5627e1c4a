"""Shared building blocks: RMSNorm, RoPE, gated MLP, top-k MoE.

The port of the JAX package's ``models/layers.py``.  Conventions: params
are plain dicts of tensors with the JAX package's layouts (``x @ W``, ``W``
as ``(d_in, d_out)``); compute dtype follows the input; reductions (norms,
softmax, router) accumulate in f32, and every cast stands where the JAX
module has it, so a bfloat16 model promotes as it does there.  Random
initialisation draws from an explicit ``torch.Generator`` on the device
the parameters are made on.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["MetaGenerator", "dense_init", "rms_norm", "rope", "act_fn",
           "mlp_init", "mlp_apply", "moe_init", "moe_route", "moe_chunks",
           "moe_sorted_chunks", "moe_capacity", "moe_expert", "moe_apply",
           "moe_apply_sorted", "torch_dtype"]


def torch_dtype(name) -> torch.dtype:
    """``"bfloat16"`` -> ``torch.bfloat16`` (a torch dtype passes through)."""
    return name if isinstance(name, torch.dtype) else getattr(torch, name)


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------

class MetaGenerator:
    """Stands in for a ``torch.Generator`` on the ``meta`` device (torch
    has none there): the init functions then build a tree of shapes and
    dtypes without allocating or drawing (``lm.param_specs``)."""

    device = torch.device("meta")


def dense_init(gen: torch.Generator, shape, dtype, scale: float | None = None):
    """Normal draws in f32 times ``scale`` (default ``shape[0] ** -0.5``,
    as in JAX, also for stacked expert weights), cast to ``dtype``; an
    empty ``meta`` tensor for a :class:`MetaGenerator`."""
    if gen.device.type == "meta":
        return torch.empty(tuple(shape), dtype=torch_dtype(dtype),
                           device="meta")
    fan_in = shape[0] if len(shape) >= 2 else 1
    scale = scale if scale is not None else fan_in ** -0.5
    w = torch.randn(tuple(shape), generator=gen, dtype=torch.float32,
                    device=gen.device)
    return w.mul_(scale).to(torch_dtype(dtype))


# ---------------------------------------------------------------------------
# norms / rope / activations
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float) -> torch.Tensor:
    """Normalised in f32, cast back to ``x``'s dtype, then scaled."""
    dt = x.dtype
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(dt) * gamma


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding.  x: (..., S, H, hd); positions: (..., S)."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    angles = positions[..., None].float() * freqs  # (..., S, half)
    cos = torch.cos(angles)[..., None, :]  # (..., S, 1, half)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    xr1 = x1 * cos - x2 * sin
    xr2 = x2 * cos + x1 * sin
    return torch.cat([xr1, xr2], dim=-1).to(x.dtype)


def _gelu(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu's default is the tanh approximation; torch's is exact
    return F.gelu(x, approximate="tanh")


def act_fn(name: str):
    return {"silu": F.silu, "gelu": _gelu, "geglu": _gelu}[name]


# ---------------------------------------------------------------------------
# dense MLP (gated or plain)
# ---------------------------------------------------------------------------

def mlp_init(gen, d: int, ff: int, gated: bool, dtype):
    p = {"w_up": dense_init(gen, (d, ff), dtype),
         "w_down": dense_init(gen, (ff, d), dtype)}
    if gated:
        p["w_gate"] = dense_init(gen, (d, ff), dtype)
    return p


def mlp_apply(p, x: torch.Tensor, act: str) -> torch.Tensor:
    up = x @ p["w_up"]
    if "w_gate" in p:
        up = up * act_fn(act)(x @ p["w_gate"])
    else:
        up = act_fn(act)(up)
    return up @ p["w_down"]


# ---------------------------------------------------------------------------
# Mixture of Experts (top-k, dropless dense dispatch; sorted dispatch)
# ---------------------------------------------------------------------------

def moe_init(gen, d: int, ff: int, n_experts: int, gated: bool, dtype):
    p = {"router": dense_init(gen, (d, n_experts), torch.float32, scale=0.02),
         "w_up": dense_init(gen, (n_experts, d, ff), dtype),
         "w_down": dense_init(gen, (n_experts, ff, d), dtype)}
    if gated:
        p["w_gate"] = dense_init(gen, (n_experts, d, ff), dtype)
    return p


def moe_expert(p, e: int, xb: torch.Tensor, act: str) -> torch.Tensor:
    """Expert ``e``'s MLP on ``xb`` (its ``d_ff`` whole or a slice of it)."""
    up = xb @ p["w_up"][e]
    if "w_gate" in p:
        up = up * act_fn(act)(xb @ p["w_gate"][e])
    else:
        up = act_fn(act)(up)
    return up @ p["w_down"][e]


def moe_route(router: torch.Tensor, x: torch.Tensor, top_k: int) -> tuple:
    """``(combine, idx)``: each token's weight for every expert (B, S, E)
    in ``x``'s dtype, and its top-k experts (B, S, k).  The router
    product, ``top_k`` and softmax in f32."""
    E = router.shape[1]
    logits = x.float() @ router
    weights, idx = torch.topk(logits, top_k, dim=-1)      # (B,S,k)
    weights = torch.softmax(weights, dim=-1)
    combine = torch.sum(F.one_hot(idx, E).float() * weights[..., None],
                        dim=2).to(x.dtype)                 # (B,S,E)
    return combine, idx


def moe_chunks(S: int) -> list:
    """The ``[lo, hi)`` position ranges the expert loop runs over: chunks
    of 4096 where ``S`` is a longer multiple of it, as in JAX."""
    cs = 4096  # seq-chunk the pointwise expert loop: per-chunk transients
    if S > cs and S % cs == 0:
        return [(i, i + cs) for i in range(0, S, cs)]
    return [(0, S)]


def moe_sorted_chunks(S: int) -> list:
    """The ``[lo, hi)`` position ranges the sorted dispatch sorts over:
    chunks of 2048 where ``S`` is a longer multiple of it, as in JAX."""
    cs = 2048
    if S > cs and S % cs == 0:
        return [(i, i + cs) for i in range(0, S, cs)]
    return [(0, S)]


def moe_capacity(capacity_factor: float, N: int, top_k: int, E: int) -> int:
    """Each expert's slots for ``N`` tokens, as JAX's ``C``."""
    return int(capacity_factor * N * top_k / E + 0.999)


def moe_apply(p, x: torch.Tensor, *, top_k: int, act: str) -> torch.Tensor:
    """Dropless top-k MoE, expert-looped dense dispatch.

    x: (B, S, d).  Routing in f32; every expert processes every token,
    masked by its combine weight, one (B, S, ff) transient per expert.
    Sequences longer than 4096 (and a multiple of it) run in chunks of
    4096 positions, as in JAX.
    """
    E = p["w_up"].shape[0]
    combine, _ = moe_route(p["router"], x, top_k)

    def block(xb, cb):  # (B, cs, d), (B, cs, E)
        ob = torch.zeros_like(xb)
        for e in range(E):
            ob = ob + cb[..., e, None] * moe_expert(p, e, xb, act)
        return ob

    chunks = moe_chunks(x.shape[1])
    if len(chunks) > 1:
        return torch.cat([block(x[:, lo:hi], combine[:, lo:hi])
                          for lo, hi in chunks], dim=1)
    return block(x, combine)


def moe_apply_sorted(p, x: torch.Tensor, *, top_k: int, act: str,
                     capacity_factor: float = 1.25) -> torch.Tensor:
    """Capacity-based sorted MoE dispatch.

    Sorts the (token, expert) assignments by expert, packs each expert's
    tokens into a fixed-capacity buffer (E, C, d), runs E batched matmuls
    and combines; assignments past capacity are dropped.  Sequences
    longer than 2048 (and a multiple of it) run in chunks of 2048.
    """
    chunks = moe_sorted_chunks(x.shape[1])
    if len(chunks) > 1:
        return torch.cat([
            _moe_sorted_block(p, x[:, lo:hi], top_k=top_k, act=act,
                              capacity_factor=capacity_factor)
            for lo, hi in chunks], dim=1)
    return _moe_sorted_block(p, x, top_k=top_k, act=act,
                             capacity_factor=capacity_factor)


def _moe_sorted_block(p, x, *, top_k, act, capacity_factor):
    B, S, d = x.shape
    E = p["w_up"].shape[0]
    N = B * S
    xf = x.reshape(N, d)
    logits = xf.float() @ p["router"]
    weights, idx = torch.topk(logits, top_k, dim=-1)      # (N, k)
    weights = torch.softmax(weights, dim=-1).to(x.dtype)

    C = moe_capacity(capacity_factor, N, top_k, E)
    # sort assignments by expert (stable, as jnp.argsort); rank in expert
    flat_e = idx.reshape(-1)                               # (N*k,)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    pos_in_e = torch.arange(N * top_k, device=x.device) - torch.searchsorted(
        sorted_e, sorted_e, side="left")
    keep = pos_in_e < C
    slot = sorted_e * C + torch.where(keep, pos_in_e, 0)   # (N*k,)
    token_of = order // top_k

    # dispatch: every kept assignment owns its slot, so a plain indexed
    # write is JAX's scatter-add into zeros; dropped ones (which add 0 in
    # JAX) go to a dump row past the buffer
    disp = torch.zeros((E * C + 1, d), dtype=x.dtype, device=x.device)
    disp[torch.where(keep, slot, E * C)] = torch.where(
        keep[:, None], xf[token_of], 0.0).to(x.dtype)
    disp = disp[:E * C].reshape(E, C, d)

    up = torch.einsum("ecd,edf->ecf", disp, p["w_up"])
    if "w_gate" in p:
        up = up * act_fn(act)(torch.einsum("ecd,edf->ecf", disp, p["w_gate"]))
    else:
        up = act_fn(act)(up)
    y = torch.einsum("ecf,efd->ecd", up, p["w_down"]).reshape(E * C, d)

    # combine: each kept assignment's output times its weight, summed per
    # token.  Un-sorted back to (N, k) and added in rank order from zero:
    # deterministic on any device (no atomics).  JAX adds in sorted order;
    # for top_k = 2 the sums agree bit for bit (0 + a + b = 0 + b + a).
    w_flat = weights.reshape(-1)[order]
    contrib = torch.where(keep[:, None], y[slot] * w_flat[:, None],
                          0.0).to(x.dtype)
    per_token = torch.empty_like(contrib)
    per_token[order] = contrib
    per_token = per_token.reshape(N, top_k, d)
    out = torch.zeros((N, d), dtype=x.dtype, device=x.device)
    for j in range(top_k):
        out = out + per_token[:, j]
    return out.reshape(B, S, d)
