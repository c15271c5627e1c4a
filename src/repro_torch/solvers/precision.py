"""PrecisionPolicy — mixed-precision Krylov storage with f64 refinement.

A copy of the JAX package's policy table.  A :class:`PrecisionPolicy`
names one point on the storage-width trade of a bandwidth-bound Krylov
loop:

* ``storage`` — the dtype the DIA bands and the Krylov vectors of the
  *inner* sweep are held in (what the SpMV/axpy kernels stream from
  device memory);
* ``accum`` — the dtype the dot-product partials accumulate in (kernels
  upcast per element, so a bf16 sweep still reduces in f32);
* ``refine`` — whether an **outer f64 iterative-refinement loop** wraps
  the inner sweep.

The port's kernels take every (storage, accum) pair below, and
``SolverOps`` carries a policy into ``cg``/``bicgstab``: under ``f32_ir``
and ``bf16_ir`` they replay the true residual ``r = b - A_hi x`` in f64,
solve the correction ``A_lo d = r`` with one sweep at the storage dtype
to ``inner_tol``, apply ``x += d`` in f64, and repeat up to
``max_outer`` times.
"""
from __future__ import annotations

import dataclasses

import torch

__all__ = [
    "PrecisionPolicy", "F64", "F32_IR", "BF16_IR", "POLICIES",
    "PRECISION_FALLBACK", "get_policy",
]


@dataclasses.dataclass(frozen=True)
class PrecisionPolicy:
    """One named point on the storage-precision / refinement trade."""

    name: str
    storage: str          # dtype name for bands + inner-sweep vectors
    accum: str            # dtype name for dot-partial accumulation
    storage_itemsize: int  # bytes/value streamed by the inner hot loop
    accum_itemsize: int    # bytes/value of a partial-sum slot
    refine: bool          # outer f64 residual-replay loop around the sweep
    inner_tol: float      # relative tolerance of one inner correction solve
    max_outer: int        # outer-refinement cadence cap

    @property
    def storage_dtype(self) -> torch.dtype:
        """The storage dtype as a torch dtype."""
        return getattr(torch, self.storage)

    @property
    def accum_dtype(self) -> torch.dtype:
        return getattr(torch, self.accum)


# The do-nothing policy: everything f64, no outer loop — the pre-policy
# solver behaviour, bit-identical by construction (all casts are no-ops).
F64 = PrecisionPolicy(name="f64", storage="float64", accum="float64",
                      storage_itemsize=8, accum_itemsize=8,
                      refine=False, inner_tol=0.0, max_outer=0)

# f32 storage halves every band/vector byte; f32 accumulation is ample for
# the block partials (the outer loop absorbs the rest).  One inner sweep
# reliably reaches 1e-4, so ~3-4 outers cover a 1e-12 pressure tolerance.
F32_IR = PrecisionPolicy(name="f32_ir", storage="float32", accum="float32",
                         storage_itemsize=4, accum_itemsize=4,
                         refine=True, inner_tol=1e-4, max_outer=16)

# bf16 storage quarters the bytes but eps ~= 4e-3 floors what one sweep
# can contract: the inner tolerance stays above the bf16 stagnation level
# (5e-2 >> eps) so every sweep terminates fast, and the generous outer cap
# still reaches 1e-12 at ~6e-2 contraction per outer.  Partials accumulate
# in f32 (a bf16 reduction over 2048-row blocks would lose the dot).
BF16_IR = PrecisionPolicy(name="bf16_ir", storage="bfloat16", accum="float32",
                          storage_itemsize=2, accum_itemsize=4,
                          refine=True, inner_tol=5e-2, max_outer=48)

POLICIES: dict[str, PrecisionPolicy] = {
    p.name: p for p in (F64, F32_IR, BF16_IR)
}

# The supervisor's escalation ladder: one rung toward f64 per fault, tried
# *before* any backend rebind (repro_torch.serving.engine._supervise).
PRECISION_FALLBACK: dict[str, str] = {"bf16_ir": "f32_ir", "f32_ir": "f64"}


def get_policy(precision: str | PrecisionPolicy) -> PrecisionPolicy:
    """Resolve a policy name (or pass a policy through), raising on typos."""
    if isinstance(precision, PrecisionPolicy):
        return precision
    try:
        return POLICIES[precision]
    except KeyError:
        raise ValueError(
            f"unknown precision policy {precision!r}; "
            f"expected one of {tuple(POLICIES)}") from None
