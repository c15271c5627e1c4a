"""SIMPLE — the steady-state segregated program (simpleFoam).

A different phase list over the same phase toolkit as PISO
(``fvm/step_program._phase_toolkit``), plus an outer-loop convergence
predicate that :meth:`~repro_torch.fvm.step_program.SerialExecutor.
run_converged` iterates to.  One outer iteration:

1. **assemble_mom** — the steady momentum matrix: assembling with
   ``dt = inf`` makes the transient term exactly zero (``V/inf = 0``).
2. **relax_mom** — implicit under-relaxation (OpenFOAM ``relax()``):
   ``diag' = diag / λ_u``, ``source' = source + (1-λ_u) diag' U``; the
   factor is an extra operand of the step (``extra_keys``).
3. **update_mom → solve_mom** — the repartitioned BiCGStab.
4. **assemble_p → update_p → solve_p** — one pressure correction, ``rAU``
   from the *relaxed* diagonal, CG from the previous pressure.
5. **correct** — conservative flux correction with the *unrelaxed*
   ``p_new``, explicit pressure relaxation ``p = p_old + λ_p (p_new -
   p_old)``, momentum correction from the relaxed gradient, and the two
   convergence residuals: the continuity error and ``u_delta = max|U -
   U_prev|``.

The program is converged when both residuals are under their gates
(``solver.tol_continuity``, ``solver.tol_u``).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.fvm.step_program import (Phase, ProgramSpec, StepProgram,
                                         _binding, _phase_toolkit,
                                         cohort_form,
                                         final_state, health_flags,
                                         register_program, seed_env)

__all__ = ["SimpleStats", "build_simple_program"]


class SimpleStats(NamedTuple):
    """Per-outer-iteration residuals: ``StepStats``'s fields plus the
    outer velocity change ``u_delta``."""

    mom_iters: torch.Tensor
    p_iters: torch.Tensor         # (1,): one correction per outer iteration
    continuity_err: torch.Tensor  # max |div(phi)| / V after correction
    p_residual: torch.Tensor
    u_delta: torch.Tensor         # max |U - U_prev| over the outer iteration
    converged: torch.Tensor       # health, as StepStats (health_flags)
    diverged: torch.Tensor
    hit_cap: torch.Tensor


def build_simple_program(solver, lanes: int | None = None,
                         binding: tuple | None = None) -> StepProgram:
    """Bind a :class:`~repro_torch.fvm.piso.SegregatedSolver` into the
    SIMPLE phase list (see the module docstring).

    The program ignores the executor's ``dt`` (steady assembly uses ``dt
    = inf``) but keeps it, so every program takes ``(state, dt,
    *extras)``; the extras are ``(relax_u, relax_p)``, after ``n_active``
    for a padded (size-class) solver.  ``lanes``: the cohort form (as
    :func:`~repro_torch.fvm.step_program.build_piso_program`).
    """
    binding = _binding(solver) if binding is None else binding
    tk = _phase_toolkit(solver, lanes, binding)
    lay, mask_keys = tk.layout, tk.mask_keys
    tol_c = float(solver.tol_continuity)
    tol_u = float(solver.tol_u)

    def relax_mom(sysM, U, relax_u):
        # a tensor on the device either way, so one lane and a cohort take
        # the same (true) division on every device
        relax_u = torch.as_tensor(lay.per_part(relax_u), dtype=U.dtype,
                                  device=U.device)
        diag = sysM.diag / relax_u
        source = sysM.source + ((1.0 - relax_u) * diag)[..., None] * U
        return dataclasses.replace(sysM, diag=diag, source=source)

    def correct(sysP, phiH, phiH_if, phiH_b, p, p_new, HbyA, rAU, relax_p,
                U0, *masks):
        a = tk.asm_of(*masks)
        # mass conservation sees the FULL pressure correction ...
        phi, phi_if = a.correct_flux(sysP, phiH, phiH_if, p_new)
        phi_b = a.correct_boundary_flux(sysP, phiH_b, p_new)
        # ... while the momentum correction uses the relaxed field
        p_rel = p + lay.per_part(relax_p) * (p_new - p)
        U = HbyA - rAU[..., None] * a.grad(p_rel)
        cont = lay.max(torch.abs(a.divergence(phi, phi_if, phi_b))) / a.V
        u_delta = lay.max(torch.abs(U - U0))
        return phi, phi_if, phi_b, p_rel, U, cont, u_delta

    phases = (
        Phase("assemble_mom", "assembly",
              ("U", "phi", "phi_if", "phi_b", "p", "dt") + mask_keys,
              ("sysM0",), tk.assemble_mom),
        Phase("relax_mom", "assembly", ("sysM0", "U", "relax_u"),
              ("sysM",), relax_mom),
        Phase("update_mom", "assembly", ("sysM",), ("bandsM",),
              tk.update_mom),
        Phase("solve_mom", "assembly", ("bandsM", "sysM", "U"),
              ("U", "mom_iters", "mom_ok", "mom_cap"), tk.solve_mom),
        Phase("assemble_p", "assembly", ("sysM", "U") + mask_keys,
              ("rAU", "HbyA", "phiH", "phiH_if", "phiH_b", "sysP"),
              tk.assemble_p),
        Phase("update_p", "update", ("sysP",), ("bandsP",), tk.update_p),
        Phase("solve_p", "solve", ("bandsP", "sysP", "p"),
              ("p_new", "p_iters_0", "p_res", "p_ok_0", "p_cap_0"),
              tk.solve_p),
        Phase("correct", "assembly",
              ("sysP", "phiH", "phiH_if", "phiH_b", "p", "p_new", "HbyA",
               "rAU", "relax_p", "U0") + mask_keys,
              ("phi", "phi_if", "phi_b", "p", "U", "cont", "u_delta"),
              correct),
    )

    def steady_seed(state, n_active, relax_u, relax_p):
        # the steady timestep: dt = inf zeroes the transient term exactly
        if lay.lanes is None:
            dt = float("inf")
        else:
            dt = torch.full((lay.lanes,), float("inf"), dtype=solver.dtype,
                            device=state[0].device)
        env = seed_env(tk, state, dt, n_active)
        env.update(U0=env["U"], relax_u=relax_u, relax_p=relax_p)
        return env

    seed_keys = ("U", "p", "phi", "phi_if", "phi_b", "dt", "U0", "relax_u",
                 "relax_p")
    if tk.padded:
        def seed(state, dt, n_active, relax_u, relax_p):
            return steady_seed(state, n_active, relax_u, relax_p)

        seed_keys += ("n_active", "if_mask", "patch_mask")
        extra_keys = ("n_active", "relax_u", "relax_p")
    else:
        def seed(state, dt, relax_u, relax_p):
            return steady_seed(state, None, relax_u, relax_p)

        extra_keys = ("relax_u", "relax_p")

    def finalize(env):
        state = final_state(tk, env)
        krylov_ok, diverged, hit_cap = health_flags(
            state, env["mom_ok"] & env["p_ok_0"],
            env["mom_cap"] | env["p_cap_0"],
            env["cont"], env["p_res"], env["u_delta"], lanes=lay.lanes,
            across=lay.across)
        stats = SimpleStats(
            mom_iters=env["mom_iters"].to(torch.int32),
            p_iters=env["p_iters_0"].unsqueeze(-1).to(torch.int32),
            continuity_err=env["cont"],
            p_residual=env["p_res"],
            u_delta=env["u_delta"],
            converged=krylov_ok, diverged=diverged, hit_cap=hit_cap)
        return state, stats

    def converged(stats):
        # on the device: run_converged reads it once per outer iteration
        return (stats.continuity_err < tol_c) & (stats.u_delta < tol_u)

    def lanes_of(batch: int) -> StepProgram:
        return build_simple_program(solver, lanes=batch, binding=binding)

    return StepProgram(phases=phases, seed=seed, finalize=finalize,
                       seed_keys=seed_keys, extra_keys=extra_keys,
                       converged=converged,
                       lanes_of=cohort_form(solver, lanes, lanes_of),
                       moves=tk.moves)


register_program(ProgramSpec(
    name="simple",
    build=build_simple_program,
    transient=False,
    description=("steady-state SIMPLE: under-relaxed momentum + one "
                 "pressure correction per outer iteration, converged on "
                 "continuity + velocity-change gates (simpleFoam)"),
))
