"""Serving launcher: batched LM generation and multi-tenant CFD serving
(the port of the JAX package's ``launch/serve.py``).

  python -m repro_torch.launch.serve --arch qwen3-0.6b
  python -m repro_torch.launch.serve --device cpu --arch qwen3-0.6b \
      --smoke --n-new 4
  python -m repro_torch.launch.serve --sessions 8 --steps 32 --cfd-n 64 \
      --parts 16
  python -m repro_torch.launch.serve --device cpu --sessions 3 --steps 4 \
      --cfd-n 4 --parts 4
  python -m repro_torch.launch.serve --sessions 16 --steps 8 --cfd-n 64 \
      --parts 16 --arrival-rate 50 --lane-classes --cases cavity,channel \
      --programs piso,simple
  python -m repro_torch.launch.serve --device cpu --sessions 4 --steps 16 \
      --cfd-n 4 --parts 2 --scan-steps 4 --chaos all --chaos-seed 0 \
      --chaos-events 2

``--arch NAME`` (with ``--smoke`` for the registry's small config) makes
random parameters from ``torch.Generator`` seed 0 on ``--device``, draws
``--batch`` prompts of ``--prompt-len`` tokens (and a stub frontend's
embeddings) from ``np.random.default_rng(0)`` as the JAX launcher does,
and greedily generates ``--n-new`` tokens
(:func:`~repro_torch.serving.engine.generate`); it prints the JAX
launcher's ``generated (B, n) in s (tok/s)`` line and the first two
rows.  ``--sessions N`` opens N concurrent PISO tenants (mixed timestep
sizes) on the ``--cfd-n`` cube and advances them through the engine's
cohort-batched ``step_all`` (:class:`~repro_torch.serving.engine.
SimulationEngine`): same-shape sessions stack into cohorts and a window of
a whole cohort is one dispatch.  ``--arrival-rate R > 0`` switches to the
open-loop mode: Poisson arrivals of a heterogeneous size-class mesh mix
(:func:`mesh_mix`), flow cases and programs sampled per tenant, scheduled
by :class:`~repro_torch.serving.scheduler.EngineScheduler` (size-class
cohorts, deadline preemption, per-class p50/p99).  ``--supervise``,
``--chaos``, ``--snapshot-dir`` or ``--resume`` switch to the supervised
mode (:func:`serve_cfd_supervised`): windows of ``--scan-steps`` through a
supervised engine, a seeded fault schedule, engine snapshots, and a
``digest`` line per surviving session that a killed and resumed run must
reproduce.

The flags are the JAX launcher's CFD flags with its defaults, plus
``--device`` (default ``cuda``; ``cpu`` runs the same path on the CPU),
``--p-tol`` and ``--p-maxiter`` (the pressure CG's tolerance and cap, as
in :mod:`repro_torch.launch.case`).
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np

__all__ = ["build_parser", "mesh_mix", "serve_lm", "serve_cfd",
           "serve_cfd_arrivals", "serve_cfd_supervised", "main"]


def serve_lm(args, log=print):
    """Greedy generation on ``--arch`` with seeded random parameters.
    Returns the (batch, n_new) tokens."""
    import torch

    from repro_torch.configs.registry import get_config, get_smoke_config
    from repro_torch.env import resolve_device
    from repro_torch.models import lm
    from repro_torch.serving.engine import generate

    dev = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    rng = np.random.default_rng(0)
    prompts = torch.as_tensor(
        rng.integers(0, cfg.vocab_size, (args.batch, args.prompt_len)),
        dtype=torch.int32, device=dev)
    frontend = None
    if cfg.frontend:
        frontend = torch.as_tensor(
            rng.standard_normal((args.batch, cfg.frontend_len, cfg.d_model))
            * 0.02, dtype=torch.float32, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.time()
    out = generate(cfg, params, prompts, args.n_new, frontend=frontend)
    out = out.cpu().numpy()  # waits for the device
    dt = time.time() - t0
    log(f"generated {out.shape} in {dt:.2f}s "
        f"({args.batch * args.n_new / dt:.1f} tok/s)")
    log(out[:2])
    return out


def mesh_mix(args):
    """The heterogeneous tenant mix: meshes sharing one per-part slab
    structure (nx = ny = cfd_n, nzl = cfd_n // parts) with slab counts
    {parts/2 .. parts} — exactly what size-class padding co-batches."""
    from repro_torch.fvm.mesh import CavityMesh

    nzl = args.cfd_n // args.parts
    parts = sorted({max(2, args.parts // 2), max(2, 3 * args.parts // 4),
                    args.parts})
    return [CavityMesh(nx=args.cfd_n, ny=args.cfd_n, nz=nzl * p,
                       n_parts=p, h=0.1 / args.cfd_n) for p in parts]


def _tenant_axes(args) -> tuple[list[str], list[str]]:
    """Validated (cases, programs) sampling lists from the CLI."""
    from repro_torch.fvm.cases import case_names
    from repro_torch.fvm.piso import SOLVERS

    cases = [c.strip() for c in args.cases.split(",") if c.strip()]
    programs = [p.strip() for p in args.programs.split(",") if p.strip()]
    bad = sorted(set(cases) - set(case_names()))
    if bad:
        raise SystemExit(f"unknown case(s) {bad} (registered: "
                         f"{case_names()})")
    bad = sorted(set(programs) - set(SOLVERS))
    if bad:
        raise SystemExit(f"unknown program(s) {bad} (registered: "
                         f"{tuple(sorted(SOLVERS))})")
    return cases, programs


def _solver_kw(args) -> dict:
    return {"p_tol": args.p_tol, "p_maxiter": args.p_maxiter}


def serve_cfd_arrivals(args, log=print) -> dict:
    """Open-loop serving: Poisson arrivals of a heterogeneous tenant mix
    scheduled by :class:`~repro_torch.serving.scheduler.EngineScheduler`.
    Returns the scheduler's stats (``sched`` holds the scheduler)."""
    from repro_torch.core.controller import ControllerConfig
    from repro_torch.serving.engine import SimulationEngine
    from repro_torch.serving.scheduler import (BULK, DEADLINE,
                                               EngineScheduler, SessionSpec)

    cfg = ControllerConfig(sample_every=max(args.sample_every, 1))
    eng = SimulationEngine(config=cfg, scan_window=max(args.scan_steps, 1),
                           lane_classes=args.lane_classes,
                           track_latency=True, device=args.device)
    sched = EngineScheduler(eng, max_wait_rounds=args.max_wait_rounds)
    rng = np.random.default_rng(args.seed)
    meshes = mesh_mix(args)
    cases, programs = _tenant_axes(args)
    t = 0.0
    for i in range(args.sessions):
        t += float(rng.exponential(1.0 / args.arrival_rate))
        mesh = meshes[int(rng.integers(len(meshes)))]
        deadline = float(rng.random()) < args.deadline_frac
        sched.submit(SessionSpec(
            sid=f"tenant{i}", mesh=mesh, dt=args.co * mesh.h,
            n_steps=args.steps, arrival_t=t,
            priority=DEADLINE if deadline else BULK,
            deadline_ms=args.deadline_ms if deadline else None,
            open_kwargs={"adaptive": args.adaptive,
                         "alpha0": args.alpha or None, "nu": args.nu,
                         "solver_backend": args.solver_backend,
                         "pipeline": args.pipeline,
                         "program": programs[int(rng.integers(len(programs)))],
                         "case": cases[int(rng.integers(len(cases)))],
                         **_solver_kw(args)}))
    t0 = time.time()
    rounds = sched.run()
    wall = time.time() - t0
    stats = sched.stats()
    done = args.sessions * args.steps
    log(f"served {args.sessions} arrivals ({done} session-steps) in "
        f"{rounds} rounds / {wall:.2f}s ({done / wall:.1f} steps/s), "
        f"{stats['dispatches']} dispatches")
    for prio, row in sorted(stats["latency"]["classes"].items()):
        log(f"  {prio}: n={row['n']} p50={row['p50'] * 1e3:.2f}ms "
            f"p99={row['p99'] * 1e3:.2f}ms")
    log(f"engine counters: {stats['engine']['counters']}")
    stats["sched"] = sched
    return stats


def _state_digest(eng) -> dict:
    """Per-session state digests (sha256 over each leaf's raw bytes, in
    ``PisoState`` field order): the kill-and-resume parity gate compares
    these across runs."""
    import hashlib

    out = {}
    for sid in sorted(eng.sessions):
        h = hashlib.sha256()
        for leaf in eng.sessions[sid].state:
            h.update(leaf.cpu().numpy().tobytes())
        out[sid] = h.hexdigest()[:16]
    return out


def serve_cfd_supervised(args, log=print) -> dict:
    """Supervised/chaos/checkpointed CFD serving (the correctness driver).

    Windows of ``--scan-steps`` advance every session toward ``--steps``
    **total** steps each; the :class:`~repro_torch.faults.ChaosMonkey`
    pokes its seeded fault schedule between windows; ``--snapshot-dir``
    checkpoints the engine (at ``--snapshot-every`` boundaries and at the
    end) and ``--resume`` restores from it.  The ``digest`` lines printed
    at the end are byte-exact state hashes: a killed run resumed from its
    snapshot must reproduce the uninterrupted run's digests bit for bit.
    Returns the engine (``engine``), the digests (``digests``) and the
    health counts (``health``).
    """
    from repro_torch.core.controller import ControllerConfig
    from repro_torch.faults import ChaosMonkey, parse_kinds
    from repro_torch.fvm.mesh import CavityMesh
    from repro_torch.serving.engine import SimulationEngine
    from repro_torch.serving.supervisor import SupervisorConfig

    if args.resume:
        if not args.snapshot_dir:
            raise SystemExit("--resume needs --snapshot-dir")
        eng = SimulationEngine.restore(args.snapshot_dir, device=args.device)
        log(f"resumed {len(eng.sessions)} sessions from "
            f"{args.snapshot_dir} at steps "
            f"{sorted({s.steps_done for s in eng.sessions.values()})}")
    else:
        cfg = ControllerConfig(sample_every=max(args.sample_every, 1))
        sup_cfg = SupervisorConfig(
            fallback_backend=args.fallback_backend or None)
        mesh = CavityMesh.cube(args.cfd_n, args.parts)
        eng = SimulationEngine(config=cfg,
                               scan_window=max(args.scan_steps, 1),
                               supervise=True, supervisor_config=sup_cfg,
                               device=args.device)
        base_dt = args.co * mesh.h
        for i in range(args.sessions):
            eng.open_session(f"tenant{i}", mesh, dt=base_dt * (1 + 0.1 * i),
                             alpha0=args.alpha or None, nu=args.nu,
                             adaptive=args.adaptive,
                             solver_backend=args.solver_backend,
                             pipeline=args.pipeline, **_solver_kw(args))
        log(f"opened {args.sessions} supervised sessions, cohorts="
            f"{[len(g) for g in eng.cohorts().values()]}")

    chaos = None
    if args.chaos is not None:
        seed = args.seed if args.chaos_seed is None else args.chaos_seed
        chaos = ChaosMonkey(seed, sorted(eng.sessions),
                            kinds=parse_kinds(args.chaos),
                            n_events=args.chaos_events or None,
                            horizon=max(2, args.steps))
        log(f"chaos schedule: "
            f"{[(e.step, e.sid, e.kind) for e in chaos.events]}")

    window = max(args.scan_steps, 1)
    next_snap = args.snapshot_every or 0
    while True:
        live = [s for s in eng.sessions.values()
                if s.steps_done < args.steps]
        if not live:
            break
        n = min([window] + [args.steps - s.steps_done for s in live])
        eng.step_all(n, sids=[s.sid for s in live])
        if chaos is not None:
            for ev in chaos.poke(eng):
                log(f"chaos: injected {ev.kind} into {ev.sid} "
                    f"(scheduled step {ev.step})")
        if (args.snapshot_dir and next_snap and eng.sessions
                and min(s.steps_done for s in eng.sessions.values())
                >= next_snap):
            eng.snapshot(args.snapshot_dir)
            log(f"snapshot @ step {next_snap} -> {args.snapshot_dir}")
            next_snap += args.snapshot_every
    if args.snapshot_dir:
        eng.snapshot(args.snapshot_dir)
        log(f"snapshot -> {args.snapshot_dir}")

    counts = {"healthy": 0, "degraded": 0, "quarantined": 0,
              "failed": len(eng.failed)}
    for s in eng.sessions.values():
        counts[s.supervisor.state] += 1
    log("supervision: " + " ".join(f"{k}={v}" for k, v in counts.items()))
    for sid, s in sorted(eng.sessions.items()):
        log(f"health {sid} {s.supervisor.state} steps={s.steps_done} "
            f"events={len(s.supervisor.events)}")
    for sid in sorted(eng.failed):
        log(f"health {sid} failed events={len(eng.failed[sid]['events'])}")
    digests = _state_digest(eng)
    for sid, h in digests.items():
        log(f"digest {sid} {h}")
    log(f"counters: {eng.stats()['counters']}")
    return {"engine": eng, "digests": digests, "health": counts}


def serve_cfd(args, log=print) -> dict:
    """Multi-tenant PISO serving: cohort-batched stepping of N sessions.
    Returns the engine's stats after the timed request (``engine`` holds
    the engine, ``wall`` the seconds of the timed request)."""
    from repro_torch.core.controller import ControllerConfig
    from repro_torch.fvm.mesh import CavityMesh
    from repro_torch.serving.engine import SimulationEngine

    mesh = CavityMesh.cube(args.cfd_n, args.parts)
    cfg = ControllerConfig(sample_every=max(args.sample_every, 1))
    steps = args.steps
    if args.adaptive and steps % cfg.sample_every:
        # the warm-up request covers the timed request's window lengths
        # only when both start on the same sampling phase
        steps += cfg.sample_every - steps % cfg.sample_every
        log(f"note: rounding --steps up to {steps} (a multiple of "
            f"--sample-every {cfg.sample_every})")
    eng = SimulationEngine(config=cfg, scan_window=max(args.scan_steps, 1),
                           device=args.device)
    base_dt = args.co * mesh.h
    for i in range(args.sessions):
        # mixed timestep sizes: dt is a per-session tensor of the cohort
        eng.open_session(f"tenant{i}", mesh, dt=base_dt * (1 + 0.1 * i),
                         alpha0=args.alpha or None, nu=args.nu,
                         adaptive=args.adaptive,
                         solver_backend=args.solver_backend,
                         pipeline=args.pipeline, **_solver_kw(args))
    log(f"opened {args.sessions} sessions, cohorts="
        f"{[len(g) for g in eng.cohorts().values()]}")
    # a warm-up request first (the first capture of each Krylov loop and
    # the plans' device indices), outside the timed request
    eng.step_all(steps)
    eng._sync()
    t0 = time.time()
    eng.step_all(steps)
    eng._sync()
    wall = time.time() - t0
    stats = eng.stats()
    done = args.sessions * steps
    log(f"advanced {done} session-steps in {wall:.2f}s "
        f"({done / wall:.1f} steps/s)")
    log(f"counters: {stats['counters']}")
    log(json.dumps(stats["sessions"], indent=2))
    stats.update(engine=eng, wall=wall)
    return stats


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None,
                    help="LM serving: architecture from the registry")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--n-new", type=int, default=16)
    ap.add_argument("--sessions", type=int, default=0,
                    help="open N concurrent sessions and advance them via "
                         "cohort-batched step_all")
    ap.add_argument("--steps", type=int, default=16,
                    help="timesteps to advance every session")
    ap.add_argument("--cfd-n", type=int, default=8,
                    help="cavity cells per axis")
    ap.add_argument("--parts", type=int, default=4)
    ap.add_argument("--alpha", type=int, default=2,
                    help="repartitioning ratio (0 = cost-model pick)")
    ap.add_argument("--nu", type=float, default=0.01)
    ap.add_argument("--co", type=float, default=0.5, help="CFL number")
    ap.add_argument("--adaptive", action="store_true",
                    help="per-session adaptive controllers (sampled "
                         "instrumented steps feed each tenant's controller)")
    ap.add_argument("--sample-every", type=int, default=4)
    ap.add_argument("--scan-steps", type=int, default=8,
                    help="window cap (steps per cohort dispatch)")
    ap.add_argument("--solver-backend", default="auto",
                    choices=["auto", "fused", "reference"])
    ap.add_argument("--pipeline", default="auto",
                    choices=["auto", "on", "off"],
                    help="software-pipelined windows per tenant (auto: "
                         "whenever the tenant's program declares a "
                         "pipelined form; off: serial)")
    ap.add_argument("--p-tol", type=float, default=1e-8,
                    help="pressure CG relative tolerance")
    ap.add_argument("--p-maxiter", type=int, default=2000,
                    help="pressure CG iteration cap")
    ap.add_argument("--device", default="cuda", help="cuda or cpu")
    # -- open-loop arrivals (continuous-batching scheduler) ----------------
    ap.add_argument("--arrival-rate", type=float, default=0.0,
                    help="Poisson arrival rate (sessions/s of virtual "
                         "time); > 0 switches to the EngineScheduler "
                         "mode with a heterogeneous size-class mix")
    ap.add_argument("--deadline-ms", type=float, default=50.0,
                    help="per-step latency target of deadline tenants")
    ap.add_argument("--deadline-frac", type=float, default=0.25,
                    help="fraction of arrivals in the deadline class")
    ap.add_argument("--max-wait-rounds", type=int, default=4,
                    help="bulk anti-starvation bound (scheduler rounds)")
    ap.add_argument("--lane-classes", action="store_true",
                    help="pad cohort batch axes to powers of two")
    ap.add_argument("--cases", default="cavity",
                    help="comma-separated flow cases sampled per arrival")
    ap.add_argument("--programs", default="piso",
                    help="comma-separated timestep programs (piso,simple) "
                         "sampled per arrival")
    ap.add_argument("--seed", type=int, default=0)
    # -- supervised serving ------------------------------------------------
    ap.add_argument("--supervise", action="store_true",
                    help="attach a SessionSupervisor to every session "
                         "(divergence detection, backoff, quarantine)")
    ap.add_argument("--chaos", default=None, metavar="KINDS",
                    help="deterministic fault injection: 'all' or a "
                         "comma list of nan,blowup,cap,slow "
                         "(implies --supervise)")
    ap.add_argument("--chaos-seed", type=int, default=None,
                    help="fault-schedule seed (defaults to --seed)")
    ap.add_argument("--chaos-events", type=int, default=0,
                    help="number of scheduled faults (0 = one per two "
                         "sessions)")
    ap.add_argument("--fallback-backend", default="",
                    help="solver backend quarantined sessions fall back "
                         "to (e.g. 'reference'; empty = keep backend)")
    ap.add_argument("--snapshot-dir", default="",
                    help="engine checkpoint directory (written at "
                         "--snapshot-every boundaries and at exit)")
    ap.add_argument("--snapshot-every", type=int, default=0,
                    help="snapshot once all sessions pass each multiple "
                         "of this step count (0 = only at exit)")
    ap.add_argument("--resume", action="store_true",
                    help="restore the engine from --snapshot-dir and "
                         "continue to --steps total steps per session")
    return ap


def main(argv=None):
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.sessions > 0 or args.resume:
        if (args.supervise or args.resume or args.chaos is not None
                or args.snapshot_dir):
            return serve_cfd_supervised(args)
        if args.arrival_rate > 0:
            return serve_cfd_arrivals(args)
        return serve_cfd(args)
    if args.arch is None:
        ap.error("--arch is required (or use --sessions N for CFD mode)")
    return serve_lm(args)


if __name__ == "__main__":
    main()
