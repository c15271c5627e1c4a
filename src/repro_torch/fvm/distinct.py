"""The stacked solve over a ``(solve, assemble)`` mesh of distinct devices.

The paper's deployment: fine parts assembled where they live, the
repartitioning update carrying each coarse part's coefficient values to
its owner, the owner solving, the solution carried back.  On a mesh whose
positions name more than one device (:meth:`~repro_torch.core.comm.
ShardMesh.groups`), a :class:`~repro_torch.fvm.piso.SegregatedSolver`
with ``solve_mode="stacked"`` steps through :class:`DistinctSteps`: one
*rank* a distinct device (:class:`~repro_torch.core.ranks.Ranks`, rank 0
the device of the first position, the solver's), each rank running the
program's own executors over its device's fine parts, positions that
share a device one tensor.  What a rank runs:

* **the fine phases** (``assemble_mom``, ``assemble_p``, ``correct``, the
  pipelined form's factored phases): the program's own phase functions on
  the rank's parts, through a block view of the assembly
  (:meth:`~repro_torch.fvm.assembly.CavityAssembly.block_view`) whose
  neighbour planes are the one place where fine planes cross devices
  (move kind ``halo``); a maximum over the parts (the continuity error,
  SIMPLE's ``u_delta``) and the health flags' ``finite`` are combined over
  the ranks (:class:`RankLayout`);
* **the value updates**: the momentum system (alpha 1) is its own owner's,
  each rank gathers its parts' buffers; each coarse part's ``alpha``
  pressure buffers go to the device of its owner
  (:func:`~repro_torch.core.update.owner_positions`), in one copy from each
  device (``device_direct``) or staged through the host (``host_buffer``:
  every buffer to the host, then on to the owner's device), and the
  ``coef_update`` kernel runs there;
* **the solves**: ``b_c``, ``x0_c`` and ``diag_c`` go to the owners, the
  pressure CG runs on the owners' device, the solution comes back to the
  fine parts' devices.  Where every coarse part's owner is on one device,
  that device runs the stacked solve as it runs without a mesh (on the
  card the same kernels, launch for launch) while the other ranks wait
  for the solution.  A solve whose parts span devices (the momentum
  always: each fine part is its own owner; the pressure when owners are
  on several devices) runs :func:`rank_ops`: each rank's rows on its
  device, the SpMV of each device over its rows with the neighbour planes
  copied in (move kind ``solve_halo``), the dots summed over the ranks in
  rank order on the host, the solvers' host loops.

Every copy between devices goes through :meth:`~repro_torch.core.ranks.
Ranks.carry` and lands in the solver's ``moves.carried`` by kind, which the
closed forms of ``moves.kinds`` count.  A CPU rank runs the kernels'
plain versions because the caller put its positions on the CPU; a card's
rank launches the kernels.  Against the run on one device the fine
phases, the updates and a solve on one device are bit for bit; a solve
whose dots are summed over devices rounds its dots in another order (the
ranks' partial sums added in rank order), as the JAX package's mesh of
distinct devices does.

Every precision policy runs over the ranks, as JAX's stacked mode runs it:
under ``f32_ir`` and ``bf16_ir`` each rank downcasts its own bands on its
own device (the value updates and the solve operands still travel in
f64), a solve on one device is the stacked refined solve, and a solve over
the ranks runs the refinement loop over :func:`rank_ops`'s refined bundle,
its inner sweep the host loop and its f64 dots summed over the ranks; the
neighbour planes of a product travel at the itemsize of the vector it
multiplies.  A padded (size-class) mesh passes its real part count to
every rank, and each rank's activity masks follow its parts' global
indices (:meth:`~repro_torch.fvm.assembly.CavityAssembly.block_view`), so
a rank may hold padding parts only.
"""
from __future__ import annotations

import dataclasses
import time

import torch

from repro_torch.core.comm import (assembly_layout, assembly_sharding,
                                   canonical_device, solve_constraint)
from repro_torch.core.layout import Sharded
from repro_torch.core.ldu import buffer_from_parts
from repro_torch.core.ranks import HOST, MeshRanks
from repro_torch.core.update import concat_group_buffers, solve_halo_moves
from repro_torch.fvm.step_program import (LaneLayout, ProgramExecutors,
                                         get_program)
from repro_torch.kernels.coef_update.coef_update import coef_update
from repro_torch.kernels.krylov_fused.krylov_fused import lane_vdot
from repro_torch.sparse.distributed import spmv_dia

__all__ = ["DistinctSteps", "RankLayout", "rank_ops"]


def _runs(ids) -> list[tuple[int, int]]:
    """``[i0, i1)`` index ranges of the maximal runs of consecutive values
    in the sorted ``ids``."""
    out = []
    for i, v in enumerate(ids):
        if out and ids[out[-1][1] - 1] == v - 1:
            out[-1] = (out[-1][0], i + 1)
        else:
            out.append((i, i + 1))
    return out


@dataclasses.dataclass(frozen=True)
class RankLayout(LaneLayout):
    """One rank's share of one system: a maximum and a health flag are
    combined over the ranks."""

    group: object = None
    rank: int = 0

    def max(self, x: torch.Tensor) -> torch.Tensor:
        return self.group.ranks.max(self.rank, torch.max(x))

    def across(self, flag: torch.Tensor) -> torch.Tensor:
        return self.group.ranks.all(self.rank, flag)


def _refuse(*_args, **_kwargs):
    raise RuntimeError("a bundle over ranks runs the host loops")


def rank_ops(view, group: MeshRanks, rank: int, plan, bands, diag, ids,
             rank_of, index, owners, moves=None):
    """The :class:`~repro_torch.solvers.ops.SolverOps` bundle of rank
    ``rank``'s rows of a system whose parts (fine or coarse, ``len(rank_of)``
    of them) sit on several devices: ``ids`` the parts this rank holds
    (sorted; ``bands`` ``(len(ids), nb, m)`` and ``diag`` ``(len(ids),
    m)`` theirs, f64), ``rank_of``/``index`` where each part is held,
    ``owners`` each part's position (the closed form of the product's
    planes, added to ``moves`` under ``solve_halo`` once a product, at the
    itemsize of the vector it multiplies).

    Each product first takes the neighbour planes (:meth:`~repro_torch.
    core.ranks.MeshRanks.planes`), in the dtype of the vector.  On the fused backend (a card) it
    runs over the rank's rows stacked with a zero-band ghost part beside
    each run that has a neighbour, the ghost's facing plane the
    neighbour's: one launch of the stacked SpMV kernel.  On the reference
    backend (a CPU rank) the plain SpMV takes the planes directly
    (``halo=``).  Either way each row's product is its product in the
    whole, bit for bit.  The Jacobi apply and the axpy step run on the
    rank's rows (the axpy kernel on a card); each dot is the rank's
    partial summed over the ranks.  ``host_loop``: the solvers run their
    host loops, every rank the same iterations.

    Under a refined policy the bundle is the one
    :meth:`~repro_torch.fvm.piso.SegregatedSolver._solver_ops` builds on
    one device, over the rank's rows: ``matvec`` over the bands downcast
    on the rank's device to the storage dtype, ``matvec_hi`` over the f64
    bands, the dots at the accum dtype and ``dots_hi`` (the outer loop's
    f64 dots), each summed over the ranks.
    """
    from repro_torch.solvers.ops import reference_ops, resolve_backend
    from repro_torch.solvers.precision import get_policy

    policy = get_policy(view.precision)
    plane, m = plan.plane, bands.shape[-1]
    planes = group.planes(rank, ids, rank_of, index, plane, "solve_halo")
    per_product = {}

    def halo(x):
        got = planes(x.reshape(-1, m))
        if moves is not None:
            size = x.element_size()
            if size not in per_product:
                per_product[size] = solve_halo_moves(group.mesh, owners,
                                                     plane * size)
            moves.add("solve_halo", per_product[size])
        return got

    def total(*vals):
        return group.ranks.sum(rank, vals)

    def dots_hi(*pairs):
        return total(*(lane_vdot(a, b) for a, b in pairs))

    acc = policy.accum_dtype
    if not ids:   # a rank holding none of the parts takes part in each sum
        local = reference_ops(lambda x: x, policy=policy)

        def matvec(x):
            halo(x)
            return x

        def matvec_dot(p):
            halo(p)
            return p, total(p.new_zeros((), dtype=acc))[0]

        def fused_step(x, r, p, Ap, alpha):
            return (x.clone(), r.clone(), r.clone(),
                    *total(r.new_zeros((), dtype=acc),
                           r.new_zeros((), dtype=acc)))

        def dots(*pairs):
            return total(*(a.new_zeros((), dtype=acc) for a, _ in pairs))

        matvec_hi = matvec
    else:
        local = view._solver_ops(plan, bands, diag)

        def fused_step(x, r, p, Ap, alpha):
            xn, rn, z, rz, rr = local.fused_step(x, r, p, Ap, alpha)
            return (xn, rn, z, *total(rz, rr))

        def dots(*pairs):
            return total(*local.dots(*pairs))

    if ids and resolve_backend(view.solver_backend,
                               bands.device) != "fused":
        offsets = tuple(int(o) for o in plan.dia_offsets)
        bands_lo = bands.to(policy.storage_dtype)

        def over(b):
            def A(x):
                return spmv_dia(b, x, offsets=offsets, plane=plane,
                                halo=halo(x))
            return A

        matvec, matvec_hi = over(bands_lo), over(bands)

        def matvec_dot(p):
            Ap = matvec(p)
            return Ap, total(*local.dots((p, Ap)))[0]
    elif ids:
        # the ghost layout: (row, the rank's row whose plane it lends,
        # below or above the run)
        real, ghosts, n_ext = [], [], 0
        for i0, i1 in _runs(ids):
            if ids[i0] > 0:
                ghosts.append((n_ext, i0, True))
                n_ext += 1
            real.extend(range(n_ext, n_ext + i1 - i0))
            n_ext += i1 - i0
            if ids[i1 - 1] < len(rank_of) - 1:
                ghosts.append((n_ext, i1 - 1, False))
                n_ext += 1
        idx = torch.as_tensor(real, device=bands.device)
        bands_ext = bands.new_zeros((n_ext,) + tuple(bands.shape[1:]))
        bands_ext.index_copy_(0, idx, bands)
        diag_ext = diag.new_ones((n_ext, m))
        diag_ext.index_copy_(0, idx, diag.reshape(-1, m))
        inner = view._solver_ops(plan, bands_ext, diag_ext)
        x_ext = {}    # one buffer a dtype: the inner sweep's and the f64's

        def fill(x):
            down, up = halo(x)
            buf = x_ext.get(x.dtype)
            if buf is None:
                buf = x_ext[x.dtype] = x.new_zeros((n_ext, m))
            buf.index_copy_(0, idx, x.reshape(-1, m))
            for row, i, below in ghosts:
                if below:
                    buf[row, m - plane:] = down[i]
                else:
                    buf[row, :plane] = up[i]
            return buf

        def over(A):
            def product(x):
                return A(fill(x)).index_select(0, idx).view(x.shape)
            return product

        matvec = over(inner.matvec)
        matvec_hi = over(inner.matvec_hi or inner.matvec)

        def matvec_dot(p):
            y, d = inner.matvec_dot(fill(p))
            return y.index_select(0, idx).view(p.shape), total(d)[0]

    return dataclasses.replace(
        local, matvec=matvec, matvec_dot=matvec_dot, fused_step=fused_step,
        dots=dots, matvec_into=_refuse, matvec_dot_direction_into=_refuse,
        alpha_into=_refuse, fused_step_into=_refuse, advance=_refuse,
        loops={}, host_loop=True,
        matvec_hi=matvec_hi if policy.refine else None, dots_hi=dots_hi)


class _RankView:
    """A rank's solver: its own ``device``, block assembly ``asm``, move
    record ``moves`` (rank 0's is the solver's, the others None) and
    ``rank`` phases; everything else read from the solver at each use."""

    def __init__(self, solver, **own):
        self.__dict__.update(own, _solver=solver)

    def __getattr__(self, name):
        return getattr(self.__dict__["_solver"], name)


class _RankMoves:
    """A rank's view of the step's move record: rank 0's adds land in the
    solver's record; every rank's reset (the step's seed) meets the others
    there, so no rank carries anything into a step before the record is
    cleared."""

    def __init__(self, record, group: MeshRanks, rank: int):
        self.record, self.group, self.rank = record, group, rank

    @property
    def kinds(self):
        return self.record.kinds

    def reset(self) -> None:
        if self.rank == 0:
            self.record.reset()
        self.group.ranks.exchange(self.rank, None)

    def add(self, kind, stats) -> None:
        if self.rank == 0:
            self.record.add(kind, stats)


class RankPhases:
    """One rank's update and solve phases (the toolkit's ``update_mom``,
    ``solve_mom``, ``update_p``, ``solve_p``) and its layout; see the
    module doc."""

    def __init__(self, group: MeshRanks, rank: int, view: _RankView):
        self.group, self.rank, self.view = group, rank, view

    def toolkit(self, tk, plan_m, plan_p, n_c):
        """``tk`` with this rank's layout and phases (called by the phase
        toolkit's build for a rank view)."""
        from repro_torch.solvers.bicgstab import bicgstab
        from repro_torch.solvers.cg import cg

        g, r, view = self.group, self.rank, self.view
        ranks, dev = g.ranks, g.devices[r]
        solver = view._solver
        alpha = plan_p.alpha
        co = g.coarse(n_c)
        mine, owned = g.parts[r], co["parts"][r]
        lead = r == 0       # rank 0 adds the step's closed forms

        def buffers(sys):
            return buffer_from_parts(sys.diag, sys.upper, sys.lower,
                                     sys.iface)

        def update_mom(sysM):
            buf = buffers(sysM)
            if lead:
                solver._count_update("update_mom", plan_m, buf.element_size())
            grouped = buf.reshape(buf.shape[0], 1, plan_m.buffer_len)
            if view.update_schedule == "host_buffer":
                staged = ranks.carry(grouped, dev, HOST, "update_mom",
                                     copy=True)
                grouped = ranks.carry(staged, HOST, dev, "update_mom")
            return coef_update(plan_m, concat_group_buffers(grouped), "dia")

        def solve_mom(bandsM, sysM, U):
            ops = rank_ops(view, g, r, plan_m, bandsM, sysM.diag, mine,
                           g.rank_of_part, g.index, g.part_pos,
                           view.moves)
            res = [bicgstab(ops, sysM.source[..., c].contiguous(),
                            U[..., c].contiguous(), tol=view.mom_tol,
                            maxiter=view.mom_maxiter) for c in range(3)]
            U_new = torch.stack([x.x for x in res], dim=2)
            return (U_new, torch.stack([x.iters for x in res]).amax(0),
                    torch.stack([x.converged for x in res]).all(0),
                    torch.stack([x.hit_cap for x in res]).any(0))

        rows = [c * alpha + j for c in owned for j in range(alpha)]

        def to_owners(t, kind, at=None):
            """The fine rows of the coarse parts this rank owns, from every
            rank's block ``t``, as ``(n_owned, alpha * ...)``."""
            got = g.gather(r, t, dev if at is None else at, rows, kind)
            if got is None:
                return None
            got = got.reshape((len(owned), -1) + tuple(got.shape[2:]))
            return solve_constraint(g.mesh, got, parts=owned, n_coarse=n_c,
                                    device=dev)

        def update_p(sysP):
            buf = buffers(sysP)
            if lead:
                solver._count_update("update_p", plan_p, buf.element_size())
            at = dev
            if view.update_schedule == "host_buffer":
                buf, at = ranks.carry(buf, dev, HOST, "update_p",
                                      copy=True), HOST
            got = to_owners(buf, "update_p", at)
            if got is None:
                return None
            grouped = got.reshape(len(owned), alpha, plan_p.buffer_len)
            return coef_update(plan_p, concat_group_buffers(grouped), "dia")

        def solve_p(bandsP, sysP, p):
            b_c, x0_c, diag_c = (to_owners(t, kind) for t, kind in (
                (sysP.source, "b_c"), (p, "x0_c"), (sysP.diag, "diag_c")))
            if lead:
                part = p.shape[1] * p.element_size()
                for kind in ("b_c", "x0_c", "diag_c"):
                    solver._count_owner_bytes(kind, alpha, part)
            local = co["local"]
            if local is None:
                m_c = plan_p.m_coarse
                if b_c is None:
                    b_c = x0_c = p.new_zeros((0, m_c))
                    diag_c, bandsP = p.new_ones((0, m_c)), p.new_zeros(
                        (0, len(plan_p.dia_offsets), m_c))
                opsP = rank_ops(view, g, r, plan_p, bandsP, diag_c, owned,
                                co["rank_of"], co["index"], co["owner_pos"],
                                view.moves)
                sol = cg(opsP, b_c, x0_c, tol=view.p_tol,
                         maxiter=view.p_maxiter)
                x, stats = sol.x, (sol.iters, sol.residual, sol.converged,
                                   sol.hit_cap)
            else:
                x = stats = None
                if r == local:
                    opsP = view._solver_ops(plan_p, bandsP, diag_c)
                    sol = cg(opsP, b_c, x0_c, tol=view.p_tol,
                             maxiter=view.p_maxiter)
                    x, stats = sol.x, (sol.iters, sol.residual,
                                       sol.converged, sol.hit_cap)
                stats = ranks.broadcast(r, local, stats)
            if lead:
                solver._count_owner_bytes("x_back", alpha,
                                          p.shape[1] * p.element_size())
            back = g.scatter(r, None if x is None else x.reshape(
                -1, p.shape[1]), co, alpha, "x_back")
            return (back.reshape(p.shape), *stats)

        layout = RankLayout(None, len(mine), g, r)
        return dataclasses.replace(tk, layout=layout,
                                   moves=_RankMoves(solver.moves, g, r),
                                   update_mom=update_mom,
                                   solve_mom=solve_mom, update_p=update_p,
                                   solve_p=solve_p)


class DistinctSteps:
    """A solver's steps over a mesh of distinct devices (module doc): the
    ranks' executors per binding, the state in and out.  While ``timing``
    is set (and in a timed step) each rank records each phase's seconds,
    a card's rank synchronised at each phase boundary and before it hands
    a value to a collective, with the seconds it waited at collectives in
    the phase: ``last_ranks``, one ``{"device", "parts", "phases":
    [(label, tag, seconds, waited)]}`` a rank."""

    def __init__(self, solver):
        self.solver = solver
        self.group = MeshRanks(solver.spmd_mesh, solver.mesh.n_parts,
                               ledger=solver.moves)
        self._execs: dict[tuple, list] = {}
        self._logs = [[] for _ in range(self.group.ranks.n)]
        self.timing = False
        self.last_ranks: list[dict] | None = None

    # -- the ranks' programs -------------------------------------------------
    def executors(self) -> list[ProgramExecutors]:
        s = self.solver
        key = (s.program_name, s.alpha, s.solver_backend, s.precision,
               s.pipelined)
        execs = self._execs.get(key)
        if execs is None:
            execs = self._execs[key] = [self._rank(r)
                                        for r in range(self.group.ranks.n)]
        return execs

    def _rank(self, rank: int) -> ProgramExecutors:
        s, g = self.solver, self.group
        dev = g.devices[rank]
        for plan in (s.plan_mom, s.plan_p):
            plan.src_on(dev)      # each device's index, before the threads
        asm = s.asm.block_view(g.parts[rank], dev,
                               g.asm_halo(rank, s.mesh.plane))
        if rank == 0:
            asm.on_halo = s._count_halo
        view = _RankView(s, device=dev, asm=asm,
                         moves=s.moves if rank == 0 else None)
        view.rank = RankPhases(g, rank, view)
        program = get_program(s.program_name).build(view)
        return ProgramExecutors(self._timed(program, rank))

    def _timed(self, program, rank: int):
        """``program`` with each phase recording its seconds into rank
        ``rank``'s log while ``timing`` is set."""
        ranks, log = self.group.ranks, self._logs[rank]
        dev = ranks.devices[rank]

        def now():
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            return time.perf_counter(), ranks.waited[rank]

        def wrap(ph):
            fn = ph.fn

            def timed(*args):
                if not self.timing:
                    return fn(*args)
                t0, w0 = now()
                out = fn(*args)
                t1, w1 = now()
                log.append((ph.label, ph.tag, t1 - t0, w1 - w0))
                return out

            return dataclasses.replace(ph, fn=timed)

        pipe = program.pipeline
        if pipe is not None:
            pipe = dataclasses.replace(pipe,
                                       phases=tuple(map(wrap, pipe.phases)))
        return dataclasses.replace(
            program, phases=tuple(map(wrap, program.phases)), pipeline=pipe)

    # -- the state in and out ------------------------------------------------
    def enter(self, state):
        """Each rank's block of ``state`` and the function handing the
        ranks' blocks back in the layout ``state`` came in: the assembly
        layout over the solver's mesh, shards on their positions' devices,
        or a stacked state on the solver's device."""
        s, g = self.solver, self.group
        mesh, leaves = s.spmd_mesh, tuple(state)
        sharded = [isinstance(t, Sharded) for t in leaves]
        if not any(sharded):
            laid = [assembly_layout(t, mesh) for t in leaves]
        elif all(sharded):
            laid = list(leaves)
            for t in laid:
                if t.mesh != mesh:
                    raise ValueError(f"the state is laid out over {t.mesh!r}"
                                     f", the solver's mesh is {mesh!r}")
                want = assembly_sharding(mesh, t.ndim - 1)
                if t.sharding != want:
                    raise ValueError(f"expected the assembly layout "
                                     f"{want.spec}, got {t.sharding.spec}")
                for k, sh in enumerate(t.shards):
                    if not _holds(sh, mesh.flat()[k]):
                        raise ValueError(f"position {k}'s shard is on "
                                         f"{sh.device}, the position on "
                                         f"{mesh.flat()[k]}")
        else:
            raise ValueError("a state is in the assembly layout in every "
                             "leaf or in none")
        blocks = [type(state)(*(
            torch.cat([t.shards[k] for k in g.positions[r]])
            for t in laid)) for r in range(g.ranks.n)]

        def back(states):
            out = []
            for j, t in enumerate(laid):
                shards = []
                for k in range(mesh.size):
                    r = g.rank_of_pos[k]
                    i = g.positions[r].index(k)
                    n = t.shards[k].shape[0]
                    shards.append(states[r][j][i * n:(i + 1) * n])
                out.append(Sharded(t.sharding, t.shape, tuple(shards)))
            if any(sharded):
                return type(state)(*out)
            return type(state)(*(
                torch.cat([sh.to(s.device) for sh in o.shards]) for o in out))

        return blocks, back

    # -- the entry points ----------------------------------------------------
    def call(self, how: str, state, dt, *args):
        """Run ``how`` ("step", "run_steps", "steady" or "timed": the serial
        step, timed) on every rank; returns what the solver's method
        returns."""
        s = self.solver
        execs = self.executors()
        blocks, back = self.enter(state)
        extras = s._extras()
        ranks = self.group.ranks
        timed, kept = how == "timed" or self.timing, self.timing
        for log in self._logs:
            log.clear()
        ranks.sync = self.timing = timed
        try:
            outs = ranks.run(lambda r: self._work(how, execs[r], blocks[r],
                                                  dt, args, extras))
        finally:
            ranks.sync, self.timing = False, kept
        state = back([o[0] for o in outs])
        if timed:
            self.last_ranks = [
                {"device": str(d), "parts": len(p), "phases": list(log)}
                for d, p, log in zip(self.group.devices, self.group.parts,
                                     self._logs)]
        if how == "timed":
            s._instrumented.last_moves = dict(s.moves.kinds)
            return state, outs[0][1], _breakdown(
                self.last_ranks[0]["phases"])
        return (state,) + tuple(outs[0][1:])

    def _work(self, how, ex, block, dt, args, extras):
        stepper = ex.pipelined if self.solver.pipelined else ex.serial
        if how == "step":
            return stepper.step(block, dt, *extras)
        if how == "run_steps":
            return stepper.run_steps(block, dt, args[0], *extras)
        if how == "steady":
            return ex.serial.run_converged(block, dt, args[0], *extras)
        return ex.serial.step(block, dt, *extras)


def _holds(t: torch.Tensor, dev) -> bool:
    """``t`` sits on the mesh device ``dev`` (a CPU tensor on any CPU
    place)."""
    dev = canonical_device(dev)
    return t.device.type == dev.type and (dev.type != "cuda"
                                          or t.device == dev)


def _breakdown(phases):
    from repro_torch.core.cost_model import PhaseBreakdown

    times = dict.fromkeys(PhaseBreakdown.TIME_FIELDS, 0.0)
    for _label, tag, secs, _waited in phases:
        times[tag] += secs
    return PhaseBreakdown(**times)
