"""Flow-case registry: named BC sets over the slab-decomposed box mesh.

A :class:`FlowCase` is a small declarative record — one :class:`PatchBC`
per geometric boundary role plus a Reynolds-number parameterization — that
:class:`~repro_torch.fvm.assembly.CavityAssembly` binds into assembly
masks and boundary sources.  The case is a *registry key* the stack
threads through: solver binding, launcher flags.  This is a numpy copy
of the JAX package's registry; the port's assembly binds the wall-only
cases (``cavity``) so far and refuses inlet/outlet cases.

Roles name the six box faces by outward normal: ``x0``/``x1``/``y0``/
``y1`` (±x, ±y) and ``z0``/``z1`` (±z).  The z-slab decomposition pins a
structural constraint: only the ``z0``/``z1`` faces are whole
``nx*ny`` planes owned by a single part (part 0 / the last part), so
**inlet and outlet patches must be z-faces** — their boundary fluxes
then ride the ``(P, 2, B)`` plane layout of the interface fluxes.

Registered cases:

* ``cavity``  — the paper's lidDrivenCavity3D: six walls, the ``z1`` lid
  sliding in +x.  All-Neumann pressure (needs the reference cell).
* ``channel`` — duct flow: uniform inlet at ``z0`` blowing in +z, outlet
  at ``z1`` (fixed p = 0), four no-slip side walls.
* ``backstep`` — a backward-facing-step surrogate on the structured box:
  the inlet spans only the upper half of the ``z0`` face (the blocked
  lower half is wall), so the jet expands over a step into the full duct
  and recirculates behind it; outlet at ``z1``.
"""
from __future__ import annotations

import dataclasses
from types import MappingProxyType

__all__ = ["WALL", "MOVING_WALL", "INLET", "OUTLET", "ROLES", "PatchBC",
           "FlowCase", "CASES", "get_case", "case_names"]

WALL = "wall"                # no-slip Dirichlet U = 0
MOVING_WALL = "moving_wall"  # Dirichlet U = bc.U (tangential — the lid)
INLET = "inlet"              # Dirichlet U = bc.U with fixed boundary flux
OUTLET = "outlet"            # zero-gradient U, Dirichlet p = 0

KINDS = (WALL, MOVING_WALL, INLET, OUTLET)
ROLES = ("x0", "x1", "y0", "y1", "z0", "z1")
PROFILES = ("uniform", "upper_half")


@dataclasses.dataclass(frozen=True)
class PatchBC:
    """One boundary patch's condition.

    ``U`` is the Dirichlet velocity (ignored for ``outlet``); ``profile``
    shapes an inlet over its face: ``uniform`` everywhere, ``upper_half``
    only on the y >= ny/2 half (the backstep's expansion geometry) with
    the other half reverting to wall.
    """

    kind: str = WALL
    U: tuple[float, float, float] = (0.0, 0.0, 0.0)
    profile: str = "uniform"

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown BC kind {self.kind!r} "
                             f"(must be one of {KINDS})")
        if self.profile not in PROFILES:
            raise ValueError(f"unknown inlet profile {self.profile!r} "
                             f"(must be one of {PROFILES})")
        if self.profile != "uniform" and self.kind != INLET:
            raise ValueError("profiles only apply to inlet patches")


@dataclasses.dataclass(frozen=True)
class FlowCase:
    """A named BC set + Reynolds parameterization (registry entry).

    ``bcs`` maps geometric roles to :class:`PatchBC`; omitted roles are
    no-slip walls.  ``reynolds`` parameterizes the viscosity through
    :meth:`nu` (``nu = u_ref * L / Re`` with ``L`` the domain edge
    length) — registered entries are templates, and :func:`get_case`
    re-parameterizes them per tenant.
    """

    name: str
    description: str
    bcs: MappingProxyType | dict = dataclasses.field(default_factory=dict)
    u_ref: float = 1.0
    reynolds: float = 100.0

    def __post_init__(self):
        bad = sorted(set(self.bcs) - set(ROLES))
        if bad:
            raise ValueError(f"case {self.name!r}: unknown roles {bad} "
                             f"(must be among {ROLES})")
        n_io = 0
        for role, bc in self.bcs.items():
            if bc.kind in (INLET, OUTLET):
                n_io += 1
                if role not in ("z0", "z1"):
                    raise ValueError(
                        f"case {self.name!r}: {bc.kind} on {role!r} — "
                        "inlet/outlet patches must be z-faces (whole "
                        "slab planes) under the z-slab decomposition")
        kinds = {r: bc.kind for r, bc in self.bcs.items()}
        if (INLET in kinds.values()) != (OUTLET in kinds.values()):
            raise ValueError(
                f"case {self.name!r}: an inlet needs an outlet (and vice "
                "versa) — fixed inflow with no pressure outlet has no "
                "mass-consistent solution")
        if self.reynolds <= 0 or self.u_ref <= 0:
            raise ValueError(
                f"case {self.name!r}: u_ref and reynolds must be > 0")
        # freeze the mapping so the (hashable-by-id) case is not mutated
        object.__setattr__(self, "bcs", MappingProxyType(dict(self.bcs)))

    def bc(self, role: str) -> PatchBC:
        """The patch BC for a geometric role (default: no-slip wall)."""
        if role not in ROLES:
            raise ValueError(f"unknown role {role!r}")
        return self.bcs.get(role, PatchBC(WALL))

    @property
    def needs_ref(self) -> bool:
        """All-Neumann pressure (no outlet) needs the reference cell."""
        return not any(bc.kind == OUTLET for bc in self.bcs.values())

    def nu(self, length: float) -> float:
        """Viscosity realizing ``reynolds`` on a domain of edge ``length``."""
        return self.u_ref * length / self.reynolds


CASES: dict[str, FlowCase] = {}


def register_case(case: FlowCase) -> FlowCase:
    if case.name in CASES:
        raise ValueError(f"case {case.name!r} already registered")
    CASES[case.name] = case
    return case


register_case(FlowCase(
    name="cavity",
    description="lidDrivenCavity3D (paper §4): six walls, +x sliding lid",
    bcs={"z1": PatchBC(MOVING_WALL, U=(1.0, 0.0, 0.0))},
    reynolds=100.0,
))

register_case(FlowCase(
    name="channel",
    description="duct flow: uniform +z inlet at z0, p=0 outlet at z1",
    bcs={"z0": PatchBC(INLET, U=(0.0, 0.0, 1.0)),
         "z1": PatchBC(OUTLET)},
    reynolds=100.0,
))

register_case(FlowCase(
    name="backstep",
    description=("backward-facing step surrogate: upper-half inlet at z0 "
                 "expanding over the blocked half into the full duct, "
                 "p=0 outlet at z1"),
    bcs={"z0": PatchBC(INLET, U=(0.0, 0.0, 1.0), profile="upper_half"),
         "z1": PatchBC(OUTLET)},
    reynolds=100.0,
))


def case_names() -> tuple[str, ...]:
    return tuple(sorted(CASES))


def get_case(name: str | FlowCase, reynolds: float | None = None,
             u_ref: float | None = None) -> FlowCase:
    """Look up a registered case, optionally re-parameterized.

    Accepts an already-built :class:`FlowCase` (pass-through, still
    re-parameterized) so solver constructors take either form.
    """
    if isinstance(name, FlowCase):
        case = name
    else:
        try:
            case = CASES[name]
        except KeyError:
            raise KeyError(f"unknown flow case {name!r} "
                           f"(registered: {case_names()})") from None
    kw = {}
    if reynolds is not None:
        kw["reynolds"] = reynolds
    if u_ref is not None:
        kw["u_ref"] = u_ref
    if kw:
        # replace() re-wraps bcs through __post_init__; hand it a plain dict
        case = dataclasses.replace(case, bcs=dict(case.bcs), **kw)
    return case
