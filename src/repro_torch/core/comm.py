"""The ``(solve, assemble)`` shard mesh of the full-mesh solve mode.

The paper splits its ranks into an active set that enters the solver and an
inactive set that skips it.  The stacked layout (every other solve in the
port) keeps a coarse part's rows together on the solver's device.  The
full-mesh mode (``solve_mode="full_mesh"``) cuts each coarse part's
``m_coarse`` rows again into ``alpha`` row shards of ``m_loc = m_coarse /
alpha`` rows, one shard per fine part, laid out in ``(solve, assemble)``
order: shard ``c * alpha + j`` is rows ``[j * m_loc, (j + 1) * m_loc)`` of
coarse part ``c``.  Every shard then works during the solve, and
:mod:`repro_torch.sparse.shardmap_spmv` swaps one halo plane between
linear neighbours.

:class:`ShardMesh` is the grid of ``torch.device``\\s the shards live on.
It is one process's mesh, as the JAX package's ``Mesh`` is one
controller's: its device list may name one device many times (the
counterpart of forced host devices), and shards that share a device run as
the lanes of one kernel launch.  There is no multi-process mode.

:func:`to_shards` / :func:`from_shards` move a stacked ``(n_c, ..., m_c)``
tensor to the shard layout ``(n_c * alpha, ..., m_loc)`` and back; they
stand in for the JAX package's ``solve_sharding`` / ``solve_constraint``.
A vector's shard layout is a view; bands ``(n_c, nb, m_c)`` are copied
once.  The assembly layout over the mesh (``assembly_sharding``) is not
ported: assembly stays on the solver's device.
"""
from __future__ import annotations

import dataclasses

import torch

__all__ = ["SOLVE_AXIS", "ASSEMBLE_AXIS", "ShardMesh", "make_cfd_mesh",
           "visible_devices", "canonical_device", "to_shards", "from_shards"]

SOLVE_AXIS = "solve"
ASSEMBLE_AXIS = "assemble"


def canonical_device(device) -> torch.device:
    """A device with its index: ``cuda`` is the current card."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


@dataclasses.dataclass(frozen=True)
class ShardMesh:
    """An ``(n_coarse, alpha)`` grid of devices, one per row shard.

    ``devices[c][j]`` holds shard ``c * alpha + j``.  ``axis_names`` and
    ``shape`` pair up as the JAX ``Mesh``'s do: ``dict(zip(mesh.axis_names,
    mesh.shape))`` is ``{"solve": n_coarse, "assemble": alpha}``.
    """

    devices: tuple[tuple[torch.device, ...], ...]
    axis_names: tuple[str, str] = (SOLVE_AXIS, ASSEMBLE_AXIS)

    @property
    def shape(self) -> tuple[int, int]:
        return len(self.devices), len(self.devices[0])

    @property
    def n_shards(self) -> int:
        n_c, alpha = self.shape
        return n_c * alpha

    def flat(self) -> list[torch.device]:
        """The shards' devices in linear ``(solve, assemble)`` order."""
        return [d for row in self.devices for d in row]

    def groups(self) -> list[tuple[torch.device, int, int]]:
        """``(device, first, end)`` for each run of consecutive shards on
        one device: a run's shards are the lanes of one launch."""
        out = []
        for s, dev in enumerate(self.flat()):
            if out and out[-1][0] == dev:
                out[-1] = (dev, out[-1][1], s + 1)
            else:
                out.append((dev, s, s + 1))
        return out

    @property
    def one_device(self) -> torch.device | None:
        """The device when every shard is on it, else None."""
        devs = set(self.flat())
        return devs.pop() if len(devs) == 1 else None


def visible_devices(device_type: str = "cuda") -> list[torch.device]:
    """The distinct devices of one type this process sees."""
    if device_type == "cuda":
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        return [torch.device("cuda", i) for i in range(n)]
    if device_type == "cpu":
        return [torch.device("cpu")]
    raise ValueError(f"unsupported device type {device_type!r}")


def make_cfd_mesh(n_coarse: int, alpha: int, devices=None, *,
                  device_type: str = "cuda") -> ShardMesh:
    """The ``(n_coarse, alpha)`` mesh over the first ``n_coarse * alpha``
    of ``devices`` (default: the distinct visible devices of
    ``device_type``); raises when there are fewer, as the JAX package's
    ``make_cfd_mesh`` does.  ``devices`` may name one device many times."""
    devs = (visible_devices(device_type) if devices is None
            else [canonical_device(d) for d in devices])
    if len(devs) < n_coarse * alpha:
        raise ValueError(f"need {n_coarse * alpha} devices, have {len(devs)}")
    devs = devs[:n_coarse * alpha]
    return ShardMesh(tuple(tuple(devs[c * alpha:(c + 1) * alpha])
                           for c in range(n_coarse)))


def to_shards(t: torch.Tensor, alpha: int) -> torch.Tensor:
    """A stacked ``(n_c, m_c)`` vector as ``(n_c * alpha, m_loc)`` (a
    view), or stacked bands ``(n_c, nb, m_c)`` as ``(n_c * alpha, nb,
    m_loc)`` (a contiguous copy): shard ``c * alpha + j`` holds rows ``[j *
    m_loc, (j + 1) * m_loc)`` of part ``c``."""
    n_c, m_c = t.shape[0], t.shape[-1]
    if m_c % alpha:
        raise ValueError(f"{m_c} rows do not split into {alpha} shards")
    m_loc = m_c // alpha
    if t.dim() == 2:
        return t.reshape(n_c * alpha, m_loc)
    nb = t.shape[1]
    return (t.reshape(n_c, nb, alpha, m_loc).permute(0, 2, 1, 3)
            .reshape(n_c * alpha, nb, m_loc).contiguous())


def from_shards(t: torch.Tensor, alpha: int) -> torch.Tensor:
    """The inverse of :func:`to_shards`: ``(n_c * alpha, m_loc)`` back to
    ``(n_c, m_c)`` (a view), ``(n_c * alpha, nb, m_loc)`` to ``(n_c, nb,
    m_c)`` (a copy)."""
    S, m_loc = t.shape[0], t.shape[-1]
    if S % alpha:
        raise ValueError(f"{S} shards are not groups of {alpha}")
    n_c = S // alpha
    if t.dim() == 2:
        return t.reshape(n_c, alpha * m_loc)
    nb = t.shape[1]
    return (t.reshape(n_c, alpha, nb, m_loc).permute(0, 2, 1, 3)
            .reshape(n_c, nb, alpha * m_loc).contiguous())
