"""The port's kernel modules against the JAX package's kernels and oracles.

On the CPU every kernel wrapper runs its plain PyTorch version; these tests
hold those plain versions against the JAX package's Pallas kernels run in
interpret mode and its ``ref.py`` oracles, for every (storage, accum)
pair, on block-aligned, ragged and stacked (halo-crossing) shapes.  The
CUDA kernels themselves are held against the plain versions on the card
by ``chip_smoke.py`` (the machine with the card has no JAX, which these
tests and their conftest import).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels.krylov_fused import krylov_fused as jax_kf
from repro.kernels.krylov_fused.ref import (fused_axpy_precond_ref,
                                            spmv_dot_ref)
from repro.kernels.spmv_dia.spmv_dia import spmv_dia_single
from repro.sparse.distributed import x_pad as jax_x_pad

from repro_torch.kernels import WRAPPERS, launch_counts, reset_launch_counts
from repro_torch.kernels._build import SOURCES, dtype_code
from repro_torch.kernels.coef_update.coef_update import (
    check_gather_operands, coef_update_plain, coef_update_stacked)
from repro_torch.kernels.krylov_fused.krylov_fused import (
    fused_axpy_precond_cost, fused_axpy_precond_plain, fused_matvec_dot,
    fused_update_step, spmv_dot_cost, spmv_dot_plain)
from repro_torch.kernels.spmv_dia.spmv_dia import (check_stacked_operands,
                                                   spmv_dia_plain,
                                                   spmv_dia_stacked)
from repro_torch.kernels.stencil_assembly.stencil_assembly import (
    check_face_operands, momentum_bands_plain, momentum_bands_stacked)

# (storage, accum, tolerance relative to the output's max): the tolerances
# of tests/test_krylov_fused.py — f64 round-off, f32 round-off, bf16 storage
PAIRS = [
    ("float64", "float64", 1e-12),
    ("float32", "float32", 1e-5),
    ("bfloat16", "float32", 2e-2),
]
# (P, m, nx, plane): block-aligned single part, ragged single part, and
# stacked ragged parts whose shifts cross into the neighbours' halos
SHAPES = [(1, 4096, 16, 256), (1, 777, 4, 16), (3, 777, 4, 16)]


def _operands(P, m, storage, seed=0):
    """Random operands exactly representable in ``storage``, as float32 or
    float64 numpy arrays, so both frameworks start from identical values."""
    rng = np.random.default_rng(seed)
    out = {"bands": rng.standard_normal((P, 7, m)),
           "x": rng.standard_normal((P, m)), "r": rng.standard_normal((P, m)),
           "p": rng.standard_normal((P, m)), "Ap": rng.standard_normal((P, m)),
           "inv": rng.uniform(0.5, 1.5, (P, m))}
    if storage != "float64":
        out = {k: torch.as_tensor(v, dtype=torch.float32)
               .to(getattr(torch, storage)).float().numpy()
               for k, v in out.items()}
    return out


def _t(a, dtype):
    return torch.as_tensor(a).to(getattr(torch, dtype))


def _j(a, dtype):
    return jnp.asarray(a).astype(getattr(jnp, dtype))


def _close(got, want, tol):
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    scale = max(float(np.abs(want).max()), 1e-300)
    assert float(np.abs(got - want).max()) <= tol * scale


def _offsets(nx, plane):
    return (-plane, -nx, -1, 0, 1, nx, plane)


@pytest.mark.parametrize("P,m,nx,plane", SHAPES)
@pytest.mark.parametrize("storage,accum,tol", PAIRS)
def test_spmv_dia_plain_matches_pallas_interpret(P, m, nx, plane, storage,
                                                 accum, tol):
    ops = _operands(P, m, storage)
    offsets = _offsets(nx, plane)
    xp = jax_x_pad(_j(ops["x"], storage), plane)
    want = np.concatenate([
        np.asarray(spmv_dia_single(_j(ops["bands"][p], storage), xp[p],
                                   offsets=offsets, plane=plane,
                                   block_rows=256, interpret=True,
                                   accum_dtype=accum).astype(jnp.float64))
        for p in range(P)])
    got = spmv_dia_plain(_t(ops["bands"], storage), _t(ops["x"], storage),
                         offsets=offsets, plane=plane,
                         accum_dtype=getattr(torch, accum))
    assert got.dtype == getattr(torch, storage)
    _close(got.double().reshape(-1), want, tol)


@pytest.mark.parametrize("P,m,nx,plane", SHAPES)
@pytest.mark.parametrize("storage,accum,tol", PAIRS)
def test_spmv_dot_plain_matches_ref(P, m, nx, plane, storage, accum, tol):
    ops = _operands(P, m, storage, seed=1)
    offsets = _offsets(nx, plane)
    xp = jax_x_pad(_j(ops["x"], storage), plane)
    ys, dots = [], []
    for p in range(P):
        y, d = spmv_dot_ref(_j(ops["bands"][p], storage), xp[p],
                            offsets=offsets, plane=plane, accum_dtype=accum)
        ys.append(np.asarray(y.astype(jnp.float64)))
        dots.append(float(d))
    y_t, d_t = spmv_dot_plain(_t(ops["bands"], storage),
                              _t(ops["x"], storage), offsets=offsets,
                              plane=plane, accum_dtype=getattr(torch, accum))
    assert d_t.dtype == getattr(torch, accum)
    _close(y_t.double().reshape(-1), np.concatenate(ys), tol)
    _close(float(d_t), sum(dots), 10 * tol)


@pytest.mark.parametrize("P,m", [(1, 4096), (3, 777)])
@pytest.mark.parametrize("storage,accum,tol", PAIRS)
def test_fused_axpy_precond_plain_matches_ref(P, m, storage, accum, tol):
    ops = _operands(P, m, storage, seed=2)
    names = ("x", "r", "p", "Ap", "inv")
    alpha = 0.37
    want = fused_axpy_precond_ref(
        *(_j(ops[k].reshape(-1), storage) for k in names),
        jnp.asarray(alpha, getattr(jnp, accum)), accum_dtype=accum)
    got = fused_axpy_precond_plain(
        *(_t(ops[k], storage) for k in names),
        torch.tensor(alpha, dtype=getattr(torch, accum)),
        accum_dtype=getattr(torch, accum))
    for g, w in zip(got[:3], want[:3]):
        assert g.shape == (P, m) and g.dtype == getattr(torch, storage)
        _close(g.double().reshape(-1), w.astype(jnp.float64), tol)
    for g, w in zip(got[3:], want[3:]):
        assert g.dtype == getattr(torch, accum)
        _close(float(g), float(w), 10 * tol)


def test_wrappers_take_plain_versions_on_cpu_without_launching():
    """On CPU tensors the wrappers return exactly the plain versions'
    results and launch nothing."""
    ops = _operands(2, 300, "float64", seed=3)
    offsets = _offsets(5, 25)
    b, x = _t(ops["bands"], "float64"), _t(ops["x"], "float64")
    vecs = [_t(ops[k], "float64") for k in ("x", "r", "p", "Ap", "inv")]
    alpha = torch.tensor(0.25, dtype=torch.float64)
    reset_launch_counts()
    assert torch.equal(spmv_dia_stacked(b, x, offsets=offsets, plane=25),
                       spmv_dia_plain(b, x, offsets=offsets, plane=25))
    for g, w in zip(fused_matvec_dot(b, x, offsets=offsets, plane=25),
                    spmv_dot_plain(b, x, offsets=offsets, plane=25)):
        assert torch.equal(g, w)
    for g, w in zip(fused_update_step(*vecs, alpha),
                    fused_axpy_precond_plain(*vecs, alpha)):
        assert torch.equal(g, w)
    src = torch.as_tensor(np.arange(0, 601, 3)[::-1].copy(), dtype=torch.int32)
    assert torch.equal(coef_update_stacked(b.reshape(2, -1)[:, :601], src),
                       coef_update_plain(b.reshape(2, -1)[:, :601], src))
    faces = [_t(ops[k], "float64") for k in ("x", "r", "p", "Ap", "inv")]
    faces += [b[:, 0], b[:, 1]]
    assert torch.equal(momentum_bands_stacked(*faces, nx=5, plane=25, vdt=2.),
                       momentum_bands_plain(*faces, nx=5, plane=25, vdt=2.))
    assert launch_counts() == {name: 0 for name in WRAPPERS}
    assert set(WRAPPERS) == {"spmv_dia", "spmv_dot", "axpy_precond",
                             "coef_update", "momentum_bands"}
    assert set(SOURCES) == {"spmv_dia", "krylov_fused", "coef_update",
                            "stencil_assembly"}


def test_kernel_operand_checks_raise():
    b = torch.zeros((2, 7, 10), dtype=torch.float64)
    x = torch.zeros((2, 10), dtype=torch.float64)
    offsets = _offsets(2, 4)
    with pytest.raises(ValueError, match="CUDA"):
        check_stacked_operands(b, x, offsets, 4)
    buf = torch.zeros((2, 10), dtype=torch.float64)
    src = torch.zeros(5, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        check_gather_operands(buf, src)
    with pytest.raises(ValueError, match="CUDA"):
        # neither all on the CPU (the plain version) nor on a card
        coef_update_stacked(buf, src.to("meta"))
    with pytest.raises(ValueError, match="CUDA"):
        check_face_operands([x] * 7)
    with pytest.raises(ValueError, match="CUDA"):
        momentum_bands_stacked(*([x] * 6 + [x.to("meta")]), nx=2, plane=4,
                               vdt=1.0)
    assert dtype_code(torch.float64, torch.float64) == 0
    with pytest.raises(TypeError, match="no kernel instantiation"):
        dtype_code(torch.float16, torch.float32)


@pytest.mark.parametrize("nb,m,plane,itemsize,block,acc", [
    (7, 4096, 256, 8, 512, None), (7, 777, 16, 4, 256, 4),
    (7, 100, 8, 2, 2048, 4), (7, 9_261_000, 44_100, 8, 2048, None)])
def test_cost_contracts_match_jax_as_ints(nb, m, plane, itemsize, block, acc):
    want = jax_kf.spmv_dot_cost(nb, m, plane, itemsize, block_rows=block,
                                accum_itemsize=acc)
    got = spmv_dot_cost(nb, m, plane, itemsize, block_rows=block,
                        accum_itemsize=acc)
    assert got == {k: int(v) for k, v in want.items()}
    assert all(isinstance(v, int) for v in got.values())
    want = jax_kf.fused_axpy_precond_cost(m, itemsize, block_rows=block,
                                          accum_itemsize=acc)
    got = fused_axpy_precond_cost(m, itemsize, block_rows=block,
                                  accum_itemsize=acc)
    assert got == {k: int(v) for k, v in want.items()}
