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
from repro_torch.fvm.mesh import CavityMesh
from repro_torch.fvm.piso import make_solver
from repro_torch.kernels.krylov_fused import krylov_fused as torch_kf
from repro_torch.kernels.krylov_fused.krylov_fused import (
    axpy_precond_partials, axpy_precond_partials_plain, block_partials_plain,
    check_axpy_operands, fused_axpy_precond_cost, fused_axpy_precond_plain,
    fused_matvec_dot, fused_matvec_dot_into, fused_update_step,
    spmv_dot_cost, spmv_dot_partials, spmv_dot_partials_plain, spmv_dot_plain)
from repro_torch.kernels.krylov_loop.krylov_loop import (
    cg_advance, cg_direction, cg_direction_plain)
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


def _tree_partials(v, block=256):
    """block_sum's order, one scalar add at a time: each block of ``block``
    values (zero-padded), level h adds a[i + h] to a[i] for i < h."""
    out = []
    zero = v.dtype.type(0)
    for start in range(0, len(v), block):
        a = list(v[start:start + block])
        a += [zero] * (block - len(a))
        h = block // 2
        while h >= 1:
            a = [a[i] + a[i + h] for i in range(h)]
            h //= 2
        out.append(a[0])
    return np.array(out, dtype=v.dtype)


@pytest.mark.parametrize("n", [1, 255, 256, 257, 3 * 777])
@pytest.mark.parametrize("storage,accum,tol", PAIRS)
def test_block_partials_plain_is_the_kernels_tree(n, storage, accum, tol):
    """The oracle of the SpMV+dot kernel's partials: bitwise a scalar tree
    in block_sum's order, and its sum the dot within the dtype's
    tolerance."""
    rng = np.random.default_rng(n)
    x = _t(rng.standard_normal(n), storage).to(getattr(torch, accum))
    y = _t(rng.standard_normal(n), accum)
    v = x * y
    got = block_partials_plain(v)
    assert got.dtype == getattr(torch, accum)
    assert got.shape == (-(-n // 256),)
    want = _tree_partials(v.numpy())
    assert np.array_equal(got.numpy(), want)
    scale = float(v.abs().sum())
    assert abs(float(got.sum()) - float(torch.dot(x, y))) <= tol * scale


@pytest.mark.parametrize("storage,accum,tol", PAIRS)
def test_spmv_dot_partials_on_cpu_are_the_plain_versions(storage, accum,
                                                         tol):
    """On CPU tensors the partials entry point returns the plain SpMV and
    the tree-order partials, whose sum is the plain dot."""
    ops = _operands(3, 777, storage, seed=4)
    b, x = _t(ops["bands"], storage), _t(ops["x"], storage)
    kw = dict(offsets=_offsets(4, 16), plane=16,
              accum_dtype=getattr(torch, accum))
    y, part = spmv_dot_partials(b, x, **kw)
    y_want, dot = spmv_dot_plain(b, x, **kw)
    assert torch.equal(y, y_want)
    y_acc = spmv_dia_plain(b.to(getattr(torch, accum)),
                           x.to(getattr(torch, accum)), offsets=kw["offsets"],
                           plane=16)
    part_want = block_partials_plain(x.to(getattr(torch, accum)) * y_acc)
    assert torch.equal(part, part_want)
    for g, w in zip(spmv_dot_partials_plain(b, x, **kw), (y_want, part_want)):
        assert torch.equal(g, w)
    _close(float(part.sum()), float(dot), 10 * tol)


def _axpy_kernel_partials(v, storage):
    """The axpy kernel's partials (csrc/krylov_fused.cu) in its own order:
    a warp per 256-row partial, lane l holding L = 8 / W vectors of W = 16 /
    itemsize consecutive rows (vector w at rows 32*W*w + W*l + k); the
    vectors of one thread added in registers (levels 128 .. 32W), then
    five ``__shfl_down_sync`` levels 16 .. 1 lanes apart on each live
    value (a lane past 31 reads its own value, as the hardware returns),
    then the rows of one vector in registers (levels W/2 .. 1); lane 0's
    first value is the partial."""
    W = 16 // torch.empty((), dtype=storage).element_size()
    L = 8 // W
    n = v.numel()
    nb = -(-n // 256)
    a = v.new_zeros(nb * 256)
    a[:n] = v
    e = a.reshape(nb, L, 32, W)            # [warp, vector, lane, row]
    s = L // 2
    while s >= 1:
        e = e[:, :s] + e[:, s:2 * s]
        s //= 2
    e = e[:, 0]                            # [warp, lane, row]
    for d in (16, 8, 4, 2, 1):
        down = torch.cat([e[:, d:], e[:, 32 - d:]], dim=1)
        e = e + down
    e = e[:, 0]                            # lane 0: [warp, row]
    s = W // 2
    while s >= 1:
        e = e[:, :s] + e[:, s:2 * s]
        s //= 2
    return e[:, 0]


@pytest.mark.parametrize("n", [256, 3 * 777, 4097])
@pytest.mark.parametrize("storage,accum,tol", PAIRS)
def test_axpy_kernel_order_is_block_partials_plain(n, storage, accum, tol):
    """The axpy kernel's warp-shuffle order gives block_partials_plain's
    partials bit for bit: a thread's vectors and the lanes pair the rows
    of the tree's levels exactly, whatever the storage width."""
    rng = np.random.default_rng(n)
    r = _t(rng.standard_normal(n), storage).to(getattr(torch, accum))
    z = _t(rng.standard_normal(n), storage).to(getattr(torch, accum))
    for v in (r * z, r * r):
        got = _axpy_kernel_partials(v, getattr(torch, storage))
        want = block_partials_plain(v)
        assert got.dtype == want.dtype == getattr(torch, accum)
        assert torch.equal(got, want)
    # a warp's lanes past the shuffle distance add values no level reads
    v = torch.zeros(256, dtype=getattr(torch, accum))
    v[255] = 1.0
    assert float(_axpy_kernel_partials(v, getattr(torch, storage))[0]) == 1.0


@pytest.mark.parametrize("P,m", [(1, 4096), (3, 777)])
@pytest.mark.parametrize("storage,accum,tol", PAIRS)
def test_fused_update_step_on_cpu_is_the_plain_version_and_ref(
        P, m, storage, accum, tol):
    """On CPU tensors the wrapper returns the plain version's results bit
    for bit, launches nothing, and agrees with the JAX oracle."""
    ops = _operands(P, m, storage, seed=5)
    names = ("x", "r", "p", "Ap", "inv")
    alpha = 0.37
    vecs = [_t(ops[k], storage) for k in names]
    a = torch.tensor(alpha, dtype=getattr(torch, accum))
    reset_launch_counts()
    got = fused_update_step(*vecs, a, accum_dtype=getattr(torch, accum))
    assert launch_counts()["axpy_precond"] == 0
    for g, w in zip(got, fused_axpy_precond_plain(
            *vecs, a, accum_dtype=getattr(torch, accum))):
        assert g.dtype == w.dtype and torch.equal(g, w)
    want = fused_axpy_precond_ref(
        *(_j(ops[k].reshape(-1), storage) for k in names),
        jnp.asarray(alpha, getattr(jnp, accum)), accum_dtype=accum)
    for g, w in zip(got[:3], want[:3]):
        assert g.shape == (P, m) and g.dtype == getattr(torch, storage)
        _close(g.double().reshape(-1), w.astype(jnp.float64), tol)
    for g, w in zip(got[3:], want[3:]):
        assert g.dtype == getattr(torch, accum)
        _close(float(g), float(w), 10 * tol)


@pytest.mark.parametrize("storage,accum,tol", PAIRS)
def test_axpy_precond_partials_on_cpu_are_the_plain_versions(storage, accum,
                                                             tol):
    """On CPU tensors the partials entry point returns the plain vectors
    and the tree-order partials of the accum-width terms, whose sums are
    the plain dots."""
    ops = _operands(3, 777, storage, seed=6)
    vecs = [_t(ops[k], storage) for k in ("x", "r", "p", "Ap", "inv")]
    a = torch.tensor(0.29, dtype=getattr(torch, accum))
    acc = getattr(torch, accum)
    got = axpy_precond_partials(*vecs, a, accum_dtype=acc)
    plain = fused_axpy_precond_plain(*vecs, a, accum_dtype=acc)
    for g, w in zip(got[:3], plain[:3]):
        assert torch.equal(g, w)
    rn = plain[1].to(acc)
    for g, term, dot in ((got[3], rn * plain[2].to(acc), plain[3]),
                         (got[4], rn * rn, plain[4])):
        assert g.shape == (-(-3 * 777 // 256),) and g.dtype == acc
        assert torch.equal(g, block_partials_plain(term))
        _close(float(g.sum()), float(dot), 10 * tol)
    for g, w in zip(got, axpy_precond_partials_plain(*vecs, a,
                                                     accum_dtype=acc)):
        assert torch.equal(g, w)


def test_check_axpy_operands_raise():
    base = torch.zeros(2 * 64 + 1, dtype=torch.float64)
    vecs = [torch.zeros((2, 64), dtype=torch.float64) for _ in range(5)]
    alpha = torch.tensor(0.5, dtype=torch.float64)
    with pytest.raises(ValueError, match="16-byte boundary"):
        check_axpy_operands(vecs[:4] + [base[1:].reshape(2, 64)], alpha)
    with pytest.raises(ValueError, match="share device, dtype and shape"):
        check_axpy_operands(vecs[:4] + [vecs[4].float()], alpha)
    with pytest.raises(ValueError, match="contiguous"):
        check_axpy_operands(vecs[:4] + [base[:128].reshape(64, 2).T],
                            alpha)
    with pytest.raises(ValueError, match="CUDA"):
        check_axpy_operands(vecs, alpha)
    with pytest.raises(ValueError, match="CUDA"):
        # neither all on the CPU (the plain version) nor on a card
        fused_update_step(*vecs, alpha.to("meta"))


@pytest.mark.parametrize("case,program,precision", [
    ("cavity", "piso", "f64"), ("cavity", "piso", "f32_ir"),
    ("channel", "piso", "bf16_ir"), ("channel", "simple", "f64")])
def test_axpy_operands_are_16_byte_aligned_at_every_call_site(
        monkeypatch, case, program, precision):
    """Every vector the solvers hand the axpy wrapper starts on a 16-byte
    boundary (the kernel's vector loads need it): a step of each program,
    case and policy on the fused backend's CPU path, each call's operands
    recorded."""
    seen = []
    plain = torch_kf.fused_axpy_precond_plain

    def recording(*args, **kwargs):
        seen.append([t.data_ptr() % 16 for t in args[:5]])
        return plain(*args, **kwargs)

    monkeypatch.setattr(torch_kf, "fused_axpy_precond_plain", recording)
    solver = make_solver(program, CavityMesh.cube(8, 4), alpha=2,
                         case=case, precision=precision,
                         solver_backend="fused", device="cpu")
    solver.step(solver.initial_state(), 2e-4)
    assert seen and all(m == [0] * 5 for m in seen)


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
    # the Krylov loops' kernels and forms
    g_new, g = torch.tensor(0.7, dtype=torch.float64), alpha
    p_k, p_p = vecs[2].clone(), vecs[2].clone()
    assert torch.equal(cg_direction(p_k, vecs[1], g_new, g),
                       cg_direction_plain(p_p, vecs[1], g_new, g))
    scal = [torch.tensor(v, dtype=torch.float64) for v in (1., 2., 3., 4.)]
    k, flag = torch.zeros((), dtype=torch.int32), torch.ones((), dtype=bool)
    cg_advance(*scal, k, flag, torch.tensor(0.5, dtype=torch.float64), 9)
    assert int(k) == 1 and bool(flag) and float(scal[0]) == 2.
    y, d = torch.empty_like(x), torch.empty((), dtype=torch.float64)
    fused_matvec_dot_into(b, x, y, d, {}, offsets=offsets, plane=25,
                          active=flag)
    y_w, d_w = spmv_dot_plain(b, x, offsets=offsets, plane=25)
    assert torch.equal(y, y_w) and torch.equal(d, d_w)
    assert launch_counts() == {name: 0 for name in WRAPPERS}
    assert set(WRAPPERS) == {"spmv_dia", "spmv_dot", "axpy_precond",
                             "coef_update", "momentum_bands", "cg_direction",
                             "cg_advance"}
    assert set(SOURCES) == {"spmv_dia", "krylov_fused", "coef_update",
                            "stencil_assembly", "krylov_loop"}


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
