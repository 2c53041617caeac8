"""The port's process meshes and distributed FFTs
(`spheremanopt_torch/parallel/`), the 3-D Fourier basis, and KDyn's
`transform="distributed"`: the counterparts of `tests/test_parallel.py`.

The port's side runs in local gloo worlds of 2 and 4 processes (one
world each per module, `LocalWorld`; it and the cases are in
`torch_dist_cases.py`, which imports no JAX). The JAX side runs here on
the virtual devices of `conftest.py`. The slab and 2 x 2 pencil
transforms match `numpy.fft.rfftn` / the round trip and JAX's
distributed outputs at 1e-13 (f64), and their gradients pass
`torch.autograd.gradcheck`. KDyn's distributed transform (slab; 2 x 2
pencil) matches the matmul transform at J rtol 1e-12 and gradients 1e-9,
the tolerances of `tests/test_parallel.py`.
"""

import numpy as np
import pytest
import torch

import torch_dist_cases as cases
from spheremanopt_torch.ops.fourier import FourierBasis3D, _pad_3d, _truncate_3d
from torch_dist_cases import LocalWorld

TOL = 1e-13


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    with LocalWorld(2, str(tmp_path_factory.mktemp("world2"))) as w:
        yield w


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    with LocalWorld(4, str(tmp_path_factory.mktemp("world4"))) as w:
        yield w


def _close(a, b, tol=TOL):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    np.testing.assert_allclose(a, b, rtol=tol, atol=tol * np.abs(b).max())


def _jax_slab(v):
    import jax
    import jax.numpy as jnp

    from spheremanopt_tpu.parallel.fft import distributed_rfftn
    from spheremanopt_tpu.parallel.mesh import field_sharding, make_mesh

    mesh = make_mesh(2)
    vs = jax.device_put(jnp.asarray(v), field_sharding(mesh, v.ndim, v.ndim - 3))
    return np.asarray(distributed_rfftn(vs, mesh))


# ---------------------------------------------------------------------------
# the counterparts of tests/test_parallel.py
# ---------------------------------------------------------------------------


def test_distributed_rfftn_matches_local(world2):
    v = np.random.RandomState(0).randn(16, 8, 8)
    outs = world2.run(cases.slab_fft, v)
    c, _, local_shape = outs[0]
    _close(c, np.fft.rfftn(v))
    _close(c, _jax_slab(v))
    # this rank's coefficients are sharded over Y
    assert local_shape == (16, 4, 5)
    for o in outs[1:]:
        np.testing.assert_array_equal(o[0], c)


def test_distributed_roundtrip(world2):
    v = np.random.RandomState(1).randn(8, 16, 12)
    _, back, _ = world2.run(cases.slab_fft, v)[0]
    _close(back, v)


def test_distributed_batched_fields(world2):
    v = np.random.RandomState(2).randn(3, 8, 8, 8)   # a vector field
    c, back, _ = world2.run(cases.slab_fft, v)[0]
    _close(c, np.fft.rfftn(v, axes=(-3, -2, -1)))
    _close(c, _jax_slab(v))
    _close(back, v)


def test_distributed_mean_product(world2):
    rng = np.random.RandomState(3)
    x, y = rng.randn(8, 4, 4), rng.randn(8, 4, 4)
    got = world2.run(cases.mean_product, x, y)
    assert got[0] == got[1]
    np.testing.assert_allclose(got[0], float(np.mean(x * y)), rtol=1e-12)


def test_grad_through_distributed_fft(world2):
    """The transform is differentiable (it sits inside the sharded
    solves): d/dv sum |F v|^2 matches autograd of the local transform,
    and gradcheck passes for the slab's forward and inverse."""
    v = np.random.RandomState(4).randn(8, 8, 8)
    g = world2.run(cases.energy_gradient, v)[0]
    t = torch.as_tensor(v).requires_grad_(True)
    c = torch.fft.rfftn(t)
    torch.sum(c.real ** 2 + c.imag ** 2).backward()
    np.testing.assert_allclose(g, t.grad.numpy(), rtol=1e-12, atol=1e-9)
    assert world2.run(cases.gradchecks, False) == [(True, True)] * 2


def test_kdyn_distributed_transform_in_step_path(world2):
    """transform="distributed" (slab, 2 ranks) as the step path: the IC
    pipeline through either transform agrees, and J and the fused
    gradient (unprojected, as JAX's test) match the matmul transform."""
    Jm, Jd, gm, gd, ic = world2.run(cases.kdyn_distributed, None, 8, (), True, 5,
                                    False)[0]
    assert ic < 1e-11
    np.testing.assert_allclose(Jd, Jm, rtol=1e-12)
    for a, b in zip(gd, gm):
        np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-12)


def test_distributed_rfftn_2d_matches_dense(world4):
    """The 2 x 2 pencil: exact against rfftn and JAX's 2-D transform,
    batched, with an odd (never sharded) Z extent; the round trip; the
    divisibility error."""
    import jax.numpy as jnp

    from spheremanopt_tpu.parallel.fft import distributed_rfftn_2d as jax_2d
    from spheremanopt_tpu.parallel.mesh import make_mesh2d as jax_mesh2d

    rng = np.random.RandomState(3)
    for shape in ((3, 8, 8, 8), (8, 8, 9)):
        v = rng.randn(*shape)
        outs = world4.run(cases.pencil_fft, 2, 2, v)
        # the coefficients' Y blocks: iy * px + ix
        c = np.concatenate([o[1] for o in sorted(outs, key=lambda o: o[0][1] * 2 + o[0][0])],
                           axis=-2)
        _close(c, np.fft.rfftn(v, axes=(-3, -2, -1)))
        _close(c, np.asarray(jax_2d(jnp.asarray(v), jax_mesh2d(2, 2))))
        X, Y = shape[-3], shape[-2]
        back = np.zeros_like(v)
        for (ix, iy), _, b in outs:
            back[..., ix * X // 2:(ix + 1) * X // 2, iy * Y // 2:(iy + 1) * Y // 2, :] = b
        _close(back, v)
    msgs = world4.run(cases.pencil_indivisible, 2, 2)
    assert all("divisible" in m for m in msgs), msgs
    assert world4.run(cases.gradchecks, True) == [(True, True)] * 4


def test_kdyn_2d_pencil_objective_and_gradient_parity(world4):
    """KDyn on a 2 x 2 pencil mesh (mesh_shape=(2, 2)) matches the
    matmul transform: J and both gradients, from JAX's x0."""
    from spheremanopt_tpu.problems.kinematic_dynamo import KDynConfig, KinematicDynamo

    jp = KinematicDynamo(KDynConfig(npts=8, n_iters=5, dt=1e-3, dtype="float64"))
    x0 = [np.asarray(v) for v in jp.generate_ic(seed=6)]
    Jj, gj = jp.objective_and_gradient(x0)
    Jm, Jd, gm, gd, _ = world4.run(cases.kdyn_distributed, x0, 8, (2, 2), True)[0]
    np.testing.assert_allclose(Jd, Jm, rtol=1e-12)
    np.testing.assert_allclose(Jm, float(Jj), rtol=1e-12)
    for a, b, c in zip(gd, gm, gj):
        np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-12)
        np.testing.assert_allclose(b, np.asarray(c), rtol=1e-9, atol=1e-12)


def test_kdyn_distributed_f32_state_of_an_f64_problem(world2):
    """A state stored in f32 (as the pinned x0s are) given to the f64
    problems: the gradients are projected in f64 on both transforms
    (an f32 leaf gradient projected through the FFTs in complex64 read
    1.3e-7 of the matmul transform's)."""
    from spheremanopt_tpu.problems.kinematic_dynamo import KDynConfig, KinematicDynamo

    jp = KinematicDynamo(KDynConfig(npts=8, n_iters=5, dt=1e-3, dtype="float64"))
    x0 = [np.asarray(v, np.float32) for v in jp.generate_ic(seed=2)]
    Jm, Jd, gm, gd, _ = world2.run(cases.kdyn_distributed, x0, 8, (), True)[0]
    np.testing.assert_allclose(Jd, Jm, rtol=1e-12)
    for a, b in zip(gd, gm):
        assert a.dtype == b.dtype == np.float64
        np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-12)


def test_make_mesh_rejects_oversized_request(world2):
    one, two, sharded, whole = world2.run(cases.mesh_errors)[0]
    assert "visible" in one and "3-device" in one
    assert "visible" in two and "2x2" in two
    assert sharded == "(Shard(dim=1),)" and whole == "(Replicate(),)"


@pytest.mark.parametrize("remat", [True, "nested"])
def test_kdyn_distributed_slab_remat_modes(world4, remat):
    """The slab over 4 ranks with step and nested remat."""
    Jm, Jd, gm, gd, _ = world4.run(cases.kdyn_distributed, None, 8, (), remat)[0]
    np.testing.assert_allclose(Jd, Jm, rtol=1e-12)
    for a, b in zip(gd, gm):
        np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-12)


# ---------------------------------------------------------------------------
# the 3-D Fourier basis against the JAX package's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [8, 9, 12])
def test_fourier_basis3d_matches_jax(n):
    from spheremanopt_tpu.ops import fourier as jf

    b, jb = FourierBasis3D(n), jf.FourierBasis3D(n)
    assert b.n_grid == jb.n_grid and b.coeff_shape == jb.coeff_shape
    for k, jk in zip(b.wavenumber_grids(), jb.wavenumber_grids()):
        np.testing.assert_array_equal(k, jk)
    np.testing.assert_array_equal(b.keep_mask(), jb.keep_mask())
    v = np.random.RandomState(n).randn(3, b.n_grid, b.n_grid, b.n_grid)
    c = b.to_coeff(torch.as_tensor(v))
    assert c.shape == (3,) + b.coeff_shape
    _close(c.numpy(), np.asarray(jb.to_coeff(v)))
    for over in (True, False):
        _close(b.to_grid(c, over).numpy(), np.asarray(jb.to_grid(np.asarray(c), over)))
    full = np.fft.rfftn(v, axes=(-3, -2, -1))
    t = _truncate_3d(torch.as_tensor(full), n)
    _close(t.numpy(), np.asarray(jf._truncate_3d(full, n)))
    _close(_pad_3d(t, n, b.n_grid).numpy(), np.asarray(jf._pad_3d(np.asarray(t), n, b.n_grid)))


def test_fourier_basis3d_roundtrip_and_derivative():
    b = FourierBasis3D(16)
    m = b.n_grid
    xs = np.arange(m) * 2 * np.pi / m
    X, Y, Z = np.meshgrid(xs, xs, xs, indexing="ij")
    u = np.sin(X) * np.cos(2 * Y) * np.sin(Z)
    c = b.to_coeff(torch.as_tensor(u))
    np.testing.assert_allclose(b.to_grid(c).numpy(), u, atol=1e-11)
    kx, _, _ = b.wavenumber_grids()
    dudx = b.to_grid(1j * torch.as_tensor(kx) * c).numpy()
    np.testing.assert_allclose(dudx, np.cos(X) * np.cos(2 * Y) * np.sin(Z), atol=1e-10)
