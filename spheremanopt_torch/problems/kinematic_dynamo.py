"""Willis optimal kinematic dynamo: two-sphere optimisation over (B0, U).

PyTorch port of the JAX package's `problems/kinematic_dynamo.py`
(reference: `Example_Problems/Periodic_Domain(Fourier)/Kinematic_Dynamo/
FWD_Solve_KDyn.py`). The optimisation is

    max_{B0, U} J = (1/V) int |B(T)|^2 dV   ("Final"; or time-integrated)
    s.t.  (1/V) int |B0|^2 = M0,  (1/V) int |U|^2 = E0,
          dB/dt - nabla x (U x B) + grad(Pi) - (1/Rm) lap(B) = 0,
          div B = 0, div U = 0,   triply periodic, 24^3 modes,

CNAB1 timestepping with 3/2-rule dealiasing (ref `:211-216,443`).

  * the state is a pair of (3, m, m, m) grid tensors (B and U components
    stacked); the optimiser is shape-agnostic
  * the tau-pressure / divergence constraint pair (ref `:431-440`) is
    the mode-wise Leray projection P = I - k k^T/k^2 applied to the CNAB1
    right-hand side, with the mean mode pinned to zero
  * the induction term nabla x (U x B) is a padded-grid cross product
    followed by a spectral curl (i k x E-hat), discretely divergence-free
  * gradients for BOTH spheres come from one reverse pass over the
    discrete forward: the discrete adjoint
  * the constants are built with the JAX package's numpy expressions in
    the same dtype order (so they are bitwise the same) and moved to the
    device once, at construction

`method` maps onto the JAX package's:
  * "plain" (JAX "xla"): a Python loop over the complex CNAB1 step,
    differentiated by autograd; f32 or f64, `transform` "matmul"
    (per-axis DFT einsums) or "fft" (`torch.fft.rfftn`). `remat` sets
    the reverse sweep's trajectory memory: True or "step" (default)
    checkpoints every step (one stored coefficient field per step on the
    device), "nested" checkpoints sqrt(N) chunks of sqrt(N) steps
    (O(sqrt N) stored fields, one extra recompute), "offload" stores each
    step's field in pinned host memory (O(1) on the device), False stores
    every intermediate.
  * "cuda" (JAX "pallas"): the whole solve and its hand-transposed
    reverse sweep as one CUDA kernel launch each
    (`ops/cuda/kdyn_step.py`); f32 and `transform="matmul"` only. On CPU
    tensors the wrappers run their plain versions. It has no fused
    diagnostics (the objective is a closed kernel), as in JAX.

Rows (a sweep of R starting points, `row_forms`): "cuda" with the
discrete adjoint runs the row kernels (`FusedEnergyRows`: one forward and
one reverse launch for up to 8 rows, the JAX package's `jax.vmap` of its
Pallas kernels), each row bitwise the one-row kernels. The parts around
the kernels (`_prepare`'s transforms, the Riesz map with its Leray
projection, the inner product) run a row at a time, as the unbatched call
runs them, so that each row of an f32 sweep makes its unbatched run's
decisions bit for bit. Every other configuration has no batched form: a
sweep runs its rows one after another on the unbatched loop.

`transform="distributed"` (the JAX package's) runs the transforms as the
slab or 2-D pencil distributed FFTs of `parallel/fft.py` over a process
mesh (`torch.distributed`: NCCL on GPUs, gloo on CPUs): `n_shards`
ranks in a slab (0: the whole group), or `mesh_shape=(px, py)` for a
pencil. Each rank holds its shard of the state: (c, mg/P, mg, mg) grid
fields for a slab, (c, mg/px, mg/py, mg) for a pencil (`shard_state`
cuts full fields, `gather_state` joins them). The coefficients take the
full oversampled layout (c, mg, mg/P, mg//2+1), the band kept by a mask,
so the step, Leray and energy code serves both layouts; energies and
inner products are summed over the ranks, so every rank's optimiser sees
the same scalars and makes the same decisions. Without a process group
the constructor starts a one-rank group (`parallel.mesh.init_distributed`).

`adjoint="continuous"` integrates the reference's adjoint PDE system
backward along the stored forward (`gradient`, `adjoint_diagnostics`);
J still comes from `objective` (under "cuda", the forward kernel).
`objective_and_gradient_rm` takes Rm's CNAB1 factors as an operand, so
one device loop serves every Rm.

`solve_precision="df64"` with dtype="float32" is the JAX package's f64
accuracy mode of an f32 problem (there a double-float emulation, which
the TPU needs for lack of f64): here the solve and its reverse sweep run
in torch.float64 on an f64 twin of the problem, from the f32 state, and
return the JAX package's forms (an f32 `objective`, `objective_f64`, f32
gradients). Diagnostics and initial conditions stay on the f32 solve.

The f32 path is full f32 (TF32 off); the JAX package's
`matmul_precision`, `carry` and `unroll` are TPU pass-count and layout
settings, and its `df_n_bits`, `df_slice_dtype` and `df_batched_einsums`
the emulation's; they have no counterpart here.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import List, Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from spheremanopt_torch.problems.base import (MeshForms, DTYPES, RowForms,
                                              SegmentAdvance, check_choice,
                                              resolve_device, to_f64,
                                              value_and_raw_gradient)
from spheremanopt_torch.solvers.scan_utils import (checkpoint_on_host,
                                                   host_copy, kahan_add,
                                                   kahan_zero,
                                                   nested_checkpoint_scan,
                                                   offload_checkpoint)

_REMATS = (True, "step", "nested", "offload", False)


@dataclass(frozen=True)
class KDynConfig:
    npts: int = 24
    length: float = 2.0 * np.pi
    rm: float = 1.0
    dt: float = 5e-4
    n_iters: int = 2000          # Rm/dt (ref `__main__` :1028-1031)
    m0: float = 1.0              # <B0,B0> sphere
    e0: float = 1.0              # <U,U> sphere
    cost: str = "Final"          # "Final" | "Integrated" (ref :655-673)
    pad_factor: float = 1.5      # Dedalus dealias=3/2
    dtype: str = "float64"
    remat: object = True         # True/"step": per-step checkpointing |
                                 # "nested": sqrt(N) two-level | "offload":
                                 # per-step carries in pinned host memory
                                 # | False: store-all
    transform: str = "matmul"    # "matmul" | "fft" | "distributed"
    n_shards: int = 0            # transform="distributed": slab ranks
                                 # (0 = the whole process group)
    mesh_shape: tuple = ()       # transform="distributed": () = 1-D slab;
                                 # (px, py) = 2-D pencil decomposition
    adjoint: str = "discrete"    # "discrete" (autograd) | "continuous"
                                 # (the ref's adjoint system,
                                 # `FWD_Solve_KDyn.py:766-1004`)
    method: str = "plain"        # "plain" | "cuda" (f32 kernels)
    project_gradients: bool = True
    # Leray-project dJ/dB0 and dJ/dU onto divergence-free fields. The
    # reference's adjoint systems solve with div G = div nu = 0 tau
    # constraints, so its gradients are solenoidal and the optimiser
    # stays on the div-free manifold; raw autodiff gradients carry a
    # compressible component (exact for unconstrained perturbations).
    solve_precision: str = "native"
    # "native": the config's dtype | "df64": under dtype="float32", the
    # solve and its reverse sweep in float64 from the f32 state (a no-op
    # under dtype="float64"); discrete adjoint, transform="matmul",
    # method="plain" and remat True/"step"/False only, as in the JAX
    # package
    df_adjoint: bool = False
    # df64 only: the JAX package's hand-written double-float reverse
    # sweep, which lifts its gradient to the f32-output class. The f64
    # reverse sweep is already of that class, so this runs the same sweep.


def _cross(a, b):
    return torch.stack([
        a[1] * b[2] - a[2] * b[1],
        a[2] * b[0] - a[0] * b[2],
        a[0] * b[1] - a[1] * b[0],
    ])


class KinematicDynamo(MeshForms):
    """Two-sphere problem: X = [B (3,m,m,m), U (3,m,m,m)], on `device`
    in `cfg.dtype`."""

    def __init__(self, cfg: KDynConfig = KDynConfig(), device="cuda", mesh=None):
        check_choice("dtype", cfg.dtype, tuple(DTYPES))
        check_choice("method", cfg.method, ("plain", "cuda"))
        check_choice("transform", cfg.transform, ("matmul", "fft", "distributed"))
        check_choice("adjoint", cfg.adjoint, ("discrete", "continuous"))
        check_choice("cost", cfg.cost, ("Final", "Integrated"))
        if cfg.remat not in _REMATS:
            raise ValueError(f"remat must be one of {_REMATS!r}, got {cfg.remat!r}")
        check_choice("solve_precision", cfg.solve_precision, ("native", "df64"))
        # df64 is an f32 accuracy mode; under dtype='float64' it is a no-op
        self._df64 = (cfg.solve_precision == "df64"
                      and cfg.dtype == "float32")
        if self._df64:
            if cfg.adjoint != "discrete":
                raise ValueError(
                    "solve_precision='df64' pairs with adjoint='discrete' "
                    "only (its gradient is the reverse sweep of the f64 "
                    "forward; the continuous adjoint integrates its own "
                    "f32 PDE and would discard the f64 accuracy)")
            if cfg.transform != "matmul":
                raise ValueError(
                    "solve_precision='df64' requires transform='matmul', "
                    "as in the JAX package")
            if cfg.method != "plain":
                raise ValueError(
                    "solve_precision='df64' requires method='plain' (the "
                    "CUDA kernels are closed f32 integrators)")
            if cfg.remat not in (True, "step", False):
                raise ValueError(
                    "solve_precision='df64' supports remat=True|'step'|"
                    f"False (got {cfg.remat!r}), as in the JAX package")
        if cfg.method == "cuda":
            if cfg.dtype != "float32":
                raise ValueError(
                    "method='cuda' runs f32 kernels; use dtype='float32' "
                    "(or method='plain' for f64 runs)")
            if cfg.transform != "matmul":
                raise ValueError(
                    "method='cuda' supports transform='matmul' only")
        self._dist = cfg.transform == "distributed"
        if self._dist:
            if cfg.adjoint != "discrete":
                raise ValueError(
                    "transform='distributed' runs the discrete adjoint only "
                    "(the continuous sweep is not sharded)")
            if cfg.mesh_shape and len(cfg.mesh_shape) != 2:
                raise ValueError(
                    "mesh_shape must be a (px, py) pair for the 2-D "
                    f"pencil decomposition, got {cfg.mesh_shape!r}")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = DTYPES[cfg.dtype]
        n = cfg.npts
        self.mg = int(round(n * cfg.pad_factor))
        self.radii = [cfg.m0, cfg.e0]
        rdtype = np.dtype(cfg.dtype)
        if self._dist:
            self._setup_mesh(mesh)

        # --- numpy constant tensors (the JAX package's expressions) ---
        # For transform="distributed" the coefficient layout is the full
        # oversampled rfftn layout (mg, mg, mg//2+1): truncation becomes a
        # band mask, so the distributed FFT needs no band gather
        M = self.mg if self._dist else n
        kfull = 2 * np.pi * np.fft.fftfreq(M, 1.0 / M) / cfg.length
        kr = 2 * np.pi * np.fft.rfftfreq(M, 1.0 / M) / cfg.length
        nr = M // 2 + 1
        k64 = np.stack(
            [np.broadcast_to(kfull[:, None, None], (M, M, nr)),
             np.broadcast_to(kfull[None, :, None], (M, M, nr)),
             np.broadcast_to(kr[None, None, :], (M, M, nr))]
        )
        self._k = k64.astype(rdtype)
        k2 = self._k2 = (self._k ** 2).sum(axis=0)   # from the rdtype-cast k
        with np.errstate(divide="ignore", invalid="ignore"):
            inv_k2 = np.where(k2 > 0, 1.0 / k2, 0.0)
        self._inv_k2 = inv_k2.astype(rdtype)

        # Nyquist-free keep mask (Dedalus keeps |k| < n/2 of the NPTS
        # band); the mean is zeroed by the step's mean mask. The same
        # retained mode set in both layouts.
        nyq = n // 2
        fidx = np.abs(np.fft.fftfreq(M) * M)
        full_keep = fidx < nyq
        r_keep = np.arange(nr) < nyq
        self._keep = (full_keep[:, None, None] & full_keep[None, :, None]
                      & r_keep[None, None, :])

        # rfftn Hermitian double-count weights for Parseval energies
        wz = np.full(nr, 2.0)
        wz[0] = 1.0
        if M % 2 == 0:
            wz[-1] = 1.0
        self._pw = np.broadcast_to(wz[None, None, :], (M, M, nr)).astype(rdtype)

        # CNAB1 diagonal factors: (1/dt -+ k^2/(2Rm))
        a = 1.0 / cfg.dt
        nu = 1.0 / (2.0 * cfg.rm)
        self._lhs_inv = (1.0 / (a + nu * k2)).astype(rdtype)
        self._rhs_fac = (a - nu * k2).astype(rdtype)

        # per-axis DFT matrices of the matmul transform: grid (mg) ->
        # truncated modes with 1/mg per axis, and back; the z-axis
        # synthesis carries the Hermitian doubling
        cdt = np.complex64 if rdtype == np.float32 else np.complex128
        mg = self.mg
        freqs = np.concatenate([np.arange(0, n // 2 + 1),
                                np.arange(-(n - n // 2 - 1), 0)])
        j = np.arange(mg)
        self._Ff = (np.exp(-2j * np.pi * np.outer(freqs, j) / mg) / mg).astype(cdt)
        self._Fz = (np.exp(-2j * np.pi * np.outer(np.arange(n // 2 + 1), j) / mg)
                    / mg).astype(cdt)
        # (wz_n: the doubling weights of the truncated n-band layout; wz
        # above is the coefficient layout's, the mg grid's when distributed)
        wz_n = np.full(n // 2 + 1, 2.0)
        wz_n[0] = 1.0
        if n % 2 == 0:
            wz_n[-1] = 1.0
        self._Bf = np.exp(2j * np.pi * np.outer(j, freqs) / mg).astype(cdt)
        self._Bz = (np.exp(2j * np.pi * np.outer(j, np.arange(n // 2 + 1)) / mg)
                    * wz_n[None, :]).astype(cdt)

        # --- the same constants on the device (this rank's coefficient
        # shard under transform="distributed") ---
        t, c = self._t, self._local_coeff
        self._kt, self._inv_k2t = t(c(self._k)), t(c(self._inv_k2))
        self._keept, self._pwt = t(c(self._keep)), t(c(self._pw))
        self._lhs_invt, self._rhs_fact = t(c(self._lhs_inv)), t(c(self._rhs_fac))
        self._Fft, self._Fzt = t(self._Ff), t(self._Fz)
        self._Bft, self._Bzt = t(self._Bf), t(self._Bz)
        self._cdtype = self._Fft.dtype
        mean_mask = np.ones((M, M, nr), rdtype)
        mean_mask[0, 0, 0] = 0.0
        self._mean_maskt = t(c(mean_mask))
        self._czero = torch.zeros((), dtype=self._cdtype, device=self.device)
        self._w = 1.0 / self.mg ** 3  # IP weight: sum over comps of grid means

        if cfg.method == "cuda":
            from spheremanopt_torch.ops.cuda.kdyn_step import (
                consts_to_torch, make_consts)

            self._consts = consts_to_torch(make_consts(self), self.device)
        # df64: the f64 twin that runs the solves (same constants as an f64
        # problem, so its gradient cast to f32 is this mode's gradient)
        self._df = (KinematicDynamo(replace(cfg, dtype="float64",
                                            solve_precision="native",
                                            df_adjoint=False), self.device)
                    if self._df64 else None)

    def _t(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(a), device=self.device)

    # ------------------------------------------------------------------
    # transform="distributed": the mesh and this rank's shards
    # ------------------------------------------------------------------

    def _setup_mesh(self, mesh):
        """The process mesh (`mesh`, else one made from the config, in the
        group `init_distributed` starts when there is none) and this
        rank's blocks: the grid's X (and Y for a pencil) block, and the
        coefficients' Y block (slab: the rank; pencil: iy * px + ix, the
        split order of `distributed_rfftn_2d`)."""
        from spheremanopt_torch.parallel.mesh import (init_distributed,
                                                      make_mesh, make_mesh2d)

        cfg, mg = self.cfg, self.mg
        init_distributed(self.device)
        if mesh is None:
            mesh = (make_mesh2d(*cfg.mesh_shape) if cfg.mesh_shape
                    else make_mesh(cfg.n_shards or None))
        self._mesh = mesh
        if cfg.mesh_shape:
            px, py = cfg.mesh_shape
            ix, iy = mesh.get_coordinate()
            self._grid_blocks = ((ix, px), (iy, py))
            cblock = iy * px + ix
        else:
            px, py = mesh.size(), 1
            (ix,) = mesh.get_coordinate()
            self._grid_blocks = ((ix, px),)
            cblock = ix
        P = px * py
        if mg % P:
            raise ValueError(
                f"transform='distributed' needs the grid extent {mg} divisible "
                f"by the {P} ranks (npts={cfg.npts}, pad_factor={cfg.pad_factor})")
        self._cslice = slice(cblock * (mg // P), (cblock + 1) * (mg // P))

    def _local_coeff(self, a):
        """This rank's Y block of a (..., M, M, Mr) coefficient-layout
        array (all of it unless distributed)."""
        return a[..., self._cslice, :] if self._dist else a

    def shard_state(self, x_list):
        """This rank's shards of full (c, mg, mg, mg) state fields (the
        fields themselves unless distributed)."""
        if not self._dist:
            return list(x_list)
        out = []
        for x in x_list:
            x = torch.as_tensor(x)
            for d, (i, p) in enumerate(self._grid_blocks):
                b = x.shape[-3 + d] // p
                x = x.narrow(x.dim() - 3 + d, i * b, b)
            out.append(x.to(self.device).contiguous())
        return out

    @property
    def state_placements(self):
        """DTensor placements of a state field over the mesh."""
        from torch.distributed.tensor import Shard

        if not self._dist:
            raise ValueError("state_placements: transform='distributed' only")
        return (Shard(1), Shard(2)) if self.cfg.mesh_shape else (Shard(1),)

    def gather_state(self, x_list):
        """Full (c, mg, mg, mg) fields from this rank's shards (an all-gather
        over the mesh; the fields themselves unless distributed)."""
        if not self._dist:
            return list(x_list)
        from torch.distributed.tensor import DTensor

        return [DTensor.from_local(x, self._mesh, self.state_placements,
                                   run_check=False).full_tensor() for x in x_list]

    def _sum_ranks(self, x):
        if not self._dist:
            return x
        from spheremanopt_torch.parallel.fft import sum_over_ranks

        return sum_over_ranks(x)

    def _max_ranks(self, x):
        if not self._dist:
            return x
        from spheremanopt_torch.parallel.fft import max_over_ranks

        return max_over_ranks(x)

    # ------------------------------------------------------------------
    # transforms (batched over the leading component axis)
    # ------------------------------------------------------------------

    def to_coeff(self, v_grid: torch.Tensor) -> torch.Tensor:
        """(c, mg, mg, mg) grid -> truncated coeffs (c, n, n, n//2+1);
        distributed: this rank's grid shard -> its band-masked shard of
        the (c, mg, mg, mg//2+1) coefficients."""
        if self._dist:
            from spheremanopt_torch.parallel import fft as pfft

            if self.cfg.mesh_shape:
                c = pfft.distributed_rfftn_2d(v_grid, self._mesh)
            else:
                c = pfft.distributed_rfftn(v_grid, self._mesh)
            return torch.where(self._keept, c / (self.mg ** 3), self._czero)
        if self.cfg.transform == "matmul":
            c = torch.einsum("Zk,...abk->...abZ", self._Fzt,
                             v_grid.to(self._cdtype))
            c = torch.einsum("Yb,...abZ->...aYZ", self._Fft, c)
            c = torch.einsum("Xa,...aYZ->...XYZ", self._Fft, c)
            return torch.where(self._keept, c, self._czero)
        n, mg = self.cfg.npts, v_grid.shape[-1]
        c = torch.fft.rfftn(v_grid, dim=(-3, -2, -1)) / (mg ** 3)
        h = n // 2
        c = torch.cat([c[..., : h + 1, :, :], c[..., -(n - h - 1):, :, :]], dim=-3)
        c = torch.cat([c[..., :, : h + 1, :], c[..., :, -(n - h - 1):, :]], dim=-2)
        c = c[..., :, :, : n // 2 + 1]
        return torch.where(self._keept, c, self._czero)

    def to_grid(self, c: torch.Tensor) -> torch.Tensor:
        """Truncated coeffs -> (c, mg, mg, mg) oversampled grid (this
        rank's shards of each, distributed)."""
        n, mg = self.cfg.npts, self.mg
        if self._dist:
            from spheremanopt_torch.parallel import fft as pfft

            if self.cfg.mesh_shape:
                return pfft.distributed_irfftn_2d(c * (mg ** 3), self._mesh, n_z=mg)
            return pfft.distributed_irfftn(c * (mg ** 3), self._mesh, n_z=mg)
        if self.cfg.transform == "matmul":
            g = torch.einsum("aX,...XYZ->...aYZ", self._Bft, c)
            g = torch.einsum("bY,...aYZ->...abZ", self._Bft, g)
            g = torch.einsum("kZ,...abZ->...abk", self._Bzt, g)
            return g.real
        h = n // 2
        hi = n - h - 1
        out = c.new_zeros(c.shape[:-3] + (mg, mg, mg // 2 + 1))
        out[..., : h + 1, : h + 1, : h + 1] = c[..., : h + 1, : h + 1, :]
        out[..., mg - hi:, : h + 1, : h + 1] = c[..., h + 1:, : h + 1, :]
        out[..., : h + 1, mg - hi:, : h + 1] = c[..., : h + 1, h + 1:, :]
        out[..., mg - hi:, mg - hi:, : h + 1] = c[..., h + 1:, h + 1:, :]
        return torch.fft.irfftn(out * (mg ** 3), s=(mg, mg, mg), dim=(-3, -2, -1))

    # ------------------------------------------------------------------
    # dynamics
    # ------------------------------------------------------------------

    def _energy(self, c: torch.Tensor) -> torch.Tensor:
        """(1/V) int |B|^2 via Parseval over the 3 components (summed over
        the ranks, distributed)."""
        return self._sum_ranks(torch.sum(self._pwt * (c.real ** 2 + c.imag ** 2)))

    def _leray(self, c: torch.Tensor) -> torch.Tensor:
        """Mode-wise projection onto divergence-free fields (the i
        factors cancel in P; inv_k2[0,0,0] = 0)."""
        div = torch.sum(self._kt * c, dim=0)
        return c - self._kt * (div * self._inv_k2t)[None]

    def _induction(self, b_c: torch.Tensor, u_grid: torch.Tensor) -> torch.Tensor:
        """F-hat = i k x (U x B)-hat with padded-grid cross product."""
        e_c = self.to_coeff(_cross(u_grid, self.to_grid(b_c)))
        return 1j * _cross(self._kt, e_c)

    def _cnab1_step(self, b_c: torch.Tensor, u_grid: torch.Tensor,
                    ops: Optional[dict] = None) -> torch.Tensor:
        """CNAB1: (1/dt + k^2/2Rm) B' = (1/dt - k^2/2Rm) B + F, with the
        tau-pressure divergence constraint as Leray projection and the
        mean mode pinned to zero (ref equations :431-440). `ops`
        optionally replaces the Rm-dependent factors {"lhs_inv",
        "rhs_fac"} (see `objective_and_gradient_rm`)."""
        lhs_inv, rhs_fac = ((self._lhs_invt, self._rhs_fact) if ops is None
                            else (ops["lhs_inv"], ops["rhs_fac"]))
        rhs = rhs_fac * b_c + self._induction(b_c, u_grid)
        # lhs_inv[0,0,0] is finite, so the mean mode (k=0) is masked
        return self._leray(rhs) * lhs_inv * self._mean_maskt

    def _remat_step(self, step):
        """`step(b, u)` under the configured trajectory-memory policy: the
        one place that applies it, for `_integrate` and so for the plain
        objective, the fused diagnostics and the Rm route alike. "nested"
        wraps whole chunks in `_integrate` instead."""
        remat = self.cfg.remat
        if remat is True or remat == "step":
            def checkpointed(b, u):
                if torch.is_grad_enabled():
                    return checkpoint(step, b, u, use_reentrant=False)
                return step(b, u)

            return checkpointed
        if remat == "offload":
            return offload_checkpoint(step)
        return step

    def _integrate(self, b0_c, u_grid, n_steps: int, series: bool = False,
                   ops: Optional[dict] = None):
        """(b_T, J) of n_steps of CNAB1, and with `series` the per-step
        energies E(b_0..b_N) of the same solve (the J arithmetic does
        not depend on that flag). The Integrated cost is Kahan-summed,
        or under remat="nested" summed per chunk, then across chunks, as
        `nested_checkpoint_scan` does: J = dt (sum + E(b_N)). Under
        "offload" the per-step energies are offloaded too (their reverse
        needs b_n, which would otherwise stay on the device): b_n's energy
        and its step share one host copy, so b_n's two cotangents meet in
        host memory (with a copy each, one of them would wait on the device
        for the other, as many as the autograd engine's threads let run
        ahead: up to a state a step)."""
        integrated = self.cfg.cost == "Integrated"
        raw_step = (self._cnab1_step if ops is None
                    else (lambda b, u: self._cnab1_step(b, u, ops)))
        step = self._remat_step(raw_step)
        energy = self._energy
        shared = integrated and self.cfg.remat == "offload"

        def step_energy(b):
            """E(b_n) for the sum (recorded) or the series only (not)."""
            if integrated:
                return energy(b)
            with torch.no_grad():
                return self._energy(b)

        if self.cfg.remat == "nested":
            def one(b):
                e = (step_energy(b) if integrated or series
                     else b.real.new_zeros(()))
                return step(b, u_grid), e

            out = nested_checkpoint_scan(one, b0_c, n_steps,
                                         return_series=series)
            b, tot = out[0], out[1]
            eN = self._energy(b)
            J = self.cfg.dt * (tot + eN) if integrated else eN
            if series:
                return b, J, torch.cat([out[2], eN[None]]).detach()
            return b, J

        b = b0_c
        acc = kahan_zero(self.dtype, self.device)
        es = []
        for _ in range(n_steps):
            if shared and torch.is_grad_enabled() and b.requires_grad:
                h = host_copy(b)
                e = checkpoint_on_host(energy, h, b.device)
                es.append(e)
                acc = kahan_add(acc, e)
                b = checkpoint_on_host(raw_step, h, b.device, u_grid)
                continue
            if integrated or series:
                e = step_energy(b)
                es.append(e)
            if integrated:
                acc = kahan_add(acc, e)
            b = step(b, u_grid)
        eN = self._energy(b)
        J = self.cfg.dt * kahan_add(acc, eN)[0] if integrated else eN
        if series:
            return b, J, torch.stack(es + [eN]).detach()
        return b, J

    def _prepare(self, x_list):
        """(B0 coefficients, band-limited U) of a state: U is band-limited
        the way Vec_to_Field + Dedalus products do."""
        b0 = x_list[0].to(self.dtype)
        u = x_list[1].to(self.dtype)
        return self.to_coeff(b0), self.to_grid(self.to_coeff(u))

    def _objective_impl(self, x_list) -> torch.Tensor:
        b0_c, u_bl = self._prepare(x_list)
        if self.cfg.method == "cuda":
            from spheremanopt_torch.ops.cuda.kdyn_step import FusedEnergy

            # whole solve in one kernel (its backward is the hand-derived
            # transposed sweep); the outer transforms stay torch and
            # differentiate as usual. Real planes cross the boundary.
            return -FusedEnergy.apply(
                b0_c.real.contiguous(), b0_c.imag.contiguous(),
                u_bl.contiguous(), self._consts, self.cfg.n_iters,
                self.cfg.cost == "Integrated", self.cfg.dt)
        return -self._integrate(b0_c, u_bl, self.cfg.n_iters)[1]

    def _objective_rm_impl(self, ops, x_list) -> torch.Tensor:
        b0_c, u_bl = self._prepare(x_list)
        return -self._integrate(b0_c, u_bl, self.cfg.n_iters, ops=ops)[1]

    def _objective_aux_impl(self, x_list):
        """(-J, diagnostics) captured from one forward solve — the ME
        series + div-B invariant the reference's GlobalFlowProperty
        monitors track along the FWD solve (`FWD_Solve_KDyn.py:
        608-650,941-973`)."""
        b0_c, u_bl = self._prepare(x_list)
        b, J, energies = self._integrate(b0_c, u_bl, self.cfg.n_iters,
                                         series=True)
        b = b.detach()
        div_b = self._max_ranks(torch.abs(torch.sum(self._kt * b, dim=0)).max())
        return -J, {"magnetic_energy": energies, "max_div_B": div_b,
                    "B_final": self.to_grid(b)}

    # ------------------------------------------------------------------
    # continuous adjoint (ref `FWD_Solve_KDyn.py:766-1004`)
    # ------------------------------------------------------------------

    def _curl_cross(self, a_c: torch.Tensor, b_grid: torch.Tensor) -> torch.Tensor:
        """F(A, B) = (curl A) x B on the padded grid, truncated (the
        reference's F_x/F_y/F_z substitutions, `:841-848`)."""
        w = self.to_grid(1j * _cross(self._kt, a_c))
        return self.to_coeff(_cross(w, b_grid))

    def _gradient_continuous_impl(self, x_list):
        """Continuous adjoint: the reference's 8-variable coupled system
        (`FWD_Solve_KDyn.py:855-895,903-908`), integrated

            dt(G) - (1/Rm) lap G - grad Pi = (curl G) x U [- 2 B_f]
            dt(nu) + grad P = -(curl G) x B_f,   div G = div nu = 0

        backward along the stored forward b_1..b_N (one stacked tensor),
        G(T) = -2 B(T) ("Final") or 0 ("Integrated", with the -2 B_f
        forcing), CNAB1 with Leray projection for G and forward Euler
        with projection for nu, the mean mode pinned. Returns ([dJ/dB0,
        dJ/dU] = [G(0), nu(0)] on the grid, stats): stats (3, N) holds
        max|div G|, max|div nu| and |<G>| after each step, in forward
        time order (t = dt..T). First order in dt; adjoint="discrete"
        is Taylor-exact."""
        cfg = self.cfg
        n = cfg.n_iters
        with torch.no_grad():
            b, u = self._prepare(list(x_list))
            snaps = b.new_empty((n,) + tuple(b.shape))
            for i in range(n):
                b = self._cnab1_step(b, u)
                snaps[i] = b
            integrated = cfg.cost == "Integrated"
            g = torch.zeros_like(b) if integrated else -2.0 * b
            nu = torch.zeros_like(b)
            stats = torch.empty((3, n), dtype=self.dtype, device=self.device)
            for i in range(n - 1, -1, -1):
                bf_c = snaps[i]
                f_g = self._curl_cross(g, u)
                if integrated:
                    f_g = f_g - 2.0 * bf_c
                g_new = (self._leray(self._rhs_fact * g + f_g) * self._lhs_invt
                         * self._mean_maskt)
                # nu has no diffusion: forward Euler + projection
                f_nu = -self._curl_cross(g, self.to_grid(bf_c))
                nu = (nu + cfg.dt * self._leray(f_nu)) * self._mean_maskt
                g = g_new
                # the solenoidality and flux invariants the reference logs
                # every adjoint step (`:941-973`): Leray roundoff
                stats[0, i] = torch.abs(torch.sum(self._kt * g, dim=0)).max()
                stats[1, i] = torch.abs(torch.sum(self._kt * nu, dim=0)).max()
                stats[2, i] = torch.abs(g[:, 0, 0, 0]).max()
            return [self.to_grid(g), self.to_grid(nu)], stats

    # ------------------------------------------------------------------
    # PDE-state restart (ref `IVP_FWD.load_state`, FWD_Solve_SH23.py:459-460)
    # ------------------------------------------------------------------

    def initial_state(self, x_list) -> dict:
        """Induction-solver state at t=0: B spectral coefficients as a
        stacked re/im plane plus the (fixed) band-limited stirring field."""
        with torch.no_grad():
            b_c, u_bl = self._prepare(
                [torch.as_tensor(x, device=self.device) for x in x_list])
        return {"b": torch.stack([b_c.real, b_c.imag]), "u": u_bl}

    def advance_state(self, state: dict, n_steps: int) -> dict:
        if not hasattr(self, "_advance"):
            def step(s):
                b = self._cnab1_step(torch.complex(s["b"][0], s["b"][1]), s["u"])
                return {"b": torch.stack([b.real, b.imag]), "u": s["u"]}

            self._advance = SegmentAdvance(step)
        return self._advance(state, n_steps)

    def state_fields(self, state) -> dict:
        with torch.no_grad():
            b_grid = self.to_grid(torch.complex(state["b"][0], state["b"][1]))
        return {"b_grid": b_grid, "b_hat_ri": state["b"], "u": state["u"]}

    # ------------------------------------------------------------------
    # public triple
    # ------------------------------------------------------------------

    def _riesz(self, raw):
        out = []
        with torch.no_grad():
            for g in raw:
                # in the problem's dtype (a state given in f32 to an f64
                # problem has f32 leaf gradients; the FFT transforms would
                # then project in complex64)
                g = g.to(self.dtype) / self._w
                if self.cfg.project_gradients:
                    g = self.to_grid(self._leray(self.to_coeff(g)))
                out.append(g)
        return out

    def objective(self, x_list):
        if self._df is not None:
            return self._df.objective(to_f64(x_list)).float()
        with torch.no_grad():
            return self._objective_impl(list(x_list))

    def objective_f64(self, x_list) -> float:
        """df64 mode only: -J of the f64 solve as a Python float (the f32
        `objective` rounds it to ~ulp(J), which swamps Taylor remainders
        and fine line-search comparisons)."""
        if self._df is None:
            raise RuntimeError("objective_f64 requires solve_precision='df64'"
                               " with dtype='float32'")
        return float(self._df.objective(to_f64(x_list)))

    def gradient(self, x_list):
        if self._df is not None:
            return [g.float() for g in self._df.gradient(to_f64(x_list))]
        if self.cfg.adjoint == "continuous":
            return self._gradient_continuous_impl(x_list)[0]
        return self.objective_and_gradient(x_list)[1]

    def objective_and_gradient(self, x_list):
        """Fused (J, [dJ/dB0, dJ/dU]). Under adjoint='continuous' there is
        no fused form (the continuous adjoint is its own backward PDE
        integration, not the reverse sweep of the forward), so the mode's
        gradient is paired with `objective`'s J. Under df64, J is the f64
        solve's, as a Python float (host consumers compare it at f64)."""
        if self._df is not None:
            J, g = self._df.objective_and_gradient(to_f64(x_list))
            return float(J), [a.float() for a in g]
        if self.cfg.adjoint == "continuous":
            return (self.objective(x_list),
                    self._gradient_continuous_impl(x_list)[0])
        J, raw = value_and_raw_gradient(self._objective_impl, list(x_list))
        return J, self._riesz(raw)

    def adjoint_diagnostics(self, x_list) -> dict:
        """Invariant monitoring of the continuous-adjoint sweep: the
        per-step max|div G|, max|div nu| and mean flux |<G>| (numpy, in
        forward time order t = dt..T) and the gradient the sweep produced
        (the reference logs them every adjoint step, `FWD_Solve_KDyn.py:
        941-973`). They sit at Leray-projection roundoff; a drift flags a
        broken projector or operator. Requires adjoint='continuous'."""
        if self.cfg.adjoint != "continuous":
            raise ValueError(
                "adjoint_diagnostics monitors the continuous-adjoint "
                "integration; construct with adjoint='continuous' (the "
                "discrete mode's correctness surface is the Taylor test)")
        grads, stats = self._gradient_continuous_impl(x_list)
        stats = stats.cpu().numpy()
        return {
            "adj_sim_time": self.cfg.dt * np.arange(1, self.cfg.n_iters + 1),
            "max_div_G": stats[0],
            "max_div_nu": stats[1],
            "max_flux_G": stats[2],
            "gradient": grads,
        }

    # The device loop's `aux` forms: `objective_and_gradient_aux` is
    # (fg(ops, xs), ops), and `objective_ops` / `gradient_ops` its J-only
    # and gradient-only counterparts. KDyn has no operand stacks: under
    # df64 the pair is (fg, {}) with an f32 0-dim J (the loop's search
    # state is f32); otherwise (None, None), and the loop calls
    # `objective_and_gradient` directly.

    def objective_ops(self, ops, x_list):
        return self.objective(x_list)

    def gradient_ops(self, ops, x_list):
        return self.gradient(x_list)

    @property
    def objective_and_gradient_aux(self):
        if self._df is None:
            return None, None

        def fg(ops, xs):
            J, g = self._df.objective_and_gradient(to_f64(xs))
            return J.float(), [a.float() for a in g]

        return fg, {}

    @property
    def objective_and_gradient_rm(self):
        """(fg(ops, xs), make_ops(rm)): the fused objective and gradient
        with Rm's CNAB1 factors as an operand, the plain step at any
        method, so one device loop (one set of captured graphs) serves
        every magnetic Reynolds number (`examples/kdyn_critical_rm.py`;
        the reference reruns its whole workload per Rm,
        `FWD_Solve_KDyn.py:1028-1036`). `make_ops(rm)` builds the factors
        with the constructor's arithmetic, on the device: at cfg.rm they
        are bitwise the problem's own."""

        def fg(ops, xs):
            J, raw = value_and_raw_gradient(
                lambda xs_: self._objective_rm_impl(ops, xs_), list(xs))
            return J, self._riesz(raw)

        def make_ops(rm: float) -> dict:
            a = 1.0 / self.cfg.dt
            nu = 1.0 / (2.0 * float(rm))
            k2, dtype = self._local_coeff(self._k2), self._lhs_inv.dtype
            return {"lhs_inv": self._t((1.0 / (a + nu * k2)).astype(dtype)),
                    "rhs_fac": self._t((a - nu * k2).astype(dtype))}

        return fg, make_ops

    def inner_product(self, x, y):
        """(1/V) int f . g dV = sum over components of grid means
        (ref `Inner_Prod_3`, `FWD_Solve_KDyn.py:173-181`); distributed,
        this rank's shards' sum, summed over the ranks."""
        if self._dist:
            return self._sum_ranks(torch.sum(x * y)) / self.mg ** 3
        return self.full_inner_product(x, y)

    @staticmethod
    def full_inner_product(x, y):
        """The inner product of full (c, mg, mg, mg) fields."""
        return torch.sum(torch.mean(x * y, dim=(-3, -2, -1)))

    # ------------------------------------------------------------------
    # rows: [B0 (R, 3, mg, mg, mg), U (R, 3, mg, mg, mg)] (see the module
    # docstring)
    # ------------------------------------------------------------------

    def _objective_rows_impl(self, x_list) -> torch.Tensor:
        """-J (R,) of each row: the row kernels on each row's B0
        coefficients and band-limited U, `_prepare`d a row at a time."""
        from spheremanopt_torch.ops.cuda.kdyn_step import FusedEnergyRows

        preps = [self._prepare([b, u]) for b, u in zip(*x_list)]
        return -FusedEnergyRows.apply(
            torch.stack([c.real for c, _ in preps]),
            torch.stack([c.imag for c, _ in preps]),
            torch.stack([u for _, u in preps]), self._consts, self.cfg.n_iters,
            self.cfg.cost == "Integrated", self.cfg.dt)

    def objective_rows(self, x_list):
        with torch.no_grad():
            return self._objective_rows_impl(list(x_list))

    def objective_and_gradient_rows(self, x_list):
        J, raw = value_and_raw_gradient(self._objective_rows_impl, list(x_list))
        per_row = [self._riesz(list(g)) for g in zip(*raw)]
        return J, [torch.stack(g) for g in zip(*per_row)]

    def gradient_rows(self, x_list):
        return self.objective_and_gradient_rows(x_list)[1]

    def inner_product_rows(self, x, y):
        return torch.stack([self.inner_product(a, b) for a, b in zip(x, y)])

    def row_forms(self, aux=False):
        """The native forms over rows: method="cuda" with the discrete
        adjoint (which implies f32, `transform="matmul"`, no df64). None
        elsewhere (the aux forms, the continuous adjoint, "plain", df64,
        the distributed transform): a sweep then runs its rows one at a
        time."""
        if aux or self.cfg.method != "cuda" or self.cfg.adjoint != "discrete":
            return None
        return RowForms(self.objective_and_gradient_rows, self.objective_rows,
                        self.gradient_rows, self.inner_product_rows)

    @property
    def inner_products(self):
        return self.inner_product

    # ------------------------------------------------------------------
    # fused diagnostics: same-solve capture for zero-extra-cost archiving
    # ------------------------------------------------------------------

    @property
    def has_fused_diagnostics(self) -> bool:
        return self.cfg.method != "cuda"

    def _need_fused_diagnostics(self):
        if not self.has_fused_diagnostics:
            raise ValueError(
                "fused diagnostics unavailable for "
                f"method={self.cfg.method!r}, remat={self.cfg.remat!r}")

    def _diag_host(self, diag: dict) -> dict:
        out = dict(diag)
        out["sim_time"] = self.cfg.dt * np.arange(self.cfg.n_iters + 1)
        return out

    def objective_and_diagnostics(self, x_list):
        """(J, diagnostics dict) from ONE forward solve (vs `diagnostics`,
        which re-runs it)."""
        self._need_fused_diagnostics()
        with torch.no_grad():
            J, diag = self._objective_aux_impl(list(x_list))
        return J, self._diag_host(diag)

    def objective_gradient_and_diagnostics(self, x_list):
        """(J, grads, diagnostics) from one fused fwd+bwd solve (under
        adjoint='continuous', the mode's own gradient next to the
        diagnostics-carrying forward, as `objective_and_gradient`)."""
        self._need_fused_diagnostics()
        if self.cfg.adjoint == "continuous":
            J, diag = self.objective_and_diagnostics(x_list)
            return J, self._gradient_continuous_impl(x_list)[0], diag
        out = {}

        def objective(xs):
            J, out["diag"] = self._objective_aux_impl(xs)
            return J

        J, raw = value_and_raw_gradient(objective, list(x_list))
        return J, self._riesz(raw), self._diag_host(out["diag"])

    def diagnostics(self, x_list) -> dict:
        """Per-step magnetic-energy series + div/flux invariants (the
        reference's GlobalFlowProperty monitors, `FWD_Solve_KDyn.py:
        608-650,941-973`) and final fields, from a plain step loop."""
        with torch.no_grad():
            b, u_bl = self._prepare(
                [torch.as_tensor(x, device=self.device) for x in x_list])
            energies = []
            for _ in range(self.cfg.n_iters):
                energies.append(self._energy(b))
                b = self._cnab1_step(b, u_bl)
            energies.append(self._energy(b))
            div_b = self._max_ranks(torch.abs(torch.sum(self._kt * b, dim=0)).max())
            return {
                "sim_time": self.cfg.dt * np.arange(self.cfg.n_iters + 1),
                "magnetic_energy": torch.stack(energies),
                "max_div_B": div_b,
                "B_final": self.to_grid(b),
            }

    # ------------------------------------------------------------------
    # initial conditions (ref `Generate_IC`, :183-317)
    # ------------------------------------------------------------------

    def _curl_of_noise(self, noise: torch.Tensor, frac=0.25) -> torch.Tensor:
        """curl-like combination of filtered-noise potential derivatives
        (ref takes B = curl-ish of (phi_y - phi_z, ...), :240-243)."""
        c = self.to_coeff(self.shard_state([noise[None]])[0])[0]
        # low-pass: keep the lowest `frac` of mode indices per axis (ref
        # filter_field frac=0.25, :30-55), on the coefficient layout (the
        # same retained mode set in the truncated and full layouts)
        n = self.cfg.npts
        M = self.mg if self._dist else n
        idx = np.abs(np.fft.fftfreq(M) * M) / (n // 2)
        idxr = np.arange(M // 2 + 1) / (n // 2)
        keep = ((idx[:, None, None] <= frac) & (idx[None, :, None] <= frac)
                & (idxr[None, None, :] <= frac))
        c = torch.where(self._t(self._local_coeff(keep)), c, self._czero)
        dx, dy, dz = 1j * self._kt[0] * c, 1j * self._kt[1] * c, 1j * self._kt[2] * c
        return self.to_grid(torch.stack([dy - dz, dz - dx, dx - dy]))

    def generate_ic(self, seed: int = 42, u_noise: bool = True,
                    noise: Optional[tuple] = None) -> List[torch.Tensor]:
        """[B0, U] on the two spheres. The noise comes from a CPU
        `torch.Generator` seeded with `seed`, unless `noise` (a pair of
        (mg, mg, mg) arrays for B and U, e.g. the JAX package's
        `jax.random.normal` draws) is given; torch and JAX draw different
        numbers from the same seed.

        B is prep-smoothed by 100 CNAB1 steps at dt=1e-3 (ref :297-302;
        the reference accidentally passes the module globals Rm, dt — a
        known bug that is not replicated). Distributed, every rank draws
        the same full noise and returns its shards."""
        shape = (self.mg,) * 3
        if noise is None:
            gen = torch.Generator(device="cpu").manual_seed(seed)
            noise = [torch.randn(shape, generator=gen, dtype=self.dtype)
                     for _ in range(2)]
        else:
            noise = [torch.tensor(np.asarray(z), dtype=self.dtype) for z in noise]
        if len(noise) != 2 or any(z.shape != shape for z in noise):
            raise ValueError(f"noise must be a pair of {shape} arrays")
        prep = KinematicDynamo(KDynConfig(
            npts=self.cfg.npts, length=self.cfg.length, rm=1.0, dt=1e-3,
            n_iters=100, cost="Final", pad_factor=self.cfg.pad_factor,
            dtype=self.cfg.dtype, remat=False, transform=self.cfg.transform,
            n_shards=self.cfg.n_shards, mesh_shape=self.cfg.mesh_shape,
        ), device=self.device, mesh=getattr(self, "_mesh", None))
        with torch.no_grad():
            b = self._curl_of_noise(noise[0].to(self.device))
            if u_noise:
                u = self._curl_of_noise(noise[1].to(self.device))
            else:
                # Willis-type ABC-like base flow (ref :255-261)
                xs = np.arange(self.mg) * self.cfg.length / self.mg
                X, Y, Z = np.meshgrid(xs, xs, xs, indexing="ij")
                s3 = np.sqrt(3.0)
                u = self.shard_state([self._t(np.stack([
                    0.5 * np.sin(Y) * np.cos(Z) / s3,
                    0.5 * np.sin(Z) * np.cos(X) / s3,
                    0.5 * np.sin(X) * np.cos(Y) / s3,
                ]).astype(np.dtype(self.cfg.dtype)))])[0]
            u = u * torch.sqrt(self.cfg.e0 / self.inner_product(u, u))
            b_c, _ = prep._integrate(prep.to_coeff(b), u, 100)
            b = self.to_grid(b_c)
            b = b * torch.sqrt(self.cfg.m0 / self.inner_product(b, b))
        return [b, u]
