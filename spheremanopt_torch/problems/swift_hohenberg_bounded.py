"""Swift-Hohenberg on a bounded domain (Chebyshev, mixed BCs).

PyTorch port of the JAX package's `problems/swift_hohenberg_bounded.py`
(reference: `Example_Problems/Bounded_Domain(Cheby)/Swift_Hohenberg_Bounded/
FWD_Solve_SHB23.py`). The optimisation is

    max_{u0} J = int_t (1/V) int_z |u|^2 dz dt
    s.t.  (1/V) int_z u0^2 dz = M0,
          du/dt + (1 + dz^2)^2 u - a u = 2 u^2 - u^3,    a = -0.1,
          dz(u) = dz^3(u) = 0 at z = -20;  u = dz^2(u) = 0 at z = +20,

SBDF1 stepping on the Chebyshev roots grid. The default config follows
the reference's Discrete mode (`__main__` :967-979): Npts = 512 grid
points, dt = 0.01, T = 20, M0 = 0.0019, top-half coefficient zeroing of
the nonlinear term (`:583-585`), and the trapezoid-weight inner product
(`weightMatrixDisc` + `Inner_Prod_Discrete`, `:69-81,156-193`).

The scalar Chebyshev-tau solve of the 4th-order operator is factorised
once in f64 numpy and folded with both transforms into two dense
grid-space propagators, u' = A_lin u + A_nl g(u), g(u) = 2u^2 - u^3 —
the JAX package's numpy code, so the operators are bitwise the same.

Step methods:
  * "matmul": two `torch.mv` per step (f32 or f64)
  * "cuda": the two-matrix CUDA kernels of `ops/cuda/fused_two_matrix.py`
    (f32; the counterpart of the JAX package's "pallas"); on a CPU
    tensor they run their plain versions

Gradients: adjoint="discrete" is reverse-mode autograd of the discrete
forward (or the kernels' reverse sweep), returned as the Riesz
representative raw / w; adjoint="continuous" integrates the adjoint PDE
backward (ref `ADJ_Solve_IVP_Cnts`), first order in dt.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from spheremanopt_torch.ops.chebyshev import ChebyshevBasis1D
from spheremanopt_torch.problems.base import (MeshForms, DTYPES, SegmentAdvance,
                                              check_choice, resolve_device,
                                              value_and_raw_gradient)
from spheremanopt_torch.solvers.scan_utils import (kahan_add, kahan_zero,
                                                   strided_energy_scan,
                                                   strided_steps)

C2, C3 = 2.0, -1.0   # g(u) = 2 u^2 - u^3


@dataclass(frozen=True)
class SHB23Config:
    npts: int = 512              # Discrete mode: 256 * dealias (ref :974-976)
    z0: float = -20.0
    z1: float = 20.0
    a: float = -0.1
    dt: float = 0.01
    n_iters: int = 2000          # T = 20 (ref :978)
    m0: float = 0.0019
    dtype: str = "float64"
    dealias_frac: float = 0.5    # zero coefficients with n >= frac * N
    adjoint: str = "discrete"    # "discrete" | "continuous"
    method: str = "matmul"       # "matmul" | "cuda" (f32 kernels)
    diag_stride: int = 1         # energy-series cadence of the fused
                                 # diagnostics (any >= 1; `diagnostics()`
                                 # stays per-step)


class SwiftHohenbergBounded(MeshForms):
    """SHB23 problem: callable triple + IC generation for the optimiser,
    on `device` in `cfg.dtype`."""

    def __init__(self, cfg: SHB23Config = SHB23Config(), device="cuda"):
        check_choice("dtype", cfg.dtype, tuple(DTYPES))
        check_choice("method", cfg.method, ("matmul", "cuda"))
        check_choice("adjoint", cfg.adjoint, ("discrete", "continuous"))
        if cfg.diag_stride < 1:
            raise ValueError(f"diag_stride={cfg.diag_stride} must be >= 1")
        if cfg.method == "cuda" and cfg.dtype != "float32":
            raise ValueError(
                "method='cuda' runs f32 kernels; use dtype='float32' "
                "(or method='matmul' for f64 runs)")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = DTYPES[cfg.dtype]
        self.basis = ChebyshevBasis1D(cfg.npts, cfg.z0, cfg.z1)
        self.radii = [cfg.m0]
        np_dtype = np.dtype(cfg.dtype)
        n, b = cfg.npts, self.basis

        # --- tau system (f64 numpy, init-time only; the JAX package's code) ---
        d2 = b.deriv_matrix(2)
        d4 = b.deriv_matrix(4)
        L = (1.0 / cfg.dt + 1.0 - cfg.a) * np.eye(n) + 2.0 * d2 + d4
        M_tau = np.zeros((n, n))
        M_tau[: n - 4] = L[: n - 4]          # first N-4 equation rows
        M_tau[n - 4] = b.boundary_row("left", 1)    # dz(u)(-20)   = 0
        M_tau[n - 3] = b.boundary_row("left", 3)    # dz^3(u)(-20) = 0
        M_tau[n - 2] = b.boundary_row("right", 0)   # u(+20)       = 0
        M_tau[n - 1] = b.boundary_row("right", 2)   # dz^2(u)(+20) = 0

        E = np.eye(n)
        E[n - 4:] = 0.0                      # BC rows get zero rhs
        Z = np.diag(b.dealias_mask(cfg.dealias_frac))
        Minv_E = np.linalg.solve(M_tau, E)

        V, A = b.synthesis, b.analysis
        self._A_lin = (V @ Minv_E @ A / cfg.dt).astype(np_dtype)
        self._A_nl = (V @ Minv_E @ Z @ A).astype(np_dtype)
        self._resid = float(np.abs(M_tau @ Minv_E - E).max())

        # inner-product weights pair with the adjoint mode, as the
        # reference's Inner_Prod alias switch (`FWD_Solve_SHB23.py:951-965`):
        # discrete -> trapezoid, continuous -> Clenshaw-Curtis
        vol = cfg.z1 - cfg.z0
        if cfg.adjoint == "continuous":
            self._w = (b.clenshaw_curtis_weights / vol).astype(np_dtype)
        else:
            self._w = (b.trapezoid_weights / vol).astype(np_dtype)

        self._Alt, self._Ant = self._t(self._A_lin), self._t(self._A_nl)
        self._wt = self._t(self._w)

        if cfg.method == "cuda":
            from spheremanopt_torch.ops.cuda.fused_two_matrix import (
                FusedObjective,
                FusedObjectiveDiag,
            )

            a32 = self._Alt.float().contiguous()
            b32 = self._Ant.float().contiguous()
            w32 = self._wt.float().contiguous()
            sidx = torch.as_tensor(strided_steps(cfg.n_iters, cfg.diag_stride),
                                   device=self.device)

            def obj_cuda(xs):
                return FusedObjective.apply(a32, b32, w32, xs[0].float(), C2, C3,
                                            cfg.dt, cfg.n_iters, False)

            def obj_diag_cuda(xs):
                J, ser, uT = FusedObjectiveDiag.apply(
                    a32, b32, w32, xs[0].float(), C2, C3, cfg.dt, cfg.n_iters,
                    False)
                return J, {"kinetic_energy": ser[sidx], "u_final": uT}

            self._objective_dispatch = obj_cuda
            self._objective_aux_dispatch = obj_diag_cuda
        else:
            self._objective_dispatch = self._objective_impl
            self._objective_aux_dispatch = self._objective_aux_impl

    def _t(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a, device=self.device)

    # ------------------------------------------------------------------
    # dynamics
    # ------------------------------------------------------------------

    def _step(self, u: torch.Tensor) -> torch.Tensor:
        """SBDF1 via the precomputed grid-space propagators (tau solve +
        BCs + dealiasing folded in)."""
        g = 2.0 * u * u - u * u * u
        return torch.mv(self._Alt, u) + torch.mv(self._Ant, g)

    def _energy(self, u: torch.Tensor) -> torch.Tensor:
        return torch.sum(self._wt * u * u)

    def _integrate(self, u0: torch.Tensor, n_steps: int):
        """cost = dt * sum_{i=0..n_steps} IP(u_i, u_i): the i=0 term plus
        one per solve (ref `FWD_Solve_IVP_Discrete` :627-665)."""
        u = u0
        acc = kahan_zero(self.dtype, self.device)
        for _ in range(n_steps):
            acc = kahan_add(acc, self._energy(u))
            u = self._step(u)
        acc = kahan_add(acc, self._energy(u))
        return u, self.cfg.dt * acc[0]

    def _objective_impl(self, x_list) -> torch.Tensor:
        _, J = self._integrate(x_list[0].to(self.dtype), self.cfg.n_iters)
        return -J

    def _objective_aux_impl(self, x_list):
        """(-J, diagnostics) from one forward solve (the fused analogue of
        the reference's scalar_data handler riding the forward
        trajectory, `FWD_Solve_SHB23.py:604-676`); J is bitwise the
        plain path's."""
        u, J, energies = strided_energy_scan(
            self._step, self._energy, x_list[0].to(self.dtype),
            self.cfg.n_iters, self.cfg.diag_stride, self.dtype, self.cfg.dt)
        return -J, {"kinetic_energy": energies.detach(), "u_final": u.detach()}

    def _gradient_continuous_impl(self, x_list):
        """Continuous adjoint (ref `ADJ_Solve_IVP_Cnts`,
        `FWD_Solve_SHB23.py:685-795`): dt(q) + (1-a)q + 2 qzz + qzzzz =
        (4 uf - 3 uf^2) q - 2 uf with the same BCs, q(T) = 0, SBDF1 in
        reverse through the stored trajectory. First-order in dt."""
        with torch.no_grad():
            u = x_list[0].to(self.dtype)
            snaps = []
            for _ in range(self.cfg.n_iters):
                u = self._step(u)
                snaps.append(u)      # u_1..u_N; the adjoint consumes u_N..u_1
            q = torch.zeros_like(u)
            for uf in reversed(snaps):
                h = (4.0 * uf - 3.0 * uf * uf) * q - 2.0 * uf
                q = torch.mv(self._Alt, q) + torch.mv(self._Ant, h)
        return [q]

    # ------------------------------------------------------------------
    # PDE-state restart (ref `IVP_FWD.load_state`, FWD_Solve_SH23.py:459-460)
    # ------------------------------------------------------------------

    def initial_state(self, x_list) -> dict:
        return {"u": torch.as_tensor(x_list[0], dtype=self.dtype,
                                     device=self.device)}

    def advance_state(self, state: dict, n_steps: int) -> dict:
        """Advance the solver state n_steps; advance(s, a+b) ==
        advance(advance(s, a), b) exactly."""
        if not hasattr(self, "_advance"):
            self._advance = SegmentAdvance(lambda s: {"u": self._step(s["u"])})
        return self._advance(state, n_steps)

    def state_fields(self, state) -> dict:
        return {"u": state["u"]}

    # ------------------------------------------------------------------
    # public triple
    # ------------------------------------------------------------------

    def objective(self, x_list):
        with torch.no_grad():
            return self._objective_dispatch(list(x_list))

    def _discrete_gradient(self, x_list):
        J, raw = value_and_raw_gradient(self._objective_dispatch, list(x_list))
        return J, [raw[0] / self._wt.to(raw[0].dtype)]

    def gradient(self, x_list):
        if self.cfg.adjoint == "continuous":
            return self._gradient_continuous_impl(list(x_list))
        return self._discrete_gradient(x_list)[1]

    def objective_and_gradient(self, x_list):
        """Fused (J, gradient); under adjoint='continuous' there is no
        fused form (the continuous adjoint is its own backward PDE
        integration, not the VJP of the discrete forward), so the mode's
        gradient is paired with a separate forward."""
        if self.cfg.adjoint == "continuous":
            return self.objective(x_list), self.gradient(x_list)
        return self._discrete_gradient(x_list)

    def inner_product(self, x, y):
        return torch.sum(self._wt * x * y)

    @property
    def inner_products(self):
        return self.inner_product

    # ------------------------------------------------------------------
    # fused diagnostics: the energy series and final state from the
    # optimisation's own solve
    # ------------------------------------------------------------------

    has_fused_diagnostics = True

    def _diag_host(self, x_list, diag: dict) -> dict:
        out = dict(diag)
        out["sim_time"] = self.cfg.dt * strided_steps(self.cfg.n_iters,
                                                      self.cfg.diag_stride)
        out["z_grid"] = self.basis.grid
        out["u_initial"] = x_list[0]
        return out

    def objective_and_diagnostics(self, x_list):
        """(J, diagnostics dict) from ONE forward solve (vs `diagnostics`,
        which re-runs it)."""
        with torch.no_grad():
            J, diag = self._objective_aux_dispatch(list(x_list))
        return J, self._diag_host(x_list, diag)

    def objective_gradient_and_diagnostics(self, x_list):
        """(J, grads, diagnostics) from one fused fwd+bwd solve (or, under
        adjoint='continuous', the mode's own gradient next to the
        diagnostics-carrying forward)."""
        if self.cfg.adjoint == "continuous":
            J, diag = self.objective_and_diagnostics(x_list)
            return J, self.gradient(x_list), diag
        out = {}

        def objective(xs):
            J, out["diag"] = self._objective_aux_dispatch(xs)
            return J

        J, raw = value_and_raw_gradient(objective, list(x_list))
        return (J, [raw[0] / self._wt.to(raw[0].dtype)],
                self._diag_host(x_list, out["diag"]))

    def final_state(self, x_list) -> torch.Tensor:
        with torch.no_grad():
            u, _ = self._integrate(torch.as_tensor(x_list[0], dtype=self.dtype,
                                                   device=self.device),
                                   self.cfg.n_iters)
        return u

    def diagnostics(self, x_list) -> dict:
        """Per-step KE series + initial/final states (the reference's
        scalar_data/CheckPoints payloads, `FWD_Solve_SHB23.py:604-676`)."""
        u0 = torch.as_tensor(x_list[0], dtype=self.dtype, device=self.device)
        with torch.no_grad():
            u, _, energies = strided_energy_scan(
                self._step, self._energy, u0, self.cfg.n_iters, 1, self.dtype,
                self.cfg.dt)
        return {
            "sim_time": self.cfg.dt * np.arange(self.cfg.n_iters + 1),
            "kinetic_energy": energies,
            "z_grid": self.basis.grid,
            "u_initial": u0,
            "u_final": u,
        }

    # ------------------------------------------------------------------
    # initial conditions (ref Generate_IC :194-268: filtered noise,
    # prep-smooth 100 steps of dt=1e-2, normalise onto the sphere)
    # ------------------------------------------------------------------

    def generate_ic(self, seed: int = 42, m0: Optional[float] = None,
                    noise: Optional[np.ndarray] = None) -> List[torch.Tensor]:
        """The noise comes from a CPU `torch.Generator` seeded with `seed`,
        unless `noise` (npts values, e.g. the JAX package's
        `jax.random.normal` draw) is given; torch and JAX draw different
        numbers from the same seed."""
        m0 = self.cfg.m0 if m0 is None else m0
        npts = self.cfg.npts
        if noise is None:
            gen = torch.Generator(device="cpu").manual_seed(seed)
            noise = torch.randn(npts, generator=gen, dtype=self.dtype)
        else:
            noise = torch.tensor(np.asarray(noise), dtype=self.dtype)
        if noise.shape != (npts,):
            raise ValueError(f"noise must have shape ({npts},), "
                             f"got {tuple(noise.shape)}")
        prep = SwiftHohenbergBounded(
            SHB23Config(npts=npts, z0=self.cfg.z0, z1=self.cfg.z1,
                        a=self.cfg.a, dt=1e-2, n_iters=100, m0=m0,
                        dtype=self.cfg.dtype, dealias_frac=self.cfg.dealias_frac),
            device=self.device)
        # low-pass projector (filter frac=0.25 in Discrete mode): numpy
        keep = (np.arange(npts) < 0.25 * npts).astype(float)
        lowpass = self._t((self.basis.synthesis @ np.diag(keep)
                           @ self.basis.analysis).astype(np.dtype(self.cfg.dtype)))
        with torch.no_grad():
            u = torch.mv(lowpass, noise.to(self.device))
            u, _ = prep._integrate(u, 100)
            return [u * torch.sqrt(m0 / self._energy(u))]
