"""Swift-Hohenberg minimal-seed problem, 1D periodic (Fourier).

PyTorch port of the JAX package's `problems/swift_hohenberg.py`
(reference: `Example_Problems/Periodic_Domain(Fourier)/Swift_Hohenberg/
FWD_Solve_SH23.py`). The optimisation is

    max_{u0} J(u0) = int_t int_x |u(x,t)|^2 dx dt
    s.t.  (1/V) int_x u0^2 dx = E0,
          du/dt + (1 + dx^2)^2 u - a*u = 1.8 u^2 - u^3,   a = -0.3,

on x in [0, 12*pi) with 256 Fourier modes, SBDF1 timestepping, and the
Dedalus `dealias=2` convention (nonlinear products on a 2x oversampled
grid; ref `FWD_Solve_SH23.py:202-204`).

Step methods (the same discretisation, bit-for-bit the same operators
as the JAX package):
  * "matmul": the SBDF1 step as one real circulant matrix on the
    oversampled grid, u' = M (u/dt + 1.8u^2 - u^3) (`torch.mv` per step)
  * "fft": state in rfft coefficients, diagonal implicit solve
  * "cuda": the "matmul" step run by the hand-written CUDA kernels of
    `ops/cuda/fused_two_matrix.py` (f32; the counterpart of the JAX
    package's "pallas"); on a CPU tensor it runs their plain versions

Rows (a sweep of R starting points, `row_forms`): "matmul" steps all rows
with one product of R columns a step, so the operator is read once a step
for every row; "fft" transforms the rows together; "cuda" runs the row
kernels (`FusedObjectiveSharedRows`: R forwards in one grid launch, R
reverse clusters in one launch, each row bitwise the one-row kernels), the
counterpart of the JAX package's `jax.vmap` over its "pallas" objective;
its u0 = P x and its inner product are the unbatched call's, taken a row,
so that each row of an f32 sweep is bitwise its unbatched run.
The row kernels take the reverse cluster's widths (n_grid <= 896,
`ops.cuda.fused_two_matrix.rows_width_ok`); at other widths, and for the
continuous adjoint, there is no batched form: a sweep runs the rows one
after another on the unbatched loop.

The fused diagnostics (`objective_and_diagnostics`,
`objective_gradient_and_diagnostics`) record the energy series and the
final state from the optimisation's own solve, every `diag_stride`
steps, with J bitwise the plain objective's.

The gradient is reverse-mode autograd of the discrete forward — the
reference's `Adjoint_type="Discrete"` adjoint — returned as the Riesz
representative under the grid-mean inner product (factor n_grid), or,
with adjoint="continuous", the reference's continuous adjoint: the
adjoint PDE integrated backward along the stored forward trajectory
(first-order accurate in dt; a plain torch path for every method). The
cost J = dt * sum_{n=0..N} (1/V)||u_n||^2 is Kahan-compensated.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from spheremanopt_torch.ops.fourier import (
    FourierBasis1D,
    filter_coeff_fraction,
    nyquist_mask_rfft,
)
from spheremanopt_torch.problems.base import (DTYPES, RowForms,
                                              SegmentAdvance, check_choice,
                                              resolve_device, riesz_gradient,
                                              value_and_raw_gradient)
from spheremanopt_torch.solvers.scan_utils import (kahan_add, kahan_zero,
                                                   strided_energy_scan,
                                                   strided_steps)

@dataclass(frozen=True)
class SH23Config:
    npts: int = 256
    length: float = 12.0 * np.pi
    a: float = -0.3
    dt: float = 0.05
    n_iters: int = 1000          # T/dt with T=50 (ref `__main__`, :752-755)
    e0: float = 0.0725
    pad_factor: float = 2.0      # Dedalus dealias=2
    dtype: str = "float64"
    method: str = "matmul"       # "matmul" | "fft" | "cuda" (f32 kernels)
    adjoint: str = "discrete"    # "discrete" (autodiff-exact, the ref's
                                 # Adjoint_type="Discrete") | "continuous"
                                 # (adjoint-PDE integration, ref :654-656)
    diag_stride: int = 1         # energy-series cadence of the fused
                                 # diagnostics (any >= 1; a short final
                                 # chunk records its start energy and the
                                 # final step is always included);
                                 # `diagnostics()` stays per-step


class SwiftHohenberg:
    """SH23 problem: callable triple + IC generation for the optimiser,
    on `device` in `cfg.dtype`."""

    def __init__(self, cfg: SH23Config = SH23Config(), device="cuda"):
        check_choice("dtype", cfg.dtype, tuple(DTYPES))
        check_choice("method", cfg.method, ("matmul", "fft", "cuda"))
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
        self.basis = FourierBasis1D(cfg.npts, cfg.length, cfg.pad_factor)
        self.radii = [cfg.e0]
        np_dtype = np.dtype(cfg.dtype)

        k = 2.0 * np.pi * np.fft.rfftfreq(cfg.npts, 1.0 / cfg.npts) / cfg.length
        # (1 + dx^2)^2 - a  ->  (1 - k^2)^2 - a in Fourier space
        L = ((1.0 - k * k) ** 2 - cfg.a).astype(np_dtype)
        # Parseval weights for (1/V) int u^2: |c_0|^2 + 2 sum_{k>0} |c_k|^2
        w = np.full(self.basis.n_coeff, 2.0)
        w[0] = 1.0
        self._L = self._t(L)
        self._parseval = self._t(w.astype(np_dtype))

        if cfg.method in ("matmul", "cuda"):
            # Fuse irfft . diag(1/(1/dt+L)) . truncate . rfft into one real
            # circulant matrix: the whole SBDF1 step becomes a single
            # matvec u' = M (u/dt + G(u)) on the oversampled grid, with
            # dealiasing/band-limiting included in M. P = D Q is the
            # band-limit projector applied to raw input vectors. The same
            # numpy code as the JAX package, so M and P agree bitwise.
            mg, K = self.basis.n_grid, self.basis.n_coeff
            eye = np.eye(mg)
            QI = (np.fft.rfft(eye, axis=0)[:K] / mg) * nyquist_mask_rfft(
                cfg.npts
            ).astype(float)[:, None]

            def D_np(cm):
                cp = np.zeros((mg // 2 + 1, mg), complex)
                cp[:K] = cm
                return np.fft.irfft(cp * mg, n=mg, axis=0)

            Ainv = 1.0 / (1.0 / cfg.dt + L.astype(np.float64))
            self._M = D_np(Ainv[:, None] * QI).astype(np_dtype)
            self._P = D_np(QI).astype(np_dtype)
            self._Mt, self._Pt = self._t(self._M), self._t(self._P)
        else:
            self._M = self._P = None

        n_grid = self.basis.n_grid
        if cfg.method == "cuda":
            # the shared-matrix kernel pair: B = M, lin = 1/dt, cost
            # weights = grid mean; u0 = P x stays a matmul outside
            from spheremanopt_torch.ops.cuda.fused_two_matrix import (
                FusedObjectiveShared,
                FusedObjectiveSharedDiag,
                FusedObjectiveSharedRows,
            )

            b32 = self._Mt.float().contiguous()
            w32 = torch.full((n_grid,), 1.0 / n_grid, dtype=torch.float32,
                             device=self.device)
            p32 = self._Pt.float()

            def obj_cuda(xs):
                u0 = torch.matmul(p32, xs[0].float())
                return FusedObjectiveShared.apply(
                    b32, w32, u0, 1.8, -1.0, 1.0 / cfg.dt, cfg.dt,
                    cfg.n_iters, False)

            sidx = torch.as_tensor(strided_steps(cfg.n_iters, cfg.diag_stride),
                                   device=self.device)

            def obj_diag_cuda(xs):
                u0 = torch.matmul(p32, xs[0].float())
                J, ser, uT = FusedObjectiveSharedDiag.apply(
                    b32, w32, u0, 1.8, -1.0, 1.0 / cfg.dt, cfg.dt,
                    cfg.n_iters, False)
                return J, {"kinetic_energy": ser[sidx], "u_final": uT}

            def obj_rows_cuda(xs):
                # row r: P x_r by obj_cuda's own product (a matrix-vector
                # product a row, not one product of R columns), so that each
                # row's u0, J and gradient are bitwise its unbatched call's
                u0 = torch.stack([torch.matmul(p32, x) for x in xs[0].float()])
                return FusedObjectiveSharedRows.apply(
                    b32, w32, u0, 1.8, -1.0, 1.0 / cfg.dt, cfg.dt, cfg.n_iters)

            self._objective_impl = obj_cuda
            self._objective_aux_impl = obj_diag_cuda
            self._objective_rows_impl = obj_rows_cuda
            # the JAX pallas path scales by n_grid in both gradient forms
            self._gradient = lambda xs: [
                g * n_grid for g in value_and_raw_gradient(obj_cuda, xs)[1]]
        else:
            self._gradient = riesz_gradient(self._objective_impl,
                                            [1.0 / n_grid])

    def _t(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a, device=self.device)

    # ------------------------------------------------------------------
    # dynamics
    # ------------------------------------------------------------------

    def _energy(self, c: torch.Tensor) -> torch.Tensor:
        """(1/V) int u^2 dx via Parseval (exact for the retained band)."""
        return torch.sum(self._parseval * (c.real ** 2 + c.imag ** 2))

    def _nonlinear(self, c: torch.Tensor) -> torch.Tensor:
        """N(u) = 1.8 u^2 - u^3 on the oversampled grid, truncated back."""
        u = self.basis.to_grid(c)
        return self.basis.to_coeff(1.8 * u * u - u * u * u)

    def _sbdf1_step(self, c: torch.Tensor) -> torch.Tensor:
        """SBDF1: (1/dt + L) u^{n+1} = u^n/dt + N(u^n); L diagonal."""
        dt = self.cfg.dt
        rhs = c / dt + self._nonlinear(c)
        return rhs / (1.0 / dt + self._L)

    def _matmul_step(self, u: torch.Tensor) -> torch.Tensor:
        """SBDF1 step as one matvec: u' = M (u/dt + 1.8u^2 - u^3)."""
        rhs = u / self.cfg.dt + 1.8 * u * u - u * u * u
        return torch.mv(self._Mt, rhs)

    def _matmul_rows_step(self, u: torch.Tensor) -> torch.Tensor:
        """`_matmul_step` of R states held as the columns of u (mg, R)."""
        rhs = u / self.cfg.dt + 1.8 * u * u - u * u * u
        return torch.mm(self._Mt, rhs)

    def _integrate(self, s0, n_steps: int, use_matmul: bool, rows: bool = False):
        """Run n_steps of SBDF1, accumulating J = dt * sum_n E(u_n)
        (energies of u_0..u_{n_steps}; Euler quadrature per ref :528-529).

        State is rfft coefficients ("fft" path) or band-limited
        oversampled grid values ("matmul" path; E = grid mean of u^2).
        With `rows`, R states at once: the grid values as the columns of
        (mg, R), the coefficients as the rows of (R, K); J is (R,)."""
        if rows:
            step = self._matmul_rows_step if use_matmul else self._sbdf1_step
            energy = ((lambda u: torch.mean(u * u, 0)) if use_matmul
                      else (lambda c: torch.sum(self._parseval * (c.real ** 2
                                                                  + c.imag ** 2), -1)))
        else:
            step = self._matmul_step if use_matmul else self._sbdf1_step
            energy = (lambda u: torch.mean(u * u)) if use_matmul else self._energy
        s = s0
        acc = kahan_zero(self.dtype, self.device)
        for _ in range(n_steps):
            acc = kahan_add(acc, energy(s))
            s = step(s)
        acc = kahan_add(acc, energy(s))
        return s, self.cfg.dt * acc[0]

    def _objective_impl(self, x_list) -> torch.Tensor:
        """Returns -J (the reference maximises by minimising -J, :545)."""
        x = x_list[0].to(self.dtype)
        if self.cfg.method == "matmul":
            u0 = torch.mv(self._Pt, x)
            _, J = self._integrate(u0, self.cfg.n_iters, True)
        else:
            c0 = self.basis.to_coeff(x)
            _, J = self._integrate(c0, self.cfg.n_iters, False)
        return -J

    def _objective_rows_impl(self, x_list) -> torch.Tensor:
        """-J of each row of x_list[0] (R, n_grid), (R,)."""
        x = x_list[0].to(self.dtype)
        if self.cfg.method == "matmul":
            _, J = self._integrate(torch.mm(self._Pt, x.T), self.cfg.n_iters,
                                   True, rows=True)
        else:
            _, J = self._integrate(self.basis.to_coeff(x), self.cfg.n_iters,
                                   False, rows=True)
        return -J

    def _integrate_aux(self, s0, n_steps: int, use_matmul: bool):
        """`_integrate` that also records the energy series from the SAME
        solve, every `diag_stride` steps; J matches the plain path
        bitwise."""
        step = self._matmul_step if use_matmul else self._sbdf1_step
        energy = (lambda u: torch.mean(u * u)) if use_matmul else self._energy
        return strided_energy_scan(step, energy, s0, n_steps,
                                   self.cfg.diag_stride, self.dtype,
                                   self.cfg.dt)

    def _objective_aux_impl(self, x_list):
        """(-J, diagnostics) from ONE forward solve — the fused-capture
        analogue of the reference's shared forward trajectory feeding
        both the cost and the 'scalar_data' handler
        (`FWD_Solve_SH23.py:478-483,499-503`)."""
        x = x_list[0].to(self.dtype)
        if self.cfg.method == "matmul":
            u0 = torch.mv(self._Pt, x)
            u_final, J, energies = self._integrate_aux(u0, self.cfg.n_iters, True)
        else:
            c0 = self.basis.to_coeff(x)
            c, J, energies = self._integrate_aux(c0, self.cfg.n_iters, False)
            u_final = self.basis.to_grid(c)
        return -J, {"kinetic_energy": energies.detach(),
                    "u_final": u_final.detach()}

    def _gradient_continuous(self, x_list):
        """Continuous-adjoint gradient (ref `ADJ_Solve_IVP_Lin` with
        Adjoint_type='Continuous', `FWD_Solve_SH23.py:632-656,717-719`):
        integrate dt(q) + Lap(q) - a q = (3.6 uf - 3 uf^2) q - 2 uf
        backward along the stored forward trajectory u_1..u_N with
        q(T) = 0, SBDF1 in reverse. First-order accurate in dt (Taylor
        order 2 plateaus at the discretisation error; adjoint='discrete'
        is exact)."""
        dt = self.cfg.dt
        with torch.no_grad():
            c = self.basis.to_coeff(x_list[0].to(self.dtype))
            q = torch.zeros_like(c)
            snaps = []
            for _ in range(self.cfg.n_iters):
                c = self._sbdf1_step(c)
                snaps.append(c)   # u_1..u_N: the adjoint consumes u_N..u_1
            for uf_c in reversed(snaps):
                uf = self.basis.to_grid(uf_c)
                qg = self.basis.to_grid(q)
                rhs_nl = self.basis.to_coeff((3.6 * uf - 3.0 * uf * uf) * qg
                                             - 2.0 * uf)
                q = (q / dt + rhs_nl) / (1.0 / dt + self._L)
            return [self.basis.to_grid(q)]

    # ------------------------------------------------------------------
    # public triple
    # ------------------------------------------------------------------

    def objective(self, x_list):
        with torch.no_grad():
            return self._objective_impl(list(x_list))

    def gradient(self, x_list):
        if self.cfg.adjoint == "continuous":
            return self._gradient_continuous(list(x_list))
        return self._gradient(list(x_list))

    def objective_and_gradient(self, x_list):
        """One fused forward+backward (J, Riesz gradient) — the
        reference's FWD-then-ADJ-with-shared-trajectory pattern
        (`FWD_Solve_SH23.py:499-503` fill / `:688` consume). Under
        adjoint='continuous' there is no fused form (the continuous
        adjoint is its own backward PDE integration, not the reverse of
        the discrete forward), so the mode's gradient is paired with a
        separate forward: the Wolfe search's fused phi never mixes the
        two gradient definitions."""
        if self.cfg.adjoint == "continuous":
            return (self.objective(x_list),
                    self._gradient_continuous(list(x_list)))
        J, raw = value_and_raw_gradient(self._objective_impl, list(x_list))
        return J, [g * self.basis.n_grid for g in raw]

    def inner_product(self, x, y):
        return torch.mean(x * y)

    @property
    def inner_products(self):
        return self.inner_product

    # -- rows: (R, n_grid) states (see the module docstring) ---------------

    def objective_rows(self, x_list):
        with torch.no_grad():
            return self._objective_rows_impl(list(x_list))

    def gradient_rows(self, x_list):
        raw = value_and_raw_gradient(self._objective_rows_impl, list(x_list))[1]
        if self.cfg.method == "cuda":   # as the unbatched cuda gradient
            return [g * self.basis.n_grid for g in raw]
        return [g / (1.0 / self.basis.n_grid) for g in raw]

    def objective_and_gradient_rows(self, x_list):
        J, raw = value_and_raw_gradient(self._objective_rows_impl, list(x_list))
        return J, [g * self.basis.n_grid for g in raw]

    def inner_product_rows(self, x, y):
        if self.cfg.method == "cuda":
            # the unbatched inner product a row, as SHB23's: each f32 kernel
            # row then makes its unbatched run's decisions bit for bit
            return torch.stack([self.inner_product(a, b) for a, b in zip(x, y)])
        return torch.mean(x * y, -1)

    def row_forms(self, aux=False):
        """The native forms over rows, or None where this configuration has
        none: the continuous adjoint, and "cuda" at widths without row
        kernels (chosen by shape, the same on every device)."""
        if aux or self.cfg.adjoint == "continuous":
            return None
        if self.cfg.method == "cuda":
            from spheremanopt_torch.ops.cuda.fused_two_matrix import rows_width_ok

            if not rows_width_ok(self.basis.n_grid, two_matrix=False):
                return None
        return RowForms(self.objective_and_gradient_rows, self.objective_rows,
                        self.gradient_rows, self.inner_product_rows)

    # ------------------------------------------------------------------
    # fused diagnostics: the energy series and final state from the
    # optimisation's own solve
    # ------------------------------------------------------------------

    has_fused_diagnostics = True

    def _diag_host(self, x_list, diag: dict) -> dict:
        out = dict(diag)
        out["sim_time"] = self.cfg.dt * strided_steps(self.cfg.n_iters,
                                                      self.cfg.diag_stride)
        out["x_grid"] = self.basis.grid()
        out["u_initial"] = x_list[0]
        return out

    def objective_and_diagnostics(self, x_list):
        """(J, diagnostics dict) from ONE forward solve (vs `diagnostics`,
        which re-runs it)."""
        with torch.no_grad():
            J, diag = self._objective_aux_impl(list(x_list))
        return J, self._diag_host(x_list, diag)

    def objective_gradient_and_diagnostics(self, x_list):
        """(J, Riesz gradient, diagnostics) from one fused fwd+bwd solve
        (under adjoint='continuous', the mode's own gradient beside the
        diagnostics-carrying forward, as in `objective_and_gradient`)."""
        if self.cfg.adjoint == "continuous":
            J, diag = self.objective_and_diagnostics(x_list)
            return J, self._gradient_continuous(list(x_list)), diag
        out = {}

        def objective(xs):
            J, out["diag"] = self._objective_aux_impl(xs)
            return J

        J, raw = value_and_raw_gradient(objective, list(x_list))
        return (J, [g * self.basis.n_grid for g in raw],
                self._diag_host(x_list, out["diag"]))

    def final_state(self, x_list) -> torch.Tensor:
        """u(x, T) on the oversampled grid (for diagnostics/plots)."""
        with torch.no_grad():
            c0 = self.basis.to_coeff(self._as_state(x_list[0]))
            c, _ = self._integrate(c0, self.cfg.n_iters, False)
            return self.basis.to_grid(c)

    def diagnostics(self, x_list) -> dict:
        """Per-step KE series, initial/final states and final spectrum —
        the reference's 'scalar_data' + 'CheckPoints' analysis tasks
        (`FWD_Solve_SH23.py:478-483`)."""
        with torch.no_grad():
            c0 = self.basis.to_coeff(self._as_state(x_list[0]))
            c, _, energies = strided_energy_scan(
                self._sbdf1_step, self._energy, c0, self.cfg.n_iters, 1,
                self.dtype, self.cfg.dt)
            return {
                "sim_time": self.cfg.dt * np.arange(self.cfg.n_iters + 1),
                "kinetic_energy": energies,
                "x_grid": self.basis.grid(),
                "u_initial": self.basis.to_grid(c0),
                "u_final": self.basis.to_grid(c),
                "u_hat_final": c.cpu().numpy(),
            }

    # ------------------------------------------------------------------
    # PDE-state restart (ref `IVP_FWD.load_state`, FWD_Solve_SH23.py:459-460)
    # ------------------------------------------------------------------

    def _as_state(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=self.dtype, device=self.device)

    def initial_state(self, x_list) -> dict:
        """Solver state at t=0 from the optimisation vector: rfft
        coefficients as a stacked re/im plane (real)."""
        with torch.no_grad():
            c = self.basis.to_coeff(self._as_state(x_list[0]))
            return {"c": torch.stack([c.real, c.imag])}

    def advance_state(self, state: dict, n_steps: int) -> dict:
        """Advance the solver state n_steps; composable and restartable:
        advance(s, a+b) == advance(advance(s, a), b) exactly."""
        if not hasattr(self, "_advance"):
            def step(s):
                c = self._sbdf1_step(torch.complex(s["c"][0], s["c"][1]))
                return {"c": torch.stack([c.real, c.imag])}

            self._advance = SegmentAdvance(step)
        return self._advance(state, n_steps)

    def state_fields(self, state) -> dict:
        """Named real fields for saving/plotting a solver state."""
        with torch.no_grad():
            u = self.basis.to_grid(torch.complex(state["c"][0], state["c"][1]))
        return {"u": u, "u_hat_ri": state["c"]}

    # ------------------------------------------------------------------
    # initial conditions (ref Generate_IC, `FWD_Solve_SH23.py:174-236`)
    # ------------------------------------------------------------------

    def generate_ic(self, seed: int = 42, e0: Optional[float] = None,
                    noise: Optional[np.ndarray] = None) -> List[torch.Tensor]:
        """Seeded filtered noise, prep-smoothed 100 steps of dt=1e-2,
        renormalised onto the sphere (ref :174-236 and
        `FWD_Solve_IVP_PREP` :334-407).

        The noise comes from a CPU `torch.Generator` seeded with `seed`,
        unless `noise` (n_grid values, e.g. the JAX package's
        `jax.random.normal` draw) is given; torch and JAX draw different
        numbers from the same seed."""
        e0 = self.cfg.e0 if e0 is None else e0
        n_grid = self.basis.n_grid
        if noise is None:
            gen = torch.Generator(device="cpu").manual_seed(seed)
            noise = torch.randn(n_grid, generator=gen, dtype=self.dtype)
        else:
            noise = torch.tensor(np.asarray(noise), dtype=self.dtype)
        noise = noise.to(self.device)
        if noise.shape != (n_grid,):
            raise ValueError(f"noise must have shape ({n_grid},), "
                             f"got {tuple(noise.shape)}")
        # prep smoothing: 100 SBDF1 steps at dt=1e-2
        prep = SwiftHohenberg(
            SH23Config(
                npts=self.cfg.npts, length=self.cfg.length, a=self.cfg.a,
                dt=1e-2, n_iters=100, e0=e0, pad_factor=self.cfg.pad_factor,
                dtype=self.cfg.dtype, method="fft",
            ),
            device=self.device,
        )

        def norm(c, target):
            return c * torch.sqrt(target / self._energy(c))

        with torch.no_grad():
            c = filter_coeff_fraction(self.basis.to_coeff(noise), self.cfg.npts, 0.5)
            c = norm(c, e0)
            c, _ = prep._integrate(c, 100, False)
            return [self.basis.to_grid(norm(c, e0))]
