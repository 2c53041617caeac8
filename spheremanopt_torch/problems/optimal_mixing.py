"""Marcotte-Caulfield optimal mixing: 2D Boussinesq in a channel.

PyTorch port of the JAX package's `problems/optimal_mixing.py`
(reference: `Example_Problems/Bounded_Domain(Cheby)/Optimal_Mixing/
FWD_Solve_Poiseuille.py`). The optimisation over the initial
perturbation velocity (u0, w0) of plane Poiseuille flow U(z) = 1 - z^2 is

  s=0:  max   J = (1/2) int_t (1/V) int |u|^2 dV dt   (time-avg KE)
  s=1:  min   J = (1/2) (1/V) int |grad psi|^2 dV,  lap psi = rho(T)
        (the mix-norm ||grad^-1 rho(T)||^2, ref :1052-1117)
  s.t.  (1/V) int |u0|^2 = E0  and the linearised-about-base-flow
        advection-diffusion system (ref :824-844), stepped by implicit
        Euler (SBDF1) of the full linear operator with the nonlinear
        advection explicit; rho(0) = -erf(z/delta)/2.

The realisation:
  * per-kx Chebyshev-tau block systems over (u, w, rho, p) [+ Fb at
    kx=0] are assembled and inverted once in f64 numpy (the JAX
    package's code, so the stacks are bitwise the same) and kept in an
    on-disk cache (`utils/opcache.py`); the reduced solution operators
    S[kx] : (rhs_u, rhs_w, rhs_rho) -> (u, w, rho) live on the device as
    complex tensors in their two Chebyshev-parity blocks (kxn, 2, h, h),
    so each implicit step is one batched complex product that streams
    half the dense operator's bytes
  * the state is a real tensor of coefficient planes (kxn, 2, 3, nz):
    kx mode, (real, imaginary), field (u, w, rho), Chebyshev mode. The
    transforms are dense matmuls (rfft-layout DFT in x, Chebyshev cosine
    in z) with 3/2-oversampled products, every field of a step in one
    product a stage
  * the discrete gradient is reverse-mode autograd of that forward
    (`remat=True`: each step checkpointed); adjoint="continuous"
    integrates the reference's adjoint system (`ADJ_Solve_Cnts`)
    backward along the stored trajectory

Rows (a sweep of R starting points, `row_forms`): the forward solve
takes a state of R rows, (R, 2, mgx, mgz), as planes (kxn, 2, R, 3, nz)
and returns J of each row (R,). A step keeps its launches whatever R is:
its transforms are the same products with R times the columns, and its
implicit solve multiplies each operator block by R right-hand sides, so
the operator stacks, one operand shared by every row, are read once a
step for all of them. The continuous adjoint and df64 have no batched
form: a sweep runs their rows one after another on the unbatched loop.

`solve_precision` is "native" (the config's dtype) or "df64": with
dtype="float32", the JAX package's f64 accuracy mode (there a
double-float emulation, `mixing_df.py`, which the TPU needs for lack of
f64) runs the solve and its reverse sweep in torch.float64 on an f64
twin of the problem, from the f32 state, and returns the JAX package's
forms (an f32 `objective`, `objective_f64`, f32 gradients); diagnostics,
archiving and IC prep stay on the f32 solve, as JAX runs them
"compensated". JAX's TPU pass modes (bf16 and compensated products) and
the emulation's knobs (`df_n_bits`, `df_slice_dtype`,
`df_batched_einsums`) have no counterpart. At f32 the inner product
accumulates in f64 (the role of JAX's `df_dot`).
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.autograd.forward_ad as fwAD
from scipy.special import erf
from torch.utils.checkpoint import checkpoint

from spheremanopt_torch.ops.chebyshev import ChebyshevBasis1D
from spheremanopt_torch.problems.base import (MeshForms, DTYPES, RowForms,
                                              SegmentAdvance, check_choice,
                                              resolve_device, to_f64,
                                              value_and_raw_gradient)
from spheremanopt_torch.solvers.scan_utils import kahan_add, kahan_zero
from spheremanopt_torch.utils.opcache import cached_arrays, source_digest


@dataclass(frozen=True)
class MixingConfig:
    nx: int = 256                # Fourier modes in x (ref `__main__` :1746)
    nz: int = 128                # Chebyshev modes in z
    lx: float = 4.0 * np.pi
    reynolds: float = 500.0
    richardson: float = 0.05
    prandtl: float = 1.0
    dt: float = 5e-3
    n_iters: int = 1000          # T = 5
    e0: float = 0.02
    delta: float = 0.125         # erf buoyancy layer width (ref :1758)
    s: int = 1                   # 0: KE maximisation, 1: mix-norm min
    pad_factor: float = 1.5
    dtype: str = "float64"
    remat: bool = True           # per-step checkpointing | store-all
    adjoint: str = "discrete"    # "discrete" (autograd) | "continuous"
                                 # (the ref's ADJ_Solve_Cnts system,
                                 # `FWD_Solve_Poiseuille.py:1161-1319`)
    prep_steps: int = 100        # IC prep: LINEAR solve iterations
    prep_dt: float = 1e-4        # (ref FWD_Solve_IVP_Prep :520)
    solve_precision: str = "native"
                                 # "native" | "df64": under dtype="float32",
                                 # the solve and its reverse sweep in
                                 # float64 from the f32 state (a no-op under
                                 # dtype="float64"); discrete adjoint only
    df_adjoint: bool = False     # df64 only: the JAX package's hand-written
                                 # double-float reverse sweep, which lifts
                                 # its gradient to the f32-output class; the
                                 # f64 reverse sweep is already of that
                                 # class, so this runs the same sweep


def _cheb_mult_T(coeffs_of_factor: np.ndarray, n: int) -> np.ndarray:
    """Exact coefficient-space multiplication matrix for a polynomial
    factor given by Chebyshev coefficients: T_m T_k = (T_{m+k} + T_|m-k|)/2,
    truncated to n modes (how Dedalus applies NCCs like U(z) = 1 - z^2)."""
    M = np.zeros((n, n))
    for m, cm in enumerate(coeffs_of_factor):
        if cm == 0.0:
            continue
        for k in range(n):
            if m + k < n:
                M[m + k, k] += 0.5 * cm
            if abs(m - k) < n:
                M[abs(m - k), k] += 0.5 * cm
    return M


def _block_solve(A, E, col_a, bc_pairs):
    """Solve A X = E by exact parity decoupling: two half-size LU solves
    instead of one.

    Every tau-system ingredient maps Chebyshev parity exactly, and the
    boundary rows pair up: rows r1, r2 of each `bc_pairs` entry have zero
    rhs in E, so replacing them by (r1+r2, r1-r2) is an invertible row
    operation that leaves the solution unchanged while making each BC
    row pure-parity. `col_a` is the boolean class-A column mask (u_even,
    w_odd, rho_odd, p_even). Row and rhs classes are derived from the
    recombined matrix and verified; any structure violation returns None
    and the caller falls back to the full solve."""
    Aw = A.copy()
    for r1, r2 in bc_pairs:
        if E[r1].any() or E[r2].any():
            return None
        Aw[r1], Aw[r2] = A[r1] + A[r2], A[r1] - A[r2]
    col_b = ~col_a
    rows_a = ~Aw[:, col_b].any(axis=1)
    rows_b = ~Aw[:, col_a].any(axis=1)
    if not (rows_a ^ rows_b).all():          # every row pure, none zero
        return None
    if rows_a.sum() != col_a.sum():
        return None
    zero_cols = ~E.any(axis=0)
    cols_ea = ~E[rows_b].any(axis=0) & ~zero_cols
    cols_eb = ~E[rows_a].any(axis=0) & ~zero_cols
    if not (cols_ea | cols_eb | zero_cols).all():
        return None                          # an rhs column mixes classes
    X = np.zeros((A.shape[0], E.shape[1]), A.dtype)
    for rows, cols_v, cols_e in ((rows_a, col_a, cols_ea),
                                 (rows_b, col_b, cols_eb)):
        iv, ie = np.where(cols_v)[0], np.where(cols_e)[0]
        X[np.ix_(iv, ie)] = np.linalg.solve(
            Aw[np.ix_(np.where(rows)[0], iv)],
            E[np.ix_(np.where(rows)[0], ie)])
    return X


class OptimalMixing(MeshForms):
    """Mixing problem: X = [(2, mgx, mgz) velocity grid fields (u, w)],
    on `device` in `cfg.dtype`. `operators` (numpy "S", "MN" and, for
    adjoint="continuous", "SA": e.g. `convert.mixing_operators` of either
    package's problem) replaces the assembly."""

    def __init__(self, cfg: MixingConfig = MixingConfig(), device="cuda",
                 operators: Optional[Dict[str, np.ndarray]] = None):
        check_choice("dtype", cfg.dtype, tuple(DTYPES))
        check_choice("adjoint", cfg.adjoint, ("discrete", "continuous"))
        check_choice("s", cfg.s, (0, 1))
        check_choice("remat", cfg.remat, (True, False))
        check_choice("solve_precision", cfg.solve_precision, ("native", "df64"))
        self._df64 = (cfg.solve_precision == "df64"
                      and cfg.dtype == "float32")
        if self._df64 and cfg.adjoint != "discrete":
            raise ValueError(
                "solve_precision='df64' pairs with adjoint='discrete' (its "
                "gradient is the reverse sweep of the f64 forward; the "
                "continuous adjoint integrates its own PDE at the config's "
                "precision)")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = DTYPES[cfg.dtype]
        rdtype = np.dtype(cfg.dtype)
        self._cnp = np.complex128 if rdtype == np.float64 else np.complex64
        nx, nz = cfg.nx, cfg.nz
        kxn = self.kxn = nx // 2 + 1
        mgx = self.mgx = int(round(nx * cfg.pad_factor))
        mgz = self.mgz = int(round(nz * cfg.pad_factor))
        self.radii = [cfg.e0]

        self.zbasis = ChebyshevBasis1D(nz, -1.0, 1.0)
        zfull = ChebyshevBasis1D(mgz, -1.0, 1.0)
        self._zgrid = zfull.grid

        # --- transform matrices (the JAX package's numpy expressions) ---
        j = np.arange(mgx)
        kxi = np.arange(kxn)
        Fx64 = np.exp(-2j * np.pi * np.outer(kxi, j) / mgx) / mgx
        wx = np.full(kxn, 2.0)
        wx[0] = 1.0
        self._xmask = np.ones(kxn)
        if nx % 2 == 0:
            self._xmask[-1] = 0.0  # Nyquist of the nx-band
        Bx64 = np.exp(2j * np.pi * np.outer(j, kxi) / mgx) * wx[None, :]
        Az64 = zfull.analysis[:nz].astype(np.float64)               # (nz, mgz)
        Vz64 = np.asarray(zfull.synthesis[:, :nz], np.float64)      # (mgz, nz)
        self._Dz_np = self.zbasis.diff_matrix                       # (nz, nz)
        self._kx = (2.0 * np.pi * kxi / cfg.lx).astype(np.float64)
        # the exact f64 transforms, for regridding and the exports
        self._Fx64, self._Bx64, self._Az64, self._Vz64 = Fx64, Bx64, Az64, Vz64

        # the same matrices on the plane layout (kx, re|im) of the state:
        # x analysis rows (k, re|im) with the Nyquist mask folded in, and
        # the real part of the x synthesis, Re(Bx) a - Im(Bx) b
        t = self._t
        fx2 = np.stack([Fx64.real, Fx64.imag], 1) * self._xmask[:, None, None]
        self._Fx2 = t(fx2.reshape(2 * kxn, mgx).astype(rdtype))
        self._Bx2 = t(np.stack([Bx64.real, -Bx64.imag], 2)
                      .reshape(mgx, 2 * kxn).astype(rdtype))
        self._AzT = t(Az64.T.astype(rdtype))                        # (mgz, nz)
        self._VzT = t(Vz64.T.astype(rdtype))                        # (nz, mgz)
        self._DzT = t(self._Dz_np.T.astype(rdtype))                 # (nz, nz)
        # dx on planes: (a, b) -> (-kx b, kx a), i.e. flip(re|im) * kxs
        self._kxs = t(np.stack([-self._kx, self._kx], 1)
                      .astype(rdtype)[:, :, None, None])
        # wall evaluation T_n(-1), T_n(+1) (the BC-residual monitor)
        self._ends = t(np.stack([(-1.0) ** np.arange(nz), np.ones(nz)], 1)
                       .astype(rdtype))
        self._a0 = 1.0 / cfg.dt

        # --- per-kx implicit solve operators ---
        if operators is None:
            S, MN = self._build_operators()
            SA = (self._build_operators(adjoint=True, build_mixnorm=False)[0]
                  if cfg.adjoint == "continuous" else None)
        else:
            S, MN = operators["S"], operators["MN"]
            SA = operators.get("SA")
            if cfg.adjoint == "continuous" and SA is None:
                SA = self._build_operators(adjoint=True, build_mixnorm=False)[0]
        self._S_np, self._MN_np = S, MN   # exact f64 operators
        perm = self._parity_perm()
        self._perm = torch.as_tensor(perm, device=self.device)
        self._iperm = torch.as_tensor(np.argsort(perm), device=self.device)
        self._ops = {"S": self._put_blocked(S), "MN": self._put(MN)}
        if SA is not None:
            self._ops["SA"] = self._put_blocked(SA)

        # Inner-product weights, paired with the adjoint mode as the
        # reference pairs them (`FWD_Solve_Poiseuille.py:1730-1740`):
        # discrete -> rectangle rule (weightMatrixDisc :91-117),
        # continuous -> Clenshaw-Curtis in z x mean in x (Inner_Prod_Cnts).
        vol = cfg.lx * 2.0
        dx = cfg.lx / mgx
        z = self._zgrid
        if cfg.adjoint == "continuous":
            wz = zfull.clenshaw_curtis_weights
        else:
            wz = np.empty(mgz)
            wz[0] = z[1] - z[0]
            wz[1:] = z[1:] - z[:-1]
        w64 = self._w64 = np.broadcast_to(wz[None, :], (mgx, mgz)) * dx / vol
        self._w = t(w64.astype(rdtype))
        self._w_acc = self._w.double()   # f32 inner products sum in f64

        # rho(0) = -erf(z/delta)/2, truncated to the nz band (ref :920-925)
        rho0_grid = np.broadcast_to(-0.5 * erf(z / cfg.delta)[None, :],
                                    (mgx, mgz))
        self._rho0_c64 = (np.einsum("nz,kz->kn", Az64,
                                    np.einsum("kj,jz->kz", Fx64, rho0_grid))
                          * self._xmask[:, None])
        rho0_c = self._rho0_c64.astype(self._cnp)
        self._rho0 = t(np.stack([rho0_c.real, rho0_c.imag], 1)[:, :, None, :])
        # df64: the f64 twin that runs the solves, on the same f64 numpy
        # operators (so its gradient cast to f32 is this mode's gradient)
        self._df = (OptimalMixing(replace(cfg, dtype="float64",
                                          solve_precision="native",
                                          df_adjoint=False), self.device,
                                  operators={"S": S, "MN": MN})
                    if self._df64 else None)

    def _t(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(a), device=self.device)

    # ------------------------------------------------------------------
    # operator assembly (init-time, f64 numpy)
    # ------------------------------------------------------------------

    def _parity_perm(self) -> np.ndarray:
        """The order of the (u, w, rho)-stacked 3 nz coefficients in the two
        parity families: A = (u[::2], w[1::2], rho[1::2]), then B = the
        complements. `_solve` and `_put_blocked` share it."""
        nz = self.cfg.nz
        ev, od = np.arange(0, nz, 2), np.arange(1, nz, 2)
        return np.concatenate([ev, nz + od, 2 * nz + od,
                               od, nz + ev, 2 * nz + ev])

    def _put(self, a: np.ndarray) -> torch.Tensor:
        return self._t(np.asarray(a).astype(self._cnp))

    def _put_blocked(self, a: np.ndarray) -> torch.Tensor:
        """An S-type stack as its two parity blocks (kxn, 2, h, h) on the
        device; the full (kxn, m, m) form if the decoupling does not hold
        numerically (never expected with the U = 1 - z^2 base flow)."""
        a = np.asarray(a)
        m = 3 * self.cfg.nz
        if self.cfg.nz % 2 or a.shape[1:] != (m, m):
            return self._put(a)
        perm, h = self._parity_perm(), m // 2
        ap = a[:, perm][:, :, perm]
        off = max(np.abs(ap[:, :h, h:]).max(), np.abs(ap[:, h:, :h]).max())
        if off > 1e-11 * max(np.abs(ap).max(), 1e-300):
            return self._put(a)
        return self._put(np.stack([ap[:, :h, :h], ap[:, h:, h:]], axis=1))

    def _build_operators(self, adjoint: bool = False, dt: float = None,
                         build_mixnorm: bool = True):
        """Content-keyed disk cache around `_build_operators_uncached`;
        disable with SMO_OP_CACHE=0."""
        cfg = self.cfg
        key = dict(problem="mixing", nx=cfg.nx, nz=cfg.nz, lx=cfg.lx,
                   reynolds=cfg.reynolds, richardson=cfg.richardson,
                   prandtl=cfg.prandtl,
                   dt=float(cfg.dt if dt is None else dt),
                   adjoint=bool(adjoint), build_mixnorm=bool(build_mixnorm),
                   code=_OP_BUILDER_DIGEST)
        S, MN = cached_arrays(
            key,
            lambda: self._build_operators_uncached(adjoint, dt,
                                                   build_mixnorm),
            ("S", "MN"))
        return S, MN

    def _build_operators_uncached(self, adjoint: bool = False,
                                  dt: float = None,
                                  build_mixnorm: bool = True):
        cfg = self.cfg
        nz = cfg.nz
        I = np.eye(nz)  # noqa: E741
        D1 = self._Dz_np
        D2 = D1 @ D1
        # U = 1 - z^2 = T0/2 - T2/2 ; U' = -2z = -2 T1  (exact Chebyshev)
        U_c = np.zeros(nz); U_c[0] = 0.5; U_c[2] = -0.5   # noqa: E702
        Up_c = np.zeros(nz); Up_c[1] = -2.0               # noqa: E702
        MU = _cheb_mult_T(U_c, nz)
        MUp = _cheb_mult_T(Up_c, nz)
        b = self.zbasis
        row_left = b.boundary_row("left", 0)
        row_right = b.boundary_row("right", 0)
        row_dz_left = b.boundary_row("left", 1)
        row_dz_right = b.boundary_row("right", 1)
        # integral row: int_-1^1 T_n dz
        nn = np.arange(nz)
        q = np.zeros(nz)
        q[nn % 2 == 0] = 2.0 / (1.0 - nn[nn % 2 == 0].astype(float) ** 2)

        re_inv = 1.0 / cfg.reynolds
        pe_inv = 1.0 / (cfg.reynolds * cfg.prandtl)
        ri = cfg.richardson
        a0 = 1.0 / (cfg.dt if dt is None else dt)

        def solve_block(kx, mixnorm=False):
            ikx = 1j * kx
            if mixnorm:
                # lap psi (+Fpsi at kx=0) = rho; psi_z(+-1)=0; integ gauge
                extra = 1 if kx == 0.0 else 0
                A = np.zeros((nz + extra, nz + extra), complex)
                lap = D2 - kx * kx * I
                A[: nz - 2, :nz] = lap[: nz - 2]
                if extra:
                    A[: nz - 2, nz] = np.eye(nz)[: nz - 2, 0]  # +Fpsi (T0 col)
                A[nz - 2, :nz] = row_dz_left
                if kx == 0.0:
                    A[nz - 1, :nz] = q          # integ(psi) = 0
                    A[nz, :nz] = row_dz_right   # extra eq row for Fpsi dof
                else:
                    A[nz - 1, :nz] = row_dz_right
                # rhs rho injects into equation rows 0..nz-3
                E = np.zeros((nz + extra, nz), complex)
                E[: nz - 2, : nz - 2] = np.eye(nz - 2)
                X = None
                if kx != 0.0:
                    X = _block_solve(A, E, np.arange(nz) % 2 == 0,
                                     [(nz - 2, nz - 1)])
                if X is None:
                    X = np.linalg.solve(A, E)
                return X[:nz]  # psi coefficients

            # variables [u, w, rho, p] (+Fb at kx=0)
            nv = 4 * nz + (1 if kx == 0.0 else 0)
            A = np.zeros((nv, nv), complex)
            sl = {v: slice(i * nz, (i + 1) * nz) for i, v in enumerate("uwrp")}

            lap_re = re_inv * (D2 - kx * kx * I)
            lap_pe = pe_inv * (D2 - kx * kx * I)
            adv = ikx * MU

            r = 0
            # the continuous-adjoint operator (ref :1220-1228): base-flow
            # advection and the pressure gradient flip sign, the Uz and Ri
            # couplings transpose
            adv_s = -adv if adjoint else adv
            psign = -1.0 if adjoint else 1.0
            # momentum-u rows (nz-2) + BCs u(+-1)=0
            A[r: r + nz - 2, sl["u"]] = (a0 * I - lap_re + adv_s)[: nz - 2]
            if not adjoint:
                A[r: r + nz - 2, sl["w"]] = MUp[: nz - 2]
            A[r: r + nz - 2, sl["p"]] = (psign * ikx * I)[: nz - 2]
            r += nz - 2
            # momentum-w rows; at kx = 0 keep nz-1 rows (one tau)
            nw = nz - 2 if kx != 0.0 else nz - 1
            A[r: r + nw, sl["w"]] = (a0 * I - lap_re + adv_s)[:nw]
            if adjoint:
                A[r: r + nw, sl["u"]] = MUp[:nw]       # + u_adj * Uz
            else:
                A[r: r + nw, sl["r"]] = (ri * I)[:nw]  # + rho * Ri
            A[r: r + nw, sl["p"]] = (psign * D1)[:nw]
            r += nw
            # density rows (nz-2)
            A[r: r + nz - 2, sl["r"]] = (a0 * I - lap_pe + adv_s)[: nz - 2]
            if adjoint:
                A[r: r + nz - 2, sl["w"]] = (ri * I)[: nz - 2]  # + Ri w_adj
            if kx == 0.0:
                A[r: r + nz - 2, 4 * nz] = np.eye(nz)[: nz - 2, 0]  # +Fb
            r += nz - 2
            # continuity rows; at kx = 0 the last row is identically zero,
            # so drop it and pin w(+1) = 0 explicitly
            ncont = nz if kx != 0.0 else nz - 1
            A[r: r + ncont, sl["u"]] = (ikx * I)[:ncont]
            A[r: r + ncont, sl["w"]] = D1[:ncont]
            r += ncont
            # boundary/gauge rows
            A[r, sl["u"]] = row_left;  r += 1   # noqa: E702
            A[r, sl["u"]] = row_right; r += 1   # noqa: E702
            A[r, sl["w"]] = row_left;  r += 1   # noqa: E702
            if kx == 0.0:
                A[r, sl["p"]] = q          # integ(p) = 0 gauge (no w(+1))
            else:
                A[r, sl["w"]] = row_right
            r += 1
            A[r, sl["r"]] = row_dz_left;  r += 1   # noqa: E702
            A[r, sl["r"]] = row_dz_right; r += 1   # noqa: E702
            if kx == 0.0:
                A[r, sl["r"]] = q          # integ(rho) = 0 (Fb's equation)
                r += 1
            assert r == nv, (r, nv)

            # rhs (u, w, rho) inject into their tau-truncated equation rows
            E = np.zeros((nv, 3 * nz), complex)
            E[: nz - 2, : nz - 2] = np.eye(nz - 2)                      # rhs_u
            E[nz - 2: nz - 2 + nw, nz: nz + nw] = np.eye(nw)            # rhs_w
            off = nz - 2 + nw
            E[off: off + nz - 2, 2 * nz: 2 * nz + nz - 2] = np.eye(nz - 2)
            X = None
            if kx != 0.0:
                # parity split (u_e, w_o, rho_o, p_e | complements); BC
                # rows pair up at (4nz-6 .. 4nz-1)
                ev = np.arange(nz) % 2 == 0
                col_a = np.concatenate([ev, ~ev, ~ev, ev])
                b0 = 4 * nz - 6
                X = _block_solve(A, E, col_a,
                                 [(b0, b0 + 1), (b0 + 2, b0 + 3),
                                  (b0 + 4, b0 + 5)])
            if X is None:
                X = np.linalg.solve(A, E)
            return X[: 3 * nz]  # (u, w, rho) out

        S = np.stack([solve_block(kx) for kx in self._kx])
        S[~self._xmask.astype(bool)] = 0.0
        if not build_mixnorm:
            return S, None
        MN = np.stack([solve_block(kx, mixnorm=True) for kx in self._kx])
        MN[~self._xmask.astype(bool)] = 0.0
        return S, MN

    # ------------------------------------------------------------------
    # transforms. Planes: (kxn, 2, F, nz) real, (kx, re|im, field, mode);
    # grids: (mgx, F, mgz). Over rows, planes (kxn, 2, R, F, nz) and grids
    # (mgx, R, F, mgz): the field axis is always the one before the last
    # ------------------------------------------------------------------

    def _analysis(self, g: torch.Tensor) -> torch.Tensor:
        """(mgx, [R,] F, mgz) grid fields -> (kxn, 2, [R,] F, nz) coefficient
        planes."""
        c = (self._Fx2 @ g.reshape(self.mgx, -1)).view(-1, self.mgz) @ self._AzT
        return c.view((self.kxn, 2) + g.shape[1:-1] + (self.cfg.nz,))

    def _synthesis(self, p: torch.Tensor) -> torch.Tensor:
        """(kxn, 2, [R,] F, nz) coefficient planes -> (mgx, [R,] F, mgz) grid
        fields."""
        g = (p.reshape(-1, self.cfg.nz) @ self._VzT).view(2 * self.kxn, -1)
        return (self._Bx2 @ g).view((self.mgx,) + p.shape[2:-1] + (self.mgz,))

    def _dx(self, p):
        return p.flip(1) * self._kxs.view(self._kxs.shape[:2] + (1,) * (p.dim() - 2))

    def _dz(self, p):
        return p @ self._DzT

    def to_coeff(self, g: torch.Tensor) -> torch.Tensor:
        """Grid (..., mgx, mgz) -> complex coefficients (..., kxn, nz)."""
        lead = g.shape[:-2]
        p = self._analysis(g.to(self.dtype).reshape(-1, self.mgx, self.mgz)
                           .transpose(0, 1))
        c = torch.complex(p[:, 0], p[:, 1]).transpose(0, 1)
        return c.reshape(lead + (self.kxn, self.cfg.nz))

    def to_grid(self, c: torch.Tensor) -> torch.Tensor:
        """Complex coefficients (..., kxn, nz) -> grid (..., mgx, mgz)."""
        lead = c.shape[:-2]
        c = c.reshape(-1, self.kxn, self.cfg.nz).transpose(0, 1)
        g = self._synthesis(torch.stack([c.real, c.imag], 1))
        return g.transpose(0, 1).reshape(lead + (self.mgx, self.mgz))

    # ------------------------------------------------------------------
    # dynamics on the planes state X = (kxn, 2, [R,] 3, nz): fields
    # (u, w, rho)
    # ------------------------------------------------------------------

    def _solve(self, op: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
        """Apply a per-kx solve operator to planes (kxn, 2, [R,] F, nz):
        each operator block times the R rows' right-hand sides as R
        columns. A parity-blocked op (kxn, 2, h, h) takes the (u, w, rho)
        rhs in its family order: family A = (u even, w odd, rho odd), B =
        the mirror. The output is in the config's dtype (complex products
        of the config's complex dtype)."""
        kxn = rhs.shape[0]
        R = rhs.shape[2] if rhs.dim() == 5 else 1
        r = rhs.reshape(kxn, 2, R, -1)
        if op.dim() == 4:
            r = r.index_select(3, self._perm)
            c = torch.complex(r[:, 0], r[:, 1]).view(kxn, R, 2, -1)
            # (kxn, 2, h, R); one state's is the plain view (R columns in
            # a permuted layout would change the product's summation)
            c = c.permute(0, 2, 3, 1) if rhs.dim() == 5 else c.view(kxn, 2, -1, 1)
            out = (op @ c).permute(0, 3, 1, 2).reshape(kxn, R, -1)
            out = out.index_select(2, self._iperm)
        else:
            c = torch.complex(r[:, 0], r[:, 1])               # (kxn, R, m)
            out = (op @ c.transpose(1, 2)).transpose(1, 2)
        return torch.stack([out.real, out.imag], 1).view(rhs.shape)

    def _nonlinear(self, x: torch.Tensor) -> torch.Tensor:
        """to_coeff((u.grad)(u, w, rho)) on the 3/2 grid, as planes: the
        grids of u, w and of dx, dz of each field in one synthesis."""
        g = self._synthesis(torch.cat([x[..., :2, :], self._dx(x), self._dz(x)], -2))
        adv = torch.addcmul(g[..., 0:1, :] * g[..., 2:5, :], g[..., 1:2, :],
                            g[..., 5:8, :])
        return self._analysis(adv)

    def _step(self, ops, x: torch.Tensor) -> torch.Tensor:
        """rhs = state/dt - (u.grad)state; one batched per-kx tau solve."""
        return self._solve(ops["S"], self._a0 * x - self._nonlinear(x))

    def _remat_step(self, ops, x):
        """One step under the configured trajectory-memory policy. A step
        whose state carries forward-mode tangents (RTR's Hessian-vector
        products) stores its intermediates: torch.utils.checkpoint has no
        forward-mode rule before torch 2.13 (its input saver is an
        autograd.Function without a jvp)."""
        if (self.cfg.remat and torch.is_grad_enabled()
                and fwAD.unpack_dual(x).tangent is None):
            return checkpoint(self._step, ops, x, use_reentrant=False,
                              preserve_rng_state=False)
        return self._step(ops, x)

    def _grid_energy(self, g):
        """(1/V) int (a^2 + b^2) of the two grid fields g (mgx, [R,] 2,
        mgz): a 0-dim tensor, or one value a row (R,)."""
        e = g[..., 0, :] * g[..., 0, :] + g[..., 1, :] * g[..., 1, :]
        if e.dim() == 2:
            return torch.sum(self._w * e)
        return torch.sum(self._w[:, None] * e, (0, 2))

    def _ke(self, x):
        """(1/V) int (u^2 + w^2): the rectangle-rule IP on the grid
        (the reference's Inner_Prod_Discrete, `:282-299`)."""
        return self._grid_energy(self._synthesis(x[..., :2, :]))

    def _de(self, x):
        """(1/V) int rho^2: the buoyancy-variance series."""
        rg = self._synthesis(x[:, :, 2:3])[:, 0]
        return torch.sum(self._w * rg * rg)

    def _mixnorm(self, ops, x):
        psi = self._solve(ops["MN"], x[..., 2:3, :])
        return 0.5 * self._grid_energy(
            self._synthesis(torch.cat([self._dx(psi), self._dz(psi)], -2)))

    def _bc_residual(self, x):
        """Wall residuals of one state, (2, 3): rows (z=-1, z=+1), cols
        (dz rho, u, w), each the max over x of |value| at the wall. The
        tau solve enforces these BCs exactly, so they sit at solve
        roundoff (ref logs dz(b), `FWD_Solve_Poiseuille.py:726-727,747`)."""
        f = torch.cat([self._dz(x[:, :, 2:3]), x[:, :, :2]], 2)
        v = (f @ self._ends).reshape(2 * self.kxn, -1)     # (k re|im, 3 x 2)
        g = (self._Bx2 @ v).view(self.mgx, 3, 2)
        return g.abs().amax(0).transpose(0, 1)

    def _initial(self, x0: torch.Tensor) -> torch.Tensor:
        """Planes of (u0, w0) from the ([R,] 2, mgx, mgz) grid state, with
        rho(0)."""
        uw = self._analysis(x0.to(self.dtype).movedim(-2, 0))
        rho0 = self._rho0.view(self._rho0.shape[:2] + (1,) * (uw.dim() - 4)
                               + self._rho0.shape[2:])
        return torch.cat([uw, rho0.expand(uw.shape[:-2] + rho0.shape[-2:])], -2)

    def _integrate(self, ops, x_list, series: bool = False):
        """(J, X_T) of the forward solve, and with `series` the per-step
        (KE, buoyancy variance, BC residual) lists of the same solve (the
        J arithmetic does not depend on that flag). Over rows (without
        `series`), J is (R,)."""
        cfg = self.cfg
        x = self._initial(x_list[0])
        acc = kahan_zero(self.dtype, self.device)
        stats = []
        for _ in range(cfg.n_iters):
            if cfg.s == 0 or series:
                ke = self._ke(x)
            if cfg.s == 0:
                acc = kahan_add(acc, ke)
            if series:
                stats.append((ke, self._de(x), self._bc_residual(x)))
            x = self._remat_step(ops, x)
        if cfg.s == 0:
            ke = self._ke(x)
            J = -0.5 * cfg.dt * kahan_add(acc, ke)[0]   # maximise time-avg KE
        else:
            J = self._mixnorm(ops, x)                  # minimise mix-norm
        if series:
            stats.append((self._ke(x) if cfg.s else ke, self._de(x),
                          self._bc_residual(x)))
            return J, x, stats
        return J, x

    def _objective_aux_impl(self, ops, x_list):
        """(J, diagnostics) captured from one forward solve: the KE and
        buoyancy-variance series and the final fields the reference's
        scalar_data/CheckPoints handlers record (`FWD_Solve_Poiseuille.py:
        939-1026`), and the BC-residual series (T+1, 2, 3)."""
        J, x, stats = self._integrate(ops, x_list, series=True)
        x = x.detach()
        ke, de, bc = (torch.stack([s[i].detach() for s in stats])
                      for i in range(3))
        vort = self._dx(x[:, :, 1:2]) - self._dz(x[:, :, 0:1])
        g = self._synthesis(torch.cat([x, vort], 2))
        return J, {"kinetic_energy": ke, "buoyancy_energy": de,
                   "rho_final": g[:, 2], "vorticity_final": g[:, 3],
                   "bc_residuals": bc, "u_final": g[:, 0], "w_final": g[:, 1]}

    # ------------------------------------------------------------------
    # rows: the forms above on R states (R, 2, mgx, mgz)
    # ------------------------------------------------------------------

    def inner_product_rows(self, x, y):
        dims = tuple(range(1, x.dim()))
        if self.dtype == torch.float32:
            return torch.sum(self._w_acc * x.double() * y.double(), dims).float()
        return torch.sum(self._w * x * y, dims)

    def row_forms(self, aux=False):
        """The native forms over rows, with the operator stacks as the aux
        operand (`aux`) or this problem's own; None under the continuous
        adjoint and df64."""
        if self._df is not None or self.cfg.adjoint == "continuous":
            return None
        fg, f, g = (self.objective_and_gradient_ops, self.objective_ops,
                    self.gradient_ops)
        if not aux:
            ops = self._ops
            fg, f, g = ((lambda xs, _m=m: _m(ops, xs)) for m in (fg, f, g))
        return RowForms(fg, f, g, self.inner_product_rows)

    # ------------------------------------------------------------------
    # continuous adjoint (ref `ADJ_Solve_Cnts`, :1161-1319)
    # ------------------------------------------------------------------

    def _adjoint_step(self, ops, a, xf):
        """One backward step of the adjoint Boussinesq system along the
        stored forward state `xf` (rhs of ref :1220-1228)."""
        y = torch.cat([xf, a], 2)           # uf wf bf ua wa ba
        g = self._synthesis(torch.cat([y, self._dx(y), self._dz(y)], 2))
        ufg, wfg, uag, wag, bag = g[:, 0], g[:, 1], g[:, 3], g[:, 4], g[:, 5]
        xuf, xwf, xbf, xua, xwa, xba = (g[:, 6 + i] for i in range(6))
        zuf, zwf, zbf, zua, zwa, zba = (g[:, 12 + i] for i in range(6))
        nl_b = ufg * xba + wfg * zba
        nl_u = (-(uag * xuf + wag * xwf) + ufg * xua + wfg * zua - bag * xbf)
        nl_w = (-(uag * zuf + wag * zwf) + ufg * xwa + wfg * zwa - bag * zbf)
        if self.cfg.s == 0:
            nl_u = nl_u - ufg
            nl_w = nl_w - wfg
        rhs = self._a0 * a + self._analysis(torch.stack([nl_u, nl_w, nl_b], 1))
        return self._solve(ops["SA"], rhs)

    def _gradient_continuous_impl(self, ops, x_list, with_bc: bool = False):
        """Integrate the adjoint system backward along the stored
        trajectory. s=0: volumetric forcing (-uf, -wf); s=1: terminal
        condition b_adj(T) = -psi with lap psi = rho(T). Returns
        [(u_adj, w_adj)] at t=0, the Riesz representative under the
        Clenshaw-Curtis inner product restricted to the band (first
        order in dt, as the reference's); with `with_bc`, also the (T, 2,
        3) wall residuals of the sweep's solve outputs in forward time
        order (the terminal condition is not a solve output)."""
        with torch.no_grad():
            x = self._initial(x_list[0])
            snaps = []
            for _ in range(self.cfg.n_iters):
                x = self._step(ops, x)
                snaps.append(x)
            a = torch.zeros_like(x)
            if self.cfg.s == 1:
                a[:, :, 2:3] = -self._solve(ops["MN"], x[:, :, 2:3])
            bcs = []
            for xf in reversed(snaps):
                a = self._adjoint_step(ops, a, xf)
                if with_bc:
                    bcs.append(self._bc_residual(a))
            grads = [self._synthesis(a[:, :, :2]).transpose(0, 1).contiguous()]
        if with_bc:
            return grads, torch.stack(bcs[::-1])
        return grads

    # ------------------------------------------------------------------
    # public triple; the `*_ops` forms take the operator stacks as an
    # argument (the device loop's `aux` operand)
    # ------------------------------------------------------------------

    def _riesz(self, raw):
        return [g / self._w for g in raw]

    def _solve_ops(self):
        """The operator stacks of the core solves: the f64 twin's under
        df64, else this problem's."""
        return self._ops if self._df is None else self._df._ops

    def objective_ops(self, ops, x_list):
        if self._df is not None:
            return self._df.objective_ops(ops, to_f64(x_list)).float()
        with torch.no_grad():
            return self._integrate(ops, list(x_list))[0]

    def objective_and_gradient_ops(self, ops, x_list):
        """Fused (J, gradient). Under adjoint='continuous' the gradient
        is the adjoint PDE's, paired with a separate forward: the two
        gradient definitions (and their inner products) never mix in one
        search. Under df64, the f64 twin's with `ops` its stacks, J as an
        f32 0-dim tensor (the device loop's search state is f32)."""
        if self._df is not None:
            J, g = self._df.objective_and_gradient_ops(ops, to_f64(x_list))
            return J.float(), [a.float() for a in g]
        if self.cfg.adjoint == "continuous":
            return (self.objective_ops(ops, x_list),
                    self._gradient_continuous_impl(ops, list(x_list)))
        J, raw = value_and_raw_gradient(
            lambda xs: self._integrate(ops, xs)[0], list(x_list))
        return J, self._riesz(raw)

    def gradient_ops(self, ops, x_list):
        if self._df is not None:
            return [g.float() for g in self._df.gradient_ops(ops, to_f64(x_list))]
        if self.cfg.adjoint == "continuous":
            return self._gradient_continuous_impl(ops, list(x_list))
        return self.objective_and_gradient_ops(ops, x_list)[1]

    def objective(self, x_list):
        return self.objective_ops(self._solve_ops(), x_list)

    def objective_f64(self, x_list) -> float:
        """df64 mode only: J of the f64 solve as a Python float (the f32
        `objective` rounds it to ~ulp(J), which swamps Taylor
        remainders)."""
        if self._df is None:
            raise RuntimeError("objective_f64 requires solve_precision='df64'"
                               " with dtype='float32'")
        return float(self._df.objective(to_f64(x_list)))

    def gradient(self, x_list):
        return self.gradient_ops(self._solve_ops(), x_list)

    def objective_and_gradient(self, x_list):
        """Fused (J, gradient); under df64, J of the f64 solve as a Python
        float (host consumers compare it at f64)."""
        if self._df is not None:
            J, g = self._df.objective_and_gradient(to_f64(x_list))
            return float(J), [a.float() for a in g]
        return self.objective_and_gradient_ops(self._ops, x_list)

    @property
    def objective_and_gradient_aux(self):
        """(callable(ops, xs), ops): the fused objective and gradient with
        the operator stacks as an explicit operand, for the device loop's
        `aux` (`objective_ops` and `gradient_ops` are its J-only and
        gradient-only counterparts)."""
        return self.objective_and_gradient_ops, self._solve_ops()

    def inner_product(self, x, y):
        """(1/V) int x . y dV with the mode's weights; at f32 the weighted
        products are summed in f64 and the result returned in f32."""
        if self.dtype == torch.float32:
            return torch.sum(self._w_acc * x.double() * y.double()).float()
        return torch.sum(self._w * x * y)

    @property
    def inner_products(self):
        return self.inner_product

    # ------------------------------------------------------------------
    # fused diagnostics: same-solve capture for zero-extra-cost archiving
    # ------------------------------------------------------------------

    @property
    def has_fused_diagnostics(self) -> bool:
        return True

    def _diag_host(self, diag: dict) -> dict:
        out = dict(diag)
        out["sim_time"] = self.cfg.dt * np.arange(self.cfg.n_iters + 1)
        out["x_grid"] = np.arange(self.mgx) * self.cfg.lx / self.mgx
        out["z_grid"] = self._zgrid
        return out

    def objective_and_diagnostics(self, x_list):
        """(J, diagnostics dict) from one forward solve."""
        with torch.no_grad():
            J, diag = self._objective_aux_impl(self._ops, list(x_list))
        return J, self._diag_host(diag)

    def objective_gradient_and_diagnostics(self, x_list):
        """(J, grads, diagnostics) from one fused forward and backward
        (under adjoint='continuous', the mode's own gradient next to the
        diagnostics-carrying forward)."""
        if self.cfg.adjoint == "continuous":
            J, diag = self.objective_and_diagnostics(x_list)
            return J, self._gradient_continuous_impl(self._ops, list(x_list)), diag
        out = {}

        def objective(xs):
            J, out["diag"] = self._objective_aux_impl(self._ops, xs)
            return J

        J, raw = value_and_raw_gradient(objective, list(x_list))
        return J, self._riesz(raw), self._diag_host(out["diag"])

    def diagnostics(self, x_list) -> dict:
        """KE and buoyancy-variance series, final fields and the wall
        residuals, from the fused solve (J discarded)."""
        return self.objective_and_diagnostics(list(x_list))[1]

    def adjoint_bc_residuals(self, x_list) -> torch.Tensor:
        """(T, 2, 3) wall residual series of the continuous-adjoint
        sweep, rows (z=-1, z=+1), cols (dz b_adj, u_adj, w_adj), in
        forward time order; at solve roundoff when the transposed
        operator assembly is right."""
        if self.cfg.adjoint != "continuous":
            raise ValueError(
                "adjoint_bc_residuals needs adjoint='continuous' (the "
                "discrete mode has no adjoint PDE solve to monitor)")
        return self._gradient_continuous_impl(self._ops, list(x_list),
                                              with_bc=True)[1]

    # ------------------------------------------------------------------
    # PDE-state restart (ref `IVP_FWD.load_state`)
    # ------------------------------------------------------------------

    @staticmethod
    def _to_dict(x):
        return {k: x[:, :, i].transpose(0, 1).contiguous()
                for i, k in enumerate("uwr")}

    @staticmethod
    def _from_dict(s):
        return torch.stack([s[k].transpose(0, 1) for k in "uwr"], 2)

    def initial_state(self, x_list) -> dict:
        """Boussinesq state at t=0: the (u, w, rho) coefficient fields as
        stacked re/im planes, (2, kxn, nz) each."""
        with torch.no_grad():
            return self._to_dict(self._initial(
                torch.as_tensor(x_list[0], device=self.device)))

    def advance_state(self, state: dict, n_steps: int) -> dict:
        if not hasattr(self, "_advance"):
            self._advance = SegmentAdvance(
                lambda s: self._to_dict(self._step(self._ops, self._from_dict(s))))
        return self._advance(state, n_steps)

    def state_fields(self, state) -> dict:
        with torch.no_grad():
            g = self._synthesis(self._from_dict(state))
        return {"u": g[:, 0], "w": g[:, 1], "rho": g[:, 2]}

    def final_fields(self, x_list):
        """(u, w, rho) numpy complex coefficient state at t = T."""
        with torch.no_grad():
            x = self._initial(torch.as_tensor(x_list[0], device=self.device))
            for _ in range(self.cfg.n_iters):
                x = self._step(self._ops, x)
            x = x.cpu().numpy()
        return tuple(x[:, 0, i] + 1j * x[:, 1, i] for i in range(3))

    # ------------------------------------------------------------------
    # initial conditions (ref Generate_IC :301-385 + FWD_Solve_IVP_Prep
    # :520-608)
    # ------------------------------------------------------------------

    def _prep_solve_ops(self):
        """The Sim_Type="Linear" prep solve stack (the same tau systems at
        the prep dt; ref `FWD_Solve_Poiseuille.py:480-484,549`), built
        once."""
        if not hasattr(self, "_prep_op"):
            S_prep, _ = self._build_operators(dt=self.cfg.prep_dt,
                                              build_mixnorm=False)
            self._prep_op = self._put_blocked(S_prep)
        return self._prep_op

    def generate_ic(self, seed: int = 42,
                    noise: Optional[np.ndarray] = None) -> List[torch.Tensor]:
        """Filtered-noise streamfunction -> u = -psi_z, w = psi_x ->
        LINEAR prep solve (prep_steps x prep_dt, rho(0) coupled in) ->
        2/3-rule dealias mask -> normalised onto the e0 sphere. The noise
        comes from a CPU `torch.Generator` seeded with `seed`, unless
        `noise` (an (mgx, mgz) array, e.g. the JAX package's
        `jax.random.normal` draw) is given; torch and JAX draw different
        numbers from the same seed."""
        cfg = self.cfg
        nz, kxn = cfg.nz, self.kxn
        shape = (self.mgx, self.mgz)
        if noise is None:
            gen = torch.Generator(device="cpu").manual_seed(seed)
            noise = torch.randn(shape, generator=gen, dtype=self.dtype)
        else:
            noise = torch.tensor(np.asarray(noise), dtype=self.dtype)
        if tuple(noise.shape) != shape:
            raise ValueError(f"noise must have shape {shape}, "
                             f"got {tuple(noise.shape)}")
        rdtype = np.dtype(cfg.dtype)
        # low-pass both axes at half band (ref filter_field frac=0.5)
        mx = (np.arange(kxn) <= 0.25 * cfg.nx).astype(float)
        mz = (np.arange(nz) < 0.5 * nz).astype(float)
        # 2/3-rule DA mask applied to the prep output (ref :593-606)
        nx0, nz0 = 2 * cfg.nx // 3, 2 * nz // 3
        da_x = (np.arange(kxn) < nx0 // 2).astype(float)
        da_z = (np.arange(nz) < nz0).astype(float)
        lowpass = self._t((mx[:, None] * mz[None, :]).astype(rdtype)[:, None, None])
        da = self._t((da_x[:, None] * da_z[None, :]).astype(rdtype)[:, None, None])
        prep = self._prep_solve_ops()
        a0 = 1.0 / cfg.prep_dt
        with torch.no_grad():
            psi = self._analysis(noise.to(self.device)[:, None]) * lowpass
            x = torch.cat([-self._dz(psi), self._dx(psi), self._rho0], 2)
            # LINEAR prep: rhs = state/dt_prep only (the implicit operator
            # carries every linear coupling)
            for _ in range(cfg.prep_steps):
                x = self._solve(prep, a0 * x)
            x = self._synthesis(x[:, :, :2] * da).transpose(0, 1).contiguous()
            norm = torch.sum(self._w * x * x)
            return [x * torch.sqrt(cfg.e0 / norm)]


# Import-pinned digest of the operator-assembly sources: cached stacks
# are invalidated when any of these change.
_OP_BUILDER_DIGEST = source_digest(
    OptimalMixing._build_operators_uncached, _cheb_mult_T, _block_solve,
    ChebyshevBasis1D)
