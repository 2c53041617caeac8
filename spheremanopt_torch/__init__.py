"""SphereManOpt on PyTorch: optimisation on products of spherical
manifolds, with hand-written CUDA kernels for Hopper on the hot path.

The port of the JAX/XLA/Pallas package beside it, which stays as the
reference; this package never imports JAX or the JAX package.
Minimises PDE-constrained objectives J(X) subject to per-component norm
constraints <X_i, X_i> = E_i.

Layering (bottom-up), mirroring the JAX package:
  csrc/       CUDA C++ kernels (sm_90a), built at first use
  ops/        Fourier transforms; ops/cuda: kernel wrappers, plain
              PyTorch versions, autograd Functions, the nvcc build
  solvers/    Kahan accumulation helpers
  manifold/   sphere geometry: retraction, tangent projection, transport
  optim/      Armijo + strong-Wolfe line searches, SD/CG/L-BFGS host
              loop, the device-resident loop (CUDA graphs on the card)
              and trust-region Newton (host and device)
  grad/       Taylor-remainder adjoint verification
  problems/   PCA, Swift-Hohenberg periodic (SH23) and bounded (SHB23),
              kinematic dynamo (KDyn, two spheres)
  convert.py  numpy bridge for data shared with the JAX package
  run.py      command line (sh23, shb23, kdyn, pca)

Gradients are discrete adjoints: reverse-mode autograd of the forward
solve, or the kernels' own reverse sweep.
"""

from spheremanopt_torch.manifold.sphere import (
    normalise_sphere,
    retract,
    tangent_project,
    transport,
)
from spheremanopt_torch.optim.optimiser import (
    OptimiseResult,
    optimise_on_multi_sphere,
)
from spheremanopt_torch.grad.testgrad import adjoint_gradient_test
from spheremanopt_torch.problems.kinematic_dynamo import (
    KDynConfig,
    KinematicDynamo,
)

__version__ = "0.1.0"

__all__ = [
    "normalise_sphere",
    "retract",
    "tangent_project",
    "transport",
    "OptimiseResult",
    "optimise_on_multi_sphere",
    "adjoint_gradient_test",
    "KDynConfig",
    "KinematicDynamo",
]
