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
              and trust-region Newton (host and device), each device
              loop also over rows (`sweep`: R optimisations at once)
  grad/       Taylor-remainder adjoint verification
  utils/      the content-keyed on-disk cache of assembled operators
  problems/   PCA, Swift-Hohenberg periodic (SH23) and bounded (SHB23),
              kinematic dynamo (KDyn, two spheres), optimal mixing (2D
              Boussinesq, Fourier x Chebyshev-tau); the native forms
              over rows of PCA, SH23 (matmul, fft) and mixing
  convert.py  numpy bridge for data shared with the JAX package
  run.py      command line (sh23, shb23, kdyn, mixing, pca)
  serve.py    the warm optimisation server: device loops kept on their
              CUDA graphs, answering optimise / sweep / status / shutdown
              requests over a Unix socket

Gradients are discrete adjoints: reverse-mode autograd of the forward
solve, or the kernels' own reverse sweep.
"""

__version__ = "0.1.0"

# the public names, each imported from its module on first use, so that
# importing a light submodule (`run doctor`'s report) does not import torch
_EXPORTS = {
    "normalise_sphere": "spheremanopt_torch.manifold.sphere",
    "retract": "spheremanopt_torch.manifold.sphere",
    "tangent_project": "spheremanopt_torch.manifold.sphere",
    "transport": "spheremanopt_torch.manifold.sphere",
    "OptimiseResult": "spheremanopt_torch.optim.optimiser",
    "optimise_on_multi_sphere": "spheremanopt_torch.optim.optimiser",
    "adjoint_gradient_test": "spheremanopt_torch.grad.testgrad",
    "KDynConfig": "spheremanopt_torch.problems.kinematic_dynamo",
    "KinematicDynamo": "spheremanopt_torch.problems.kinematic_dynamo",
}


def __getattr__(name):
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(f"module 'spheremanopt_torch' has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(module), name)


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
