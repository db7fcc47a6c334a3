"""ΦFlow-TPU's PyTorch/CUDA port (`phiflow_tpu_torch`).

The JAX package `phiflow_tpu` stays the reference. This package mirrors all
eight of its models — with JAX's Field-level faces: `initial_state()` returns
Fields and `step(...)` takes and returns them, through the Field API of
`math`, `geom`, `field` and `physics` — and below them the array layer
(`*_native`) on raw `torch.Tensor`s, into which every Field function
unwraps. The smoke-plume step
(`models.SmokePlume.step`, 2D and 3D, closed or periodic box) runs on both of
its advection paths: the fused 3D path (`ops/advect3d.py`) and the per-phase
path of the public advection functions (`physics/advect.py` → `math/_nd.py` →
`ops/interp.py`), each followed by the pressure projection
(`physics/fluid.py`). The FLIP liquid step (`models.FlipLiquid.step`, 2D and
3D) scatters particles to the grid (`field/_resample.py` → `ops/p2g.py`),
projects with the liquid's cells active (the masked stencil of
`ops/poisson.py`) and moves the particles through the grid velocity; its
particles are a point-cloud Field. Obstacles
(`geom/`, `physics/fluid.py::Obstacle`) enter `make_incompressible` as masks
staged into the same stencil's coefficient arrays; `models.MovingObstacles`
and `models.LidDrivenCavity` are the 2D models built on it. `models.Burgers`
advects a centred periodic velocity through the 2D window kernel and diffuses
it explicitly or by CG; `models.KolmogorovFlow` integrates a forced periodic
flow with RK4, order-6 compact finite differences (dense per-axis operator
matrices, `field/_stencil1d.py`) and a wide-stencil projection in each stage,
with no kernel of the port's on its path. `models.SphDamBreak` runs SPH
on a cell-list neighbour graph, and `models.CylinderWake` the finite-volume
wake on an unstructured mesh (`geom/_mesh.py`, built by the C++ face
matcher of `native/`, `field/_mesh_math.py`, BiCGStab in `math/_solve.py`),
both in PyTorch operations with no kernel of the port's on their paths. The array
layer's hot loops are hand-written CUDA kernels for Hopper (`csrc/*.cu`,
built with `nvcc` at first use by `ops/_build.py`). Every kernel has a
plain PyTorch twin in the same module; a wrapper takes the twin only for
tensors on the CPU.

Entry points run on the card (`device='cuda'`) unless the caller passes
`device='cpu'`, as the tests do.

Import `phiflow_tpu_torch.flow` for the full user namespace.
"""
from __future__ import annotations

import torch

__version__ = '0.1.0'

__all__ = ['resolve_device', 'verify', 'troubleshoot', 'assert_minimal_config', 'detect_backends',
           'set_logging_level']


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: `device`, or CUDA when None.

    Raises RuntimeError when CUDA is asked for (explicitly or by default) and
    absent — the port never drops to the CPU on its own."""
    dev = torch.device('cuda' if device is None else device)
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run the plain "
                           "PyTorch versions of the kernels on the CPU")
    if dev.type not in ('cuda', 'cpu'):
        raise ValueError(f"unsupported device {dev}")
    return dev


def verify(device=None):
    """Print the package's version, torch's and the device, then run a small
    `laplace` of a noise grid there: on the card unless `device='cpu'`."""
    from . import math
    from .field import CenteredGrid, Noise, laplace
    dev = resolve_device(device)
    print(f"phiflow_tpu_torch {__version__}")
    name = torch.cuda.get_device_name(dev) if dev.type == 'cuda' else 'the CPU'
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda or 'none'}, device: {dev} ({name})")
    with math.default_device(dev):
        g = laplace(CenteredGrid(Noise(), 0., x=8, y=8))
        assert bool(math.all(math.is_finite(g.values))), "laplace of a noise grid is not finite"
    print(f"basic field ops on {dev.type}: OK")


def detect_backends():
    """torch's devices: 'torch-cpu', then 'torch-cuda:<i>' for each card."""
    return ['torch-cpu'] + [f"torch-cuda:{i}" for i in range(torch.cuda.device_count())]


def set_logging_level(level='debug'):
    import logging
    logging.getLogger('phiflow_tpu_torch').setLevel(getattr(logging, level.upper()))


from ._troubleshoot import troubleshoot, assert_minimal_config  # noqa: E402
