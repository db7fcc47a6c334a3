"""ΦFlow-TPU's PyTorch/CUDA port (`phiflow_tpu_torch`).

The JAX package `phiflow_tpu` stays the reference. This package mirrors two
of its models at the array level. The smoke-plume step
(`models.SmokePlume.step`, 2D and 3D, closed or periodic box) runs on both of
its advection paths: the fused 3D path (`ops/advect3d.py`) and the per-phase
path of the public advection functions (`physics/advect.py` → `math/_nd.py` →
`ops/interp.py`), each followed by the pressure projection
(`physics/fluid.py`). The FLIP liquid step (`models.FlipLiquid.step`, 2D and
3D) scatters particles to the grid (`field/_resample.py` → `ops/p2g.py`),
projects with the liquid's cells active (the masked stencil of
`ops/poisson.py`) and moves the particles through the grid velocity. They are
plain functions on `torch.Tensor`s whose hot loops are hand-written CUDA
kernels for Hopper (`csrc/*.cu`, built with `nvcc` at first use by
`ops/_build.py`). Every kernel has a plain PyTorch twin in the same module; a
wrapper takes the twin only for tensors on the CPU.

Entry points run on the card (`device='cuda'`) unless the caller passes
`device='cpu'`, as the tests do.
"""
from __future__ import annotations

import torch

__all__ = ['resolve_device']


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
