"""Prebuilt simulation models of the port (mirrors `phiflow_tpu/models`).

Each model has JAX's Field-level face — `initial_state()` returns Fields and
`step(...)` takes and returns them — and below it the array-level methods on
raw tensors with the suffix `_native` (`step_native`, `initial_state_native`,
…). `state_fields(*native_state)` and `state_natives(*field_state)` cross
between the two without copying. Each model's module has its own
`state_from_numpy` / `state_to_numpy` at the array level; the smoke model's
are also exported here.
"""
import torch

from ..field._field import Field
from ..geom._geom import is_point_set
from ..math import Tensor, TensorStack, get_default_device
from ..math._tensor import to_torch


def _put(tensor: Tensor, device: torch.device) -> Tensor:
    """`tensor` as a contiguous torch tensor on `device`: a host constant is
    materialised there, a tensor elsewhere moved, one already there kept."""
    if isinstance(tensor, TensorStack):
        return TensorStack([_put(c, device) for c in tensor.components], tensor.stack_dim)
    native = tensor.native()
    if isinstance(native, torch.Tensor) and native.device == device and native.is_contiguous():
        return tensor
    return Tensor(to_torch(native, device).to(device).contiguous(), tensor.shape)


def to_device(state, device=None):
    """Every Field of `state` (one Field or a tuple of objects) with its
    values — and a point cloud's points, a mesh's tables — as torch tensors
    on `device` (the default device when None); other objects, such as
    obstacles, pass as they are. The models call it at the end of `initial_state`, as the JAX package
    does, so that the first step starts from device arrays like every later
    one."""
    device = get_default_device() if device is None else torch.device(device)

    def put(obj):
        if isinstance(obj, Field):
            geometry = obj.geometry
            if obj.is_mesh:
                geometry = geometry.to(device)
            elif not obj.is_grid and is_point_set(geometry.center):
                geometry = geometry.at(_put(geometry.center, device))
            values = obj.values if obj.values is None else _put(obj.values, device)
            return Field(geometry, values, obj.boundary)
        if isinstance(obj, (tuple, list)):
            return type(obj)(put(o) for o in obj)
        return obj
    return put(state)


from . import burgers, cavity, cylinder_wake, flip, kolmogorov, moving_obstacle, smoke, sph_dam
from .burgers import Burgers
from .cavity import LidDrivenCavity
from .cylinder_wake import CylinderWake
from .flip import FlipLiquid
from .kolmogorov import KolmogorovFlow
from .moving_obstacle import MovingObstacles
from .smoke import SmokePlume, state_from_numpy, state_to_numpy
from .sph_dam import SphDamBreak
