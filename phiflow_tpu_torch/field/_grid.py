"""`CenteredGrid` and `StaggeredGrid` — port of `phiflow_tpu/field/_grid.py`
(`:33`, `:61`): functions that build a grid `Field` from a number, a tuple, a
Tensor, a geometry (hard or soft mask) or another Field.

A staggered grid's values are a `TensorStack` over `~vector`: component d
holds N−1 faces along d in a closed box (a constant boundary), N in a periodic
one, N+1 under zero gradient (`valid_outer_faces`).
"""
from __future__ import annotations

from numbers import Number

from ..math import Shape, Tensor, wrap, spatial, channel, dual, stack, unstack, expand, rename_dims
from ..math import _ops as ops
from ..math._extrapolation import Extrapolation
from ..geom import Box, UniformGrid
from ._field import Field, as_boundary

__all__ = ['CenteredGrid', 'StaggeredGrid', 'unstack_staggered_tensor', 'expand_staggered', 'Grid']

Grid = Field


def _is_float(dtype) -> bool:
    return getattr(dtype, 'is_floating_point', None) or getattr(dtype, 'kind', '') in 'fc'


def _get_resolution(resolution, resolution_, bounds) -> Shape:
    if isinstance(resolution, int):
        assert isinstance(bounds, Box) and bounds.names, "an int resolution needs bounds with axis names"
        return spatial(**{n: resolution for n in bounds.names})
    return (resolution or spatial()) & spatial(**{k: int(v) for k, v in resolution_.items()})


def _as_bounds(bounds, resolution: Shape) -> Box:
    if bounds is None:
        return Box(**{n: float(s) for n, s in zip(resolution.names, resolution.sizes)})
    if isinstance(bounds, (int, float)):
        return Box(**{n: float(bounds) for n in resolution.names})
    assert isinstance(bounds, Box), f"bounds: a Box, a number or None, got {type(bounds)}"
    return bounds


def CenteredGrid(values=0., boundary=0., bounds=None, resolution=None,
                 extrapolation=None, convert=True, **resolution_) -> Field:
    """A Field sampled at the cell centres of a uniform grid."""
    boundary = as_boundary(boundary if extrapolation is None else extrapolation, UniformGrid)
    if resolution is None and not resolution_:
        assert isinstance(values, Tensor), "resolution must be specified when values is not a Tensor"
        resolution = values.shape.spatial
        elements = UniformGrid(resolution, _as_bounds(bounds, resolution))
    else:
        resolution = _get_resolution(resolution, resolution_, bounds)
        elements = UniformGrid(resolution, _as_bounds(bounds, resolution))
        if isinstance(values, (Number, bool)):
            values = wrap(values)
        if isinstance(values, Tensor):
            if not _is_float(values.dtype):  # before the expansion: a host number stays one number
                values = ops.to_float(values)
            values = expand(values, resolution)
    if isinstance(values, Tensor) and not _is_float(values.dtype):
        values = ops.to_float(values)
    result = Field(elements, values, boundary)
    if not _is_float(result.values.dtype):
        result = result.with_values(ops.to_float(result.values))
    return result


def StaggeredGrid(values=0., boundary=0., bounds=None, resolution=None,
                  extrapolation=None, convert=True, **resolution_) -> Field:
    """A Field sampled at the face centres of a uniform grid (MAC layout)."""
    boundary = as_boundary(boundary if extrapolation is None else extrapolation, UniformGrid)
    if resolution is None and not resolution_:
        assert isinstance(values, Tensor), "resolution must be specified when values is not a Tensor"
        assert '~vector' in values.shape or 'vector' in values.shape, "need staggered components"
        if '~vector' not in values.shape:
            resolution = values.shape.spatial.with_sizes([s - 1 for s in values.shape.spatial.sizes])
            values = unstack_staggered_tensor(values, boundary)
        else:
            resolution = _staggered_resolution(values, boundary)
        return Field(UniformGrid(resolution, _as_bounds(bounds, resolution)), values, boundary)
    resolution = _get_resolution(resolution, resolution_, bounds)
    elements = UniformGrid(resolution, _as_bounds(bounds, resolution))
    if isinstance(values, Tensor):
        if '~vector' in values.shape:
            pass
        elif 'vector' in values.shape and values.shape.spatial:
            if all(values.shape.get_size(d) == resolution.get_size(d) + 1 for d in resolution.names):
                values = unstack_staggered_tensor(values, boundary)
            else:
                values = rename_dims(values, 'vector', dual(vector=resolution.names))
        else:
            values = expand_staggered(values, resolution, boundary)
    elif isinstance(values, (Number, bool)):
        values = expand_staggered(wrap(float(values)), resolution, boundary)
    elif isinstance(values, (tuple, list)):
        values = expand_staggered(wrap(list(values), channel(vector=resolution.names)), resolution, boundary)
    else:
        from ._resample import sample
        values = sample(values, elements, at='face', boundary=boundary, dot_face_normal=elements)
    if isinstance(values, Tensor) and 'vector' in values.shape and '~vector' in values.shape:
        values = stack([values[{'vector': i, '~vector': i}] for i in range(resolution.rank)],
                       dual(vector=resolution.names))
    result = Field(elements, values, boundary)
    if not _is_float(result.values.dtype):
        result = result.with_values(ops.to_float(result.values))
    return result


def _staggered_resolution(values: Tensor, ext: Extrapolation) -> Shape:
    labels = values.shape.get_labels('~vector') or values.shape.spatial.names
    sizes = {}
    for dim, comp in zip(labels, unstack(values, '~vector')):
        lo, up = ext.valid_outer_faces(dim)
        sizes[dim] = comp.shape.get_size(dim) - int(lo) - int(up) + 1
    return spatial(**sizes)


def unstack_staggered_tensor(data: Tensor, extrapolation: Extrapolation):
    """Slice a padded uniform staggered tensor (resolution+1 per dim) into its
    per-axis components."""
    sliced = []
    names = data.shape.spatial.names
    for dim in names:
        component = data[{'vector': dim}] if 'vector' in data.shape else data
        lo_valid, up_valid = extrapolation.valid_outer_faces(dim)
        slices = {d: slice(0, -1) for d in names}
        slices[dim] = slice(int(not lo_valid), (-int(not up_valid)) or None)
        sliced.append(component[slices])
    return stack(sliced, dual(vector=names))


def expand_staggered(values: Tensor, resolution: Shape, extrapolation: Extrapolation):
    """A constant or vector expanded onto the staggered components: along its
    own dim component d has N − 1 faces plus the outer ones
    `valid_outer_faces` keeps."""
    components = [values[{'vector': i}] for i in range(resolution.rank)] if 'vector' in values.shape \
        else [values] * resolution.rank
    tensors = []
    for dim, c in zip(resolution.names, components):
        lower, upper = extrapolation.valid_outer_faces(dim)
        faces = resolution.with_dim_size(dim, resolution.get_size(dim) + int(lower) + int(upper) - 1)
        tensors.append(expand(c, faces))
    return stack(tensors, dual(vector=resolution.names))
