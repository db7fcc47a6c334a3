"""Graphs: nodes plus edge values — port of `phiflow_tpu/geom/_graph.py`
(`Graph`, `:22`; `graph`, `:138`).

Edges are a dense (instance × dual) Tensor with zeros off the
neighbourhoods: all pairs (a dual copy of the instance dim), or the compact
candidate lists of the cell-list search (a dual dim '~neighbors', with the
candidates' ids in `indices`). The Tensors stay on their device; a Graph
needs no registration with the autograd machinery.
"""
from __future__ import annotations

from typing import Dict

from ..math import Tensor, Shape, wrap, rename_dims
from ..math import _ops as ops
from ..math._magic import slicing_dict
from ._geom import Geometry, Point

__all__ = ['Graph', 'graph']


class Graph(Geometry):
    """Nodes (a Geometry collection) plus per-pair edge values."""

    def __init__(self, nodes: Geometry, edges: Tensor, boundary: Dict[str, Dict[str, slice]] = None,
                 deltas: Tensor = None, distances: Tensor = None, bounding_distance=None,
                 indices: Tensor = None):
        self._nodes = nodes
        self._edges = edges
        self._boundary = boundary or {}
        self._deltas = deltas
        self._distances = distances
        self._bounding_distance = wrap(bounding_distance) if bounding_distance is not None else None
        # compact (cell-list) neighbourhoods: each node's candidate ids along the dual dim, −1 in empty
        # slots; None for dense all-pairs graphs
        self._indices = indices

    @property
    def nodes(self) -> Geometry:
        return self._nodes

    @property
    def edges(self) -> Tensor:
        return self._edges

    @property
    def indices(self) -> Tensor:
        return self._indices

    @property
    def is_compact(self) -> bool:
        return self._indices is not None

    @property
    def deltas(self) -> Tensor:
        return self._deltas

    @property
    def unit_deltas(self) -> Tensor:
        return ops.safe_div(self._deltas, self._distances)

    @property
    def distances(self) -> Tensor:
        return self._distances

    @property
    def bounding_distance(self):
        return self._bounding_distance

    @property
    def connectivity(self) -> Tensor:
        return ops.to_float(self._edges != 0) if self._edges is not None else None

    @property
    def boundary(self) -> Dict[str, Dict[str, slice]]:
        return self._boundary

    @property
    def center(self) -> Tensor:
        return self._nodes.center

    @property
    def shape(self) -> Shape:
        return self._nodes.shape

    @property
    def spatial_rank(self) -> int:
        return self._nodes.spatial_rank

    @property
    def volume(self) -> Tensor:
        return self._nodes.volume

    @property
    def boundary_elements(self):
        return self._boundary

    def lies_inside(self, location):
        return self._nodes.lies_inside(location)

    def approximate_signed_distance(self, location):
        return self._nodes.approximate_signed_distance(location)

    def bounding_radius(self):
        return self._nodes.bounding_radius()

    def bounding_half_extent(self):
        return self._nodes.bounding_half_extent()

    def at(self, center):
        raise AssertionError("Changing the node positions of a Graph invalidates the edges; "
                             "create a new Graph instead")

    def shifted(self, delta):
        return self.at(self.center + delta)

    def __getitem__(self, item):
        item = slicing_dict(self, item)

        def part(t):
            return t[{k: v for k, v in item.items() if k in t.shape}] if t is not None else None
        return Graph(self._nodes[item] if item else self._nodes, part(self._edges), self._boundary,
                     part(self._deltas), part(self._distances), self._bounding_distance)

    def __repr__(self):
        return f"Graph[{self._nodes}]"


def graph(nodes, edges: Tensor, boundary=None, build_distances=True, build_bounding_distance=False) -> Graph:
    """A Graph of `nodes` (a Geometry, or a Tensor of points) with the edge
    values `edges`; all-pairs deltas x_j − x_i and distances with
    `build_distances`, their maximum as the bounding distance with
    `build_bounding_distance`."""
    if isinstance(nodes, Tensor):
        nodes = Point(nodes)
    deltas = None
    distances = None
    if build_distances:
        inst = nodes.shape.instance
        others = rename_dims(nodes.center, inst, inst.as_dual())
        deltas = others - nodes.center
        distances = ops.vec_length(deltas)
    bounding = ops.max_(distances) if build_bounding_distance and distances is not None else None
    return Graph(nodes, edges, boundary or {}, deltas, distances, bounding)
