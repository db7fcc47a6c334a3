"""Smoothed Particle Hydrodynamics: neighbour graphs and kernel evaluation —
port of `phiflow_tpu/physics/sph.py`, with its signatures.

Neighbourhoods are dense masked (N × Ñ) Tensors: all pairs (`format='dense'`)
or the compact candidate lists of the cell-list search (`math/_neighbors.py`,
a dual dim '~neighbors' of static width 3^d · capacity). The kernels are
elementwise expressions on those Tensors; the edge sums reduce along the dual
dim. Everything is PyTorch operations on the particles' device: no kernel of
the port's own lies on this path.
"""
from __future__ import annotations

from typing import Dict, Sequence, Union

import numpy as np
import torch

from ..math import Tensor, PI, wrap, channel, stack, concat, expand, rename_dims
from ..math import _ops as ops
from ..math._shape import Shape, Dim, DUAL, INSTANCE, CHANNEL
from ..geom import Geometry, Box, Sphere
from ..geom._graph import Graph

__all__ = ['neighbor_graph', 'evaluate_kernel', 'expected_neighbors',
           'gather_neighbors', 'edge_gradient', 'density', 'tait_pressure', 'pressure_acceleration']

_DEFAULT_DESIRED_NEIGHBORS = {
    'quintic-spline': 34,
    'wendland-c2': 22,
    'poly6': 30,
}


def neighbor_graph(nodes: Geometry,
                   kernel: str,
                   boundary: Dict = None,
                   desired_neighbors: float = None,
                   compute: str = 'kernel,grad',
                   format='dense',
                   search_method='auto',
                   domain: Box = None,
                   periodic: Union[bool, Tensor] = False,
                   support_radius: float = None) -> Graph:
    """A Graph of particle neighbourhoods with kernel values on the edges,
    packed along a channel dim 'vector': 'kernel', 'grad_x', 'grad_y', … as
    `compute` asks ('laplace' too), or 1/r with an empty `compute`.

    The support radius is `support_radius`, or the radius of a sphere holding
    `desired_neighbors` particles of the mean volume. The search is the dense
    all-pairs one, or the cell list for `format='compact'`,
    `search_method='cell-list'`, or 'auto' with a `domain` and more than 4096
    particles; the cell list needs the `domain` Box."""
    assert isinstance(nodes, Geometry), f"nodes must be a Geometry, got {type(nodes)}"
    boundary = {} if boundary is None else boundary
    desired_neighbors = _DEFAULT_DESIRED_NEIGHBORS[kernel] if desired_neighbors is None else desired_neighbors
    # --- support radius from the desired neighbour count ---
    if support_radius is not None:
        support = wrap(support_radius)
    else:
        avg_volume = ops.mean(nodes.volume, nodes.shape.instance) if nodes.shape.instance else nodes.volume
        support = Sphere.radius_from_volume(avg_volume * desired_neighbors, nodes.spatial_rank)
    # --- neighbour search: dense all-pairs, or the cell list ---
    indices = None
    n_particles = nodes.shape.instance.volume
    use_cell_list = (format == 'compact' or search_method == 'cell-list'
                     or (search_method == 'auto' and domain is not None and n_particles > 4096))
    if use_cell_list:
        assert domain is not None, "cell-list search requires a domain Box"
        indices, deltas, mask, distances = _cell_list_graph(nodes, support, domain, periodic)
    else:
        dom = (domain.lower, domain.upper) if domain is not None else None
        deltas = ops.pairwise_differences(nodes.center, max_distance=None, format=format,
                                          method=search_method, domain=dom, periodic=periodic, default=0.)
        dist2 = ops.vec_squared(deltas)
        mask = (dist2 < support ** 2) & (dist2 > 1e-12)  # excludes the self-pair exactly
        deltas = deltas * ops.to_float(mask)
        distances = ops.sqrt(dist2) * ops.to_float(mask)
    # --- evaluate the kernel on the edges ---
    compute_list = [s.strip() for s in compute.split(',') if s.strip()]
    if compute_list:
        values = evaluate_kernel(deltas, distances, support, nodes.spatial_rank, kernel, types=compute_list)
        parts = []
        for k, v in values.items():
            v = v * ops.to_float(mask)
            if 'vector' not in v.shape:
                v = expand(v, channel(vector=[k]))
            else:
                v = rename_dims(v, 'vector', channel(vector=[f"{k}_{l}" for l in v.shape.get_labels('vector')]))
            parts.append(v)
        edges = concat(parts, 'vector')
    else:
        edges = ops.safe_div(ops.to_float(mask), distances)
    return Graph(nodes, edges, boundary, deltas=deltas, distances=distances, bounding_distance=support,
                 indices=indices)


def _cell_list_graph(nodes: Geometry, support, domain: Box, periodic):
    """The cell-list search as named Tensors with the compact dual dim
    '~neighbors': (indices, masked deltas, mask, masked distances)."""
    from ..math._neighbors import cell_list_neighbors
    inst = nodes.shape.instance
    labels = nodes.shape.get_labels('vector')
    pos = nodes.center.torch((inst.names[0], 'vector'))
    lower = np.asarray(domain.lower.numpy()).reshape(-1)
    upper = np.asarray(domain.upper.numpy()).reshape(-1)
    idx, deltas, mask = cell_list_neighbors(pos, float(support), lower, upper, periodic=bool(periodic))
    n, m = idx.shape
    shape2 = Shape((Dim(inst.names[0], n, INSTANCE, None), Dim('~neighbors', m, DUAL, None)))
    shape3 = Shape(shape2.dims + (Dim('vector', len(labels), CHANNEL, tuple(labels)),))
    maskf = mask.to(pos.dtype)
    dist2 = deltas[..., 0] ** 2
    for a in range(1, deltas.shape[-1]):
        dist2 = dist2 + deltas[..., a] ** 2
    deltas_t = Tensor(deltas * maskf[..., None], shape3)
    dist_t = Tensor(torch.sqrt(dist2) * maskf, shape2)
    idx_t = Tensor(torch.where(mask, idx, -1), shape2)
    mask_t = Tensor(mask, shape2)
    return idx_t, deltas_t, mask_t, dist_t


def gather_neighbors(graph: Graph, per_particle: Tensor) -> Tensor:
    """Per-particle values → (particle, ~neighbors) values at each neighbour
    index, 0 where the slot is empty. Requires a compact (cell-list) graph."""
    idx = graph.indices
    assert idx is not None, "gather_neighbors requires a compact (cell-list) graph; pass domain= to neighbor_graph"
    mask = idx >= 0
    safe = ops.where(mask, idx, 0)
    inst = graph.shape.instance.names[0]
    gathered = ops.gather(per_particle, ops.to_int32(safe), dims=inst)
    return gathered * ops.to_float(mask)


def edge_gradient(graph: Graph) -> Tensor:
    """∇W_ij edge vectors reassembled from the packed edge channels
    ('grad_x', 'grad_y', …) as a channel-'vector' tensor."""
    labels = graph.nodes.shape.get_labels('vector')
    comps = [graph.edges[{'vector': f'grad_{l}'}] for l in labels]
    return stack(comps, channel(vector=list(labels)))


def density(graph: Graph, kernel: str, masses=1.) -> Tensor:
    """Summation density ρ_i = m·(W(0) + Σ_j W_ij) from a neighbour graph
    built with compute including 'kernel'."""
    W = graph.edges[{'vector': 'kernel'}]
    w_sum = ops.sum_(W, W.shape.dual.names)
    w0 = evaluate_kernel(None, wrap(0.), graph.bounding_distance, graph.spatial_rank,
                         kernel, types=['kernel'])['kernel']
    return masses * (w0 + w_sum)


def tait_pressure(rho: Tensor, rho0, speed_of_sound: float = 10., gamma: float = 7.,
                  clip_negative: bool = True) -> Tensor:
    """Weakly-compressible Tait equation of state
    P = c₀²ρ₀/γ · ((ρ/ρ₀)^γ − 1); negative (tensile) pressures clipped."""
    P = (speed_of_sound ** 2 * rho0 / gamma) * ((rho / rho0) ** gamma - 1.)
    return ops.maximum(P, 0.) if clip_negative else P


def pressure_acceleration(graph: Graph, pressure: Tensor, rho: Tensor, masses=1.) -> Tensor:
    """Symmetric SPH pressure acceleration
    a_i = −m Σ_j (P_i/ρ_i² + P_j/ρ_j²) ∇_i W_ij.

    The graph's deltas are x_j − x_i, so the stored edge gradient is
    ∇_j W = −∇_i W and the sign folds into a PLUS here. ∇W is zero on empty
    neighbour slots, which annihilates the broadcast P_i term there."""
    p_over_rho2 = pressure / rho ** 2
    pj = gather_neighbors(graph, p_over_rho2)
    pair = p_over_rho2 + pj
    gradW = edge_gradient(graph)
    return masses * ops.sum_(pair * gradW, gradW.shape.dual.names)


def expected_neighbors(volume: Tensor, support_radius, spatial_rank: int):
    """Average neighbour count for a particle volume and a support radius."""
    return Sphere.volume_from_radius(support_radius, spatial_rank) / volume


def evaluate_kernel(delta, distance, h, spatial_rank: int, kernel: str,
                    types: Sequence[str] = ('kernel',)) -> Dict[str, Tensor]:
    """An SPH kernel and / or its derivatives at distances `distance` with
    support (cutoff) radius `h`: 'quintic-spline' (1–3D), 'wendland-c2' and
    'poly6' (2D, 3D). Returns a dict with the keys of `types` ⊂ {'kernel',
    'grad', 'laplace'}; 'grad' is the vector ∇W = dW/dr · δ/r, 0 at r = 0."""
    d = spatial_rank
    r = distance
    result = {}
    if kernel == 'poly6':
        # W = C (h²−r²)³, C₂D = 4/(π h⁸), C₃D = 315/(64 π h⁹)
        if d == 2:
            c = 4 / (PI * h ** 8)
        elif d == 3:
            c = 315 / (64 * PI * h ** 9)
        else:
            raise NotImplementedError(f"poly6 in {d}D")
        r2 = ops.vec_squared(delta) if hasattr(delta, 'shape') and 'vector' in delta.shape else r ** 2
        diff = ops.maximum(h ** 2 - r2, 0.)
        if 'kernel' in types:
            result['kernel'] = c * diff ** 3
        if 'grad' in types:
            # ∇W = −6C (h²−r²)² δ
            result['grad'] = (-6 * c) * diff ** 2 * delta
        if 'laplace' in types:
            # ΔW = 6C (h²−r²)(4r²−d(h²−r²)), the radial Laplacian in d dims
            result['laplace'] = 6 * c * diff * (4 * r2 - d * diff)
        return result
    if kernel == 'wendland-c2':
        # W = C (1−q)⁴ (4q+1), q = r/h; C₂D = 7/(π h²), C₃D = 21/(2 π h³)
        q = ops.clip(r / h, 0., 1.)
        if d == 2:
            c = 7 / (PI * h ** 2)
        elif d == 3:
            c = 21 / (2 * PI * h ** 3)
        else:
            raise NotImplementedError(f"wendland-c2 in {d}D")
        omq = (1 - q)
        if 'kernel' in types:
            result['kernel'] = c * omq ** 4 * (4 * q + 1)
        if 'grad' in types:
            # dW/dr = −20 C q (1−q)³ / h ;  ∇W = dW/dr · δ/r
            dwdr = (-20 * c / h) * q * omq ** 3
            result['grad'] = ops.safe_div(dwdr, r) * delta
        if 'laplace' in types:
            # d²W/dr² + (d−1)/r dW/dr
            d2 = (20 * c / h ** 2) * omq ** 2 * (4 * q - 1)
            dwdr = (-20 * c / h) * q * omq ** 3
            result['laplace'] = d2 + (d - 1) * ops.safe_div(dwdr, r)
        return result
    if kernel == 'quintic-spline':
        # the B-spline of degree 5 with smoothing length h̃ = h/3 (support 3h̃ = h)
        ht = h / 3
        s = ops.clip(r / ht, 0., 3.)
        if d == 1:
            sigma = 1 / (120 * ht)
        elif d == 2:
            sigma = 7 / (478 * PI * ht ** 2)
        elif d == 3:
            sigma = 1 / (120 * PI * ht ** 3)
        else:
            raise NotImplementedError(f"quintic-spline in {d}D")
        t3 = ops.maximum(3 - s, 0.)
        t2 = ops.maximum(2 - s, 0.)
        t1 = ops.maximum(1 - s, 0.)
        if 'kernel' in types:
            result['kernel'] = sigma * (t3 ** 5 - 6 * t2 ** 5 + 15 * t1 ** 5)
        if 'grad' in types:
            dwds = sigma * (-5) * (t3 ** 4 - 6 * t2 ** 4 + 15 * t1 ** 4)
            dwdr = dwds / ht
            result['grad'] = ops.safe_div(dwdr, r) * delta
        if 'laplace' in types:
            d2wds2 = sigma * 20 * (t3 ** 3 - 6 * t2 ** 3 + 15 * t1 ** 3)
            dwds = sigma * (-5) * (t3 ** 4 - 6 * t2 ** 4 + 15 * t1 ** 4)
            result['laplace'] = d2wds2 / ht ** 2 + (d - 1) * ops.safe_div(dwds / ht, r)
        return result
    raise ValueError(f"unknown SPH kernel {kernel!r}")
