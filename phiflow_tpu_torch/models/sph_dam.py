"""Weakly-compressible SPH dam break — port of
`phiflow_tpu/models/sph_dam.py::SphDamBreak`.

A block of nx × ny particles at spacing dx collapses under gravity inside a
unit box. One step, through the Field API as in the JAX package: the
cell-list `neighbor_graph` (Wendland C2 kernel and gradient on the compact
edges), the summation `density`, the Tait equation of state, the symmetric
`pressure_acceleration`, penalty walls and gravity, a mild damping and a
speed cap, and the particles clipped to [−0.02, 1.02]. All of it is PyTorch
operations on the particles' device; the cell list makes no device→host
sync.

The default block (50 × 200 at dx = 0.008) is 1.64 high: the cell list
clamps the particles above y = 1 into its top row of cells, whose buckets
overflow (3688 of 10,000 particles dropped at step 0, the same ones as in
the JAX package), and the first step clips them onto y = 1.02.
"""
from __future__ import annotations

import numpy as np

from .. import resolve_device
from ..math import Tensor, wrap, instance, channel
from ..math import _ops as ops
from ..geom import Box, Sphere
from ..field import Field, PointCloud
from ..physics import sph

__all__ = ['SphDamBreak']


class SphDamBreak:
    """A block of SPH particles collapsing under gravity inside a unit box.
    The constructor takes JAX's arguments, then `device` (CUDA unless
    'cpu')."""

    KERNEL = 'wendland-c2'

    def __init__(self, nx: int = 50, ny: int = 200, dx: float = 0.008,
                 dt: float = 2e-4, gravity: float = -9.81,
                 speed_of_sound: float = 12., wall_stiffness: float = 20000., device=None):
        from . import _put, to_device
        self.device = resolve_device(device)
        self.dt = dt
        self.gravity = gravity
        self.c0 = speed_of_sound
        self.k_wall = wall_stiffness
        self.domain = Box(x=1., y=1.)
        self.mass = 1.0
        xs, ys = np.meshgrid(np.arange(nx) * dx + 0.05, np.arange(ny) * dx + 0.05, indexing='ij')
        pos = np.stack([xs.ravel(), ys.ravel()], -1).astype(np.float32)
        self.n_particles = pos.shape[0]
        pts = wrap(pos, instance(points=self.n_particles), channel(vector='x,y'))
        # particle radius dx/2 → Wendland support √22·r ≈ 2.35·dx; a host number: it sizes the cell list
        self.support = float(np.sqrt(22.0) * dx / 2)
        self.particles0 = PointCloud(Sphere(pts, radius=dx / 2)) * (0., 0.)
        # JAX's gravity vector, made once on the device rather than copied there every step
        self._g = _put(wrap([0., self.gravity], channel(vector='x,y')), self.device)
        # rest density calibrated to the DISCRETE kernel sum of the initial packing, on the host
        rho = self._density(to_device(self.particles0, self.device))
        self.rho0 = float(np.quantile(rho.numpy(), 0.9))

    def _graph(self, particles: Field):
        return sph.neighbor_graph(particles.geometry, self.KERNEL, compute='kernel,grad',
                                  domain=self.domain, search_method='cell-list',
                                  support_radius=self.support)

    def _density(self, particles: Field) -> Tensor:
        return sph.density(self._graph(particles), self.KERNEL, self.mass)

    def initial_state(self):
        from . import to_device
        return to_device((self.particles0,), self.device)

    def step(self, particles: Field):
        graph = self._graph(particles)
        rho = sph.density(graph, self.KERNEL, self.mass)
        P = sph.tait_pressure(rho, self.rho0, self.c0)
        acc = sph.pressure_acceleration(graph, P, rho, self.mass)
        pos = particles.geometry.center
        # penalty walls + gravity
        wall = self.k_wall * (ops.maximum(0.02 - pos, 0.) - ops.maximum(pos - 0.98, 0.))
        g = self._g
        vel = particles.values + self.dt * (acc + wall + g)
        vel = ops.clip(vel * 0.999, -3., 3.)  # mild damping + speed cap
        pos = ops.clip(pos + self.dt * vel, -0.02, 1.02)
        new = particles.with_geometry(particles.geometry.at(pos)).with_values(vel)
        return (new,)
