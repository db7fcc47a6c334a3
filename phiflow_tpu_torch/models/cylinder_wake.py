"""FVM cylinder wake — port of `phiflow_tpu/models/cylinder_wake.py::CylinderWake`.

Vortex shedding behind a circular cylinder in a free stream, on a quad FVM
mesh (`geom/_mesh.py::build_mesh`, the cells whose centre lies inside the
cylinder left out). Operator-split incompressible Navier-Stokes, line by
line as in the JAX package: backward-Euler momentum with FVM advection and
viscous diffusion (`_momentum_eq`, affine through its Dirichlet walls),
solved by BiCGStab from the previous velocity; then the pressure projection,
BiCGStab preconditioned by Chebyshev(Jacobi) on the mesh Laplacian
(`physics/fluid.py::_make_incompressible_mesh`). Free-stream Dirichlet
inflow and side walls, zero-gradient outflow, the obstacle's faces in the
default 'boundary' group at rest. Both solves suppress
`ConvergenceException`: a step goes on from an unconverged solve, as in the
JAX package. `forces(p)` is the pressure force on the cylinder.

The mesh is built on the host once, at construction, and its tables put on
the model's device once; a step then moves only Python numbers to the
device. No kernel of the port's own lies on this path: every operator is
PyTorch, as it is XLA in the JAX package. Each BiCGStab iteration reads its
stopping test on the host (one device sync).
"""
from __future__ import annotations

import numpy as np

from .. import resolve_device
from ..math import Tensor, Solve, ConvergenceException, channel, vec, default_device
from ..math import _ops as ops
from ..math import solve_linear, jit_compile_linear
from ..math.extrapolation import ZERO_GRADIENT
from ..geom import Box, Sphere
from ..geom._mesh import build_mesh
from ..field import Field, laplace as field_laplace
from ..physics import advect, fluid

__all__ = ['CylinderWake']


@jit_compile_linear(auxiliary_args='dt,viscosity,upwind', forget_traces=True)
def _momentum_eq(u, u_prev, dt, viscosity, upwind=True):
    """Backward-Euler operator u − dt·(−u_prev·∇u + ν Δu) = u_prev.
    upwind=False takes central (linear) face values."""
    diffusion = viscosity * field_laplace(u).values
    advection = advect.differential(u, u_prev, order=1, upwind=upwind).values
    return u.with_values(u.values - dt * (advection + diffusion))


class CylinderWake:
    """Flow past a circular cylinder in a free stream on a quad FVM mesh. The
    constructor takes JAX's arguments, then `device` (CUDA unless 'cpu')."""

    def __init__(self, nx: int = 400, ny: int = 128, re: float = 150., dt: float = 0.05,
                 domain: Box = None, diameter: float = 0.5, perturb: float = 0.05,
                 solve_tol: float = 1e-4, max_iterations: int = 500, upwind: bool = False, device=None):
        self.device = resolve_device(device)
        self.domain = domain if domain is not None else Box(x=8., y=4.)
        size = np.asarray((self.domain.upper - self.domain.lower).native())
        center = np.asarray(self.domain.lower.native()) + np.array([size[0] * 0.25, size[1] * 0.5])
        self.diameter = diameter
        self.re = re
        self.viscosity = 1.0 * diameter / re  # U∞ = 1
        self.dt = dt
        self.perturb = perturb
        self.solve_tol = solve_tol
        self.max_iterations = max_iterations
        self.upwind = upwind
        self.cylinder = Sphere(x=float(center[0]), y=float(center[1]), radius=diameter / 2)
        with default_device(self.device):
            self.mesh = build_mesh(self.domain, x=nx, y=ny, obstacles=self.cylinder)
        self.n_cells = self.mesh.cell_count
        # free-stream Dirichlet far-field walls keep the outer flow uniform;
        # the unnamed obstacle faces fall into the default 'boundary' group
        self.bc = {'x-': vec(x=1., y=0.), 'x+': ZERO_GRADIENT,
                   'y-': vec(x=1., y=0.), 'y+': vec(x=1., y=0.), 'boundary': 0.}

    def initial_state(self):
        """Uniform stream plus a transverse kick upstream of the cylinder that
        seeds the shedding instability; the velocity's values in (cells,
        vector) order, as the solver returns them."""
        from . import to_device
        cx = self.mesh.center[{'vector': 'x'}]
        vy = self.perturb * ops.exp(-(cx - self.cylinder.center[{'vector': 'x'}]) ** 2)
        values = ops.stack({'x': ops.ones_like(cx), 'y': vy}, channel(vector='x,y'))
        values = Tensor(values.native(('cells', 'vector')).contiguous(),
                        values.shape.only(['cells', 'vector'], reorder=True))
        v = Field(self.mesh, values, self.bc)
        p = Field(self.mesh, ops.zeros_like(cx), fluid._pressure_extrapolation(v.boundary))
        return to_device((v, p), self.device)

    def step(self, v: Field, p: Field):
        mom_solve = Solve('biCG-stab', self.solve_tol, self.solve_tol, x0=v,
                          max_iterations=self.max_iterations, suppress=(ConvergenceException,))
        v = solve_linear(_momentum_eq, v, mom_solve, v, self.dt, self.viscosity, self.upwind)
        prs_solve = Solve('auto', self.solve_tol, self.solve_tol, x0=p,
                          max_iterations=self.max_iterations, suppress=(ConvergenceException,))
        v, p = fluid.make_incompressible(v, (), prs_solve)
        return v, p

    def forces(self, p: Field) -> Tensor:
        """Pressure force on the cylinder, F = Σ_faces p A n̂ over the obstacle
        ('boundary') faces — n̂ is the fluid cell's outward normal, which
        points into the body. A vector: drag = F·x̂, lift = F·ŷ."""
        mask = self.mesh.boundary_mask('boundary')
        contrib = mask * p.values * self.mesh.face_areas * self.mesh.face_normals
        return ops.sum_(ops.sum_(contrib, '~faces'), 'cells')
