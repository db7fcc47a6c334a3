"""Physics of the port (mirrors `phiflow_tpu/physics`)."""
from . import advect, diffuse, fluid, integrate, sph
from .fluid import Obstacle, make_incompressible, apply_boundary_conditions, boundary_push, incompressible_rk4
from ._boundaries import Domain, OPEN, CLOSED, PERIODIC_DOMAIN, STICKY, SLIPPERY
