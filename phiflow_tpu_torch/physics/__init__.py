"""Physics of the port (mirrors `phiflow_tpu/physics`)."""
from . import advect, diffuse, fluid, integrate, sph
