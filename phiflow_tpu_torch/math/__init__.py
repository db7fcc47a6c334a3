"""The solver pieces of the pressure projection and the window interpolation of
the advection (mirrors `phiflow_tpu/math`)."""
from ._multigrid import make_poisson_vcycle
from ._nd import BOUNDARY, PERIODIC, masked_fill, shift_window_interp
from ._solve import SolveResult, cg
