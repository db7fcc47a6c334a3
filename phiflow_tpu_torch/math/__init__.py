"""The solver pieces of the pressure projection (mirrors `phiflow_tpu/math`)."""
from ._multigrid import make_poisson_vcycle
from ._solve import SolveResult, cg
