"""The port's kernels and their plain twins (mirrors `phiflow_tpu/ops`).

K1–K3 `poisson`, K4 `transfer`, K5 `advect3d`, K6 and K7 `interp`; `_build` compiles and loads
the CUDA sources and counts launches (`_build.LAUNCHES`).
"""
from .poisson import poisson_apply, poisson_smooth, residual_restrict
from .transfer import restrict_mean, prolong_pc, prolong_add
from .advect3d import Source, OutSpec, fused_advect_3d
from .interp import window_interp_2d, window_interp_3d
