"""Axis-aligned boxes on raw position tensors — port of
`phiflow_tpu/geom/_box.py::BaseBox.push` (`:121-135`).
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

__all__ = ['box_push']


def box_push(positions: torch.Tensor, lower: Sequence[float], upper: Sequence[float], outward: bool = True,
             shift_amount: float = 0.0) -> torch.Tensor:
    """Move the positions (N, d) that violate the box [lower, upper], axis by
    axis. ``outward=True``: positions inside are pushed out along their
    closest axis, `shift_amount` beyond the surface. ``outward=False`` — what
    the inverted box `~box` does, the walls of a domain: positions outside are
    pulled in to `shift_amount` inside the surface, at most to the centre."""
    f32 = np.float32
    lo = np.asarray(lower, f32)
    up = np.asarray(upper, f32)
    center = torch.as_tensor((lo + up) * f32(0.5), device=positions.device)
    half_size = torch.as_tensor((up - lo) * f32(0.5), device=positions.device)
    loc_to_center = positions - center
    sgn_dist = torch.abs(loc_to_center) - half_size  # per-axis signed distance
    if outward:
        closest = (sgn_dist >= sgn_dist.max(dim=1, keepdim=True).values - 1e-12) & (sgn_dist < 0)
        shift = closest.to(positions.dtype) * (sgn_dist - shift_amount)
    else:
        shift = (sgn_dist + shift_amount) * (sgn_dist > 0).to(positions.dtype)
        shift = torch.where(torch.abs(shift) > torch.abs(loc_to_center), torch.abs(loc_to_center), shift)
    sign = torch.where(loc_to_center < 0, torch.ones_like(shift), -torch.ones_like(shift))
    return positions + sign * shift
