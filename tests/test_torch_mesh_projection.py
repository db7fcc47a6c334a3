"""Why a projection of mesh-channel-3d leaves about half of its
divergence, held against the JAX package at 12 × 6 × 6: the collocated
scheme solves the compact mesh Laplacian and subtracts the Green-Gauss
gradient, whose divergence is the wide Laplacian. `chip_smoke.py` phase 11
gates the full-size channel on the same readings."""
import numpy as np
import pytest

import phiflow_tpu_torch.math as tm
from test_torch_mesh_channel import PKGS, _channel_state, _np


@pytest.fixture(autouse=True)
def _cpu():
    with tm.default_device('cpu'):
        yield


def _projection_readings(pkg, v_mom, p, v_after):
    """(pressure residual |L p − div| / |div| in L2, max |div after − (div − D G p)| / max |div|, max |div after −
    (L p − D G p)| / max |div|, L p − D G p as numpy): L the compact mesh Laplacian `make_incompressible` solves,
    G the Green-Gauss gradient it subtracts, D the divergence under the velocity boundary's linear part."""
    m, g, f, fluid, cw = pkg
    D = lambda field: _np(field.values, 'cells').astype(np.float64)
    lap = fluid.masked_laplace(p, v_mom.boundary, None, None, wide_stencil=False, order=2)
    grad = f.spatial_gradient(p, v_mom.boundary, at='center', order=2)
    wide = f.divergence(grad.with_boundary(m.extrapolation.remove_constant_offset(v_mom.boundary)))
    b, a, L, W = D(f.divergence(v_mom)), D(f.divergence(v_after)), D(lap), D(wide)
    scale = np.abs(b).max()
    return (np.linalg.norm(L - b) / np.linalg.norm(b), np.abs(a - (b - W)).max() / scale,
            np.abs(a - (L - W)).max() / scale, L - W)


def test_mesh_channel_3d_projection_leaves_the_wide_laplacian():
    """One projection of mesh-channel-3d at 12 × 6 × 6: in both packages the
    pressure solve converges (|L p − div| ≤ 1e-3 of |div| in L2), the step
    subtracts the Green-Gauss gradient (div after = div − D G p within 1e-4 of
    max |div|), and what is left of the divergence is L p − D G p, the compact
    Laplacian the solve inverts less the wide one of the collocated gradient
    (within 1e-3 of max |div|): about half of max |div|. The port's remainder
    equals JAX's within 1e-4 of max |div|. `chip_smoke.py` phase 11 gates the
    full-size channel on the same readings."""
    import jax
    cube = ((2, 4), (2, 4), (2, 4))
    rest = {}
    for name, pkg in PKGS.items():
        m, g, f, fluid, cw = pkg

        def step(v, p):
            mom = m.Solve('biCG-stab', 1e-4, 1e-4, x0=v, max_iterations=500, suppress=(m.ConvergenceException,))
            v = m.solve_linear(cw._momentum_eq, v, mom, v, 0.5, 8 / 150, False)
            prs = m.Solve('auto', 1e-4, 1e-4, x0=p, max_iterations=500, suppress=(m.ConvergenceException,))
            return (v,) + fluid.make_incompressible(v, (), prs)
        v, after, p = (jax.jit(step) if name == 'jax' else step)(*_channel_state(pkg, 12, 6, 6, cube))
        residual, subtracted, remainder, rest[name] = _projection_readings(pkg, v, p, after)
        assert residual <= 1e-3 and subtracted <= 1e-4 and remainder <= 1e-3, (name, residual, subtracted, remainder)
        scale = np.abs(_np(f.divergence(v).values, 'cells')).max()
        assert 0.3 * scale <= np.abs(rest[name]).max() <= 0.7 * scale
    np.testing.assert_allclose(rest['port'], rest['jax'], rtol=0, atol=1e-4 * np.abs(rest['jax']).max())
