"""`examples/piv.py` through the port at a small size against `phiflow_tpu`
on the CPU, and a `solve_linear` with a staggered unknown.

PIV at 16² in `Box(x=20, y=20)` with 64 markers: the divergence-free `v0`
(the port's projection of seeded numpy noise) and the markers are numpy
arrays fed to both packages; `advect.points` with `rk4`, dt 0.1. The
coarse fit over a 4² staggered grid (`0 * v0.downsample(4)` in the port;
the JAX package's `downsample2x` takes centred grids only, so its `x0` is
the 4² staggered grid of zeros, the same leaves) and the full-resolution
fit, each 3 L-BFGS iterations. Held to JAX at 1e-4 of each quantity's
scale: the final markers, each fit's loss and gradient at its start and its
result after 3 iterations. 1e-4, not float32 rounding: both sides run in
float32, and the line searches' steps and the L-BFGS history carry each
library's rounding (XLA fuses the loss; torch runs it op by op) into the
iterates.

The staggered solve: (I − 0.1·∇∇·) v = b on a closed box, CG on the
flattened (x faces, y faces) vector: x within 1e-5 of JAX's scale, the
operator of x within 1e-5 of b's, converged."""
import numpy as np
import pytest
import torch

import phiflow_tpu.math as jm
import phiflow_tpu.field as jf
import phiflow_tpu.geom as jg
import phiflow_tpu.physics as jp
import phiflow_tpu_torch.math as tm
import phiflow_tpu_torch.field as tf
import phiflow_tpu_torch.geom as tg
import phiflow_tpu_torch.physics as tp

N, MARKERS, ITERATIONS, TOL = 16, 64, 3, 1e-4


@pytest.fixture(autouse=True, scope='module')
def _cpu():
    with tm.default_device('cpu'):
        yield


def _components(field):
    return [np.asarray(field.values[{'~vector': d}].numpy(('x', 'y'))) for d in 'xy']


def _staggered(m, f, g, comps, n, size=20):
    values = m.stack([m.wrap(c, m.spatial('x,y')) for c in comps], m.dual(vector='x,y'))
    return f.StaggeredGrid(values, 0, g.Box(x=size, y=size), x=n, y=n)


def _close(got, ref, tol=TOL):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= tol * max(np.abs(ref).max(), 1e-30), (np.abs(got - ref).max(), np.abs(ref).max())


def _setup():
    rng = np.random.default_rng(0)
    noise = [rng.standard_normal((N - 1, N)).astype(np.float32), rng.standard_normal((N, N - 1)).astype(np.float32)]
    v0, _ = tp.fluid.make_incompressible(_staggered(tm, tf, tg, [torch.from_numpy(c) for c in noise], N))
    return _components(v0), rng.uniform(0, 20, (MARKERS, 2)).astype(np.float32)


def _piv(m, f, g, p, v0_comps, markers_np):
    """The example's two fits in one package: (final markers, fit1, fit2,
    the losses and gradients at each fit's start)."""
    v0 = _staggered(m, f, g, v0_comps, N)
    markers = m.wrap(markers_np, m.instance('markers'), m.channel(vector='x,y'))

    @m.jit_compile  # as the example has it (JAX: one trace of the advection for all the loss's traces)
    def simulate(v):
        return p.advect.points(markers, v, dt=.1, integrator=p.advect.rk4)

    final = simulate(v0)
    coarse = (0 * v0.downsample(4)) if m is tm else f.StaggeredGrid(0, 0, g.Box(x=20, y=20), x=N // 4, y=N // 4)
    loss1 = lambda x: m.l2_loss(final - simulate(f.resample(x, to=v0)))
    start1 = m.gradient(loss1, get_output=True)(coarse)
    fit1 = m.minimize(loss1, m.Solve('L-BFGS-B', abs_tol=1e-6, x0=coarse, max_iterations=ITERATIONS))
    fit1_fine = f.resample(fit1, to=v0)
    loss2 = lambda x: m.l2_loss(final - simulate(x + fit1_fine))
    start2 = m.gradient(loss2, get_output=True)(0 * v0)
    fit2 = m.minimize(loss2, m.Solve('L-BFGS-B', abs_tol=1e-6, x0=0 * v0, max_iterations=ITERATIONS))
    return final, fit1, fit2, (start1, start2), float(m.l2_loss(final - simulate(fit1_fine + fit2)))


def test_piv_against_jax():
    v0_comps, markers = _setup()
    port = _piv(tm, tf, tg, tp, [torch.from_numpy(c) for c in v0_comps], markers)
    ref = _piv(jm, jf, jg, jp, v0_comps, markers)
    _close(port[0].numpy(('markers', 'vector')), ref[0].numpy(('markers', 'vector')), 1e-5)
    for got, want in zip(port[3], ref[3]):  # loss and gradient at each fit's start
        _close(float(got[0]), float(want[0]), 1e-5)
        for a, b in zip(_components(got[1]), _components(want[1])):
            _close(a, b, 1e-5)
    for k in (1, 2):  # each fit after its 3 iterations
        assert [c.shape for c in _components(port[k])] == [c.shape for c in _components(ref[k])]
        for a, b in zip(_components(port[k]), _components(ref[k])):
            _close(a, b)
    _close(port[4], ref[4])
    assert port[4] < 0.5 * float(port[3][0][0])  # the two fits at least halve the marker loss of v = 0


def test_staggered_solve_linear_against_jax():
    """CG on a staggered unknown (formerly refused): (I − 0.1·∇∇·) v = b."""
    rng = np.random.default_rng(5)
    n = 8
    comps = [rng.standard_normal((n - 1, n)).astype(np.float32), rng.standard_normal((n, n - 1)).astype(np.float32)]
    out = {}
    for name, m, f, g in (('jax', jm, jf, jg), ('port', tm, tf, tg)):
        b = _staggered(m, f, g, comps, n, size=n)

        def op(v):
            return v - 0.1 * f.spatial_gradient(f.divergence(v), boundary=0, at='face')
        with m.SolveTape() as tape:
            x = m.solve_linear(op, b, m.Solve('CG', 1e-6, 1e-6, x0=0 * b))
        out[name] = (_components(x), _components(op(x)), tape[0].iterations, tape[0].converged)
    for a, r in zip(out['port'][0], out['jax'][0]):
        _close(a, r, 1e-5)
    for a, r in zip(out['port'][1], comps):
        _close(a, r, 1e-5)
    assert out['port'][3]
