"""The spline chute of `test_torch_spline_flip.py` as an obstacle at 16³,
both packages: its hard and soft masks on a grid's cells and faces, its
push, and `make_incompressible` with it as an Obstacle (its masks in the
masked stencil's mA / c0: K1m on the card). JAX's side queries the chute
through `_FlatJaxChute` (one padded shape, op by op)."""
import numpy as np
import pytest

from test_torch_spline_flip import N, PKGS, _scaled, chute
from phiflow_tpu_torch import math as tmath


@pytest.fixture(autouse=True)
def _cpu():
    with tmath.default_device('cpu'):
        yield


def test_chute_masks_and_push_match_jax():
    """The hard mask (cells whose centre lies inside) and the soft one (the
    fraction inside) of the chute on a 16³ grid's cells and faces equal to
    JAX's; the push of 2000 points within 1e-5 of the domain."""
    out = {}
    pts = np.random.default_rng(5).uniform(0, N, (2000, 3)).astype(np.float32)
    for pkg in PKGS:
        math, geom, field, fluid, advect = PKGS[pkg]
        ch = chute(pkg)
        c = field.CenteredGrid(0, 0, geom.Box(x=N, y=N, z=N), x=N, y=N, z=N)
        s = field.StaggeredGrid(0, 0, geom.Box(x=N, y=N, z=N), x=N, y=N, z=N)
        hard = field.resample(ch, c, soft=False)
        soft = field.resample(ch, c, soft=True)
        soft_faces = field.resample(ch, s, soft=True)
        loc = math.tensor(pts, math.instance('p'), math.channel(vector='x,y,z'))
        out[pkg] = [np.asarray(hard.values.numpy('x,y,z')), np.asarray(soft.values.numpy('x,y,z'))] \
            + [np.asarray(soft_faces.values.vector[d].numpy('x,y,z')) for d in 'xyz'] \
            + [np.asarray(ch.push(loc, shift_amount=0.5).numpy(('p', 'vector')))]
    j, t = out['jax'], out['torch']
    assert 0 < j[0].sum() < N ** 3
    np.testing.assert_array_equal(t[0], j[0])
    for k in range(1, 5):
        np.testing.assert_allclose(t[k], j[k], atol=1e-5)
    _scaled(t[5], j[5], 'push', 1e-5)


def test_chute_obstacle_projection_matches_jax():
    """make_incompressible with the chute as an Obstacle at 16³: the
    projected velocity within 1e-4 of its scale, the same CG count where
    JAX reports one (its eager masked solve reports -1)."""
    out = {}
    for pkg in PKGS:
        math, geom, field, fluid, advect = PKGS[pkg]
        flow = lambda p: math.stack({'x': math.sin(p.vector['y'] / 2) + 0.3, 'y': math.cos(p.vector['z'] / 3),
                                     'z': math.sin(p.vector['x'] / 2) - 0.5}, math.channel(vector='x,y,z'))
        v = field.StaggeredGrid(flow, 0, geom.Box(x=N, y=N, z=N), x=N, y=N, z=N)
        with math.SolveTape() as tape:
            v, _ = fluid.make_incompressible(v, [fluid.Obstacle(chute(pkg))],
                                             solve=math.Solve('CG', 1e-5, 1e-5, max_iterations=500))
        out[pkg] = ([np.asarray(v.values.vector[d].numpy('x,y,z')) for d in 'xyz'], tape[0].iterations)
    (jv, ji), (tv, ti) = out['jax'], out['torch']
    for d in range(3):
        _scaled(tv[d], jv[d], f'v{"xyz"[d]}', 1e-4)
    ji, ti = int(np.asarray(ji).max()), int(np.asarray(ti).max())
    assert ti > 0 and (ji < 0 or ji == ti), (ji, ti)
