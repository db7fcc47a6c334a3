"""mesh-channel-3d at a small size against the JAX package: a hex channel
past a cube (unit hexahedra over [0, nx] × [0, ny] × [0, nz] without the
cube's cells; groups inlet, outlet, walls, cube), CylinderWake's step in 3D
(BiCGStab momentum on `_momentum_eq`, `make_incompressible` with 'auto':
BiCGStab and the mesh Chebyshev preconditioner), two steps at 12 × 6 × 6
with a 2³ cube: velocity and pressure within 1e-4 of scale, equal BiCGStab
counts, |div| below its value before each projection. `chip_smoke.py`
phase 11 runs the same recipe at 96 × 32 × 32 on the card."""
import numpy as np
import pytest

import phiflow_tpu.field as jf
import phiflow_tpu.geom as jg
import phiflow_tpu.math as jm
import phiflow_tpu.models.cylinder_wake as jcw
import phiflow_tpu.physics.fluid as jfl
import phiflow_tpu_torch.field as tf
import phiflow_tpu_torch.geom as tg
import phiflow_tpu_torch.math as tm
import phiflow_tpu_torch.models.cylinder_wake as tcw
import phiflow_tpu_torch.physics.fluid as tfl

PKGS = {'jax': (jm, jg, jf, jfl, jcw), 'port': (tm, tg, tf, tfl, tcw)}


@pytest.fixture(autouse=True)
def _cpu():
    with tm.default_device('cpu'):
        yield


def _np(t, order):
    return np.asarray(t.numpy(order))


def _channel_arrays(nx, ny, nz, cube):
    """(points, hexes, groups) of unit hexes over [0, nx] × [0, ny] × [0, nz]
    without the cells of `cube` ((lo, hi) cells an axis): groups inlet (x = 0),
    outlet (x = nx), walls (y, z on the box) and cube, each an (n, 4) array of
    the hexes' boundary faces."""
    vid = np.arange((nx + 1) * (ny + 1) * (nz + 1)).reshape(nx + 1, ny + 1, nz + 1)
    pts = np.stack(np.meshgrid(np.arange(nx + 1), np.arange(ny + 1), np.arange(nz + 1), indexing='ij'), -1)
    pts = pts.reshape(-1, 3).astype(np.float32)
    keep = np.ones((nx, ny, nz), bool)
    keep[tuple(slice(lo, hi) for lo, hi in cube)] = False
    i, j, k = np.nonzero(keep)
    hexes = np.stack([vid[i, j, k], vid[i + 1, j, k], vid[i + 1, j + 1, k], vid[i, j + 1, k],
                      vid[i, j, k + 1], vid[i + 1, j, k + 1], vid[i + 1, j + 1, k + 1], vid[i, j + 1, k + 1]], 1)
    padded = np.zeros((nx + 2, ny + 2, nz + 2), bool)
    padded[1:-1, 1:-1, 1:-1] = keep
    groups = {'inlet': [], 'outlet': [], 'walls': [], 'cube': []}
    for tpl, (dx, dy, dz) in (((0, 3, 2, 1), (0, 0, -1)), ((4, 5, 6, 7), (0, 0, 1)), ((0, 1, 5, 4), (0, -1, 0)),
                              ((1, 2, 6, 5), (1, 0, 0)), ((2, 3, 7, 6), (0, 1, 0)), ((3, 0, 4, 7), (-1, 0, 0))):
        faces = hexes[~padded[i + 1 + dx, j + 1 + dy, k + 1 + dz]][:, list(tpl)]
        c = pts[faces].mean(1)
        inlet, outlet = c[:, 0] == 0, c[:, 0] == nx
        walls = ~inlet & ~outlet & ((c[:, 1] == 0) | (c[:, 1] == ny) | (c[:, 2] == 0) | (c[:, 2] == nz))
        for name, sel in (('inlet', inlet), ('outlet', outlet), ('walls', walls), ('cube', ~(inlet | outlet | walls))):
            groups[name].append(faces[sel])
    return pts, hexes, {name: np.concatenate(f) for name, f in groups.items()}


def _write_su2(path, pts, hexes, groups):
    with open(path, 'w') as f:
        f.write(f'NDIME= 3\nNELEM= {len(hexes)}\n')
        f.writelines(f'12 {" ".join(map(str, h))} {e}\n' for e, h in enumerate(hexes))
        f.write(f'NPOIN= {len(pts)}\n')
        f.writelines(f'{x:g} {y:g} {z:g} {n}\n' for n, (x, y, z) in enumerate(pts))
        f.write(f'NMARK= {len(groups)}\n')
        for name, faces in groups.items():
            f.write(f'MARKER_TAG= {name}\nMARKER_ELEMS= {len(faces)}\n')
            f.writelines(f'9 {" ".join(map(str, q))}\n' for q in faces)


def _channel_state(pkg, nx, ny, nz, cube):
    m, g, f, fluid, cw = pkg
    pts, hexes, groups = _channel_arrays(nx, ny, nz, cube)
    mesh = g.mesh_from_numpy(pts, hexes, groups)
    one = m.vec(x=1., y=0., z=0.)
    bc = {'inlet': one, 'outlet': m.extrapolation.ZERO_GRADIENT, 'walls': one, 'cube': 0.}
    cx = mesh.center[{'vector': 'x'}]
    kick = 0.05 * m.exp(-(cx - (cube[0][0] + cube[0][1]) / 2) ** 2)
    v = f.Field(mesh, m.stack({'x': m.ones_like(cx), 'y': kick, 'z': m.zeros_like(cx)}, m.channel(vector='x,y,z')), bc)
    return v, f.Field(mesh, m.zeros_like(cx), fluid._pressure_extrapolation(v.boundary))


def _channel_step(pkg, v, p, dt=0.5, viscosity=8 / 150, tol=1e-4, max_iterations=500):
    m, g, f, fluid, cw = pkg
    mom = m.Solve('biCG-stab', tol, tol, x0=v, max_iterations=max_iterations, suppress=(m.ConvergenceException,))
    v = m.solve_linear(cw._momentum_eq, v, mom, v, dt, viscosity, False)
    div = f.divergence(v)
    prs = m.Solve('auto', tol, tol, x0=p, max_iterations=max_iterations, suppress=(m.ConvergenceException,))
    v, p = fluid.make_incompressible(v, (), prs)
    return v, p, div


def test_mesh_channel_3d_two_steps():
    """Two steps of mesh-channel-3d at 12 × 6 × 6 with a 2³ cube: velocity and
    pressure within 1e-4 of scale of JAX's (its step traced once), equal
    BiCGStab counts, |div| below its value before each projection."""
    import jax
    cube = ((2, 4), (2, 4), (2, 4))
    states, counts = {}, {'port': [], 'jax': []}
    for name, pkg in PKGS.items():
        m, f = pkg[0], pkg[2]
        v, p = _channel_state(pkg, 12, 6, 6, cube)
        assert v.geometry.cell_count == 12 * 6 * 6 - 8
        step = jax.jit(lambda v, p: _channel_step(PKGS['jax'], v, p)) if name == 'jax' else \
            (lambda v, p: _channel_step(pkg, v, p))
        with (m.SolveTape(record_runtime=True) if name == 'jax' else m.SolveTape()) as tape:
            for _ in range(2):
                v, p, div = step(v, p)
                assert float(m.max(abs(f.divergence(v).values))) < float(m.max(abs(div.values)))
                if name == 'jax':
                    counts['jax'] += [i.runtime_stats['iterations'] for i in tape.solve_infos[-2:]]
        if name == 'port':
            counts['port'] = [r.iterations for r in tape]
        states[name] = (_np(v.values, ('cells', 'vector')), _np(p.values, 'cells'))
    for a, b in zip(states['port'], states['jax']):
        assert np.isfinite(a).all()
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4 * np.abs(b).max())
    assert counts['port'] == counts['jax'] and len(counts['port']) == 4
