"""The port's `physics/sph.py` and `geom/_graph.py` against the JAX
package's on the same numpy inputs, on the CPU.

`evaluate_kernel`: the three kernels × 2D and 3D × kernel / grad / laplace,
r = 0 and r beyond the support included, within 1e-5 relative (of the
largest value). `neighbor_graph` dense and compact, `density`,
`tait_pressure` and `pressure_acceleration` on a jittered lattice, within
1e-5 relative; then the port's analogues of `tests/physics/test_sph.py` and
of the two non-model tests of `tests/physics/test_sph_e2e.py` (the cell-list
ones are in `test_torch_sph_neighbors.py`, the dam break's in
`test_torch_sph_dam.py`), and `Graph` / `graph`."""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import phiflow_tpu.math as jm
from phiflow_tpu.geom import Box as JBox, Sphere as JSphere
from phiflow_tpu.physics import sph as jsph

import phiflow_tpu_torch.math as tm
from phiflow_tpu_torch.geom import Box, Graph, Point, Sphere, graph
from phiflow_tpu_torch.physics import sph


@pytest.fixture(autouse=True, scope='module')
def _cpu():
    with tm.default_device('cpu'):
        yield


def _close(got, ref, order=None, rel=1e-5):
    got = got.numpy(order) if order else got.numpy()
    ref = np.asarray(ref.native(order) if order else ref.native())
    scale = max(float(np.abs(ref).max()), 1e-30)
    np.testing.assert_allclose(got, ref, rtol=rel, atol=rel * scale)


def _points(pos, d):
    """JAX's and the port's point Tensors of the (N, d) numpy positions (a torch native for the port)."""
    labels = 'x,y' if d == 2 else 'x,y,z'
    j = jm.wrap(jnp.asarray(pos), jm.instance(points=pos.shape[0]), jm.channel(vector=labels))
    t = tm.wrap(torch.from_numpy(pos.copy()), tm.instance(points=pos.shape[0]), tm.channel(vector=labels))
    return j, t


def _jittered_lattice(n=12, spacing=0.02, d=2, jitter=0.15, seed=0):
    pts = np.array(list(itertools.product(*[range(n)] * d)), np.float32) * spacing + 0.3
    pts += np.random.default_rng(seed).uniform(-jitter, jitter, pts.shape).astype(np.float32) * spacing
    return pts.astype(np.float32)


@pytest.mark.parametrize('kernel', ['poly6', 'wendland-c2', 'quintic-spline'])
@pytest.mark.parametrize('d', [2, 3])
def test_evaluate_kernel(kernel, d):
    rng = np.random.default_rng(d)
    delta = rng.uniform(-0.4, 0.4, (64, d)).astype(np.float32)
    delta[:3] = 0.  # r = 0: the self pair and coincident particles
    dist = np.sqrt((delta ** 2).sum(-1)).astype(np.float32)
    jd, td = _points(delta, d)
    jr = jm.wrap(jnp.asarray(dist), jm.instance(points=64))
    tr = tm.wrap(torch.from_numpy(dist), tm.instance(points=64))
    types = ['kernel', 'grad', 'laplace']
    ref = jsph.evaluate_kernel(jd, jr, jm.wrap(0.3), d, kernel, types=types)
    got = sph.evaluate_kernel(td, tr, tm.wrap(0.3), d, kernel, types=types)
    assert set(got) == set(types)
    for t in types:
        order = ('points', 'vector') if t == 'grad' else ('points',)
        _close(got[t], ref[t], order)
        assert np.isfinite(got[t].numpy(order)).all()
    np.testing.assert_array_equal(got['grad'].numpy(('points', 'vector'))[:3], 0.)


def _domain(d):
    return (JBox(x=1., y=1.), Box(x=1., y=1.)) if d == 2 else (JBox(x=1., y=1., z=1.), Box(x=1., y=1., z=1.))


def _jax_points(pos):
    d = pos.shape[-1]
    return jm.wrap(pos, jm.instance(points=pos.shape[0]), jm.channel(vector='x,y' if d == 2 else 'x,y,z'))


@pytest.mark.parametrize('format', ['dense', 'compact'])
@pytest.mark.parametrize('d', [2, 3])
def test_neighbor_graph(format, d):
    """Edges ('kernel', 'grad_*', 'laplace'), deltas, distances and the
    support radius (from the particles' volume in the dense case)."""
    pos = _jittered_lattice(n=9 if d == 2 else 5, d=d)
    jdom, tdom = _domain(d)
    kw = dict(compute='kernel,grad,laplace', format=format)
    if format == 'compact':  # a host support radius (JAX's cell list needs one under jit): 22 neighbours' sphere
        kw['support_radius'] = float(JSphere.radius_from_volume(JSphere.volume_from_radius(0.01, d) * 22, d))
    dual = '~neighbors' if format == 'compact' else '~points'

    @jax.jit
    def reference(p):  # JAX's graph, jitted (its eager ops compile one by one)
        g = jsph.neighbor_graph(JSphere(_jax_points(p), radius=0.01), 'wendland-c2',
                                **dict(kw, domain=jdom) if format == 'compact' else kw)
        return dict(edges=g.edges.native(('points', dual, 'vector')), deltas=g.deltas.native(('points', dual, 'vector')),
                    distances=g.distances.native(('points', dual)), support=g.bounding_distance.native(),
                    indices=g.indices.native(('points', dual)) if g.is_compact else jnp.zeros(()),
                    labels=jnp.zeros(g.edges.shape.get_size('vector')))
    ref = reference(jnp.asarray(pos))
    _, tp = _points(pos, d)
    got = sph.neighbor_graph(Sphere(tp, radius=0.01), 'wendland-c2', **dict(kw, domain=tdom) if format == 'compact' else kw)
    assert got.is_compact == (format == 'compact')
    assert got.edges.shape.get_labels('vector') == ('kernel',) + tuple(f'grad_{l}' for l in 'xyz'[:d]) + ('laplace',)
    np.testing.assert_allclose(float(got.bounding_distance), float(ref['support']), rtol=1e-6)
    for name, order in (('edges', ('points', dual, 'vector')), ('deltas', ('points', dual, 'vector')),
                        ('distances', ('points', dual))):
        got_n, ref_n = getattr(got, name).numpy(order), np.asarray(ref[name])
        np.testing.assert_allclose(got_n, ref_n, rtol=1e-5, atol=1e-5 * float(np.abs(ref_n).max()))
    if format == 'compact':
        np.testing.assert_array_equal(got.indices.numpy(('points', dual)), np.asarray(ref['indices']))


@pytest.mark.parametrize('d', [2, 3])
def test_density_pressure_acceleration(d):
    """The dam break's chain on a jittered lattice: density, Tait pressure
    (unclipped and clipped), pressure acceleration, the neighbours' values."""
    pos = _jittered_lattice(n=14 if d == 2 else 6, d=d, seed=d)
    support = float(np.sqrt(22.0) * 0.02 / 2)
    jdom, tdom = _domain(d)
    _, tp = _points(pos, d)
    g = sph.neighbor_graph(Sphere(tp, radius=0.01), 'wendland-c2', domain=tdom, search_method='cell-list',
                           support_radius=support)
    rho = sph.density(g, 'wendland-c2', 2.)
    rho0 = float(np.median(rho.numpy()))  # half the particles compressed, half in tension

    @jax.jit
    def reference(p, rho0):
        g = jsph.neighbor_graph(JSphere(_jax_points(p), radius=0.01), 'wendland-c2', domain=jdom,
                                search_method='cell-list', support_radius=support)
        rho = jsph.density(g, 'wendland-c2', 2.)
        out = dict(rho=rho.native('points'), gathered=jsph.gather_neighbors(g, rho).native(('points', '~neighbors')))
        for clip in (False, True):
            out[f'P clip={clip}'] = jsph.tait_pressure(rho, rho0, 12., clip_negative=clip).native('points')
        P = jsph.tait_pressure(rho, rho0, 12.)
        out['acc'] = jsph.pressure_acceleration(g, P, rho, 2.).native(('points', 'vector'))
        return out
    ref = {k: np.asarray(v) for k, v in reference(jnp.asarray(pos), rho0).items()}
    np.testing.assert_allclose(rho.numpy('points'), ref['rho'], rtol=1e-5)
    assert (ref['P clip=True'] > 0).any() and (ref['P clip=False'] < 0).any()
    for clip in (False, True):
        P = sph.tait_pressure(rho, rho0, 12., clip_negative=clip).numpy('points')
        # (ρ/ρ₀)⁷ − 1 cancels near ρ₀: relative to the largest pressure
        ref_p = ref[f'P clip={clip}']
        np.testing.assert_allclose(P, ref_p, rtol=1e-4, atol=1e-4 * float(np.abs(ref_p).max()))
    acc = sph.pressure_acceleration(g, sph.tait_pressure(rho, rho0, 12.), rho, 2.).numpy(('points', 'vector'))
    np.testing.assert_allclose(acc, ref['acc'], rtol=1e-4, atol=1e-4 * float(np.abs(ref['acc']).max()))
    np.testing.assert_allclose(sph.gather_neighbors(g, rho).numpy(('points', '~neighbors')), ref['gathered'], rtol=1e-5)


def test_coincident_particles_give_zero_gradient():
    """r = 0 on a non-self edge (the default dam break clips particles onto one point): ∇W is 0, not NaN."""
    pos = np.array([[0.5, 0.5], [0.5, 0.5], [0.51, 0.5]], np.float32)
    _, tp = _points(pos, 2)
    g = sph.neighbor_graph(Sphere(tp, radius=0.005), 'wendland-c2', domain=Box(x=1., y=1.),
                           search_method='cell-list', support_radius=0.03)
    gradW = sph.edge_gradient(g).numpy(('points', '~neighbors', 'vector'))
    assert np.isfinite(gradW).all()
    rho = sph.density(g, 'wendland-c2')
    acc = sph.pressure_acceleration(g, tm.wrap(torch.ones(3), tm.instance(points=3)), rho)
    assert np.isfinite(acc.numpy(('points', 'vector'))).all()


# ---------------------------------------------------------------------------
# analogues of tests/physics/test_sph.py
# ---------------------------------------------------------------------------

def _particle_block(n=10, spacing=1.0, d=2):
    """A regular grid of particles with volume = spacing^d."""
    pts = np.array(list(itertools.product(*[range(n)] * d)), np.float32) * spacing
    centers = tm.wrap(torch.from_numpy(pts), tm.instance(points=pts.shape[0]),
                      tm.channel(vector='x,y' if d == 2 else 'x,y,z'))
    return Sphere(centers, radius=Sphere.radius_from_volume(tm.wrap(spacing ** d), d))


@pytest.mark.parametrize('kernel', ['quintic-spline', 'wendland-c2', 'poly6'])
def test_kernel_partition_of_unity(kernel):
    """∑_j W_ij · V_j ≈ 1 for the interior particles of a filled block."""
    graph_ = sph.neighbor_graph(_particle_block(12, 1.0, d=2), kernel, compute='kernel')
    W = graph_.edges[{'vector': 0}]
    density = tm.sum(W, graph_.shape.instance.as_dual())
    interior = density.numpy('points').reshape(12, 12)[4:8, 4:8]
    w0 = sph.evaluate_kernel(tm.vec(x=0., y=0.), tm.wrap(0.), graph_.bounding_distance, 2, kernel)['kernel']
    interior_total = interior + float(w0)
    assert np.allclose(interior_total, 1.0, atol=0.08), f"{kernel}: {interior_total.mean()}"


def test_grad_antisymmetry():
    """∇W_ij = −∇W_ji (momentum conservation)."""
    graph_ = sph.neighbor_graph(_particle_block(6, 1.0, d=2), 'wendland-c2', compute='grad')
    arr = graph_.edges[{'vector': 'grad_x'}].numpy(('points', '~points'))
    assert np.allclose(arr, -arr.T, atol=1e-5)


def test_support_radius_neighbor_count():
    graph_ = sph.neighbor_graph(_particle_block(12, 1.0, d=2), 'wendland-c2', compute='kernel')
    counts = tm.sum(graph_.connectivity, graph_.shape.instance.as_dual())
    interior = counts.numpy('points').reshape(12, 12)[4:8, 4:8]
    assert 14 < interior.mean() < 30  # 22 desired for wendland-c2


def test_expected_neighbors():
    n = sph.expected_neighbors(tm.wrap(1.0), tm.wrap(2.0), 2)
    assert abs(float(n) - np.pi * 4) < 1e-4
    for rank in (1, 2, 3):
        np.testing.assert_allclose(float(Sphere.volume_from_radius(0.3, rank)),
                                   float(JSphere.volume_from_radius(0.3, rank)), rtol=1e-6)
        np.testing.assert_allclose(float(Sphere.radius_from_volume(0.3, rank)),
                                   float(JSphere.radius_from_volume(0.3, rank)), rtol=1e-6)


def test_sph_cell_list_10k():
    """The SPH density sum on 10⁴ particles through the compact cell-list graph."""
    N = 10_000
    pos = np.random.default_rng(0).uniform(0, 1, (N, 2)).astype(np.float32)
    pts = tm.wrap(torch.from_numpy(pos), tm.instance(particles=N), tm.channel(vector='x,y'))
    g = sph.neighbor_graph(Sphere(pts, radius=0.5 / np.sqrt(N)), 'wendland-c2', compute='kernel', format='compact',
                           domain=Box(x=1., y=1.))
    assert g.is_compact
    dn = tm.sum(g.edges[{'vector': 'kernel'}], '~neighbors').numpy()
    assert dn.shape == (N,)
    assert np.isfinite(dn).all()
    assert (dn > 0).mean() > 0.95


def test_sph_compact_matches_dense_density():
    """Compact cell-list and dense graphs agree on the SPH density."""
    N = 800
    pos = np.random.default_rng(5).uniform(0, 1, (N, 2)).astype(np.float32)
    pts = tm.wrap(torch.from_numpy(pos), tm.instance(particles=N), tm.channel(vector='x,y'))
    nodes = Sphere(pts, radius=0.5 / np.sqrt(N))
    g_dense = sph.neighbor_graph(nodes, 'wendland-c2', compute='kernel')
    g_comp = sph.neighbor_graph(nodes, 'wendland-c2', compute='kernel', format='compact', domain=Box(x=1., y=1.))
    rho_d = tm.sum(g_dense.edges[{'vector': 'kernel'}], '~particles').numpy()
    rho_c = tm.sum(g_comp.edges[{'vector': 'kernel'}], '~neighbors').numpy()
    np.testing.assert_allclose(rho_d, rho_c, rtol=1e-4, atol=1e-3)


# ---------------------------------------------------------------------------
# analogues of tests/physics/test_sph_e2e.py (the model's test is in test_torch_sph_dam.py)
# ---------------------------------------------------------------------------

def test_density_uniform_lattice():
    """Summation density on a uniform lattice ≈ mass / dx² for interior particles."""
    dx = 0.01
    xs, ys = np.meshgrid(np.arange(24) * dx, np.arange(24) * dx, indexing='ij')
    pos = np.stack([xs.ravel(), ys.ravel()], -1).astype(np.float32) + 0.3
    _, pts = _points(pos, 2)
    g = sph.neighbor_graph(Sphere(pts, radius=dx / 2), 'wendland-c2', domain=Box(x=1., y=1.),
                           search_method='cell-list', support_radius=float(np.sqrt(22) * dx / 2))
    rho = sph.density(g, 'wendland-c2', masses=1.).numpy()
    np.testing.assert_allclose(rho[rho > 0.9 * rho.max()].mean(), 1.0 / dx ** 2, rtol=0.05)


def test_pressure_acceleration_repulsive():
    """Two close particles with positive pressure accelerate apart, equal and opposite."""
    _, pts = _points(np.array([[0.5, 0.5], [0.51, 0.5]], np.float32), 2)
    g = sph.neighbor_graph(Sphere(pts, radius=0.005), 'wendland-c2', domain=Box(x=1., y=1.),
                           search_method='cell-list', support_radius=0.03)
    rho = sph.density(g, 'wendland-c2')
    P = tm.wrap(torch.tensor([1., 1.]), tm.instance(points=2))
    acc = sph.pressure_acceleration(g, P, rho).numpy(('points', 'vector'))
    assert acc[0, 0] < 0 < acc[1, 0], f"pressure must push particles apart, got {acc}"
    np.testing.assert_allclose(acc[0], -acc[1], rtol=1e-4)


# ---------------------------------------------------------------------------
# Graph
# ---------------------------------------------------------------------------

def test_graph_properties_and_slicing():
    pos = np.random.default_rng(8).uniform(0, 1, (6, 2)).astype(np.float32)
    jp, tp = _points(pos, 2)
    from phiflow_tpu.geom import graph as jgraph
    edges = np.random.default_rng(9).uniform(size=(6, 6)).astype(np.float32)
    jg = jgraph(jp, jm.wrap(jnp.asarray(edges), jm.instance(points=6), jm.dual(points=6)), build_bounding_distance=True)
    tg = graph(tp, tm.wrap(torch.from_numpy(edges), tm.instance(points=6), tm.dual(points=6)),
               build_bounding_distance=True)
    assert isinstance(tg, Graph) and isinstance(tg.nodes, Point) and not tg.is_compact
    assert tg.spatial_rank == 2 and tg.shape == tp.shape
    _close(tg.deltas, jg.deltas, ('points', '~points', 'vector'))
    _close(tg.distances, jg.distances, ('points', '~points'))
    _close(tg.unit_deltas, jg.unit_deltas, ('points', '~points', 'vector'))
    _close(tg.connectivity, jg.connectivity, ('points', '~points'))
    np.testing.assert_allclose(float(tg.bounding_distance), float(jg.bounding_distance), rtol=1e-6)
    part = tg[{'points': slice(1, 4)}]
    assert part.shape.get_size('points') == 3 and part.edges.shape.get_size('~points') == 6
    np.testing.assert_array_equal(part.edges.numpy(('points', '~points')), edges[1:4])
    spheres = sph.neighbor_graph(Sphere(tp, radius=0.1), 'wendland-c2')[{'points': slice(0, 2)}]
    assert isinstance(spheres.nodes, Sphere) and spheres.edges.shape.get_size('points') == 2
    np.testing.assert_array_equal(spheres.center.numpy(('points', 'vector')), pos[:2])
    with pytest.raises(AssertionError):
        tg.at(tp)
    with pytest.raises(AssertionError):
        tg.shifted(tm.vec(x=0.1, y=0.))
