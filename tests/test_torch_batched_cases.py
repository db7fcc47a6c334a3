"""Batched projections without masks and the unbounded lookup in the port
against the JAX package on the CPU: the projection of a batch of centred
velocities in the periodic box (the wide stencil) and of a batch of
velocities on a mesh (`physics/fluid.py`), the ValueError for masks with
batch dims (JAX fails there with an AssertionError), and `SmokePlume(max_cells=None)`,
JAX's unbounded lookup (both advection phases gather at the back-traced
points, `physics/advect.py`; no window kernel). Inputs are numpy from a seed,
fed to both packages; JAX's side is traced in one jit a test. Tolerances are
stated at each test."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import phiflow_tpu.math as jm
from phiflow_tpu.field import CenteredGrid as JCenteredGrid, Field as JField
from phiflow_tpu.geom import Box as JBox
from phiflow_tpu.geom._mesh import build_mesh as jax_build_mesh
from phiflow_tpu.math import Solve as JSolve, Tensor as JTensor
from phiflow_tpu.math import extrapolation as jext
from phiflow_tpu.physics import fluid as jax_fluid

import phiflow_tpu_torch.math as tm
from phiflow_tpu_torch.field import CenteredGrid, Field, StaggeredGrid
from phiflow_tpu_torch.geom import Box, build_mesh
from phiflow_tpu_torch.physics import fluid

from test_torch_batched_masked import _batched_velocity, _jax_batched

ORDER = ('x', 'y', 'z')
B = 2


@pytest.fixture(autouse=True)
def _cpu():
    with tm.default_device('cpu'):
        yield


def test_batched_centred_periodic_projection_matches_jax():
    """A centred velocity in the periodic box, two entries, CG at 1e-5 on
    the wide stencil: within 1e-5 of JAX's pressure and velocity scale."""
    N = 16
    v0 = np.random.default_rng(0).standard_normal((B, N, N, 2)).astype(np.float32)
    jv = JCenteredGrid(jm.tensor(jnp.asarray(v0), jm.batch('b'), jm.spatial('x,y'), jm.channel(vector='x,y')),
                       jext.PERIODIC, x=N, y=N)
    jv2, jp = jax.jit(lambda v: jax_fluid.make_incompressible(v, (), JSolve('CG', 1e-5, 1e-5, max_iterations=2000)))(jv)
    tv = CenteredGrid(tm.tensor(torch.from_numpy(v0), tm.batch('b'), tm.spatial('x,y'), tm.channel(vector='x,y')),
                      tm.extrapolation.PERIODIC, x=N, y=N)
    tv2, tp = fluid.make_incompressible(tv, (), tm.Solve('CG', 1e-5, 1e-5, max_iterations=2000))
    ref_p = np.asarray(jp.values.native(('b', 'x', 'y')))
    assert float(np.abs(tp.values.numpy(('b', 'x', 'y')) - ref_p).max()) <= 1e-5 * float(np.abs(ref_p).max())
    ref_v = np.asarray(jv2.values.native(('b', 'x', 'y', 'vector')))
    assert float(np.abs(tv2.values.numpy(('b', 'x', 'y', 'vector')) - ref_v).max()) <= 1e-5 * float(np.abs(ref_v).max())


def test_batched_mesh_projection_matches_jax():
    """A velocity on a 12 × 6 mesh, two entries, BiCGStab at 1e-6: within
    1e-4 of each field's scale of JAX's (BiCGStab's float32 noise, ROADMAP
    §3), each entry equal to its own projection."""
    rng = np.random.default_rng(1)
    jmesh = jax_build_mesh(JBox(x=2, y=1), x=12, y=6)
    vals = rng.standard_normal((B, jmesh.center.shape.get_size('cells'), 2)).astype(np.float32)
    bc = {'x-': jext.ZERO, 'x+': jext.ZERO_GRADIENT, 'y-': 0., 'y+': 0.}
    jv = JField(jmesh, jm.tensor(jnp.asarray(vals), jm.batch('b'), jm.instance('cells'), jm.channel(vector='x,y')),
                bc)
    jv2, jp = jax.jit(lambda v: jax_fluid.make_incompressible(v, (), JSolve('biCG-stab', 1e-6, 1e-6,
                                                                            max_iterations=500)))(jv)
    mesh = build_mesh(Box(x=2, y=1), x=12, y=6)
    tbc = {'x-': tm.extrapolation.ZERO, 'x+': tm.extrapolation.ZERO_GRADIENT, 'y-': 0., 'y+': 0.}

    def project(v):
        return fluid.make_incompressible(Field(mesh, v, tbc), (), tm.Solve('biCG-stab', 1e-6, 1e-6,
                                                                           max_iterations=500))
    tv2, tp = project(tm.tensor(torch.from_numpy(vals), tm.batch('b'), tm.instance('cells'), tm.channel(vector='x,y')))
    ref_p, ref_v = np.asarray(jp.values.native(('b', 'cells'))), np.asarray(jv2.values.native(('b', 'cells', 'vector')))
    assert float(np.abs(tp.values.numpy(('b', 'cells')) - ref_p).max()) <= 1e-4 * float(np.abs(ref_p).max())
    got_v = tv2.values.numpy(('b', 'cells', 'vector'))
    assert float(np.abs(got_v - ref_v).max()) <= 1e-4 * float(np.abs(ref_v).max())
    for e in range(B):
        _, p1 = project(tm.tensor(torch.from_numpy(vals[e]), tm.instance('cells'), tm.channel(vector='x,y')))
        assert np.array_equal(p1.values.numpy(('cells',)), tp.values.numpy(('b', 'cells'))[e])


def test_masks_with_batch_dims_raise():
    """An `active` per entry: JAX's projection fails (an AssertionError);
    the port raises ValueError naming it, in the array layer and in the
    Field layer."""
    N = 16
    comps = _batched_velocity(N, 2, False, (1, 2))
    active = np.ones((B, N, N), np.float32)
    jactive = JCenteredGrid(JTensor(jnp.asarray(active), jm.batch(b=B) & jm.spatial(x=N, y=N)), 0.,
                            bounds=JBox(x=N, y=N), x=N, y=N)
    with pytest.raises(AssertionError):
        jax_fluid.make_incompressible(_jax_batched(comps, False), (), JSolve('CG', 1e-5, 0.), active=jactive)
    with pytest.raises(ValueError, match='AssertionError'):
        fluid.make_incompressible_native([torch.from_numpy(c) for c in comps], None, 1.0,
                                         active=torch.from_numpy(active))
    values = tm.stack([tm.tensor(torch.from_numpy(c), tm.batch('b'), tm.spatial(x=c.shape[1], y=c.shape[2]))
                       for c in comps], tm.dual(vector='x,y'))
    tactive = CenteredGrid(tm.tensor(torch.from_numpy(active), tm.batch('b'), tm.spatial('x,y')), 0., x=N, y=N)
    with pytest.raises(ValueError, match='AssertionError'):
        fluid.make_incompressible(StaggeredGrid(values, 0., x=N, y=N), (), tm.Solve('CG', 1e-5, 0.), active=tactive)


# ---------------------------------------------------------------------------
# SmokePlume(max_cells=None): JAX's unbounded lookup
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('dims,N', [(2, 24), (3, 12)], ids=['2d', '3d'])
def test_smoke_plume_unbounded_lookup_matches_jax(dims, N):
    """Two steps of `SmokePlume(max_cells=None)` (dt 1.5, a closed box) from
    rest through the Field `step` and `step_native`, within 1e-5 of each
    field's scale of JAX's (the lookups gather in both packages); the fused
    path is gated off, no window kernel runs."""
    from phiflow_tpu.models import SmokePlume as JaxSmoke
    from phiflow_tpu_torch.models import SmokePlume
    from phiflow_tpu_torch.ops import _build
    jmodel = JaxSmoke(resolution=N, dims=dims, max_cells=None, dt=1.5)

    def two_steps(*s):
        for _ in range(2):
            s = jmodel.step(*s)
        return s
    js = jax.jit(two_steps)(*jmodel.initial_state())
    model = SmokePlume(resolution=N, dims=dims, max_cells=None, dt=1.5, device='cpu')
    assert not model._fused_advect_available_native(*model.initial_state_native()[:2])
    before = dict(_build.LAUNCHES)
    state = model.initial_state()
    for _ in range(2):
        state = model.step(*state)
    native = model.initial_state_native()
    native = (native[0], native[1], None)
    for _ in range(2):
        native = model.step_native(*native)
    assert dict(_build.LAUNCHES) == before
    names = ORDER[:dims]
    pairs = [(state[1].values.numpy(names), native[1].numpy(), np.asarray(js[1].values.native(names)))]
    pairs += [(state[0].vector[n].values.numpy(names), native[0][d].numpy(),
               np.asarray(js[0].vector[n].values.native(names))) for d, n in enumerate(names)]
    for field_v, native_v, ref in pairs:
        scale = float(np.abs(ref).max())
        assert float(np.abs(field_v - ref).max()) <= 1e-5 * scale
        assert float(np.abs(native_v - ref).max()) <= 1e-5 * scale
