"""The port's `CylinderWake` against the JAX package's, on the CPU.

At the JAX suite's size (`tests/physics/test_cylinder_wake.py`: 120×36,
4,292 cells) with solve_tol 1e-5: the initial state within 1e-7; three
Field steps within 3e-4 of the velocity's scale and 3e-3 of the pressure's
at step 1, 1e-2 at steps 2 and 3; momentum solves at most 2 iterations
apart, the pressure solves both converged and within 25% of JAX's count;
`forces(p)` after them within 3e-3 of its scale. The default configuration
builds its 50,892 cells.

BiCGStab at this tolerance leaves noise of the solves' size: relative
perturbations of 1e-7 of the initial velocity (eight seeds) move JAX's own
pressure by up to 6.5e-4, 3.3e-3 and 1.1e-3 of its scale at steps 1–3, its
velocity by up to 8.0e-5, and its pressure iterations over 63–67, 63–73 and
48–53. The port from JAX's initial state differs from JAX by 4.2e-3 in the
pressure at step 2 (7.6e-4 at step 1), 7.4e-5 in the velocity, and its
counts (63, 65, 47) lie 2–4 from JAX's (65, 69, 50)."""
import jax
import numpy as np
import pytest
import torch

from phiflow_tpu.math import SolveTape as JSolveTape
from phiflow_tpu.models import CylinderWake as JaxCylinderWake

import phiflow_tpu_torch.math as tm
from phiflow_tpu_torch.field import Field
from phiflow_tpu_torch.geom import Mesh
from phiflow_tpu_torch.math import SolveTape
from phiflow_tpu_torch.models import CylinderWake

SUITE = dict(nx=120, ny=36, re=120., dt=0.08, diameter=0.5, upwind=False, perturb=0.2, solve_tol=1e-5,
             max_iterations=300)
STEPS = 3
PRESSURE_TOL = (3e-3, 1e-2, 1e-2)  # of the pressure's scale, by step: 3x JAX's own noise after step 1


@pytest.fixture(autouse=True, scope='module')
def _cpu():
    with tm.default_device('cpu'):
        yield


def _arrays(v, p):
    def host(t, names):
        native = t.native(names)
        return native.numpy() if isinstance(native, torch.Tensor) else np.asarray(native)
    return host(v.values, ('cells', 'vector')), host(p.values, ('cells',))


@pytest.fixture(scope='module')
def runs():
    """Both models at the suite's size, their initial states, and per step
    (velocity, pressure, [momentum, pressure] iterations, converged flags)."""
    jax_model, model = JaxCylinderWake(**SUITE), CylinderWake(**SUITE, device='cpu')
    jv, jp = jax_model.initial_state()
    v, p = model.initial_state()
    out = {'models': (jax_model, model), 'initial': (_arrays(jv, jp), _arrays(v, p), v, p), 'jax': [], 'port': []}
    step = jax.jit(jax_model.step)
    infos = None
    with JSolveTape(record_runtime=True) as tape:
        for _ in range(STEPS):
            jv, jp = step(jv, jp)
            jax.block_until_ready(jv.values.native())
            infos = infos or list(tape.solve_infos)  # filled at each run through the trace's callbacks
            out['jax'].append((*_arrays(jv, jp), [i.runtime_stats['iterations'] for i in infos],
                               [i.runtime_stats['converged'] for i in infos]))
    for _ in range(STEPS):
        with SolveTape() as tape:
            v, p = model.step(v, p)
        out['port'].append((*_arrays(v, p), [i.iterations for i in tape], [i.converged for i in tape]))
    out['final'] = (jp, p)
    return out


def _sides(boundary):
    """A mixed boundary as {group: (lower, upper)} of reprs."""
    return {k: tuple(repr(e) for e in pair) for k, pair in boundary.ext.items()}


def test_initial_state_matches_jax(runs):
    (jv, jp), (v, p), vf, pf = runs['initial']
    np.testing.assert_allclose(v, jv, rtol=0, atol=1e-7)
    np.testing.assert_array_equal(p, jp)
    assert isinstance(vf.geometry, Mesh) and pf.geometry is vf.geometry
    assert vf.values.shape.names == ('cells', 'vector') and vf.values.native().is_contiguous()
    jax_model, model = runs['models']
    for got, ref in zip((vf, pf), jax_model.initial_state()):
        assert _sides(got.boundary) == _sides(ref.boundary)
        assert got.boundary.is_flexible and ref.boundary.is_flexible


@pytest.mark.parametrize('step', range(STEPS), ids=[f'step{k + 1}' for k in range(STEPS)])
def test_steps_match_jax(runs, step):
    jv, jp, j_its, j_conv = runs['jax'][step]
    v, p, its, conv = runs['port'][step]
    assert np.isfinite(v).all() and np.isfinite(p).all()
    np.testing.assert_allclose(v, jv, rtol=0, atol=3e-4 * np.abs(jv).max(), err_msg='velocity')
    np.testing.assert_allclose(p, jp, rtol=0, atol=PRESSURE_TOL[step] * np.abs(jp).max(), err_msg='pressure')
    assert all(conv) and all(j_conv), (conv, j_conv)
    assert abs(its[0] - j_its[0]) <= 2, ('momentum iterations', its, j_its)
    assert abs(its[1] - j_its[1]) <= 0.25 * j_its[1], ('pressure iterations', its, j_its)


def test_forces_match_jax(runs):
    jax_model, model = runs['models']
    jp, p = runs['final']
    ref = np.asarray(jax_model.forces(jp).native(('vector',)))
    got = model.forces(p).numpy(('vector',))
    np.testing.assert_allclose(got, ref, rtol=0, atol=3e-3 * np.abs(ref).max())


def test_state_stays_on_the_models_mesh(runs):
    """The step keeps the model's mesh (the tables are not copied or rebuilt)
    and returns JAX's Fields: the velocity under the model's boundary."""
    _, model = runs['models']
    v, p = model.initial_state()
    v1, p1 = model.step(v, p)
    assert v1.geometry is model.mesh and p1.geometry is model.mesh
    assert v1.boundary == v.boundary and p1.boundary == p.boundary
    assert isinstance(v1, Field) and v1.values.shape.get_labels('vector') == ('x', 'y')


def test_default_configuration_builds():
    model = CylinderWake(device='cpu')
    assert model.n_cells == 50892 == model.mesh.cell_count
    assert model.mesh.device.type == 'cpu'


def test_runs_on_the_card_unless_told():
    """Without a card the model raises rather than falling back to the CPU."""
    if torch.cuda.is_available():
        assert CylinderWake(nx=12, ny=6).device.type == 'cuda'
    else:
        with pytest.raises(RuntimeError, match='CUDA is not available'):
            CylinderWake(nx=12, ny=6)
