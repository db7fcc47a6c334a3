"""Every public name that the JAX package's `phiflow_tpu.math`,
`phiflow_tpu.field`, `phiflow_tpu.geom`, `phiflow_tpu.nn` or
`phiflow_tpu.physics.{advect,diffuse,fluid,integrate,sph}` exports and the port exports too
takes the JAX package's signature: the same parameters, kinds and defaults.
The models' constructors, `initial_state` and `step` take JAX's parameters
first, then only the port's `device` (and `seed` for `FlipLiquid`, `Burgers`
and `KolmogorovFlow`). The
port's array-level functions and model methods that held such a name carry
the suffix `_native`."""
import importlib
import inspect

import pytest

PAIRS = [('phiflow_tpu.math', 'phiflow_tpu_torch.math', False), ('phiflow_tpu.field', 'phiflow_tpu_torch.field', False),
         ('phiflow_tpu.geom', 'phiflow_tpu_torch.geom', False),
         ('phiflow_tpu.physics.advect', 'phiflow_tpu_torch.physics.advect', True),
         ('phiflow_tpu.physics.diffuse', 'phiflow_tpu_torch.physics.diffuse', True),
         ('phiflow_tpu.physics.fluid', 'phiflow_tpu_torch.physics.fluid', True),
         ('phiflow_tpu.physics.integrate', 'phiflow_tpu_torch.physics.integrate', True),
         ('phiflow_tpu.physics.sph', 'phiflow_tpu_torch.physics.sph', True),
         ('phiflow_tpu.nn', 'phiflow_tpu_torch.nn', False)]


def _default(value):
    if value is inspect.Parameter.empty:
        return value
    if inspect.isfunction(value) or inspect.isclass(value):
        return value.__name__
    return repr(value)


def _signature(obj):
    target = obj.__init__ if inspect.isclass(obj) else obj
    return [(p.name, p.kind, _default(p.default)) for p in inspect.signature(target).parameters.values()
            if p.name != 'self']


def _shared(jax_name, port_name, by_all):
    jax_module, port_module = importlib.import_module(jax_name), importlib.import_module(port_name)
    names = jax_module.__all__ if by_all else [n for n in dir(jax_module) if not n.startswith('_')]
    for name in names:
        a, b = getattr(jax_module, name, None), getattr(port_module, name, None)
        if b is None or inspect.ismodule(a) or not callable(a):
            continue
        try:
            inspect.signature(a.__init__ if inspect.isclass(a) else a)
        except (TypeError, ValueError):
            continue
        yield name, a, b


@pytest.mark.parametrize('jax_name,port_name,by_all', PAIRS, ids=[p[1] for p in PAIRS])
def test_shared_names_take_jax_signatures(jax_name, port_name, by_all):
    shared = list(_shared(jax_name, port_name, by_all))
    assert shared
    mismatched = [name for name, a, b in shared if _signature(a) != _signature(b)]
    assert not mismatched, mismatched


MODELS = [('SmokePlume', ()), ('FlipLiquid', ('device', 'seed')), ('LidDrivenCavity', ()), ('MovingObstacles', ()),
          ('Burgers', ('device', 'seed')), ('KolmogorovFlow', ('device', 'seed')), ('SphDamBreak', ()),
          ('CylinderWake', ())]


@pytest.mark.parametrize('model,extra', MODELS, ids=[m for m, _ in MODELS])
def test_models_take_jax_signatures(model, extra):
    """`__init__`, `initial_state` and `step`: JAX's parameters in JAX's
    order, kinds and defaults, then `device` (and `seed`) only."""
    a = getattr(importlib.import_module('phiflow_tpu.models'), model)
    b = getattr(importlib.import_module('phiflow_tpu_torch.models'), model)
    for method, added in (('__init__', extra or ('device',)), ('initial_state', ()), ('step', ())):
        ref, got = _signature(getattr(a, method)), _signature(getattr(b, method))
        assert got[:len(ref)] == ref, (model, method)
        assert [p[0] for p in got[len(ref):]] == list(added), (model, method)


@pytest.mark.parametrize('jax_name,port_name,names', [
    ('phiflow_tpu.geom', 'phiflow_tpu_torch.geom', ['Mesh', 'mesh', 'mesh_from_numpy', 'build_mesh', 'load_su2',
                                                    'load_gmsh', 'load_stl', 'MeshBuilder', 'join_meshes',
                                                    'decimate_tri_mesh', 'as_sdf', 'surface_mesh']),
    ('phiflow_tpu.physics.fluid', 'phiflow_tpu_torch.physics.fluid', ['masked_laplace']),
    ('phiflow_tpu.field', 'phiflow_tpu_torch.field', ['write', 'read', 'Scene', 'SceneBatch']),
], ids=['geom-mesh', 'fluid-mesh', 'field-io'])
def test_mesh_names_are_shared(jax_name, port_name, names):
    """The mesh's entry points are among the shared names the test above
    holds to JAX's signatures."""
    shared = {name: (a, b) for name, a, b in _shared(jax_name, port_name, jax_name.endswith('fluid'))}
    for name in names:
        assert name in shared, name
        a, b = shared[name]
        assert _signature(a) == _signature(b), name


def _attribute(module, path):
    obj = module
    for part in path.split('.'):
        obj = getattr(obj, part)
    return obj


@pytest.mark.parametrize('module,names', [
    ('phiflow_tpu_torch.physics.advect', ['semi_lagrangian', 'mac_cormack', 'max_displacement_cells', 'points',
                                          'finite_rk4']),
    ('phiflow_tpu_torch.physics.diffuse', ['explicit']),
    ('phiflow_tpu_torch.physics.fluid', ['make_incompressible', 'apply_boundary_conditions', 'boundary_push']),
    ('phiflow_tpu_torch.field', ['divergence', 'spatial_gradient', 'stagger', 'laplace', 'safe_mul', 'finite_fill',
                                 'distribute_points']),
    ('phiflow_tpu_torch.geom', ['rotation_matrix']),
    ('phiflow_tpu_torch.models', [f'{m}.{n}' for m in ('SmokePlume', 'FlipLiquid', 'LidDrivenCavity', 'MovingObstacles')
                                  for n in ('initial_state', 'step')]
     + [f'SmokePlume.{n}' for n in ('advect_smoke', 'advect_velocity', 'project', '_fused_advect',
                                    '_fused_advect_available', '_inflow_mask_values')]),
], ids=['advect', 'diffuse', 'fluid', 'field', 'geom', 'models'])
def test_array_level_functions_carry_native(module, names):
    mod = importlib.import_module(module)
    for name in names:
        assert callable(_attribute(mod, name)) and callable(_attribute(mod, name + '_native')), name


def test_flip_phases_are_array_level():
    """FLIP's phases have no JAX counterpart; they work on arrays and say so."""
    from phiflow_tpu_torch.models import FlipLiquid
    for name in ('particles_to_grid', 'project', 'grid_to_particles'):
        assert callable(getattr(FlipLiquid, name + '_native')) and not hasattr(FlipLiquid, name), name


@pytest.mark.parametrize('jax_name,port_name,names', [
    ('phiflow_tpu.math', 'phiflow_tpu_torch.math',
     ['gradient', 'functional_gradient', 'jacobian', 'custom_gradient', 'iterate', 'map_s2b', 'map_d2c', 'map_c2d',
      'broadcast', 'get_function_parameters', 'trace_check', 'when_available', 'perf_counter', 'native_call',
      'stop_gradient', 'l2_loss', 'l1_loss']),
    ('phiflow_tpu.field', 'phiflow_tpu_torch.field', ['native_call']),
    ('phiflow_tpu.nn', 'phiflow_tpu_torch.nn',
     ['Network', 'dense_net', 'mlp', 'u_net', 'conv_net', 'res_net', 'conv_classifier', 'invertible_net',
      'parameter_count', 'get_parameters', 'save_state', 'load_state', 'Optimizer', 'adam', 'sgd', 'rmsprop',
      'adagrad', 'update_weights', 'train', 'set_learning_rate', 'get_learning_rate']),
], ids=['math-functional', 'field-native-call', 'nn'])
def test_gradient_and_nn_names_are_shared(jax_name, port_name, names):
    """The functional layer's and `nn`'s entry points are among the shared
    names held to JAX's signatures above."""
    shared = {name: (a, b) for name, a, b in _shared(jax_name, port_name, False)}
    for name in names:
        assert name in shared, name
        a, b = shared[name]
        assert _signature(a) == _signature(b), name


@pytest.mark.parametrize('name', ['profile', 'profile_function', 'benchmark', 'Timer', 'CheckpointManager',
                                  'save_checkpoint', 'load_checkpoint'])
def test_utils_take_jax_parameters(name):
    """`phiflow_tpu_torch.utils` has every name of `phiflow_tpu.utils`, each
    taking JAX's parameters in JAX's order (defaults apart: the trace folder
    lies in the temporary directory), then only `device` where a checkpoint
    is loaded; so do `CheckpointManager`'s methods."""
    jax_utils, port_utils = importlib.import_module('phiflow_tpu.utils'), importlib.import_module('phiflow_tpu_torch.utils')
    assert sorted(n for n in dir(jax_utils) if not n.startswith('_')) == \
        sorted(n for n in dir(port_utils) if not n.startswith('_') and n not in ('utils',))
    pairs = [(getattr(jax_utils, name), getattr(port_utils, name))]
    if name == 'CheckpointManager':
        pairs += [(getattr(pairs[0][0], m), getattr(pairs[0][1], m)) for m in ('save', 'restore', 'all_steps')]
    for a, b in pairs:
        ref = [(p.name, p.kind) for p in inspect.signature(a).parameters.values()]
        got = [(p.name, p.kind) for p in inspect.signature(b).parameters.values()]
        assert got[:len(ref)] == ref, (name, got, ref)
        assert [p for p, _ in got[len(ref):]] in ([], ['device']), (name, got)
