"""The port stands alone: `phiflow_tpu_torch` imports with JAX, flax,
optax and the JAX package blocked, and none of its modules (nor
`chip_smoke.py`) imports them."""
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, 'phiflow_tpu_torch')
FORBIDDEN = re.compile(r'^\s*(import|from)\s+(jax|flax|optax|phiflow_tpu)\b', re.MULTILINE)
OBSTACLE_MODULES = ['geom._geom', 'geom._sphere', 'geom._box', 'geom._grid', 'geom._transform',
                    'field._angular_velocity', 'physics.diffuse', 'physics.fluid', 'models.moving_obstacle',
                    'models.cavity']
FIELD_MODULES = ['math._shape', 'math._magic', 'math._static', 'math._tensor', 'math._ops', 'math._extrapolation',
                 'math.extrapolation', 'math._functional', 'math._solve', 'field._field', 'field._grid',
                 'field._resample', 'field._field_math', 'physics.advect']
GRID_MODEL_MODULES = ['field._noise', 'field._stencil1d', 'field._higher_order', 'physics.integrate', 'models.burgers',
                      'models.kolmogorov']
SPH_MODULES = ['math._neighbors', 'geom._graph', 'physics.sph', 'models.sph_dam']
FVM_MODULES = ['native._lib', 'geom._mesh', 'field._mesh_math', 'models.cylinder_wake']
GRADIENT_MODULES = ['math._functional', 'math._solve', 'math._nd', 'ops.interp', 'nn._nets', 'nn._optim']
IO_MODULES = ['field._field_io', 'field._scene', 'utils._checkpoint', 'utils._profile', '_entry']
MESH_MODULES = ['geom._mesh_builder', 'geom._convert']
MODULES = (OBSTACLE_MODULES + FIELD_MODULES + GRID_MODEL_MODULES + SPH_MODULES + FVM_MODULES + GRADIENT_MODULES +
           IO_MODULES + MESH_MODULES)


def test_imports_with_jax_blocked():
    code = ("import sys, importlib, pkgutil\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['flax'] = None\n"
            "sys.modules['optax'] = None\n"
            "sys.modules['phiflow_tpu'] = None\n"
            "import phiflow_tpu_torch\n"
            "names = [m.name for m in pkgutil.walk_packages(phiflow_tpu_torch.__path__, 'phiflow_tpu_torch.')]\n"
            "for name in names:\n"
            "    importlib.import_module(name)\n"
            f"missing = [m for m in {MODULES!r} if 'phiflow_tpu_torch.' + m not in names]\n"
            "assert not missing, missing\n"
            "print('imported')\n")
    out = subprocess.run([sys.executable, '-c', code], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert 'imported' in out.stdout


def test_no_module_imports_jax():
    files = [os.path.join(ROOT, 'chip_smoke.py')]
    for dirpath, _, names in os.walk(PKG):
        files += [os.path.join(dirpath, n) for n in names if n.endswith('.py')]
    assert len(files) > 10
    for module in MODULES:
        assert os.path.join(PKG, *module.split('.')) + '.py' in files, module
    offenders = []
    for path in files:
        with open(path, encoding='utf-8') as f:
            if FORBIDDEN.search(f.read()):
                offenders.append(os.path.relpath(path, ROOT))
    assert not offenders, offenders
