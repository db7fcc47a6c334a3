"""The port stands alone: `phiflow_tpu_torch` imports with JAX and the JAX
package blocked, and none of its modules (nor `chip_smoke.py`) imports them."""
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, 'phiflow_tpu_torch')
FORBIDDEN = re.compile(r'^\s*(import|from)\s+(jax|phiflow_tpu)\b', re.MULTILINE)


def test_imports_with_jax_blocked():
    code = ("import sys, importlib, pkgutil\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['phiflow_tpu'] = None\n"
            "import phiflow_tpu_torch\n"
            "for m in pkgutil.walk_packages(phiflow_tpu_torch.__path__, 'phiflow_tpu_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "print('imported')\n")
    out = subprocess.run([sys.executable, '-c', code], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert 'imported' in out.stdout


def test_no_module_imports_jax():
    files = [os.path.join(ROOT, 'chip_smoke.py')]
    for dirpath, _, names in os.walk(PKG):
        files += [os.path.join(dirpath, n) for n in names if n.endswith('.py')]
    assert len(files) > 10
    offenders = []
    for path in files:
        with open(path, encoding='utf-8') as f:
            if FORBIDDEN.search(f.read()):
                offenders.append(os.path.relpath(path, ROOT))
    assert not offenders, offenders
