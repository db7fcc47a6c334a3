"""Build and load the port's CUDA kernels.

Each `csrc/<name>.cu` (with the headers `csrc/*.cuh` it includes) has a plain C interface and is compiled on its own by
`nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC` into
`phiflow_tpu_torch/_build/lib<name>.so` at first use, then loaded with
`ctypes`. A build takes seconds: no source includes PyTorch's headers. The
wrappers pass raw device pointers and `torch.cuda.current_stream().cuda_stream`
as `c_void_p`; every C entry returns `cudaGetLastError()` after its launches and
`check` raises when that is not 0.

Nothing here runs at import: `ctypes` and `nvcc` are reached only when a kernel
is first launched (or `build` is called), so the package imports on machines
without CUDA.

`LAUNCHES` counts kernel launches by kernel name. Each wrapper adds one where
it launches its kernel and nowhere else, so a caller can show that a run went
through the kernels.

`refuse_grad` is the guard of a kernel that has no backward: its wrapper
raises, before the launch, where autograd would record the call and an input
requires grad, instead of returning an output that silently drops the
gradient.
"""
from __future__ import annotations

import collections
import functools
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Iterable, Sequence

__all__ = ['SOURCES', 'LAUNCHES', 'SMEM_LIMIT', 'BUILD_DIR', 'reset_launches', 'stale', 'build', 'ptxas_log', 'library',
           'check', 'refuse_grad', 'block_x', 'stream_of', 'nonfinite_flag', 'SRC_MODE', 'src_struct']

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, 'csrc')
BUILD_DIR = os.path.join(_PKG, '_build')
SOURCES = ('poisson', 'transfer', 'advect3d', 'interp', 'p2g')
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-shared', '-Xcompiler', '-fPIC')

LAUNCHES: collections.Counter = collections.Counter()
SMEM_LIMIT = 232448  # dynamic shared memory a block may take on Hopper (227 KB)

_libs: Dict[str, object] = {}
_lock = threading.Lock()


def reset_launches():
    LAUNCHES.clear()


def _nvcc() -> str:
    home = os.environ.get('CUDA_HOME') or os.environ.get('CUDA_PATH') or '/usr/local/cuda'
    cand = os.path.join(home, 'bin', 'nvcc')
    if os.path.exists(cand):
        return cand
    found = shutil.which('nvcc')
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels cannot be built")
    return found


def _so_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f'lib{name}.so')


def ptxas_log(name: str) -> str:
    return os.path.join(BUILD_DIR, f'ptxas_{name}.log')


def stale(target: str, deps: Iterable[str]) -> bool:
    """Whether `target` is missing or older than any of its sources `deps`."""
    if not os.path.exists(target):
        return True
    return any(os.path.getmtime(d) > os.path.getmtime(target) for d in deps)


def _stale(name: str) -> bool:
    deps = [os.path.join(CSRC, f'{name}.cu')] + [
        os.path.join(CSRC, f) for f in os.listdir(CSRC) if f.endswith('.cuh')]
    return stale(_so_path(name), deps)


def build(names: Iterable[str] = SOURCES, force: bool = False, verbose: bool = False) -> float:
    """Compile the named sources (those whose library is missing or older than
    its sources, or all with `force`), one `nvcc` process per source, all
    started together. Returns the wall seconds. With `verbose`, ptxas reports
    each kernel's registers and spills into `ptxas_log(name)`."""
    names = [n for n in names if force or _stale(n)]
    t0 = time.perf_counter()
    if not names:
        return 0.0
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for n in names:
        tmp = _so_path(n) + f'.{os.getpid()}.tmp'
        cmd = [nvcc, *NVCC_FLAGS, *(('-Xptxas', '-v') if verbose else ()),
               '-o', tmp, os.path.join(CSRC, f'{n}.cu')]
        procs.append((n, tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                               stderr=subprocess.STDOUT, text=True)))
    failed = []
    for n, tmp, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f'--- {n}.cu (nvcc exit {proc.returncode}) ---\n{out}')
            continue
        os.replace(tmp, _so_path(n))
        if verbose:
            with open(ptxas_log(n), 'w') as f:
                f.write(out)
    if failed:
        raise RuntimeError('CUDA kernel build failed:\n' + '\n'.join(failed))
    return time.perf_counter() - t0


def library(name: str, signatures: Dict[str, Sequence]):
    """The loaded `lib<name>.so` (built if needed) with `argtypes` set for every
    entry in `signatures` and `restype` int (a cudaError_t)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            import ctypes
            build([name])
            lib = ctypes.CDLL(_so_path(name))
            lib.ptt_error_string.argtypes = [ctypes.c_int]
            lib.ptt_error_string.restype = ctypes.c_char_p
            for fn, argtypes in signatures.items():
                f = getattr(lib, fn)
                f.argtypes = list(argtypes)
                f.restype = ctypes.c_int
            _libs[name] = lib
        return lib


def check(lib, err: int, what: str):
    if err != 0:
        msg = lib.ptt_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def refuse_grad(what: str, *tensors):
    """Raise when grad mode is on and one of `tensors` (None entries are
    skipped) requires grad: the kernel `what` has no backward."""
    import torch
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(f"{what}: the CUDA kernel has no backward, and an input requires grad; call it under "
                           f"torch.no_grad() or detach the input (a differentiable path takes the kernels that "
                           f"have one: the implicit-diff solves, the window interpolation)")


def block_x(n: int) -> int:
    """Threads per block along the contiguous axis of extent n: 128, or n
    rounded up to a whole warp when smaller."""
    return 128 if n >= 128 else max(32, -(-n // 32) * 32)


def stream_of(t) -> int:
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream


_FLAGS: Dict[tuple, object] = {}


def nonfinite_flag(t) -> int:
    """The device pointer of the two ints that the window kernels' first
    launch of a call raises at a NaN or an infinity of its grid and the call's
    fix kernel lowers again (`csrc/window.cuh`, fix_raised): one pair for each
    stream of `t`'s device, since a pair is safe only for calls that run one
    after the other. A stream's pair is zeroed once, by its first call, so
    that no call adds a fill; that first call must not be under CUDA-graph
    capture, where the fill would run only inside the graph: make one call on
    a stream before capturing on it."""
    import torch
    stream = torch.cuda.current_stream(t.device)
    key = (stream.device_index, stream.cuda_stream)
    flag = _FLAGS.get(key)
    if flag is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("the window kernels' first call on a stream is under CUDA-graph capture: make one "
                               "call on that stream before capturing on it, so that its non-finite flag is zeroed "
                               "outside the graph")
        flag = _FLAGS[key] = torch.zeros(2, dtype=torch.int32, device=t.device)
    return flag.data_ptr()


# what an array read by the advection kernels holds past its raw extent
# (`csrc/window.cuh`): a constant, its nearest edge value, or a periodic wrap
SRC_MODE = {'const': 0, 'edge': 1, 'wrap': 2}


@functools.lru_cache(maxsize=1)
def src_struct():
    """The ctypes mirror of `Src` in `csrc/window.cuh`."""
    import ctypes

    class Src(ctypes.Structure):
        _fields_ = [('p', ctypes.c_void_p), ('n', ctypes.c_int * 3), ('shift', ctypes.c_int * 3),
                    ('mode', ctypes.c_int), ('c', ctypes.c_float)]
    return Src
