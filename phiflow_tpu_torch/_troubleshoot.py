"""Setup diagnostics — port of `phiflow_tpu/_troubleshoot.py`.

`troubleshoot()` returns a report of the installation: the versions, the
card (`torch.cuda.is_available()`, its name), `nvcc` for the kernels of
`csrc/`, whether `ops/_build.py` has built them and whether the mesh face
matcher's library is there, and the plotting packages. It only reads:
nothing is built, launched or allocated on the card.
"""
from __future__ import annotations

import os

__all__ = ['assert_minimal_config', 'troubleshoot', 'troubleshoot_torch', 'troubleshoot_vis']


def assert_minimal_config():
    """Raise AssertionError if the base requirements are missing."""
    import sys
    assert sys.version_info.major == 3 and sys.version_info.minor >= 9, \
        f"phiflow_tpu_torch requires Python 3.9+, found {sys.version}"
    try:
        import numpy  # noqa: F401
    except ImportError:
        raise AssertionError("numpy is required")
    try:
        import torch  # noqa: F401
    except ImportError:
        raise AssertionError("torch is required (the only compute backend)")


def troubleshoot_torch() -> str:
    """torch's version and CUDA build, the card, nvcc, and the state of the kernel libraries."""
    import torch
    from .ops import _build
    from .native import _lib
    lines = [f"torch {torch.__version__} (CUDA build {torch.version.cuda or 'none'})"]
    if torch.cuda.is_available():
        names = ', '.join(torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count()))
        lines.append(f"CUDA available: {torch.cuda.device_count()} device(s): {names}")
    else:
        lines.append("CUDA NOT available: entry points need device='cpu' (the kernels' plain PyTorch versions)")
    try:
        nvcc = _build._nvcc()
    except RuntimeError:
        nvcc = None
    lines.append(f"nvcc: {nvcc}" if nvcc else "nvcc NOT found: the CUDA kernels of csrc/ cannot be built")
    built = [n for n in _build.SOURCES if not _build._stale(n)]
    missing = [n for n in _build.SOURCES if n not in built]
    lines.append(f"CUDA kernels built: {', '.join(built) or 'none'}"
                 + (f"; to build at first use: {', '.join(missing)}" if missing else ''))
    lines.append(f"native mesh face matcher: {'built' if os.path.exists(_lib.library_path()) else 'to build at first use'}")
    return '\n'.join(lines)


def troubleshoot_vis() -> str:
    lines = []
    try:
        import matplotlib
        lines.append(f"matplotlib {matplotlib.__version__} (backend {matplotlib.get_backend()})")
    except ImportError:
        lines.append("matplotlib NOT installed — plot()/show() unavailable")
    try:
        from .vis._plotly_plots import plotly_available
        lines.append(f"plotly backend: {'available' if plotly_available() else 'not installed (matplotlib + web GUI active)'}")
    except Exception as e:
        lines.append(f"plotly probe failed: {e}")
    lines.append("web GUI: built-in (std-lib http.server, vis.WebGui)")
    return '\n'.join(lines)


def troubleshoot() -> str:
    """The full report."""
    from . import __version__
    import numpy
    return '\n'.join([f"phiflow_tpu_torch {__version__}", f"numpy {numpy.__version__}", troubleshoot_torch(),
                      troubleshoot_vis()])
