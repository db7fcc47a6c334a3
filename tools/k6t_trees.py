"""K6ᵀ / K7ᵀ on the card for the tree in the current directory, so that two
trees (a parent unpacked with `git archive`, and this one) can be compared
in one call, each run in turn from its own root:

    cd <tree> && python3 <this repo>/tools/k6t_trees.py NAME [--checks] [--paths] [--times]

--checks: build interp.cu with ptxas's report of the backward kernels, then
  `chip_smoke.py`'s `check_interp_grad` (checks and timed rows) and
  `time_batched_kernels`.
--paths: K6ᵀ / K7ᵀ checked and timed on the inputs grad-256 and grad-4096-2d
  give them (`time_grad_path_inputs`), and both paths' device profile
  (`profile_gradient`).
--times: the window kernels forward and backward and K5 checked and timed at
  the paths' shapes (`check_advect`, `check_interp`, `check_interp_grad`,
  without --quick): the `time` lines of two trees side by side.

The tree's own `chip_smoke.py` and `phiflow_tpu_torch` are used; a function
that tree's script lacks is taken from this repository's `chip_smoke.py`.
Prints NAME and the card first, the failed checks last."""
import ast
import os
import sys

sys.path.insert(0, os.getcwd())
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from phiflow_tpu_torch.ops import _build  # noqa: E402

OWN = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), 'chip_smoke.py')
BORROWED = ('_keep_grad_calls', 'time_grad_path_inputs', 'profile_gradient')


def borrow():
    with open(OWN) as f:
        tree = ast.parse(f.read())
    for node in tree.body:
        if isinstance(node, ast.FunctionDef) and node.name in BORROWED and not hasattr(cs, node.name):
            exec(compile(ast.Module([node], []), OWN, 'exec'), cs.__dict__)
            print('taken from this repository:', node.name)


def checks(ch):
    _build.build(['interp'], force=True, verbose=True)
    with open(_build.ptxas_log('interp')) as f:
        log = f.read()
    for entry, n_regs, n_spill, n_load, stack in cs.ptxas_entries(log):
        if '_grad_kernel' in entry:
            print(f'ptxas {entry}: {n_regs} registers, {stack} bytes stack frame, {n_spill} / {n_load} spill bytes')
    gen = torch.Generator(device='cuda')
    gen.manual_seed(0)
    cs.check_interp_grad(ch, gen, False)
    cs.time_batched_kernels(ch, gen)


def paths(ch):
    from phiflow_tpu_torch.models import SmokePlume, state_from_numpy
    for tag, dims, N, steps, period, cg in (('grad-256', 3, cs.PATH_N, 3, None, cs.GRAD_CG_TOL),
                                            ('grad-4096-2d', 2, cs.PATH_N_2D, 2, cs.PATH_N, cs.GRAD_CG_TOL_4096)):
        model = SmokePlume(resolution=N, dims=dims, cg_tol=cg, max_iterations=300, device='cuda')
        vel, smoke, _ = state_from_numpy(*cs.smooth_state(N, dims, period=period), device='cuda')
        w = cs._smooth_weight(N, dims, period).cuda()
        cs._smoke_grad(model, (vel, smoke), w, 1)  # the kernels' first launches
        ch.timing.setdefault(cs.GRAD_NAMES[dims], {})
        cs.time_grad_path_inputs(ch, tag, dims, model, (vel, smoke), w)
        del model, vel, smoke, w
        torch.cuda.empty_cache()
        cs.profile_gradient(tag, dims, N, steps, period=period, cg_tol=cg)
        torch.cuda.empty_cache()


def main(argv):
    borrow()
    print('tree', argv[0], 'card:', cs.card_line())
    ch = cs.Checks()
    if '--checks' in argv:
        checks(ch)
    else:
        _build.build(['interp', 'advect3d'], force=True)
    if '--times' in argv:
        gen = torch.Generator(device='cuda')
        gen.manual_seed(0)
        for check in (cs.check_advect, cs.check_interp, cs.check_interp_grad):
            check(ch, gen, False)
            torch.cuda.empty_cache()
    if '--paths' in argv:
        paths(ch)
    print('failed', ch.failed)
    return 1 if ch.failed else 0


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:]))
