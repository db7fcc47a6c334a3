"""The window kernels' device time on finite inputs in two trees, in one call
on one card: the cost of a change to K5, K6 / K7 or K6ᵀ / K7ᵀ against its
parent, each timed call within a bound of the parent's.

    python3 tools/window_cost.py PARENT CHANGE [--rounds R] [--out DIR]

PARENT and CHANGE are the roots of two trees (a parent unpacked with
`git archive`, and this one). Both trees' `advect3d` and `interp` libraries
are built first, at once, with ptxas's report. Then each tree runs in a
process of its own from its own root (its own `phiflow_tpu_torch` and
`chip_smoke.py`), in the order parent, change, change, parent (R rounds of
that, default 1), and times on the same seeded inputs, by CUDA-graph replay
(`chip_smoke.replay_ms`, 50 replays, the median of 5 captures):

- K5: a step's three fused calls at 256³, K = 1, closed box, and the step;
- K6 256³ and K7 4096², K = 1: a velocity component with a constant halo,
  and the smoke's forward pass with an edge halo and the extrema;
- K6ᵀ 256³ and K7ᵀ 4096²: the same two forms' backward.

Prints each run's rows (each run's log also under DIR, default
`window_cost/`), the registers and spills of the K5 kernels in each tree,
then each row's change against the parent (the means of their runs), and
the card's name and power limit. Exits 1 if a run failed."""
import json
import os
import statistics
import subprocess
import sys

HERE = os.path.abspath(__file__)


def worker():
    sys.path.insert(0, os.getcwd())
    import torch
    import chip_smoke as cs
    from phiflow_tpu_torch.ops import _build
    from phiflow_tpu_torch.ops import advect3d as A
    from phiflow_tpu_torch.ops import interp as I

    with open(_build.ptxas_log('advect3d')) as f:
        for entry, n_regs, n_spill, n_load, stack in cs.ptxas_entries(f.read()):
            if 'fused_advect' in entry:
                print(f'ptxas {entry}: {n_regs} registers, {stack} bytes stack frame, {n_spill} / {n_load} spill '
                      f'bytes', flush=True)
    rows = {}

    def timed(name, fn):
        fn()
        torch.cuda.synchronize()
        rows[name] = statistics.median(cs.replay_ms(fn, reps=50) for _ in range(5))
        print(f'ROW {name:42s} {rows[name]:.4f} ms', flush=True)

    dev = 'cuda'
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    N = (cs.PATH_N,) * 3
    vel_t, smoke = cs._advect_inputs(N, gen, dev, 1, False)
    scales, calls = cs._advect_calls(N, 1, vel_t, smoke, False)
    runs = [lambda srcs=srcs, outs=outs, extras=extras: A.fused_advect_3d(srcs, N, 1, outs, scales, extras)
            for _, srcs, outs, extras in calls[:3]]
    for i, fn in enumerate(runs):
        timed(f'K5 call {i + 1} 256^3', fn)
    timed('K5 a step 256^3', lambda: [fn() for fn in runs])
    del vel_t, smoke, calls, runs
    torch.cuda.empty_cache()
    for d, shape, fwd, bwd in ((3, N, 'K6', 'K6T'), (2, (cs.PATH_N_2D,) * 2, 'K7', 'K7T')):
        fn = I.window_interp_3d if d == 3 else I.window_interp_2d
        scale = (-0.5,) * d
        grid = torch.rand(shape, generator=gen, device=dev)
        disps = [torch.rand(shape, generator=gen, device=dev) * 5.0 - 2.5 for _ in range(d)]
        g = [torch.randn(shape, generator=gen, device=dev) for _ in range(3)]
        tag = 'x'.join(map(str, shape))
        timed(f'{fwd} {tag} const', lambda: fn(grid, disps, 1, compute_extrema=False, disp_scale=scale, const_pad=0.0))
        timed(f'{fwd} {tag} edge + extrema',
              lambda: fn(grid, disps, 1, compute_extrema=True, disp_scale=scale, halo='edge'))
        timed(f'{bwd} {tag} const', lambda: cs._grad_call(d, grid, disps, 1, False, scale, 'const', 0.0, g[:1], False))
        timed(f'{bwd} {tag} edge + extrema',
              lambda: cs._grad_call(d, grid, disps, 1, True, scale, 'edge', 0.0, g, False))
        del grid, disps, g
        torch.cuda.empty_cache()
    print('JSON ' + json.dumps(rows))


def build(tree):
    code = "from phiflow_tpu_torch.ops import _build; _build.build(['advect3d', 'interp'], force=True, verbose=True)"
    return subprocess.Popen([sys.executable, '-c', code], cwd=tree)


def main(argv):
    if argv[:1] == ['--worker']:
        worker()
        return 0
    parent, change = (os.path.abspath(a) for a in argv[:2])
    rounds = int(argv[argv.index('--rounds') + 1]) if '--rounds' in argv else 1
    out = os.path.abspath(argv[argv.index('--out') + 1] if '--out' in argv else 'window_cost')
    os.makedirs(out, exist_ok=True)
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print('card:', card, flush=True)
    procs = [build(parent), build(change)]
    if any(p.wait() for p in procs):
        print('a build failed')
        return 1
    times = {'parent': [], 'change': []}
    order = ['parent', 'change', 'change', 'parent'] * rounds
    failed = False
    for i, which in enumerate(order):
        tree = parent if which == 'parent' else change
        r = subprocess.run([sys.executable, HERE, '--worker'], cwd=tree, capture_output=True, text=True)
        with open(os.path.join(out, f'window_cost_{i + 1}_{which}.log'), 'w') as f:
            f.write(r.stdout + r.stderr)
        print(f'--- run {i + 1}: {which} (exit {r.returncode})')
        print('\n'.join(line for line in r.stdout.splitlines() if line.startswith(('ROW', 'ptxas'))), flush=True)
        if r.returncode:
            print(r.stderr[-3000:])
            failed = True
            continue
        times[which].append(json.loads(next(l for l in r.stdout.splitlines() if l.startswith('JSON '))[5:]))
    if times['parent'] and times['change']:
        print(f'{"row":42s} {"parent ms":>10s} {"change ms":>10s} {"change":>8s}')
        for row in times['parent'][0]:
            p = statistics.mean(t[row] for t in times['parent'])
            c = statistics.mean(t[row] for t in times['change'])
            print(f'{row:42s} {p:10.4f} {c:10.4f} {100 * (c / p - 1):+7.2f}%  '
                  f'(parent {", ".join(f"{t[row]:.4f}" for t in times["parent"])}; '
                  f'change {", ".join(f"{t[row]:.4f}" for t in times["change"])})')
    print('card:', card)
    return 1 if failed else 0


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:]))
