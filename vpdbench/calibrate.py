"""The readings the limits of `correct` are set from, for one cell, in one
process (set-up is long, so the seeds share it):

    python3 -m vpdbench.calibrate --workload <name> --seeds 1 2 3 \
        [--control-seeds 1 2 3] [--fault half_batch --fault-seeds 4 5 6] \
        [--window 2] [--compute-dtype float32]

For each of `--seeds` the program is set up as the benchmark sets it up
(a cell that measures training checks its set-up's first steps; any
other runs a `--window` of seconds at the cell's load and checks its
answers), freed, and compared with the reference: the lower readings.
For each of `--control-seeds` the reference in float8 e4m3
(`reference/arith.Fp8Arith`) takes the program's place on the same
feed: the control's readings. Each `--fault` is planted
(`vpdbench/faults.py`) for `--fault-seeds`. One JSON line a reading,
then the largest lower and the smallest upper reading of each number.
"""

import argparse
import contextlib
import json
import os
import sys
import time

from vpdbench.run import T_START  # noqa: F401  (the caches' environment)


def _line(**kw):
    print(json.dumps(kw), flush=True)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seeds', type=int, nargs='*', default=[])
    p.add_argument('--control-seeds', type=int, nargs='*', default=[])
    p.add_argument('--fault', action='append', default=[])
    p.add_argument('--fault-seeds', type=int, nargs='*', default=[])
    p.add_argument('--window', type=float, default=2.)
    p.add_argument('--device', default='cuda')
    p.add_argument('--compute-dtype', default=None,
                   help='run the program in this dtype instead of the '
                   'configuration\'s (a look at what rounding gives)')
    args = p.parse_args(argv)

    import importlib

    import torch

    from vpdbench import bench, faults
    from vpdbench.reference.arith import Fp8Arith

    spec = bench.Spec(os.getcwd())
    w = spec.workload(args.workload)
    config, traffic = spec.config(w['config']), spec.traffic(w['traffic'])
    if args.compute_dtype:
        config['compute_dtype'] = args.compute_dtype
    driver = importlib.import_module('vpdbench.drivers.' + traffic['driver'])
    kind = traffic['driver']
    readings = {'program': {}, 'control': {}}

    def one(seed, role, control=None, fault=None):
        t0 = time.perf_counter()
        cell = driver.Cell(config, traffic, seed, args.device)
        with (faults.planted(kind, fault) if fault
              else contextlib.nullcontext()):
            cell.setup()
            if driver.MEASURES != 'train':
                cell.window(args.window)
        t1 = time.perf_counter()
        cell.release()
        nums = cell.numbers()
        t2 = time.perf_counter()
        out = {'program': nums}
        if control is not None:
            out['control'] = cell.numbers(control)
        _line(seed=seed, role=role, fault=fault, setup_s=t1 - t0,
              reference_s=t2 - t1, **out)
        for r, n in out.items():
            key = r if not fault else 'fault:' + fault
            for k, v in n.items():
                if isinstance(v, str):
                    continue
                readings.setdefault(key, {}).setdefault(k, []).append(v)
        del cell
        if torch.cuda.is_available():
            torch.cuda.empty_cache()

    controls = set(args.control_seeds)
    for seed in args.seeds:
        one(seed, 'program', Fp8Arith() if seed in controls else None)
    for seed in sorted(controls - set(args.seeds)):
        one(seed, 'program', Fp8Arith())
    for fault in args.fault:
        for seed in args.fault_seeds:
            one(seed, 'fault', fault=fault)
    summary = {'lower': {k: max(v) for k, v in readings['program'].items()}}
    for key, nums in readings.items():
        if key != 'program' and nums:
            summary['upper:' + key] = {k: min(v) for k, v in nums.items()}
    _line(summary=summary, limits=spec.limits(args.workload),
          card=torch.cuda.get_device_name(0)
          if torch.cuda.is_available() else 'cpu')
    return 0


if __name__ == '__main__':
    sys.exit(main())
