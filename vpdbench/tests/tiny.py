"""Cells cut to a size the CPU runs in seconds, for the benchmark's tests.

Each driver module gives its cut in `TINY` ({'config': {...}, 'traffic':
{...}}), which `tiny` hands to `bench.run_cell` as its `overrides`; the
student drivers' cut: 32 x 32, a few crops, batches of 8, and ResNets
cut to ResNet-18 (b0 as it is). The program computes in float32 here,
where the reference must agree with it to rounding; the timed bf16 path
is checked on the card.
"""

import importlib
import json
import os
import shutil
import time

from vpdbench import bench

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SEED = 2 ** 31 + 977


def driver(workload, root=REPO):
    """The driver module that runs `workload`."""
    spec = bench.Spec(root)
    name = spec.traffic(spec.workload(workload)['traffic'])['driver']
    return importlib.import_module('vpdbench.drivers.' + name)


def tiny(workload, root=REPO, **config):
    """The overrides of `workload`'s driver, ResNets cut to ResNet-18."""
    spec = bench.Spec(root)
    cfg = spec.config(spec.workload(workload)['config'])
    over = {k: dict(v) for k, v in driver(workload, root).TINY.items()}
    if cfg.get('reference') == 'resnet':
        over['config']['encoder_arch'] = 'resnet18'
    over['config'].update(config)
    return over


def run(workload, trace=False, root=REPO, seed=SEED, **config):
    return bench.run_cell(root, workload, seed, 0.2, trace,
                          time.perf_counter(), device='cpu',
                          overrides=tiny(workload, root, **config))


def checked(workload, seed=SEED):
    """`workload`'s cell, cut, on the CPU: set up, a short window where its
    answers are checked (any cell that does not measure training),
    released, ready to give its numbers."""
    spec = bench.Spec(REPO)
    w = spec.workload(workload)
    over = tiny(workload)
    module = driver(workload)
    cell = module.Cell(dict(spec.config(w['config']), **over['config']),
                       dict(spec.traffic(w['traffic']), **over['traffic']),
                       seed, 'cpu')
    cell.setup()
    if module.MEASURES != 'train':
        cell.window(0.1)
    cell.release()
    return cell


def copy_benchmark(dst):
    """BENCHMARK.json and the benchmark's files under `dst`, as a checkout
    holds them."""
    shutil.copy(os.path.join(REPO, 'BENCHMARK.json'), dst)
    shutil.copytree(os.path.join(REPO, 'vpdbench'),
                    os.path.join(dst, 'vpdbench'),
                    ignore=shutil.ignore_patterns('__pycache__', '.cache'))
    with open(os.path.join(dst, 'BENCHMARK.json')) as fp:
        return json.load(fp)
