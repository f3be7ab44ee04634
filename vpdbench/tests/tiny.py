"""Cells cut to a size the CPU runs in seconds, for the benchmark's tests.

`TINY[driver]` shrinks a cell through `bench.run_cell`'s `overrides`:
ResNet-18 (or b0 as it is) at 32 x 32, a few crops, batches of 8. The
program computes in float32 here, where the reference must agree with
it to rounding; the timed bf16 path is checked on the card.
"""

import json
import os
import shutil
import time

from vpdbench import bench

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SEED = 2 ** 31 + 977

TINY = {
    'train': {'config': {'img_dim': 32, 'compute_dtype': 'float32'},
              'traffic': {'cache_crops': 48, 'rows_per_shard': 20,
                          'batch_size': 8, 'epoch_samples': 16,
                          'trace_epochs': 1}},
    'extract': {'config': {'img_dim': 32, 'compute_dtype': 'float32'},
                'traffic': {'chunk': 8, 'pool_chunks': 3,
                            'segment_chunks': 4, 'warmup_chunks': 2,
                            'trace_chunks': 3}},
}


def tiny(workload, root=REPO, **config):
    """The overrides of `workload`'s driver, ResNets cut to ResNet-18."""
    spec = bench.Spec(root)
    w = spec.workload(workload)
    kind = spec.traffic(w['traffic'])['driver']
    cfg = spec.config(w['config'])
    over = {k: dict(v) for k, v in TINY[kind].items()}
    if cfg['reference'] == 'resnet':
        over['config']['encoder_arch'] = 'resnet18'
    over['config'].update(config)
    return over


def run(workload, trace=False, root=REPO, seed=SEED, **config):
    return bench.run_cell(root, workload, seed, 0.2, trace,
                          time.perf_counter(), device='cpu',
                          overrides=tiny(workload, root, **config))


def copy_benchmark(dst):
    """BENCHMARK.json and vpdbench's data files under `dst`."""
    shutil.copy(os.path.join(REPO, 'BENCHMARK.json'), dst)
    for sub in ('configs', 'traffic', 'metrics', 'limits'):
        shutil.copytree(os.path.join(REPO, 'vpdbench', sub),
                        os.path.join(dst, 'vpdbench', sub))
    with open(os.path.join(dst, 'BENCHMARK.json')) as fp:
        return json.load(fp)
