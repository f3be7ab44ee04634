"""BENCHMARK.json against the files it names, and a cell added as files."""

import json
import os
import re
import subprocess
import sys

import pytest
import torch

from vpdbench import bench
from vpdbench.tests.tiny import REPO, copy_benchmark, run

torch.set_num_threads(2)

NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')


def load():
    with open(os.path.join(REPO, 'BENCHMARK.json')) as fp:
        return json.load(fp)


def test_every_name_finds_its_file():
    b = load()
    spec = bench.Spec(REPO)
    metrics = b['end_to_end'] + b['per_layer']
    for entry in b['configs'] + b['workloads'] + metrics:
        assert NAME.match(entry['name']), entry['name']
    for c in b['configs']:
        cfg = spec.config(c['name'])
        assert cfg['name'] == c['name'] and c['reduced'] == []
        assert c['file'].startswith('vpdbench/')
    cells = {w['name'] for w in b['workloads']}
    for w in b['workloads']:
        traffic = spec.traffic(w['traffic'])
        assert os.path.exists(os.path.join(
            REPO, 'vpdbench', 'drivers', traffic['driver'] + '.py'))
        assert spec.limits(w['name'])
        assert len(w['why']) <= 200 and w['chips'] == 1
    for m in metrics:
        assert callable(spec.reader(m['name']))
        assert set(m.get('workloads', cells)) <= cells
    e2e = {m['name']: m for m in b['end_to_end']}
    for m in b['per_layer']:
        # a cell reporting a per-layer metric reports what it moves
        moved = e2e[m['moves']]
        assert set(m['workloads']) <= set(moved.get('workloads', cells))


def test_each_cell_reports_setup_and_another_metric():
    spec = bench.Spec(REPO)
    for w in load()['workloads']:
        names = [m['name'] for m in spec.metrics(w['name'], False)]
        assert 'setup_s' in names and len(names) >= 2
        assert spec.metrics(w['name'], True)


def test_a_cell_added_as_files_only_runs(tmp_path):
    """A new configuration, traffic mix, per-layer metric and cell, each a
    new file or entry: the harness finds and runs them unchanged."""
    root = str(tmp_path)
    b = copy_benchmark(root)
    cfg_path = os.path.join(root, 'vpdbench', 'configs', 'vpd-r18-new.json')
    with open(os.path.join(REPO, 'vpdbench', 'configs',
                           'vpd-r34-flow-motion.json')) as fp:
        cfg = json.load(fp)
    cfg.update(name='vpd-r18-new', encoder_arch='resnet18')
    with open(cfg_path, 'w') as fp:
        json.dump(cfg, fp)
    with open(os.path.join(REPO, 'vpdbench', 'traffic',
                           'train-cache.json')) as fp:
        mix = json.load(fp)
    mix['batch_size'] = 4
    with open(os.path.join(root, 'vpdbench', 'traffic',
                           'train-small.json'), 'w') as fp:
        json.dump(mix, fp)
    with open(os.path.join(root, 'vpdbench', 'metrics',
                           'epochs_in_window.train.py'), 'w') as fp:
        fp.write('def read(r):\n    return float(r["window"]["epochs"])\n')
    b['configs'].append({'name': 'vpd-r18-new', 'source': 'x',
                         'file': 'vpdbench/configs/vpd-r18-new.json',
                         'reduced': [], 'why': 'a test'})
    b['workloads'].append({'name': 'r18-train-small', 'config': 'vpd-r18-new',
                           'traffic': 'train-small', 'chips': 1,
                           'why': 'a test'})
    b['end_to_end'][0]['workloads'].append('r18-train-small')
    b['per_layer'][0]['workloads'].append('r18-train-small')
    b['per_layer'].append({'name': 'epochs_in_window.train', 'unit': 'n',
                           'better': 'higher', 'source': 'host_clock',
                           'layer': 'train loop and host input',
                           'moves': 'train_samples_per_s',
                           'workloads': ['r18-train-small']})
    with open(os.path.join(root, 'vpdbench', 'limits',
                           'r18-train-small.json'), 'w') as fp:
        json.dump(bench.Spec(REPO).limits('r34-train-cache'), fp)
    with open(os.path.join(root, 'BENCHMARK.json'), 'w') as fp:
        json.dump(b, fp)
    result = run('r18-train-small', trace=True, root=root)
    assert result['correct'], result['checks']
    assert result['metrics']['epochs_in_window.train']['value'] >= 1
    assert 'sampler_ms.train' in result['metrics']
    plain = run('r18-train-small', root=root)
    assert set(plain['metrics']) == {'train_samples_per_s', 'setup_s'}


_STUB_DRIVER = '''"""A driver the harness has never seen: a seeded matrix
product whose window counts {measures} samples, checked against float64.
"""

import time

import torch

from vpdbench.trace import traced

MEASURES = {measures!r}
TINY = {{'config': {{}}, 'traffic': {{'batch': 8}}}}
FAULTS = {{}}


class Cell:

    def __init__(self, config, traffic, seed, device):
        self.width, self.batch = config['width'], traffic['batch']
        self.seed, self.device = seed, device

    def setup(self):
        g = torch.Generator(self.device).manual_seed(self.seed)
        self.w, self.x = (torch.randn(n, self.width, generator=g,
                                      device=self.device)
                          for n in (self.width, self.batch))
        self.out = self.x @ self.w
        self.setup_parts = {{}}

    def window(self, seconds, timed=False):
        t0, n = time.perf_counter(), 0
        while True:
            self.out = self.x @ self.w
            n += self.batch
            if time.perf_counter() - t0 >= seconds:
                break
        return {{'seconds': time.perf_counter() - t0, 'samples': n,
                'attempted': n, 'failed': 0}}

    def trace(self):
        return traced(lambda: self.x @ self.w)[1]

    def release(self):
        pass

    def costs(self):
        return {{'train_per_sample': 6 * self.width ** 2,
                'infer_per_sample': 2 * self.width ** 2}}

    def numbers(self, control=None):
        ref = self.x.double() @ self.w.double()
        return {{'out_gap': float((self.out - ref).norm() / ref.norm())}}
'''

_STUB_RUN = r'''
import json, sys
from vpdbench.tests.tiny import run
out = {{'plain': run({cell!r}), 'traced': run({cell!r}, trace=True)}}
out['loaded'] = sorted(m for m in sys.modules if m in (
    'vpdbench.flops', 'vpdbench.reference.student'))
print(json.dumps(out))
'''


@pytest.mark.parametrize('measures', ['train', 'infer'])
def test_a_cell_of_a_new_driver_added_as_files_only_runs(tmp_path,
                                                         measures):
    """A checkout with a new driver module, a configuration with none of
    the student's keys, a mix, a per-layer metric and limits, each a new
    file, and the cell as new entries: the harness runs it unchanged,
    takes its cut and its costs from the driver, reports the throughput
    of what its window counts, and loads neither the student's reference
    nor its FLOP counts."""
    root = str(tmp_path)
    b = copy_benchmark(root)
    cell, name = 'stub-' + measures, 'stub_' + measures

    def write(rel, text):
        with open(os.path.join(root, 'vpdbench', rel), 'w') as fp:
            fp.write(text if isinstance(text, str) else json.dumps(text))

    write('drivers/{}.py'.format(name), _STUB_DRIVER.format(
        measures=measures))
    write('configs/stub-product.json', {'name': 'stub-product', 'width': 16})
    write('traffic/{}.json'.format(cell), {'driver': name, 'batch': 1024})
    write('limits/{}.json'.format(cell), {'out_gap': 1e-6})
    write('metrics/stub_batch.py',
          'def read(r):\n    return float(r["traffic"]["batch"])\n')
    b['configs'].append({'name': 'stub-product', 'source': 'x',
                         'file': 'vpdbench/configs/stub-product.json',
                         'reduced': [], 'why': 'a test'})
    b['workloads'].append({'name': cell, 'config': 'stub-product',
                           'traffic': cell, 'chips': 1, 'why': 'a test'})
    throughput = measures + '_samples_per_s'
    for m in b['end_to_end'] + b['per_layer']:
        if m['name'] in (throughput, 'idle_pct.' + measures):
            m['workloads'].append(cell)
    b['per_layer'].append({'name': 'stub_batch', 'unit': 'n',
                           'better': 'higher', 'source': 'host_clock',
                           'layer': 'device', 'moves': throughput,
                           'workloads': [cell]})
    with open(os.path.join(root, 'BENCHMARK.json'), 'w') as fp:
        json.dump(b, fp)
    proc = subprocess.run([sys.executable, '-c', _STUB_RUN.format(cell=cell)],
                          cwd=root, capture_output=True, text=True,
                          timeout=300, env=dict(os.environ,
                                                OMP_NUM_THREADS='2'))
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    plain, traced = out['plain'], out['traced']
    assert plain['correct'] and traced['correct'], traced['checks']
    assert set(plain['metrics']) == {'setup_s', throughput}
    assert plain['metrics'][throughput]['value'] > 0
    # the driver's cut: batches of 8, not the mix's 1,024
    assert traced['metrics']['stub_batch']['value'] == 8
    assert 'idle_pct.' + measures in traced['metrics']
    assert out['loaded'] == []
