"""BENCHMARK.json against the files it names, and a cell added as files."""

import json
import os
import re

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
