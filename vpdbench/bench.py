"""One run of one cell: find its files by name, set up, measure, check.

Everything a cell is made of is found by the names in `BENCHMARK.json`:

* the configuration: the file its `configs` entry names;
* the traffic mix: `vpdbench/traffic/<traffic>.json`, whose `driver`
  names the general driver under `vpdbench/drivers/` that runs it. A
  driver module gives `MEASURES`, what its window counts ('train':
  samples trained; 'infer': samples whose outputs reached host memory),
  and a `Cell` that sets up, measures, traces, releases, gives the
  numbers of `correct` and, from `costs()`, what a sample costs;
* the limits of `correct`: `vpdbench/limits/<workload>.json`, the cell's
  own, {number: limit};
* each metric: `vpdbench/metrics/<name>.py`, a reader whose `read(r)`
  takes the run's readings and returns a number, or None where it finds
  nothing to read (the metric is then left out).

A cell reports the end-to-end metrics that list it (or list no cells)
with `--trace 0`, and the per-layer metrics that list it with `--trace
1`. A traced run measures the same window, timing the host input, then
traces a short slice.
"""

import importlib
import importlib.util
import json
import math
import os
import subprocess
import sys
import time

FORBIDDEN = ('jax', 'jaxlib', 'flax', 'vpd_tpu')
HERE = os.path.dirname(os.path.abspath(__file__))


class Spec:
    """BENCHMARK.json and the files it names, under `root`."""

    def __init__(self, root):
        self.root = root
        with open(os.path.join(root, 'BENCHMARK.json')) as fp:
            self.bench = json.load(fp)

    def workload(self, name):
        for w in self.bench['workloads']:
            if w['name'] == name:
                return w
        raise KeyError('no workload "{}" in BENCHMARK.json'.format(name))

    def config(self, name):
        for c in self.bench['configs']:
            if c['name'] == name:
                with open(os.path.join(self.root, c['file'])) as fp:
                    return json.load(fp)
        raise KeyError('no config "{}" in BENCHMARK.json'.format(name))

    def _data(self, folder, name):
        with open(os.path.join(self.root, 'vpdbench', folder,
                               name + '.json')) as fp:
            return json.load(fp)

    def traffic(self, name):
        return self._data('traffic', name)

    def limits(self, workload):
        return self._data('limits', workload)

    def metrics(self, workload, trace):
        """The metric entries this cell reports in this kind of run."""
        entries = self.bench['per_layer' if trace else 'end_to_end']
        return [m for m in entries
                if workload in m.get('workloads', [workload])]

    def reader(self, name):
        path = os.path.join(self.root, 'vpdbench', 'metrics', name + '.py')
        spec = importlib.util.spec_from_file_location(
            'vpdbench_metric_' + name.replace('.', '_'), path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module.read


def load_peaks():
    with open(os.path.join(HERE, 'peaks.json')) as fp:
        return json.load(fp)


def forbidden_modules():
    return sorted(m for m in sys.modules if m.split('.')[0] in FORBIDDEN)


def power_limit():
    """The card's power limit as nvidia-smi reads it, or None."""
    try:
        out = subprocess.run(
            ['nvidia-smi', '--query-gpu=power.limit',
             '--format=csv,noheader,nounits'], capture_output=True,
            text=True, timeout=20, check=True).stdout.split()
        return float(out[0]) if out else None
    except (OSError, subprocess.SubprocessError, ValueError):
        return None


def run_cell(root, workload, seed, seconds, trace, t_start, device='cuda',
             overrides=None):
    """Run one cell; returns the result line's dict. `overrides` ({'config':
    {...}, 'traffic': {...}}) shrinks a cell for the CPU tests."""
    import torch

    from . import compare

    spec = Spec(root)
    w = spec.workload(workload)
    config = dict(spec.config(w['config']), **(overrides or {}).get(
        'config', {}))
    traffic = dict(spec.traffic(w['traffic']), **(overrides or {}).get(
        'traffic', {}))
    driver = importlib.import_module('vpdbench.drivers.' + traffic['driver'])
    torch.set_num_threads(traffic.get('host_threads', 2))
    cuda = torch.device(device).type == 'cuda'

    cell = driver.Cell(config, traffic, seed, device)
    t_setup = time.perf_counter()
    cell.setup()
    setup_s = time.perf_counter() - t_start
    setup_parts = dict(imports=t_setup - t_start, **cell.setup_parts)
    win = cell.window(seconds, timed=bool(trace))
    summary = cell.trace() if trace else None
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    cell.release()
    numbers = cell.numbers()
    correct, checks = compare.judge(numbers, spec.limits(workload))

    kind = torch.cuda.get_device_name(0) if cuda else 'cpu'
    readings = {
        'kind': traffic['driver'], 'measures': driver.MEASURES,
        'setup_s': setup_s, 'window': win, 'trace': summary,
        'peaks': load_peaks().get(kind), 'costs': cell.costs(),
        'traffic': traffic, 'config': config}
    metrics = {}
    for m in spec.metrics(workload, trace):
        value = spec.reader(m['name'])(readings)
        if value is not None and math.isfinite(value):
            metrics[m['name']] = {'value': value, 'unit': m['unit']}
    dev = {'platform': 'gpu' if cuda else 'cpu', 'kind': kind,
           'count': w['chips'], 'memory_peak_bytes': peak}
    if cuda:
        dev['power_limit_w'] = power_limit()
    result = {'correct': correct, 'attempted': win['attempted'],
              'failed': win['failed'], 'metrics': metrics, 'device': dev}
    if summary is not None:
        dev['busy_s'] = summary['busy_us'] / 1e6
        dev['window_s'] = summary['window_us'] / 1e6
        result['breakdown'] = {
            'device_ops': [[n, us / 1e6] for n, us in summary['device_ops']],
            'idle_gaps': [[n, us / 1e6] for n, us in summary['idle_gaps']]}
    result['setup_parts'] = setup_parts
    result['checks'] = checks
    return result
