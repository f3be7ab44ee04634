"""`vpd_tpu_torch.core.profiling` against `vpd_tpu.core.profiling`.

`StepTimer`: both packages' timers on one scripted `time.perf_counter`
sequence give equal `summary()`, and the port's `step` takes a CPU
tensor to force. `trace` on the CPU writes a Chrome-format trace that
holds the recorded ops, and `device_activity` reads it back (no device
events on the CPU; the busy share of intervals is held on a written
trace).
"""

import json
import os
import time

import numpy as np
import pytest
import torch

from vpd_tpu.core import profiling as jprof
from vpd_tpu_torch.core import profiling as tprof

torch.set_num_threads(2)


def _scripted(monkeypatch, times):
    it = iter(times)
    monkeypatch.setattr(time, 'perf_counter', lambda: next(it))


@pytest.mark.parametrize('warmup', [0, 1, 2])
def test_step_timer_matches_vpd_tpu(monkeypatch, warmup):
    times = [0.0, 0.5, 0.75, 1.0, 1.125, 1.25, 1.5]
    summaries = []
    for mod in (jprof, tprof):
        _scripted(monkeypatch, times)
        timer = mod.StepTimer(items_per_step=64, warmup=warmup)
        timer.start()
        for i in range(len(times) - 1):
            timer.step(torch.ones(3) * i if mod is tprof else None)
        summaries.append(timer.summary())
    assert summaries[0] == summaries[1]
    assert summaries[1]['steps'] == len(times) - 1 - warmup


def test_step_timer_without_steps_matches_vpd_tpu():
    got, want = tprof.StepTimer().summary(), jprof.StepTimer().summary()
    assert got['steps'] == want['steps'] == 0
    assert np.isnan(got['mean_step_ms']) and np.isnan(want['mean_step_ms'])
    assert got['items_per_sec'] == want['items_per_sec'] == 0.


def test_trace_writes_a_chrome_trace_with_the_ops(tmp_path):
    log_dir = str(tmp_path / 'tb')
    with tprof.trace(log_dir):
        a = torch.randn(32, 32)
        (a @ a).sum()
    files = [f for f in os.listdir(log_dir) if f.endswith('.pt.trace.json')]
    assert len(files) == 1
    with open(os.path.join(log_dir, files[0])) as fp:
        events = json.load(fp)['traceEvents']
    ops = {e['name'] for e in events if e.get('cat') == 'cpu_op'}
    assert {'aten::mm', 'aten::sum'} <= ops, sorted(ops)
    activity = tprof.device_activity(log_dir)
    assert activity['kernel_events'] == activity['device_events'] == 0
    assert activity['window_us'] > 0 and activity['busy_share'] == 0.


def test_device_activity_merges_overlapping_intervals(tmp_path):
    def event(cat, name, ts, dur):
        return {'ph': 'X', 'cat': cat, 'name': name, 'ts': ts, 'dur': dur}

    events = [event('cpu_op', 'aten::mm', 0, 100),
              event('kernel', 'preprocess_vector', 10, 20),
              event('kernel', 'gemm', 20, 20),         # overlaps: 10-40
              event('gpu_memcpy', 'Memcpy HtoD', 50, 10),
              event('kernel', 'preprocess_vector', 90, 30)]  # ends at 120
    with open(tmp_path / 'w.1.pt.trace.json', 'w') as fp:
        json.dump({'traceEvents': events}, fp)
    activity = tprof.device_activity(str(tmp_path))
    assert activity['kernels'] == {'preprocess_vector': 2, 'gemm': 1}
    assert activity['kernel_events'] == 3
    assert activity['device_events'] == 4
    assert activity['window_us'] == 120
    assert activity['busy_us'] == 30 + 10 + 30
    assert activity['busy_share'] == pytest.approx(70 / 120)


def test_device_name_on_the_cpu():
    assert tprof.device_name('cpu') == 'cpu'
