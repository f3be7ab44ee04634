"""`vpd_tpu_torch.core.profiling`'s trace and its reading.

`trace` on the CPU writes a Chrome-format trace that holds the recorded
ops inside its span, and `device_activity` reads it back (no device
events on the CPU; the busy share of intervals inside the span is held
on a written trace). The spans are tested in `test_torch_spans.py`.
"""

import json
import os

import pytest
import torch

from vpd_tpu_torch.core import profiling as tprof

torch.set_num_threads(2)


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
    spans = {e['name'] for e in events if e.get('cat') == 'user_annotation'}
    assert tprof.TRACE_SPAN in spans
    activity = tprof.device_activity(log_dir)
    assert activity['kernel_events'] == activity['device_events'] == 0
    assert activity['window_us'] > 0 and activity['busy_share'] == 0.


def test_device_activity_merges_overlapping_intervals(tmp_path):
    def event(cat, name, ts, dur):
        return {'ph': 'X', 'cat': cat, 'name': name, 'ts': ts, 'dur': dur}

    # the window is trace's span, 5-115: the profiler's own start and
    # stop outside it are not idle time, and device work outside it is
    # not counted
    events = [event('cpu_op', 'aten::mm', 0, 100),
              event('user_annotation', tprof.TRACE_SPAN, 5, 110),
              event('kernel', 'gemm', 0, 3),            # before the span
              event('kernel', 'preprocess_vector', 10, 20),
              event('kernel', 'gemm', 20, 20),         # overlaps: 10-40
              event('gpu_memcpy', 'Memcpy HtoD', 50, 10),
              event('kernel', 'preprocess_vector', 90, 30),  # to 115
              event('kernel', 'gemm', 130, 10)]         # after the span
    with open(tmp_path / 'w.1.pt.trace.json', 'w') as fp:
        json.dump({'traceEvents': events}, fp)
    activity = tprof.device_activity(str(tmp_path))
    assert activity['kernels'] == {'preprocess_vector': 2, 'gemm': 1}
    assert activity['kernel_events'] == 3
    assert activity['device_events'] == 4
    assert activity['window_us'] == 110
    assert activity['busy_us'] == 30 + 10 + 25
    assert activity['busy_share'] == pytest.approx(65 / 110)


def test_device_name_on_the_cpu():
    assert tprof.device_name('cpu') == 'cpu'
