"""A traced slice of a run, and what the per-layer metrics read from it.

`traced(fn)` runs fn() under `torch.profiler` (CPU ops and, on the card,
its kernels, copies and memsets through CUPTI) inside the span
`vpdbench.traced`, writes the Chrome trace to a temporary directory
under $TMPDIR, reads it back and deletes it. `summarize` bounds the
window by that span, not by the trace's first and last events, so the
profiler's own start and stop are not counted as idle time. The busy
time is the union of the device events' intervals inside the window (the
arithmetic of the port's `core/profiling.device_activity`, copied). Each
idle gap is named by the innermost `vpdbench.*` span the host was in at
its middle.
"""

import gzip
import json
import os
import tempfile

import torch

WINDOW_SPAN = 'vpdbench.traced'
DEVICE_CATEGORIES = ('kernel', 'gpu_memcpy', 'gpu_memset')
TOP = 10


# a host span the trace records (next to nothing outside a trace)
span = torch.profiler.record_function


def traced(fn):
    """(fn's result, the trace's summary)."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if cuda else [])
    with tempfile.TemporaryDirectory(prefix='vpdbench-trace-') as tmp:
        with profile(activities=activities) as prof:
            with span(WINDOW_SPAN):
                out = fn()
                if cuda:
                    torch.cuda.synchronize()
        path = os.path.join(tmp, 'trace.json')
        prof.export_chrome_trace(path)
        events = load_events(path)
    return out, summarize(events)


def load_events(path):
    opener = gzip.open if path.endswith('.gz') else open
    with opener(path, 'rt') as fp:
        return [e for e in json.load(fp).get('traceEvents', [])
                if e.get('ph') == 'X']


def _interval(e):
    lo = float(e['ts'])
    return lo, lo + float(e.get('dur', 0))


def summarize(events):
    """{'window_us', 'busy_us', 'kernels': {name: [launches, us]},
    'device_ops': [[name, us]], 'idle_gaps': [[host span, us]]} of the
    span `vpdbench.traced`; None if the trace has no such span."""
    windows = [_interval(e) for e in events if e.get('name') == WINDOW_SPAN
               and e.get('cat') == 'user_annotation']
    if not windows:
        return None
    w0, w1 = windows[0]
    device, spans = [], []
    for e in events:
        lo, hi = _interval(e)
        if e.get('cat') in DEVICE_CATEGORIES:
            lo, hi = max(lo, w0), min(hi, w1)
            if hi > lo:
                device.append((lo, hi, e['cat'], e.get('name', '?')))
        elif (e.get('cat') == 'user_annotation'
              and e.get('name', '').startswith('vpdbench.')
              and e['name'] != WINDOW_SPAN):
            spans.append((lo, hi, e['name']))

    kernels, ops = {}, {}
    for lo, hi, cat, name in device:
        ops[name] = ops.get(name, 0.) + hi - lo
        if cat == 'kernel':
            n, us = kernels.get(name, (0, 0.))
            kernels[name] = (n + 1, us + hi - lo)

    busy, end, gaps = 0., w0, []
    for lo, hi, _, _ in sorted(device):
        if lo > end:
            gaps.append((end, lo))
        if hi > end:
            busy += hi - max(lo, end)
            end = hi
    if w1 > end:
        gaps.append((end, w1))

    def host_at(t):
        inside = [s for s in spans if s[0] <= t <= s[1]]
        return max(inside)[2] if inside else 'other'

    named = sorted(((host_at((lo + hi) / 2), hi - lo) for lo, hi in gaps),
                   key=lambda g: -g[1])
    return {'window_us': w1 - w0, 'busy_us': busy,
            'kernels': {k: list(v) for k, v in kernels.items()},
            'device_ops': sorted(([k, v] for k, v in ops.items()),
                                 key=lambda o: -o[1])[:TOP],
            'idle_gaps': [list(g) for g in named[:TOP]]}
