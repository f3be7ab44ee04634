"""Profiling and throughput instrumentation.

Counterpart of `vpd_tpu/core/profiling.py`. `trace` wraps a block in a
`torch.profiler` trace (CPU ops and, where there is a GPU, its kernels
and copies through CUPTI), written where TensorBoard's profiler view and
chrome://tracing both read it; `device_activity` reads back the kernel
events of such a trace and the share of its window the device was busy.
`StepTimer` tracks steady-state step times and items per second.

CUDA launches return before the card has run them, so a timed section
must wait for its result: `StepTimer.step` takes a tensor whose device it
synchronizes, and `trace` synchronizes before the trace stops.
"""

import contextlib
import glob
import gzip
import json
import os
import time

import numpy as np
import torch

# Chrome-trace categories of device work in torch.profiler's export
DEVICE_CATEGORIES = ('kernel', 'gpu_memcpy', 'gpu_memset')


@contextlib.contextmanager
def trace(log_dir):
    """torch.profiler trace around a block: `with trace('/tmp/tb'): ...`

    Writes `<worker>.<time>.pt.trace.json` into `log_dir` and yields the
    profiler."""
    from torch.profiler import ProfilerActivity, profile
    from torch.profiler import tensorboard_trace_handler

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        try:
            yield prof
        finally:
            if cuda:  # the block's kernels end inside the trace
                torch.cuda.synchronize()


def _load_trace(path):
    opener = gzip.open if path.endswith('.gz') else open
    with opener(path, 'rt') as fp:
        return json.load(fp)


def device_activity(log_dir):
    """Device work in the newest trace `trace` wrote into `log_dir`:
    {'kernels': {name: launches}, 'kernel_events': n, 'device_events': n
    (kernels, copies and memsets), 'window_us': the span from the trace's
    first event to its last, 'busy_us': the union of the device events'
    intervals, 'busy_share': busy_us / window_us}."""
    paths = glob.glob(os.path.join(log_dir, '*.pt.trace.json*'))
    if not paths:
        raise FileNotFoundError('no trace under {}'.format(log_dir))
    events = [e for e in _load_trace(max(paths, key=os.path.getmtime))
              .get('traceEvents', []) if e.get('ph') == 'X']
    spans = [(float(e['ts']), float(e['ts']) + float(e.get('dur', 0)))
             for e in events]
    device = [e for e in events if e.get('cat') in DEVICE_CATEGORIES]
    kernels = {}
    for e in device:
        if e['cat'] == 'kernel':
            kernels[e['name']] = kernels.get(e['name'], 0) + 1
    busy, end = 0., float('-inf')
    for lo, hi in sorted((float(e['ts']), float(e['ts']) + float(e['dur']))
                         for e in device):
        if hi > end:
            busy += hi - max(lo, end)
            end = hi
    window = (max(hi for _, hi in spans) - min(lo for lo, _ in spans)
              if spans else 0.)
    return {'kernels': kernels, 'kernel_events': sum(kernels.values()),
            'device_events': len(device), 'window_us': window,
            'busy_us': busy, 'busy_share': busy / window if window else 0.}


def device_name(device):
    """The name a result gives its device: the card's, or 'cpu'."""
    device = torch.device(device)
    if device.type == 'cuda':
        return torch.cuda.get_device_name(device)
    return device.type


class StepTimer:
    """Steady-state step timing; skips the first `warmup` steps."""

    def __init__(self, items_per_step=1, warmup=2):
        self.items_per_step = items_per_step
        self.warmup = warmup
        self.times = []
        self._count = 0
        self._last = None

    def start(self):
        self._last = time.perf_counter()

    def step(self, force_result=None):
        """Record one step; pass a tensor to wait for its device's work
        (an array or a CPU tensor is ready as it is)."""
        if isinstance(force_result, torch.Tensor):
            if force_result.device.type == 'cuda':
                torch.cuda.synchronize(force_result.device)
        elif force_result is not None:
            np.asarray(force_result)
        now = time.perf_counter()
        if self._last is not None:
            self._count += 1
            if self._count > self.warmup:
                self.times.append(now - self._last)
        self._last = now

    @property
    def mean_step_time(self):
        return float(np.mean(self.times)) if self.times else float('nan')

    @property
    def items_per_sec(self):
        t = self.mean_step_time
        return self.items_per_step / t if t and np.isfinite(t) else 0.

    def summary(self):
        return {
            'steps': len(self.times),
            'mean_step_ms': round(self.mean_step_time * 1e3, 3),
            'items_per_sec': round(self.items_per_sec, 1),
        }
