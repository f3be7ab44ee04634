"""Profiling: traces, the device's busy share, and the program's spans.

Counterpart of `vpd_tpu/core/profiling.py`. `trace` wraps a block in a
`torch.profiler` trace (CPU ops and, where there is a GPU, its kernels
and copies through CUPTI), written where TensorBoard's profiler view and
chrome://tracing both read it, with the block inside the span
`TRACE_SPAN`; `device_activity` reads back the device events of such a
trace inside that span and the share of it the device was busy.

`span(name, device=None, **ids)` marks a stage of the program (a train
step's input, forward and backward, AdamW; an epoch; an embed). It is on
exactly while a torch profiler is active, `trace`'s or any caller's
`torch.profiler.profile`, and then enters a `record_function` of its
name, so that it appears in the exported trace beside the kernels, and
keeps a record: its name, the enclosing span on the same thread, the
thread, `ids`, and its host start and end in Unix-epoch nanoseconds, the
trace's clock (a Chrome trace's `ts` in microseconds is `(ns -
baseTimeNanoseconds) / 1000`). Given a CUDA `device`, it also records a
timing event on that device's current stream at entry and at exit; the
device milliseconds between them are resolved when the records are
read, after a synchronize. Off, `span` makes one check and returns.
`span_records()` reads the records, the newest `SPAN_CAPACITY` of them,
and the count dropped before them; `clear_spans()` empties the buffer.

CUDA launches return before the card has run them, so `trace`
synchronizes before the trace stops and its span ends.
"""

import collections
import contextlib
import glob
import gzip
import itertools
import json
import os
import threading
import time

import torch

# Chrome-trace categories of device work in torch.profiler's export
DEVICE_CATEGORIES = ('kernel', 'gpu_memcpy', 'gpu_memset')
# the span `trace` opens around its block: the window `device_activity`
# reads
TRACE_SPAN = 'vpd.trace'
SPAN_CAPACITY = 1 << 14

_profiler_enabled = torch._C._autograd._profiler_enabled


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
        with torch.profiler.record_function(TRACE_SPAN):
            try:
                yield prof
            finally:
                if cuda:  # the block's kernels end inside the span
                    torch.cuda.synchronize()


def _load_trace(path):
    opener = gzip.open if path.endswith('.gz') else open
    with opener(path, 'rt') as fp:
        return json.load(fp)


def _interval(e):
    lo = float(e['ts'])
    return lo, lo + float(e.get('dur', 0))


def device_activity(log_dir):
    """Device work in the newest trace `trace` wrote into `log_dir`,
    inside its span `TRACE_SPAN`: {'kernels': {name: launches},
    'kernel_events': n, 'device_events': n (kernels, copies and memsets),
    'window_us': the span's length, 'busy_us': the union of the device
    events' intervals inside it, 'busy_share': busy_us / window_us}."""
    paths = glob.glob(os.path.join(log_dir, '*.pt.trace.json*'))
    if not paths:
        raise FileNotFoundError('no trace under {}'.format(log_dir))
    events = [e for e in _load_trace(max(paths, key=os.path.getmtime))
              .get('traceEvents', []) if e.get('ph') == 'X']
    windows = [_interval(e) for e in events if e.get('name') == TRACE_SPAN
               and e.get('cat') == 'user_annotation']
    if not windows:
        raise ValueError('the trace under {} has no span {}'.format(
            log_dir, TRACE_SPAN))
    w0, w1 = windows[0]
    device, kernels = [], {}
    for e in events:
        if e.get('cat') not in DEVICE_CATEGORIES:
            continue
        lo, hi = _interval(e)
        lo, hi = max(lo, w0), min(hi, w1)
        if hi <= lo:
            continue
        device.append((lo, hi))
        if e['cat'] == 'kernel':
            kernels[e['name']] = kernels.get(e['name'], 0) + 1
    busy, end = 0., w0
    for lo, hi in sorted(device):
        if hi > end:
            busy += hi - max(lo, end)
            end = hi
    window = w1 - w0
    return {'kernels': kernels, 'kernel_events': sum(kernels.values()),
            'device_events': len(device), 'window_us': window,
            'busy_us': busy, 'busy_share': busy / window if window else 0.}


def device_name(device):
    """The name a result gives its device: the card's, or 'cpu'."""
    device = torch.device(device)
    if device.type == 'cuda':
        return torch.cuda.get_device_name(device)
    return device.type


# ------------------------------------------------------------------ spans

Spans = collections.namedtuple('Spans', 'records dropped')


class _Record:
    __slots__ = ('id', 'name', 'parent', 'thread', 'ids', 'start_ns',
                 'end_ns', 'events', 'device_ms')

    def as_dict(self):
        return {'id': self.id, 'name': self.name, 'parent': self.parent,
                'thread': self.thread, 'ids': self.ids,
                'start_ns': self.start_ns, 'end_ns': self.end_ns,
                'device_ms': self.device_ms}


class _Span:
    """One span while a profiler is active (`SpanRecorder.span`)."""

    __slots__ = ('recorder', 'record', 'function', 'stream')

    def __init__(self, recorder, name, device, ids):
        self.recorder = recorder
        r = self.record = _Record()
        r.name, r.ids, r.events, r.device_ms = name, ids, None, None
        self.stream = (torch.cuda.current_stream(device)
                       if device is not None
                       and torch.device(device).type == 'cuda' else None)

    def __enter__(self):
        r = self.record
        stack = self.recorder._stack()
        r.id = next(self.recorder._ids)
        r.parent = stack[-1].id if stack else None
        r.thread = threading.get_ident()
        stack.append(r)
        # the host stamps enclose the trace's event of the span
        r.start_ns = time.time_ns()
        self.function = torch.profiler.record_function(r.name)
        self.function.__enter__()
        if self.stream is not None:
            r.events = (torch.cuda.Event(enable_timing=True),
                        torch.cuda.Event(enable_timing=True))
            r.events[0].record(self.stream)
        return self

    def __exit__(self, *exc):
        r = self.record
        if r.events is not None:
            r.events[1].record(self.stream)
        self.function.__exit__(*exc)
        r.end_ns = time.time_ns()
        self.recorder._stack().pop()
        self.recorder._keep(r)
        return False


class SpanRecorder:
    """The records of the spans that ran under a profiler: a buffer of
    the newest `capacity`, and the count of those it dropped."""

    def __init__(self, capacity=SPAN_CAPACITY):
        self._records = collections.deque(maxlen=capacity)
        self._dropped = 0
        self._lock = threading.Lock()
        self._local = threading.local()
        self._ids = itertools.count()

    def span(self, name, device=None, **ids):
        """A context manager marking a stage of the program: the one check
        whether a profiler is active, and with one, a `record_function`
        and a record (device events on `device`'s current stream where it
        is a CUDA device)."""
        if not _profiler_enabled():
            return _OFF
        return _Span(self, name, device, ids)

    def _stack(self):
        stack = getattr(self._local, 'stack', None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _keep(self, record):
        with self._lock:
            if len(self._records) == self._records.maxlen:
                self._dropped += 1
            self._records.append(record)

    def records(self):
        """`Spans(records, dropped)`: the kept records as dicts in the
        order the spans began, each with its device milliseconds (None
        without CUDA events), and the count dropped. Waits for the events'
        work to finish."""
        with self._lock:
            kept, dropped = list(self._records), self._dropped
        for r in kept:
            if r.events is not None:
                start, end = r.events
                end.synchronize()
                r.device_ms, r.events = start.elapsed_time(end), None
        return Spans([r.as_dict() for r in sorted(kept, key=lambda r: r.id)],
                     dropped)

    def clear(self):
        with self._lock:
            self._records.clear()
            self._dropped = 0


_OFF = contextlib.nullcontext()
_RECORDER = SpanRecorder()
span = _RECORDER.span
span_records = _RECORDER.records
clear_spans = _RECORDER.clear
