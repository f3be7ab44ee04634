"""The program's RAFT spans of a traced slice, for the flow cell's
per-layer metrics.

`compute_flow.make_flow_compute` opens `vpd.flow.chunk` around each
chunk's card half, and `models/raft.RAFT.forward` opens inside it
`vpd.flow.encode`, `vpd.flow.corr`, `vpd.flow.lookup` and
`vpd.flow.update` in each iteration (ids: `iter`), and
`vpd.flow.upsample` (`core/profiling.span`). The iteration ids are the
counter: a chunk is read only if it holds exactly `iters` lookup and
`iters` update spans, with ids 0 to iters - 1.

A span's time is the device time of the kernels, copies and memsets
launched inside it: `traced_launches` traces as `trace.traced` does and
matches each device event of the trace to its launch on the host by the
profiler's correlation id; a span takes the events whose launch lies
between its host stamps. The spans' own CUDA events would time the
stream, and under the profiler the host's launches, not the card, pace
RAFT's many small kernels, so the stream's bubbles would be read as the
layer's time.

Everything here returns None where there is nothing to read: a program
without these spans, a chunk short of its iterations, or a trace with no
launched device work (on the CPU).
"""

import bisect
import json
import os
import tempfile

import torch

from vpdbench.spans import records
from vpdbench.trace import DEVICE_CATEGORIES, WINDOW_SPAN, span, summarize

CHUNK = 'vpd.flow.chunk'
ITERATED = ('vpd.flow.lookup', 'vpd.flow.update')
LAUNCH_CATEGORIES = ('cuda_runtime', 'cuda_driver')


def launches(events, base_ns):
    """(launch stamps in Unix-epoch ns, ascending; running sums of the
    device us launched, one longer) of a Chrome trace's events."""
    launched = {}
    for e in events:
        if e.get('cat') in LAUNCH_CATEGORIES:
            c = (e.get('args') or {}).get('correlation')
            if c is not None:
                launched[c] = base_ns + round(float(e['ts']) * 1e3)
    found = []
    for e in events:
        c = (e.get('args') or {}).get('correlation')
        if e.get('cat') in DEVICE_CATEGORIES and c in launched:
            found.append((launched[c], float(e.get('dur', 0))))
    found.sort()
    sums = [0.]
    for _, us in found:
        sums.append(sums[-1] + us)
    return [ns for ns, _ in found], sums


def traced_launches(fn):
    """`trace.traced(fn)`'s summary, with 'launches': `launches` of the
    trace."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if cuda else [])
    with tempfile.TemporaryDirectory(prefix='vpdbench-trace-') as tmp:
        with profile(activities=activities) as prof:
            with span(WINDOW_SPAN):
                fn()
                if cuda:
                    torch.cuda.synchronize()
        path = os.path.join(tmp, 'trace.json')
        prof.export_chrome_trace(path)
        with open(path) as fp:
            doc = json.load(fp)
    events = [e for e in doc.get('traceEvents', []) if e.get('ph') == 'X']
    summary = summarize(events)
    if summary is not None:
        summary['launches'] = launches(
            events, int(doc.get('baseTimeNanoseconds', 0)))
    return summary


def traced_chunks(r):
    """[[records inside a chunk]] of the newest `trace_chunks` chunks,
    oldest first, or None unless each has its `iters` iterations."""
    recs = records() if r.get('kind') == 'flow' else None
    n = (r.get('traffic') or {}).get('trace_chunks')
    iters = (r.get('config') or {}).get('iters')
    if not recs or not n or not iters:
        return None
    chunks = [c for c in recs if c['name'] == CHUNK][-n:]
    if len(chunks) < n:
        return None
    out = []
    for chunk in chunks:
        ids = {chunk['id']}
        inside = []
        for c in recs:  # in the order the spans began: parents first
            if c['parent'] in ids:
                ids.add(c['id'])
                inside.append(c)
        for name in ITERATED:
            steps = sorted(c['ids'].get('iter', -1) for c in inside
                           if c['name'] == name)
            if steps != list(range(iters)):
                return None
        out.append(inside)
    return out


def chunk_device_ms(r, name):
    """The mean over the traced chunks of the device ms launched inside a
    chunk's spans named `name`, summed; None where a chunk has none."""
    chunks = traced_chunks(r)
    stamps, sums = (r.get('trace') or {}).get('launches') or ([], [])
    if chunks is None or not stamps:
        return None

    def ms(c):
        lo = bisect.bisect_left(stamps, c['start_ns'])
        hi = bisect.bisect_right(stamps, c['end_ns'])
        return (sums[hi] - sums[lo]) / 1e3

    totals = []
    for inside in chunks:
        found = [c for c in inside if c['name'] == name]
        if not found:
            return None
        totals.append(sum(ms(c) for c in found))
    return sum(totals) / len(totals)
