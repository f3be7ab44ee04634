"""The program's own spans of a traced slice, for the per-layer metrics
that read them.

The port's `core/profiling.span` keeps a record of each span while a
torch profiler is active, so the records are those of the traced slice
(`trace.traced`): its name, the enclosing span, its ids, host stamps on
the trace's clock and, for spans around device work, the device
milliseconds between CUDA events on the stream. Each reader takes the
newest records of the slice: the last `trace_epochs` epochs and the
spans inside them, or the last `trace_chunks` encodes. Everything here
returns None where there is nothing to read: a program without the
recorder, no records, records dropped, or a record without its device
time (on the CPU).
"""

EPOCH = 'vpd.train.epoch'
STEP = ('vpd.train.input', 'vpd.train.fwd_bwd', 'vpd.train.adamw')


def records():
    """The program's span records, or None."""
    try:
        from vpd_tpu_torch.core.profiling import span_records
    except ImportError:
        return None
    spans = span_records()
    if spans.dropped or not spans.records:
        return None
    return spans.records


def train_epochs(r):
    """[(epoch record, [records inside it])] of the traced slice's epochs,
    oldest first, or None."""
    recs = records() if r.get('kind') == 'train' else None
    n = (r.get('traffic') or {}).get('trace_epochs')
    if not recs or not n:
        return None
    epochs = [e for e in recs if e['name'] == EPOCH][-n:]
    if len(epochs) < n:
        return None
    out = []
    for e in epochs:
        ids = {e['id']}
        inside = []
        for c in recs:  # in the order the spans began: parents first
            if c['parent'] in ids:
                ids.add(c['id'])
                inside.append(c)
        out.append((e, inside))
    return out


def mean_device_ms(found):
    """The mean device ms of `found`, None if empty or one lacks it."""
    if not found or any(c['device_ms'] is None for c in found):
        return None
    return sum(c['device_ms'] for c in found) / len(found)


def train_spans(r, name):
    """Every record named `name` inside the traced slice's epochs."""
    epochs = train_epochs(r)
    if epochs is None:
        return None
    return [c for _, inside in epochs for c in inside if c['name'] == name]
