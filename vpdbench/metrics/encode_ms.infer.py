"""encode_ms.infer: device milliseconds the encoder takes over one
chunk's variants (orig and flip), the program's span
`vpd.extract.encode` (`infer/apply_vpd`), between CUDA events on the
compute stream; the mean over the traced call's chunks."""

from vpdbench.spans import mean_device_ms, records


def read(r):
    recs = records() if r.get('kind') == 'extract' else None
    n = (r.get('traffic') or {}).get('trace_chunks')
    if not recs or not n:
        return None
    found = [c for c in recs if c['name'] == 'vpd.extract.encode'][-n:]
    if len(found) < n:
        return None
    return mean_device_ms(found)
