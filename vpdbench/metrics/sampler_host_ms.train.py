"""sampler_host_ms.train: host milliseconds a batch in the program's
batch source, the program's span `vpd.train.sampler` around
`next_batch` (`train/vpd_loop.VPDTrainer._epoch`), by its host stamps;
the mean over the batches of the traced epochs."""

from vpdbench.spans import train_spans


def read(r):
    found = train_spans(r, 'vpd.train.sampler')
    if not found:
        return None
    return sum(c['end_ns'] - c['start_ns'] for c in found) / len(found) / 1e6
