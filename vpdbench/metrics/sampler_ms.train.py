"""sampler_ms.train: host milliseconds a batch in the program's batch
source (`next_batch`), the mean over every batch of the traced run's
window."""


def read(r):
    w = r.get('window') or {}
    times = w.get('sampler_ms')
    if r.get('kind') != 'train' or not times:
        return None
    return sum(times) / len(times)
