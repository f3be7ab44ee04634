"""infer_samples_per_s: the samples whose embeddings reached host memory
in the window over the window's wall time (host clock)."""


def read(r):
    w = r.get('window')
    if r.get('kind') != 'extract' or not w or not w['seconds']:
        return None
    return w['samples'] / w['seconds']
