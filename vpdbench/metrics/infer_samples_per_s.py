"""infer_samples_per_s: the samples whose outputs reached host memory in
the window over the window's wall time (host clock). Read in every cell
whose driver's window counts such samples (`MEASURES = 'infer'`)."""


def read(r):
    w = r.get('window')
    if r.get('measures') != 'infer' or not w or not w['seconds']:
        return None
    return w['samples'] / w['seconds']
