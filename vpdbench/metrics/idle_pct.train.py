"""idle_pct.train: the share of the traced window (`vpdbench.traced`,
around the slice the driver traces: whole epochs for the student) in
which no kernel, copy or memset ran, in cells whose window counts
samples trained."""


def read(r):
    t = r.get('trace')
    if r.get('measures') != 'train' or not t or not t['window_us']:
        return None
    return 100. * (1. - t['busy_us'] / t['window_us'])
