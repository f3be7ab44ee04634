"""idle_pct.train: the share of the traced window (`vpdbench.traced`,
around whole epochs) in which no kernel, copy or memset ran."""


def read(r):
    t = r.get('trace')
    if r.get('kind') != 'train' or not t or not t['window_us']:
        return None
    return 100. * (1. - t['busy_us'] / t['window_us'])
