"""idle_pct.infer: the share of the traced window (`vpdbench.traced`,
around the slice the driver traces: one pipelined call of chunks for the
student) in which no kernel, copy or memset ran, in cells whose window
counts samples read back."""


def read(r):
    t = r.get('trace')
    if r.get('measures') != 'infer' or not t or not t['window_us']:
        return None
    return 100. * (1. - t['busy_us'] / t['window_us'])
