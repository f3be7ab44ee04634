"""mfu_pct.train: the FLOPs of the window's trained samples (the cell
driver's `costs()['train_per_sample']`; for the student 3 x its forward,
`vpdbench/flops.py`) over the window's time, as a share of the card's
dense bf16 peak (`vpdbench/peaks.json`)."""


def read(r):
    w, peaks = r.get('window'), r.get('peaks')
    if r.get('measures') != 'train' or not w or not peaks:
        return None
    flops = r['costs']['train_per_sample'] * w['samples']
    return 100. * flops / w['seconds'] / peaks['bf16_flops_per_s']
