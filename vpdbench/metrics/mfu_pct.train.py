"""mfu_pct.train: the model FLOPs of the window's train steps (3 x the
student's forward a sample, `vpdbench/flops.py`) over the window's time,
as a share of the card's dense bf16 peak (`vpdbench/peaks.json`)."""


def read(r):
    w, peaks = r.get('window'), r.get('peaks')
    if r.get('kind') != 'train' or not w or not peaks:
        return None
    flops = r['flops']['train_per_sample'] * w['samples']
    return 100. * flops / w['seconds'] / peaks['bf16_flops_per_s']
