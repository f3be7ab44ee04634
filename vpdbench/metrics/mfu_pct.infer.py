"""mfu_pct.infer: the FLOPs of the window's samples (the cell driver's
`costs()['infer_per_sample']`; for the student the encoder's forward of 2
variants a crop, `vpdbench/flops.py`) over the window's time, as a share
of the card's dense bf16 peak (`vpdbench/peaks.json`)."""


def read(r):
    w, peaks = r.get('window'), r.get('peaks')
    if r.get('measures') != 'infer' or not w or not peaks:
        return None
    flops = r['costs']['infer_per_sample'] * w['samples']
    return 100. * flops / w['seconds'] / peaks['bf16_flops_per_s']
