"""b1_roofline: kernel B1's byte bound over its mean time in the traced
window, in %. The bound moves each uint8 input byte once and each bf16
output byte once (`vpdbench/flops.b1_bytes`) at the card's HBM
bandwidth (`vpdbench/peaks.json`); the kernel is found by name
(`preprocess` in the CUDA kernel's name). None where B1 did not run."""

from vpdbench.flops import b1_bytes


def read(r):
    t, peaks = r.get('trace'), r.get('peaks')
    if r.get('kind') != 'extract' or not t or not peaks:
        return None
    runs = [v for k, v in t['kernels'].items() if 'preprocess' in k]
    launches = sum(n for n, _ in runs)
    if not launches:
        return None
    mean_us = sum(us for _, us in runs) / launches
    c = r['config']
    bound_us = b1_bytes(r['traffic']['chunk'], c['img_dim'], 3) / \
        peaks['hbm_bytes_per_s'] * 1e6
    return 100. * bound_us / mean_us
