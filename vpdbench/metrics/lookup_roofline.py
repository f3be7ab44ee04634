"""lookup_roofline: RAFT's lookup kernel's byte bound over its mean device
time a launch in the traced slice, in %. The kernel is found by name
(`corr_lookup` in the CUDA kernel's name), in the flow cell only. The
bound counts what a correct lookup needs to move: of each query's maps,
each level's (2r+2)^2 window inside the map read once (the cells that a
level's (2r+1)^2 taps, which share one fractional offset, can touch),
the coordinates (N x 2 x 4 B) and each output byte written once (N x
levels x (2r+1)^2 x 4 B), at the card's HBM bandwidth
(`vpdbench/peaks.json`), for N = chunk x (img_dim / 8)^2 queries,
`corr_levels` levels of (img_dim / 8) / 2^l cells a side and radius
`corr_radius`: 133.7 MB a lookup at the flow cell's shapes (100 + 64 +
16 + 4 cells a query of its 340), 39.9 us. None where no such kernel ran
(the parent's batched products) or nothing was traced."""


def least_bytes(pairs, img_dim, levels, radius):
    """Float32 bytes of one lookup: each level's window inside the map
    and the coordinates read once, the output written once."""
    side = img_dim // 8
    queries = pairs * side * side
    window = 2 * radius + 2
    cells = sum(min(side >> lvl, window) ** 2 for lvl in range(levels))
    return 4 * queries * (cells + 2 + levels * (2 * radius + 1) ** 2)


def read(r):
    t, peaks = r.get('trace'), r.get('peaks')
    if r.get('kind') != 'flow' or not t or not peaks:
        return None
    runs = [v for k, v in t['kernels'].items() if 'corr_lookup' in k]
    launches = sum(n for n, _ in runs)
    if not launches:
        return None
    mean_us = sum(us for _, us in runs) / launches
    c = r['config']
    bound_us = least_bytes(r['traffic']['chunk'], c['img_dim'],
                           c['corr_levels'], c['corr_radius']) / \
        peaks['hbm_bytes_per_s'] * 1e6
    return 100. * bound_us / mean_us
