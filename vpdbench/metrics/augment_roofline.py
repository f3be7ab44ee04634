"""augment_roofline: the train step's input kernel's byte bound over its
mean device time a step in the traced slice, in %. The kernel is found by
name (`train_augment` in the CUDA kernel's name); the steps are the
`vpd.train.input` spans of the traced epochs (`vpdbench/spans.py`). The
bound counts what every correct kernel moves a step: each rgb byte of
the batch read once (the contrast jitter's mean reads the whole image) and
each output byte written once, at the card's HBM bandwidth
(`vpdbench/peaks.json`); flow, mask and noise are left out, as a kernel
may read only the crop's flow and the noisy samples' noise. None where no
such kernel ran."""

import torch

from vpdbench.spans import train_spans


def least_bytes(batch, img_dim, channels, itemsize):
    """Each (B, S, S, 3) uint8 rgb byte read once and each (B, S, S, C)
    output byte written once."""
    pixels = batch * img_dim * img_dim
    return pixels * 3 + pixels * channels * itemsize


def read(r):
    t, peaks = r.get('trace'), r.get('peaks')
    if r.get('kind') != 'train' or not t or not peaks:
        return None
    kernel_us = sum(us for k, (_, us) in t['kernels'].items()
                    if 'train_augment' in k)
    steps = train_spans(r, 'vpd.train.input')
    if not kernel_us or not steps:
        return None
    c = r['config']
    moved = least_bytes(r['traffic']['batch_size'], c['img_dim'],
                        c['in_channels'],
                        getattr(torch, c['compute_dtype']).itemsize)
    bound_us = moved / peaks['hbm_bytes_per_s'] * 1e6
    return 100. * bound_us / (kernel_us / len(steps))
