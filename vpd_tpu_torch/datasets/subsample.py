"""Fractional-rate frame subsampling shared by the action loaders.

The reference walks each embedding file with an inline fractional
"credit" accumulator (`finegym/util.py:97-120`, `diving48/util.py:50-62`);
both copies differ only in the starting credit and a +0.01 rate bias.
Here the decision stream is one shared primitive that the loaders
parameterize, and the loaders themselves operate on pre-stacked row
arrays + boolean take masks instead of walking appends.

Float semantics note: the credit update applies ``-= 1`` and ``+= rate``
as two separate operations in that order, matching the reference's
accumulated rounding exactly (a closed-form ``floor(j * rate)`` mask is
NOT float-identical near decision boundaries — tested differentially in
tests/test_reference_oracle.py).

Copied from `vpd_tpu/datasets/subsample.py` (this package
imports nothing of `vpd_tpu`).
"""

import numpy as np


def take_mask(n, rate, credit):
    """Boolean take/skip mask for ``n`` candidate frames.

    A frame is taken while ``credit >= 0``; taking costs 1 credit and
    every candidate earns ``rate``. ``rate >= 1`` takes everything.
    """
    mask = np.empty(n, dtype=bool)
    for j in range(n):
        mask[j] = credit >= 0
        if mask[j]:
            credit -= 1.0
        credit += rate
    return mask


def segment_means(rows, mask):
    """Per-taken-frame mean of itself plus the skipped run preceding it.

    Mirrors the reference's ``interp_skipped`` averaging
    (`finegym/util.py:112-118`): each taken row is replaced by the mean
    of [rows skipped since the previous take] + [itself]; a trailing
    skipped run after the final take is dropped.
    """
    taken = np.flatnonzero(mask)
    if taken.size == 0:
        return rows[mask]
    starts = np.concatenate([[0], taken[:-1] + 1])
    return np.stack([rows[a:b + 1].mean(axis=0)
                     for a, b in zip(starts, taken)])


def subsample_rows(rows, rate, credit, interp_skipped=False):
    """Apply the credit-accumulator mask to a (n, D) row stack."""
    mask = take_mask(len(rows), rate, credit)
    if interp_skipped:
        return segment_means(rows, mask)
    return rows[mask]
