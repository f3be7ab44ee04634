"""3D pose feature targets for the VIPE* lifting decoder.

The port's copy of `vpd_tpu/geometry/features3d.py` (numpy only, unchanged
below this note), so that `vpd_tpu_torch` imports nothing of `vpd_tpu`.

Parity with reference `vipe_dataset/dataset_base.py:30-60`. Feature layout
per edge row: [unit offset (3) | arccos(parent cossim)/pi - 0.5 (1) |
unit root-relative direction (3)], with extremity rows zeroed unless
included. All ops are plain numpy on small arrays (host sampler path); the
train step consumes the stacked result on device.
"""

import math

import numpy as np

NEG_SAMPLE_JOINT_COS_THRESHOLD = math.cos(math.radians(45))


def normalize_3d_offsets(kp_offsets):
    """Row-normalize (..., E, 3) offsets; returns (unit_offsets, lengths)."""
    kp_dists = np.linalg.norm(kp_offsets, axis=-1)
    return kp_offsets / kp_dists[..., None], kp_dists


def is_good_3d_neg_sample(a, b, ignore=None):
    """True if two unit-offset stacks differ by >45° at some joint."""
    dot = np.sum(a * b, axis=1)
    if ignore is not None:
        dot = dot.copy()
        dot[list(ignore)] = 1
    return np.min(dot) <= NEG_SAMPLE_JOINT_COS_THRESHOLD


def neg_sample_valid_batch(a, b):
    """Batched `is_good_3d_neg_sample`: (N, E, 3) vs (N, E, 3) → (N,) bool."""
    dot = np.sum(a * b, axis=-1)
    return np.min(dot, axis=-1) <= NEG_SAMPLE_JOINT_COS_THRESHOLD


def get_3d_features(abs_kp_offsets, spec, include_extremities=False,
                    include_root_directions=True):
    """(..., E, 3) raw offsets + SkeletonSpec → (..., E, F) decoder target
    features (leading batch dims supported for the vectorized sampler)."""
    norm_kp_offsets = normalize_3d_offsets(abs_kp_offsets)[0]
    feats = [
        norm_kp_offsets,
        (np.arccos(np.clip(spec.parent_cossim(norm_kp_offsets), -1., 1.))
         / np.pi - 0.5)[..., None],
    ]
    if include_root_directions:
        feats.append(normalize_3d_offsets(
            spec.decode_positions(abs_kp_offsets))[0])
    feats = np.concatenate(feats, axis=-1)
    if not include_extremities:
        feats[..., list(spec.extremity_rows), :] = 0
    return feats


def mean_offset_norms(offset_stacks):
    """Mean per-edge offset length over an iterable of (E, 3) stacks.

    Parity with `vipe_dataset/dataset_base.py:14-27` (recorded in the model
    manifest for preview rendering / downstream scaling).
    """
    total = None
    n = 0
    for offsets in offset_stacks:
        lengths = np.linalg.norm(offsets, axis=1)
        total = lengths if total is None else total + lengths
        n += 1
    return total / n
