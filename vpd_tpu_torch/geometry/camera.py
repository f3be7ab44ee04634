"""Synthetic orthographic camera projection for pose augmentation.

The port's copy of `vpd_tpu/geometry/camera.py` (numpy only, unchanged
below this note), so that `vpd_tpu_torch` imports nothing of `vpd_tpu`.

Parity with reference `vipe_dataset/keypoint.py:22-78`: random yaw, bounded
elevation/roll, random confidences, orthographic x/z projection with z
inverted into pixel coordinates. Operates on the (17, 3) COCO positions
produced by `SkeletonSpec.project_coco`. Explicit `numpy.random.Generator`
threading keeps the host sampler reproducible per worker/seed.
"""

import numpy as np

CAMERA_AUG_ELEVATION_RANGE = (-np.pi / 6, np.pi / 6)
CAMERA_AUG_ROLL_RANGE = (-np.pi / 6, np.pi / 6)


def random_project_coco(coco_xyz, rng,
                        elevation=CAMERA_AUG_ELEVATION_RANGE,
                        roll=CAMERA_AUG_ROLL_RANGE):
    """(17, 3) COCO 3D positions → (17, 3) [x, y, conf] synthetic 2D pose."""
    coco_xyz = np.asarray(coco_xyz)

    a = rng.uniform(-np.pi, np.pi)
    cos_a, sin_a = np.cos(a), np.sin(a)
    rot_z_t = np.array([
        [cos_a, sin_a, 0],
        [-sin_a, cos_a, 0],
        [0, 0, 1]])
    coco_xyz = coco_xyz.dot(rot_z_t)

    if elevation is not None:
        b = rng.uniform(*elevation)
        cos_b, sin_b = np.cos(b), np.sin(b)
        rot_x_t = np.array([
            [1, 0, 0],
            [0, cos_b, sin_b],
            [0, -sin_b, cos_b]])
        coco_xyz = coco_xyz.dot(rot_x_t)

    if roll is not None:
        c = rng.uniform(*roll)
        cos_c, sin_c = np.cos(c), np.sin(c)
        rot_y_t = np.array([
            [cos_c, 0, sin_c],
            [0, 1, 0],
            [-sin_c, 0, cos_c]])
        coco_xyz = coco_xyz.dot(rot_y_t)

    conf = rng.uniform(0.5, 1, size=17)
    conf[1:5] = 0  # eyes/ears never observed in synthetic views

    coco_xzc = np.hstack((coco_xyz[:, [0, 2]], conf[:, None]))
    coco_xzc[:, 1] *= -1  # invert z into pixel coordinates
    assert coco_xzc.shape == (17, 3)
    return coco_xzc


def random_project_offsets(spec, offsets, rng, **kwargs):
    """Decode (E, 3) offsets with `spec` and project to a synthetic view."""
    return random_project_coco(spec.project_coco(offsets), rng, **kwargs)


def random_project_coco_batch(coco_xyz, rng,
                              elevation=CAMERA_AUG_ELEVATION_RANGE,
                              roll=CAMERA_AUG_ROLL_RANGE):
    """Batched `random_project_coco`: (N, 17, 3) → (N, 17, 3), one
    independent random camera per row (vectorized host sampler)."""
    coco_xyz = np.asarray(coco_xyz)
    n = coco_xyz.shape[0]

    a = rng.uniform(-np.pi, np.pi, size=n)
    zeros, ones = np.zeros(n), np.ones(n)
    cos_a, sin_a = np.cos(a), np.sin(a)
    # transposed rotations, matching the single-pose x.dot(R^T) convention
    rot_t = np.stack([
        np.stack([cos_a, sin_a, zeros], -1),
        np.stack([-sin_a, cos_a, zeros], -1),
        np.stack([zeros, zeros, ones], -1)], axis=-2)

    if elevation is not None:
        b = rng.uniform(*elevation, size=n)
        cos_b, sin_b = np.cos(b), np.sin(b)
        rot_x_t = np.stack([
            np.stack([ones, zeros, zeros], -1),
            np.stack([zeros, cos_b, sin_b], -1),
            np.stack([zeros, -sin_b, cos_b], -1)], axis=-2)
        rot_t = rot_t @ rot_x_t

    if roll is not None:
        c = rng.uniform(*roll, size=n)
        cos_c, sin_c = np.cos(c), np.sin(c)
        rot_y_t = np.stack([
            np.stack([cos_c, zeros, sin_c], -1),
            np.stack([zeros, ones, zeros], -1),
            np.stack([-sin_c, zeros, cos_c], -1)], axis=-2)
        rot_t = rot_t @ rot_y_t

    xyz = coco_xyz @ rot_t

    conf = rng.uniform(0.5, 1, size=(n, 17))
    conf[:, 1:5] = 0  # eyes/ears never observed in synthetic views

    out = np.stack([xyz[..., 0], -xyz[..., 2], conf], axis=-1)
    return out


def random_project_offsets_batch(spec, offsets, rng, **kwargs):
    """Batched `random_project_offsets`: (N, E, 3) → (N, 17, 3)."""
    return random_project_coco_batch(spec.project_coco(offsets), rng,
                                     **kwargs)
