"""NBA2K skeleton family (25 joints kept of 35 raw; fingers dropped).

The port's copy of `vpd_tpu/geometry/nba2k.py` (numpy only, unchanged
below this note), so that `vpd_tpu_torch` imports nothing of `vpd_tpu`.

Parity with reference `vipe_dataset/nba2k.py` (offset rows `:129-155`, flip
rows `:105`, extremities `:126`, raw loader `:199-269`, which also reorders
the raw axes ``xyz = pose[:, [2, 0, 1]]``).
"""

import numpy as np

from .orientation import canonicalize
from .skeleton import SkeletonSpec

SPEC = SkeletonSpec(
    name='nba2k',
    joints=(
        'hips', 'rhip', 'rknee', 'rankle', 'lhip', 'lknee', 'lankle',
        'spine', 'neck', 'head',
        'lshoulder', 'lelbow', 'lwrist',
        'rshoulder', 'relbow', 'rwrist',
        'rtoe', 'rheel', 'reye', 'rear',
        'ltoe', 'lheel', 'leye', 'lear', 'nose',
    ),
    edges=(
        ('rhip', 'hips'), ('rknee', 'rhip'), ('rankle', 'rknee'),
        ('lhip', 'hips'), ('lknee', 'lhip'), ('lankle', 'lknee'),
        ('spine', 'hips'), ('neck', 'spine'), ('head', 'neck'),
        ('lshoulder', 'neck'), ('lelbow', 'lshoulder'), ('lwrist', 'lelbow'),
        ('rshoulder', 'neck'), ('relbow', 'rshoulder'), ('rwrist', 'relbow'),
        ('rtoe', 'rankle'), ('rheel', 'rankle'),
        ('reye', 'head'), ('rear', 'reye'),
        ('ltoe', 'lankle'), ('lheel', 'lankle'),
        ('leye', 'head'), ('lear', 'leye'),
        ('nose', 'head'),
    ),
    extremity_rows=tuple(range(15, 24)),
    coco_map=(
        ('nose',), ('leye',), ('reye',), ('lear',), ('rear',),
        ('lshoulder',), ('rshoulder',),
        ('lelbow',), ('relbow',),
        ('lwrist',), ('rwrist',),
        ('lhip',), ('rhip',),
        ('lknee',), ('rknee',),
        ('lankle',), ('rankle',),
    ),
)

_RAW_IDX = {
    'hips': 0, 'rhip': 1, 'rknee': 2, 'rankle': 3, 'lhip': 4, 'lknee': 5,
    'lankle': 6, 'spine': 7, 'neck': 8, 'head': 9,
    'lshoulder': 10, 'lelbow': 11, 'lwrist': 12,
    'rshoulder': 13, 'relbow': 14, 'rwrist': 15,
    'rtoe': 21, 'rheel': 22, 'reye': 23, 'rear': 24,
    'ltoe': 30, 'lheel': 31, 'leye': 32, 'lear': 33, 'nose': 34,
}


def load_raw_skeleton(pose):
    """Raw (35, 3) NBA2K pose → (hips_raw, theta, (24, 3) offsets)."""
    xyz = np.asarray(pose)[:, [2, 0, 1]]
    assert xyz.shape == (35, 3)

    hips_raw = xyz[0, :].copy()
    xyz = xyz - hips_raw

    xyz, theta = canonicalize(
        xyz, torso_rows=[0, 1, 4, 7, 8, 10, 13],
        left_row=10, right_row=13,
        neck_vec=xyz[8, :] - xyz[0, :])

    positions = np.stack([xyz[_RAW_IDX[j]] for j in SPEC.joints])
    return hips_raw, theta, SPEC.encode_offsets(positions)
