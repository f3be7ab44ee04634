"""AMASS (SMPL-H body) skeleton family (22 joints).

The port's copy of `vpd_tpu/geometry/amass.py` (numpy only, unchanged
below this note), so that `vpd_tpu_torch` imports nothing of `vpd_tpu`.

Parity with reference `vipe_dataset/amass.py` (offset rows `:100-123`, flip
rows `:81`, extremities `:97`, raw loader `:167-235`; the neck is synthesized
as the collar midpoint).
"""

import numpy as np

from .orientation import canonicalize
from .skeleton import SkeletonSpec

SPEC = SkeletonSpec(
    name='amass',
    joints=(
        'spine1', 'spine2', 'spine3', 'neck', 'head', 'head_top',
        'l_hip', 'l_knee', 'l_ankle', 'l_foot',
        'r_hip', 'r_knee', 'r_ankle', 'r_foot',
        'l_collar', 'l_shoulder', 'l_elbow', 'l_wrist',
        'r_collar', 'r_shoulder', 'r_elbow', 'r_wrist',
    ),
    edges=(
        ('spine2', 'spine1'), ('spine3', 'spine2'), ('neck', 'spine3'),
        ('head', 'neck'), ('head_top', 'head'),
        ('l_hip', 'spine1'), ('l_knee', 'l_hip'),
        ('l_ankle', 'l_knee'), ('l_foot', 'l_ankle'),
        ('r_hip', 'spine1'), ('r_knee', 'r_hip'),
        ('r_ankle', 'r_knee'), ('r_foot', 'r_ankle'),
        ('l_collar', 'neck'), ('l_shoulder', 'l_collar'),
        ('l_elbow', 'l_shoulder'), ('l_wrist', 'l_elbow'),
        ('r_collar', 'neck'), ('r_shoulder', 'r_collar'),
        ('r_elbow', 'r_shoulder'), ('r_wrist', 'r_elbow'),
    ),
    extremity_rows=(4, 8, 12),
    coco_map=(
        ('head_top', 'head'),) * 5 + (  # synthetic nose; no eyes/ears
        ('l_shoulder',), ('r_shoulder',),
        ('l_elbow',), ('r_elbow',),
        ('l_wrist',), ('r_wrist',),
        ('l_hip',), ('r_hip',),
        ('l_knee',), ('r_knee',),
        ('l_ankle',), ('r_ankle',),
    ),
)


def load_raw_skeleton(pose):
    """Raw (>=22, 3) SMPL-H joints → (spine1_raw, theta, (21, 3) offsets)."""
    xyz = np.asarray(pose)[:22, :].astype(np.float32)
    assert xyz.shape == (22, 3)

    spine1_raw = xyz[0, :].copy()
    xyz = xyz - spine1_raw

    xyz, theta = canonicalize(
        xyz, torso_rows=[0, 3, 6, 13, 14, 16, 17],
        left_row=13, right_row=14,
        neck_vec=(xyz[13, :] + xyz[14, :]) / 2 - xyz[0, :])

    raw = {
        'spine1': xyz[0], 'spine2': xyz[3], 'spine3': xyz[6],
        'neck': (xyz[13] + xyz[14]) / 2, 'head': xyz[12], 'head_top': xyz[15],
        'l_hip': xyz[2], 'l_knee': xyz[5], 'l_ankle': xyz[8],
        'l_foot': xyz[11],
        'r_hip': xyz[1], 'r_knee': xyz[4], 'r_ankle': xyz[7],
        'r_foot': xyz[10],
        'l_collar': xyz[14], 'l_shoulder': xyz[17], 'l_elbow': xyz[19],
        'l_wrist': xyz[21],
        'r_collar': xyz[13], 'r_shoulder': xyz[16], 'r_elbow': xyz[18],
        'r_wrist': xyz[20],
    }
    positions = np.stack([raw[j] for j in SPEC.joints])
    return spine1_raw, theta, SPEC.encode_offsets(positions)
