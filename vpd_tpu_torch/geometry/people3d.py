"""3DPeople skeleton family (25 joints kept of 67 raw).

The port's copy of `vpd_tpu/geometry/people3d.py` (numpy only, unchanged
below this note), so that `vpd_tpu_torch` imports nothing of `vpd_tpu`.

Parity with reference `vipe_dataset/people3d.py` (offset rows `:141-167`,
flip rows `:121`, extremities `:138`, raw loader `:213-285`; the source
schema's side labels for eyes and legs are flipped, which the kept-joint
index map below accounts for, mirroring the reference).
"""

import numpy as np

from .orientation import canonicalize
from .skeleton import SkeletonSpec

SPEC = SkeletonSpec(
    name='3dpeople',
    joints=(
        'hips', 'spine', 'spine1', 'spine2', 'neck', 'head', 'head_top',
        'right_eye', 'left_eye',
        'left_shoulder', 'left_arm', 'left_forearm', 'left_hand',
        'right_shoulder', 'right_arm', 'right_forearm', 'right_hand',
        'left_up_leg', 'left_leg', 'left_foot', 'left_toe_base',
        'right_up_leg', 'right_leg', 'right_foot', 'right_toe_base',
    ),
    edges=(
        ('spine', 'hips'), ('spine1', 'spine'), ('spine2', 'spine1'),
        ('neck', 'spine2'), ('head', 'neck'), ('head_top', 'head'),
        ('right_eye', 'head'), ('left_eye', 'head'),
        ('left_shoulder', 'neck'), ('left_arm', 'left_shoulder'),
        ('left_forearm', 'left_arm'), ('left_hand', 'left_forearm'),
        ('right_shoulder', 'neck'), ('right_arm', 'right_shoulder'),
        ('right_forearm', 'right_arm'), ('right_hand', 'right_forearm'),
        ('left_up_leg', 'hips'), ('left_leg', 'left_up_leg'),
        ('left_foot', 'left_leg'), ('left_toe_base', 'left_foot'),
        ('right_up_leg', 'hips'), ('right_leg', 'right_up_leg'),
        ('right_foot', 'right_leg'), ('right_toe_base', 'right_foot'),
    ),
    extremity_rows=(5, 6, 7, 19, 23),
    coco_map=(
        ('head', 'left_eye', 'right_eye'),
        ('left_eye',), ('right_eye',),
        ('left_eye',), ('right_eye',),  # no ears in 3dpeople
        ('left_arm',), ('right_arm',),
        ('left_forearm',), ('right_forearm',),
        ('left_hand',), ('right_hand',),
        ('left_up_leg',), ('right_up_leg',),
        ('left_leg',), ('right_leg',),
        ('left_foot',), ('right_foot',),
    ),
)

# 1-based raw schema rows for the kept joints (reference people3d.py:250-261;
# eye and leg side labels in the raw schema are swapped).
_RAW_IDX_1BASED = {
    'hips': 1, 'spine': 2, 'spine1': 3, 'spine2': 4, 'neck': 5, 'head': 6,
    'head_top': 9, 'left_eye': 8, 'right_eye': 7,
    'left_shoulder': 10, 'left_arm': 11, 'left_forearm': 12, 'left_hand': 13,
    'right_shoulder': 34, 'right_arm': 35, 'right_forearm': 36,
    'right_hand': 37,
    'left_up_leg': 58, 'left_leg': 59, 'left_foot': 60, 'left_toe_base': 61,
    'right_up_leg': 63, 'right_leg': 64, 'right_foot': 65,
    'right_toe_base': 66,
}


def load_raw_skeleton(fpath):
    """3DPeople per-frame txt (67 x [u v d x y z]) → (hips, theta, offsets)."""
    uvdxyz = np.loadtxt(fpath)
    assert uvdxyz.shape == (67, 6)

    xyz = uvdxyz[:, 3:]
    hips_raw = xyz[0, :].copy()
    xyz = xyz - hips_raw

    xyz, theta = canonicalize(
        xyz, torso_rows=[0, 1, 2, 3, 9, 33],
        left_row=9, right_row=33,
        neck_vec=xyz[4, :] - xyz[0, :])

    positions = np.stack(
        [xyz[_RAW_IDX_1BASED[j] - 1] for j in SPEC.joints])
    return hips_raw, theta, SPEC.encode_offsets(positions)
