"""Human3.6M skeleton family (21 joints kept of 32 raw).

The port's copy of `vpd_tpu/geometry/human36m.py` (numpy only, unchanged
below this note), so that `vpd_tpu_torch` imports nothing of `vpd_tpu`.

Parity with reference `vipe_dataset/human36m.py` (offset row order at
`:101-123`, flip rows `:82`, extremities `:98`, raw loader `:165-237`).
"""

import numpy as np

from .orientation import canonicalize
from .skeleton import SkeletonSpec

SPEC = SkeletonSpec(
    name='human36m',
    joints=(
        'hips', 'spine', 'neck', 'nose', 'head_top',
        'right_up_leg', 'right_leg', 'right_foot', 'right_toe_base',
        'left_up_leg', 'left_leg', 'left_foot', 'left_toe_base',
        'right_arm', 'right_forearm', 'right_hand', 'right_wrist_end',
        'left_arm', 'left_forearm', 'left_hand', 'left_wrist_end',
    ),
    edges=(
        ('spine', 'hips'), ('neck', 'spine'),
        ('nose', 'neck'), ('head_top', 'neck'),
        ('left_arm', 'neck'), ('left_forearm', 'left_arm'),
        ('left_hand', 'left_forearm'), ('left_wrist_end', 'left_hand'),
        ('right_arm', 'neck'), ('right_forearm', 'right_arm'),
        ('right_hand', 'right_forearm'), ('right_wrist_end', 'right_hand'),
        ('left_up_leg', 'hips'), ('left_leg', 'left_up_leg'),
        ('left_foot', 'left_leg'), ('left_toe_base', 'left_foot'),
        ('right_up_leg', 'hips'), ('right_leg', 'right_up_leg'),
        ('right_foot', 'right_leg'), ('right_toe_base', 'right_foot'),
    ),
    extremity_rows=(7, 11, 15, 19),
    # The reference pairs head_top and both arms with the *nose* edge (2)
    # rather than the neck edge (vipe_dataset/human36m.py:90-91).
    pred_overrides=((3, 2), (4, 2), (8, 2)),
    coco_map=(
        ('nose',),) * 5 + (  # no eyes/ears in h36m: all head rows → nose
        ('left_arm',), ('right_arm',),
        ('left_forearm',), ('right_forearm',),
        ('left_hand',), ('right_hand',),
        ('left_up_leg',), ('right_up_leg',),
        ('left_leg',), ('right_leg',),
        ('left_foot',), ('right_foot',),
    ),
)

# Raw CDF joint indices for the kept joints (reference human36m.py:201-212).
_RAW_IDX = {
    'hips': 0, 'right_up_leg': 1, 'right_leg': 2, 'right_foot': 3,
    'right_toe_base': 4, 'left_up_leg': 6, 'left_leg': 7, 'left_foot': 8,
    'left_toe_base': 9, 'spine': 12, 'neck': 13, 'nose': 14, 'head_top': 15,
    'left_arm': 17, 'left_forearm': 18, 'left_hand': 19, 'left_wrist_end': 22,
    'right_arm': 25, 'right_forearm': 26, 'right_hand': 27,
    'right_wrist_end': 30,
}


def load_raw_skeleton(pose):
    """Raw 96-float Human3.6M pose → (hips_raw, theta, (20, 3) offsets)."""
    xyz = np.array(pose).reshape((-1, 3)).astype(np.float32) / 100
    assert xyz.shape == (32, 3)

    hips_raw = xyz[0, :].copy()
    xyz = xyz - hips_raw

    xyz, theta = canonicalize(
        xyz, torso_rows=[0, 11, 12, 13, 17, 25],
        left_row=17, right_row=25,  # left arm x right arm
        neck_vec=xyz[13, :] - xyz[0, :])

    positions = np.stack([xyz[_RAW_IDX[j]] for j in SPEC.joints])
    return hips_raw, theta, SPEC.encode_offsets(positions)
