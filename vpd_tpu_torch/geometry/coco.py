"""COCO-17 2D skeleton constants and normalization.

Counterpart of `vpd_tpu/geometry/coco.py` (parity with reference
`vipe_dataset/dataset_base.py:84-137`). The numpy single-pose and batch
normalizers (the host samplers' path) are copies of vpd_tpu's.
`normalize_2d_batch_torch` takes the place of vpd_tpu's vmapped jax path:
the same encoding on tensors, which the teacher's embed call runs on the
device before the encoder (`infer/apply_vipe.py`), as vpd_tpu fuses it
into its jit.
"""

import numpy as np
import torch

NUM_COCO_KEYPOINTS_ORIG = 17

# Eyes and ears are dropped from the embedding input.
NUM_COCO_KEYPOINTS = 13
COCO_POINT_IDXS = [0] + list(range(5, 17))

COCO_FLIP_IDXS = [0, 2, 1, 4, 3, 6, 5, 8, 7, 10, 9, 12, 11, 14, 13, 16, 15]
COCO_TORSO_POINTS = [5, 6, 11, 12]  # shoulders + hips

_COCO_BONES_ORIG = [(a - 1, b - 1) for a, b in [
    (16, 14), (14, 12), (17, 15), (15, 13), (12, 13), (6, 12), (7, 13), (6, 7),
    (6, 8), (7, 9), (8, 10), (9, 11), (2, 3), (1, 2), (1, 3), (2, 4), (3, 5),
    (4, 6), (5, 7)]]
COCO_BONES = [x for x in _COCO_BONES_ORIG
              if x[0] in COCO_POINT_IDXS and x[1] in COCO_POINT_IDXS]
NUM_COCO_BONES = len(COCO_BONES)

# The 6 unordered torso pair index arrays (into the torso subset), for a
# vectorized max pairwise distance.
_TP_A, _TP_B = (np.array(idx) for idx in zip(
    *[(i, j) for i in range(len(COCO_TORSO_POINTS))
      for j in range(i + 1, len(COCO_TORSO_POINTS))]))


def pose_input_dim(embed_bones):
    return (NUM_COCO_KEYPOINTS + NUM_COCO_BONES if embed_bones
            else NUM_COCO_KEYPOINTS) * 3


def normalize_2d_skeleton(kp, flip, zero_confs=False,
                          include_bone_features=False):
    """Normalize a (17, 3) [x, y, conf] pose to the embedding input encoding.

    Hip-centered, scaled so the max pairwise torso distance is 0.5, optional
    horizontal flip (index remap + x negation), confidences shifted to
    [-0.5, 0.5], head reduced to the nose, optional bone-difference features.
    Returns (13, 3) or (13 + num_bones, 3) float32.
    """
    kp = np.asarray(kp, dtype=np.float32).copy()

    kp[:, :2] -= (kp[11, :2] + kp[12, :2]) / 2

    torso = kp[COCO_TORSO_POINTS, :2]
    diffs = torso[_TP_A] - torso[_TP_B]
    max_torso_dist = float(np.sqrt((diffs * diffs).sum(-1)).max())
    if max_torso_dist == 0:
        max_torso_dist = 1
    kp[:, :2] *= 0.5 / max_torso_dist

    if flip:
        kp = kp[COCO_FLIP_IDXS, :]
        kp[:, 0] *= -1

    if zero_confs:
        kp[:, 2] = 0
    else:
        kp[:, 2] -= 0.5

    if include_bone_features:
        bones = np.zeros((len(COCO_BONES), 3), dtype=np.float32)
        for i, (a, b) in enumerate(COCO_BONES):
            bones[i, :2] = kp[a, :2] - kp[b, :2]
            bones[i, 2] = (kp[a, 2] + kp[b, 2]) / 2

    kp = kp[COCO_POINT_IDXS, :]
    if include_bone_features:
        kp = np.vstack((kp, bones))
    return kp


_BONE_A = np.array([a for a, _ in COCO_BONES])
_BONE_B = np.array([b for _, b in COCO_BONES])


def normalize_2d_skeleton_batch(kps, flips, zero_confs=False,
                                include_bone_features=False):
    """Batched numpy `normalize_2d_skeleton`: (N, 17, 3) poses + (N,) flip
    flags → (N, 13[+bones], 3) float32 (vectorized host sampler path)."""
    kp = np.array(kps, dtype=np.float32)
    flips = np.asarray(flips, dtype=bool)

    kp[..., :2] -= (kp[:, None, 11, :2] + kp[:, None, 12, :2]) / 2

    torso = kp[:, COCO_TORSO_POINTS, :2]
    diffs = torso[:, _TP_A] - torso[:, _TP_B]
    max_torso_dist = np.sqrt((diffs * diffs).sum(-1)).max(-1)
    max_torso_dist[max_torso_dist == 0] = 1
    kp[..., :2] *= (0.5 / max_torso_dist)[:, None, None]

    flipped = kp[:, COCO_FLIP_IDXS, :].copy()
    flipped[..., 0] *= -1
    kp = np.where(flips[:, None, None], flipped, kp)

    if zero_confs:
        kp[..., 2] = 0
    else:
        kp[..., 2] -= 0.5

    if include_bone_features:
        bone_xy = kp[:, _BONE_A, :2] - kp[:, _BONE_B, :2]
        bone_c = (kp[:, _BONE_A, 2] + kp[:, _BONE_B, 2]) / 2
        bones = np.concatenate([bone_xy, bone_c[..., None]], axis=-1)
        return np.concatenate(
            [kp[:, COCO_POINT_IDXS, :], bones], axis=1).astype(np.float32)
    return np.ascontiguousarray(kp[:, COCO_POINT_IDXS, :])


_INDEX_CACHE = {}


def _index(device, name):
    """A constant index tensor on `device`, made once (no copy a call)."""
    key = (str(device), name)
    if key not in _INDEX_CACHE:
        _INDEX_CACHE[key] = torch.as_tensor(
            _INDEXES[name], dtype=torch.long).to(device)
    return _INDEX_CACHE[key]


_INDEXES = {'torso': COCO_TORSO_POINTS, 'tp_a': _TP_A, 'tp_b': _TP_B,
            'flip': COCO_FLIP_IDXS, 'points': COCO_POINT_IDXS,
            'bone_a': _BONE_A, 'bone_b': _BONE_B}


def normalize_2d_batch_torch(kps, flips, zero_confs=False,
                             include_bone_features=False):
    """`normalize_2d_skeleton_batch` on tensors: (N, 17, 3) poses + (N,)
    bool flip flags on one device -> (N, 13[+bones], 3) float32 there.
    Reads nothing back to the host."""
    dev = kps.device
    kp = kps.to(torch.float32)
    xy = kp[..., :2] - (kp[:, 11:12, :2] + kp[:, 12:13, :2]) / 2

    torso = xy.index_select(1, _index(dev, 'torso'))
    diffs = (torso.index_select(1, _index(dev, 'tp_a'))
             - torso.index_select(1, _index(dev, 'tp_b')))
    max_torso_dist = torch.sqrt((diffs * diffs).sum(-1)).amax(-1)
    max_torso_dist = torch.where(max_torso_dist == 0,
                                 torch.ones_like(max_torso_dist),
                                 max_torso_dist)
    xy = xy * (0.5 / max_torso_dist)[:, None, None]
    kp = torch.cat([xy, kp[..., 2:3]], dim=-1)

    flipped = kp.index_select(1, _index(dev, 'flip'))
    flipped = torch.cat([-flipped[..., :1], flipped[..., 1:]], dim=-1)
    kp = torch.where(flips.to(dev, torch.bool)[:, None, None], flipped, kp)

    conf = (torch.zeros_like(kp[..., 2:]) if zero_confs
            else kp[..., 2:] - 0.5)
    kp = torch.cat([kp[..., :2], conf], dim=-1)

    points = kp.index_select(1, _index(dev, 'points'))
    if not include_bone_features:
        return points
    a = kp.index_select(1, _index(dev, 'bone_a'))
    b = kp.index_select(1, _index(dev, 'bone_b'))
    bones = torch.cat([a[..., :2] - b[..., :2],
                       (a[..., 2:] + b[..., 2:]) / 2], dim=-1)
    return torch.cat([points, bones], dim=1)
