"""Dataset path configuration (parity: `video_dataset_paths.py`,
`vipe_dataset_paths.py`). Override roots with VPD_SPORTS_DIR /
VPD_VIPE_DATA_DIR environment variables. Every sports dataset shares a
pose/videos/crops layout under one root (tennis names its crop dir
'player-crops'); every mocap family ships a 3D-pose pickle + a cocopose
dir under the VIPE data root."""

import os
from os.path import join

SPORTS_ROOT_DIR = os.environ.get('VPD_SPORTS_DIR', 'data/sports')
VIPE_DATA_DIR = os.environ.get('VPD_VIPE_DATA_DIR', 'data/vipe')


def _sport_layout(dirname, crop_dirname='crops'):
    root = join(SPORTS_ROOT_DIR, dirname)
    return (root, join(root, 'pose'), join(root, 'videos'),
            join(root, crop_dirname))


def _mocap_layout(dirname):
    base = join(VIPE_DATA_DIR, dirname)
    return join(base, 'ground_truth_3d_pose.pkl'), join(base, 'cocopose')


FS_ROOT_DIR, FS_POSE_DIR, FS_VIDEO_DIR, FS_CROP_DIR = _sport_layout('fs')
FX_ROOT_DIR, FX_POSE_DIR, FX_VIDEO_DIR, FX_CROP_DIR = _sport_layout('fx')
(DIVING48_ROOT_DIR, DIVING48_POSE_DIR, DIVING48_VIDEO_DIR,
 DIVING48_CROP_DIR) = _sport_layout('diving48')
(TENNIS_ROOT_DIR, TENNIS_POSE_DIR, TENNIS_VIDEO_DIR,
 TENNIS_CROP_DIR) = _sport_layout('tennis', 'player-crops')

# Penn Action full frames (the reference hardcodes an absolute machine
# path, `vpd_dataset/single_frame.py:278`; here it is env-overridable)
PENN_FRAME_DIR = os.environ.get(
    'VPD_PENN_FRAME_DIR', join(SPORTS_ROOT_DIR, 'penn-action', 'frames'))

PEOPLE_3D_3D_POSE_FILE, PEOPLE_3D_KEYPOINT_DIR = _mocap_layout('3dpeople')
HUMAN36M_3D_POSE_FILE, HUMAN36M_KEYPOINT_DIR = _mocap_layout('human3.6m')
NBA2K_3D_POSE_FILE, NBA2K_KEYPOINT_DIR = _mocap_layout('nba2k')
AMASS_3D_POSE_FILE, AMASS_KEYPOINT_DIR = _mocap_layout('amass')
