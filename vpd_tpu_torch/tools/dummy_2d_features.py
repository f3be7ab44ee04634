#!/usr/bin/env python3
"""2D-VPD baseline teacher: normalized 2D keypoints as the "embedding".

Counterpart of `vpd_tpu/tools/dummy_2d_features.py`, with its flags and
byte-equal `.emb.pkl` files (the teacher-free way to exercise the whole
student + downstream stack): each video's poses normalize as ONE batched
call (`normalize_2d_skeleton_batch`) for the forward and flipped
variants; rows are then zipped back into the `.emb.pkl` interchange
format. Host only (numpy). Usage:

    python -m vpd_tpu_torch.tools.dummy_2d_features <pose_dir> -o <out_dir>
        [--no_flip]
"""

import argparse
import os

import numpy as np

from ..core.io import load_gz_json, store_pickle
from ..geometry.coco import normalize_2d_skeleton_batch
from ..infer.apply_vipe import iter_pose_videos


def get_args():
    parser = argparse.ArgumentParser()
    parser.add_argument('pose_dir', type=str)
    parser.add_argument('-o', '--out_dir', type=str)
    parser.add_argument('--no_flip', action='store_true')
    return parser.parse_args()


def video_dummy_embs(pose_rows, no_flip):
    """[(frame, pose_data)] -> [(frame, emb, meta)] for one video.

    emb is the flattened xy of the normalized top pose — (26,) raw, or
    (2, 26) stacked [orig, flip] unless no_flip. kp_score averages the
    13 kept joints' confidences (the normalizer shifts confs by -0.5,
    so +0.5 recovers them).
    """
    if not pose_rows:
        return []
    frames = [frame for frame, _ in pose_rows]
    raw = np.array([rows[0][-1] for _, rows in pose_rows], np.float32)
    n = len(raw)

    fwd = normalize_2d_skeleton_batch(raw, np.zeros(n, bool))
    scores = np.mean(fwd[:, :, 2] + 0.5, axis=1)
    embs = fwd[:, :, :2].reshape(n, -1)
    if not no_flip:
        rev = normalize_2d_skeleton_batch(raw, np.ones(n, bool))
        embs = np.stack([embs, rev[:, :, :2].reshape(n, -1)], axis=1)

    return [(frame, emb, {'is_2d': True, 'kp_score': float(s)})
            for frame, emb, s in zip(frames, embs, scores)]


def main(pose_dir, out_dir, no_flip):
    for video_name, pose_path in iter_pose_videos(pose_dir):
        embs = video_dummy_embs(list(load_gz_json(pose_path)), no_flip)
        if out_dir is not None:
            os.makedirs(out_dir, exist_ok=True)
            store_pickle(
                os.path.join(out_dir, video_name + '.emb.pkl'), embs)
    print('Done!')


if __name__ == '__main__':
    main(**vars(get_args()))
