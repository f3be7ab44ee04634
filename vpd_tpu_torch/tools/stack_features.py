#!/usr/bin/env python3
"""Concatenate two embedding dirs per frame (e.g. VIPE (+) 2D).

Counterpart of `vpd_tpu/tools/stack_features.py`, with its flags and
byte-equal `.emb.pkl` files (same positional dirs, optional -o out dir,
min-of-scores meta): the per-video merge is one stacked concatenate over
the whole video; the two embedding sets are first checked frame-aligned.
Host only (numpy). Usage:

    python -m vpd_tpu_torch.tools.stack_features <emb_dir1> <emb_dir2>
        -o <out_dir>
"""

import argparse
import os

import numpy as np

from ..core.io import load_pickle, store_pickle
from ..data.crops import get_pose_score


def get_args():
    parser = argparse.ArgumentParser()
    parser.add_argument('emb_dir1', type=str)
    parser.add_argument('emb_dir2', type=str)
    parser.add_argument('-o', '--out_dir', type=str)
    return parser.parse_args()


def stack_video_embs(rows1, rows2, name=''):
    """Merge two aligned [(frame, vec, meta)] lists for one video.

    Vectors concatenate on their LAST axis — which reproduces the
    reference's axis=0-if-1D-else-1 rule for both the (D,) and the
    (variants, D) layouts. The surviving meta dict is the first input's
    (mutated in place, like the reference), with `kp_score` replaced by
    the elementwise min of both sides' pose scores.
    """
    assert len(rows1) == len(rows2)
    if not rows1:
        return []
    frames1 = [frame for frame, _, _ in rows1]
    frames2 = [frame for frame, _, _ in rows2]
    for f1, f2 in zip(frames1, frames2):
        assert f1 == f2, 'Frame mismatch: {} != {} - {}'.format(f1, f2, name)

    stacked = np.concatenate(
        [np.stack([vec for _, vec, _ in rows1]),
         np.stack([vec for _, vec, _ in rows2])], axis=-1)
    merged = []
    for (frame, _, meta), (_, _, meta2), vec in zip(rows1, rows2, stacked):
        meta['kp_score'] = min(get_pose_score(meta, 0.5),
                               get_pose_score(meta2, 0.5))
        merged.append((frame, vec, meta))
    return merged


def main(emb_dir1, emb_dir2, out_dir):
    if out_dir is not None:
        os.makedirs(out_dir, exist_ok=True)

    for emb_file in sorted(os.listdir(emb_dir1)):
        merged = stack_video_embs(
            load_pickle(os.path.join(emb_dir1, emb_file)),
            load_pickle(os.path.join(emb_dir2, emb_file)),
            name=emb_file)
        if out_dir is not None:
            store_pickle(os.path.join(out_dir, emb_file), merged)
    print('Done!')


if __name__ == '__main__':
    main(**vars(get_args()))
