#!/usr/bin/env python3
"""Mocap -> canonical (root, theta, offsets) pickle.

Counterpart of `vpd_tpu/tools/preprocess_3d_pose.py`, with its flags and
byte-equal pickles: walks each dataset's raw layout and re-encodes every
frame with the family's raw loader (`geometry/`). Host only (numpy;
Human3.6M also needs `cdflib`, imported only for that dataset). Usage:

    python -m vpd_tpu_torch.tools.preprocess_3d_pose <data_dir>
        {3dpeople,human36m,nba2k,amass} -o <out.pkl> [-v [-vf 25]]
"""

import argparse
import os

import numpy as np

from ..core.io import load_pickle, store_pickle
from ..geometry import amass, human36m, nba2k, people3d

DATASETS = ['3dpeople', 'human36m', 'nba2k', 'amass']


def get_args():
    parser = argparse.ArgumentParser()
    parser.add_argument('data_dir')
    parser.add_argument('dataset', choices=DATASETS)
    parser.add_argument('-o', '--out_file', type=str)
    parser.add_argument('-v', '--visualize', action='store_true',
                        help='preview every Nth canonical skeleton '
                             '(front + side projections); windows when '
                             'a display exists, PNGs under '
                             '<out_file>.viz/ otherwise')
    parser.add_argument('-vf', '--visualize_frequency', type=int,
                        default=25)
    return parser.parse_args()


def make_viz(visualize, frequency, out_file, spec):
    """Per-frame preview hook (reference `preprocess_3d_pose.py:26-27` +
    the cv2.imshow calls inside each raw loader, e.g. nba2k.py:227-230).
    Decodes the canonical parent-relative offsets back to joint
    POSITIONS (`spec.decode_positions`) and renders them front-on (x, z)
    and side-on (y, z) like the reference's 'canonical'/'canonical_side'
    windows; headless hosts get PNGs under `<out_file>.viz/`."""
    if not visualize:
        return lambda skel: None
    from ..geometry.render import render_points
    from ..utils.display import imshow_or_save

    state = {'i': 0}
    viz_dir = (out_file or 'pose3d') + '.viz'

    def viz(skel):
        i, state['i'] = state['i'], state['i'] + 1
        if i % frequency:
            return
        _, _, offsets = skel
        pos = spec.decode_positions(offsets)  # (J-1, 3) joint positions
        for name, (a, b) in [('front', (0, 2)), ('side', (1, 2))]:
            img = render_points(pos[:, a], pos[:, b])
            imshow_or_save(name, img[..., ::-1], os.path.join(
                viz_dir, '{:06d}.{}.png'.format(i, name)))

    return viz


def process_3dpeople(data_dir, viz=lambda s: None):
    result = {}
    for person in sorted(os.listdir(data_dir)):
        person_dir = os.path.join(data_dir, person)
        for action in sorted(os.listdir(person_dir)):
            action_cam_dir = os.path.join(person_dir, action, 'camera01')
            frames = os.listdir(action_cam_dir)
            frame_pose3d = [None] * len(frames)
            for frame in frames:
                frame_no = int(os.path.splitext(frame)[0])
                skel = people3d.load_raw_skeleton(
                    os.path.join(action_cam_dir, frame))
                viz(skel)
                frame_pose3d[frame_no - 1] = skel
            result[(person, action)] = frame_pose3d
    return result


def process_human36m(data_dir, viz=lambda s: None):
    import cdflib  # optional dep; only needed for this dataset

    result = {}
    for person in os.listdir(data_dir):
        pose_dir = os.path.join(data_dir, person, 'MyPoseFeatures',
                                'D3_Positions')
        for action_file in os.listdir(pose_dir):
            action = os.path.splitext(action_file)[0]
            cdf_data = cdflib.CDF(os.path.join(pose_dir, action_file))
            raw_poses = cdf_data.varget('Pose').squeeze()
            cdf_data.close()
            skels = [human36m.load_raw_skeleton(raw_poses[j, :])
                     for j in range(raw_poses.shape[0])]
            for s in skels:
                viz(s)
            result[(person, action)] = skels
    return result


def process_nba2k(data_dir, viz=lambda s: None):
    result = {}
    for person in os.listdir(data_dir):
        pose_data = load_pickle(os.path.join(
            data_dir, person, 'release_{}_2ku.pkl'.format(person)))
        frames = sorted(os.listdir(
            os.path.join(data_dir, person, 'images', '2ku')))
        j3d = pose_data['j3d']
        assert len(frames) == len(j3d)
        skels = [nba2k.load_raw_skeleton(j) for j in j3d]
        for s in skels:
            viz(s)
        result[(person,)] = skels
    return result


def process_amass(data_dir, viz=lambda s: None):
    result = {}
    for seq in sorted(os.listdir(data_dir)):
        pose_file = os.path.join(data_dir, seq, 'pose.npy')
        if not os.path.isfile(pose_file):
            continue
        pose_arr = np.load(pose_file)
        frames = sorted({
            f.split('_')[0] for f in os.listdir(os.path.join(data_dir, seq))
            if f.endswith(('jpg', 'png'))})
        assert len(frames) == pose_arr.shape[0], seq
        dataset, action = seq.split('_', 1)
        skels = [amass.load_raw_skeleton(pose_arr[j])
                 for j in range(pose_arr.shape[0])]
        for s in skels:
            viz(s)
        result[(dataset, action)] = skels
    return result


PROCESSORS = {
    '3dpeople': process_3dpeople,
    'human36m': process_human36m,
    'nba2k': process_nba2k,
    'amass': process_amass,
}


SPECS = {'3dpeople': people3d.SPEC, 'human36m': human36m.SPEC,
         'nba2k': nba2k.SPEC, 'amass': amass.SPEC}


def main(data_dir, dataset, out_file, visualize=False,
         visualize_frequency=25):
    viz = make_viz(visualize, visualize_frequency, out_file,
                   SPECS[dataset])
    pose3d = PROCESSORS[dataset](data_dir, viz)
    if out_file is not None:
        store_pickle(out_file, pose3d)
    print('Done!')


if __name__ == '__main__':
    main(**vars(get_args()))
