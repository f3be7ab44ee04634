"""Per-sport recognition dataset assembly from dense embedding matrices.

Parity with reference `recognize.py:206-450`: fps-aware action windows cut
from the dense per-frame matrices (tennis: +/-0.5 s around the swing
frame; figure skating: dilate to -2.5/+0.5 s around the jump midpoint),
train/val/test splits by held-out prefixes + premade id files.

Loaders take an injected `video_meta_dict` ({video: obj with .fps}) so
they run against either real videos or the cached metadata pickles
(`data/sports.cache`).

Copied from `vpd_tpu/datasets/recognition_data.py` (this package
imports nothing of `vpd_tpu`).
"""

import os
from collections import defaultdict

from . import DATA_DIR
from .eval_splits import get_test_prefixes
from .load import (load_action_ids, load_actions, load_embs, to_categories)

ACTION_DATA_DIR = os.path.join(DATA_DIR, 'action_dataset')

TENNIS_CLASSES = [
    'forehand_topspin', 'forehand_slice', 'backhand_topspin',
    'backhand_slice', 'forehand_volley', 'backhand_volley', 'overhead']
FS_CLASSES = ['axel', 'lutz', 'flip', 'loop', 'salchow', 'toe_loop']


def action_file(dataset, name):
    return os.path.join(ACTION_DATA_DIR, dataset, name)


def load_tennis_data(dataset, emb_dir, norm, video_meta_dict,
                     window=(0.5, 0.5), action_dir=None, log=print):
    """(categories, train/val/test embs+labels, video_label_intervals)."""
    window_before, window_after = window
    classes = TENNIS_CLASSES
    action_dir = action_dir or ACTION_DATA_DIR

    def parse_emb_video_name(v):
        player, clip_name = v.split('__', 1)
        video_name, start, end = clip_name.rsplit('_', 2)
        return (video_name, player, int(start), int(end), clip_name)

    emb_dict = {parse_emb_video_name(k): v
                for k, v in load_embs(emb_dir, norm, log=log).items()}

    actions = load_actions(os.path.join(action_dir, dataset, 'all.txt'))
    val_action_ids = load_action_ids(
        os.path.join(action_dir, dataset, 'val.ids.txt'))
    test_prefixes = get_test_prefixes(dataset)

    video_label_intervals = defaultdict(list)
    splits = {k: ({}, {}) for k in ('train', 'val', 'test')}
    for action, label in actions.items():
        if label not in classes:
            continue
        label_idx = classes.index(label)
        base_video, player, frame = action.split(':')
        frame = int(frame)

        embs = None
        for v in emb_dict:
            if (v[0] == base_video and v[1] == player
                    and v[2] <= frame <= v[3]):
                fps = video_meta_dict[v[-1]].fps
                mid_frame = frame - v[2]
                start_frame = max(0, int(mid_frame - fps * window_before))
                end_frame = int(mid_frame + fps * window_after)
                video_label_intervals[base_video + '_player'].append(
                    ((start_frame + v[2]) / fps, (end_frame + v[2]) / fps))
                action_embs = emb_dict[v][0][start_frame:end_frame]
                if len(action_embs) > 0:
                    embs = action_embs
                    break

        if base_video.startswith(test_prefixes):
            split = 'test'
        elif action in val_action_ids:
            split = 'val'
        else:
            split = 'train'
        splits[split][0][action] = embs
        splits[split][1][action] = label_idx

    return (to_categories(classes), *splits['train'], *splits['val'],
            *splits['test'], video_label_intervals)


def load_fs_data(emb_dir, norm, video_meta_dict, window=(2.5, 0.5),
                 action_dir=None, log=print):
    window_before, window_after = window
    classes = FS_CLASSES
    action_dir = action_dir or ACTION_DATA_DIR

    emb_dict = load_embs(emb_dir, norm, log=log)
    actions = load_actions(os.path.join(action_dir, 'fs', 'all.txt'))
    val_action_ids = load_action_ids(
        os.path.join(action_dir, 'fs', 'val.ids.txt'))
    test_prefixes = get_test_prefixes('fs')

    video_label_intervals = defaultdict(list)
    splits = {k: ({}, {}) for k in ('train', 'val', 'test')}
    for action, label in actions.items():
        if label not in classes:
            continue
        label_idx = classes.index(label)
        video, start_frame, end_frame = action.split(':')
        start_frame, end_frame = int(start_frame), int(end_frame)
        fps = video_meta_dict[video].fps

        mid_frame = (start_frame + end_frame) / 2
        start_frame = min(start_frame,
                          int(mid_frame - fps * window_before))
        end_frame = max(end_frame, int(mid_frame + fps * window_after))
        embs = emb_dict[video][0][start_frame:end_frame]
        if len(embs) == 0:
            embs = None

        video_label_intervals[video].append(
            (start_frame / fps, end_frame / fps))

        if video.startswith(test_prefixes):
            split = 'test'
        elif action in val_action_ids:
            split = 'val'
        else:
            split = 'train'
        splits[split][0][action] = embs
        splits[split][1][action] = label_idx

    return (to_categories(classes), *splits['train'], *splits['val'],
            *splits['test'], video_label_intervals)
