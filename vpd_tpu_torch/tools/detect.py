#!/usr/bin/env python3
"""Temporal detection CLI (counterpart of `vpd_tpu/tools/detect.py`;
parity: reference `detect.py`).

    python -m vpd_tpu_torch.tools.detect fs_jump --emb_dir <emb_dir> -o out

Trains the KFold proposal ensemble on `--device` (default cuda; cpu runs
the same code on the CPU): all members as one batched model unless
`--sequential_ensemble`. Writes `ap_table.npy` (rows: activation
thresholds, columns: tIoU 0.1..0.9) to `-o`. Under `torchrun
--nproc_per_node N` the fused ensemble's members split over the N GPUs
and rank 0 writes `-o`.
"""

import argparse
import os

import numpy as np

from .. import resolve_device
from ..core.io import load_text
from ..core.mesh import distributed, is_primary, torchrun_world
from ..datasets.load import load_actions, load_embs
from ..datasets.eval_splits import get_test_prefixes
from ..datasets.metadata_cache import load_video_metadata
from ..datasets.recognition_data import ACTION_DATA_DIR
from ..tasks.detect import (DATA_CONFIGS, LOC_TEMPORAL_IOUS, Label,
                            ProposalModel, run_localization)
from . import paths

SEQ_MODELS = ['lstm', 'gru']


def get_args():
    parser = argparse.ArgumentParser()
    parser.add_argument('dataset', choices=list(DATA_CONFIGS.keys()))
    parser.add_argument('-k', type=int, default=1)
    parser.add_argument('-o', '--out_dir', type=str)
    parser.add_argument('--emb_dir', type=str, required=True)
    parser.add_argument('-nt', '--n_trials', type=int, default=1)
    parser.add_argument('--algorithm', type=str, choices=SEQ_MODELS,
                        default='gru')
    parser.add_argument('-ne', '--n_examples', type=int, default=-1)
    parser.add_argument('-tw', '--tennis_window', type=float)
    parser.add_argument('--_all', action='store_true',
                        help='score every embedded video, not just the '
                             'test split (reference detect.py:91)')
    parser.add_argument('--norm', action='store_true')
    parser.add_argument('--hidden_dim', type=int, default=128)
    parser.add_argument('--batch_size', type=int)
    parser.add_argument('--fused_ensemble', action='store_true',
                        help='accepted for compatibility: fused KFold '
                             'training (every member in one batched '
                             'model) is the default')
    parser.add_argument('--sequential_ensemble', action='store_true',
                        help='train KFold ensemble members one-by-one '
                             '(the reference-shaped loop; same results '
                             'as fused)')
    parser.add_argument('--action_dir', type=str,
                        help='override the packaged action_dataset dir '
                             '(labels + localize split files) — '
                             'tennis/fs only; lets synthetic corpora '
                             'drive the full CLI')
    parser.add_argument('--loc_epochs', type=int,
                        help='override the localization training '
                             'schedule (default: the reference\'s '
                             '200-epoch/25-min schedule); sets both '
                             'num_epochs and min_epochs')
    parser.add_argument('--samples_per_epoch', type=int,
                        help='override the per-epoch window-sample '
                             'count (default 5000)')
    parser.add_argument('--seq_len', type=int,
                        help='override the 250-frame training window '
                             '(must be shorter than the videos)')
    parser.add_argument('--device', type=str, default='cuda',
                        help='torch device (default cuda)')
    return parser.parse_args()


def load_tennis_labels(config, action_dir=None):
    action_dir = action_dir or ACTION_DATA_DIR
    meta = load_video_metadata('tennis', paths.TENNIS_VIDEO_DIR)
    meta = {
        (*k.rsplit('_', 2)[:1], int(k.rsplit('_', 2)[1]),
         int(k.rsplit('_', 2)[2]), k): v
        for k, v in meta.items()}
    actions = load_actions(
        os.path.join(action_dir, 'tennis', 'all.txt'))
    test_prefixes = get_test_prefixes('tennis')

    train_labels, test_labels = [], []
    for action, label_name in actions.items():
        if label_name not in config.classes:
            continue
        base_video, player, frame = action.split(':')
        frame = int(frame)
        label = None
        for k, m in meta.items():
            if k[0] == base_video and k[1] <= frame <= k[2]:
                fps = m.fps
                mid = frame - k[1]
                label = Label(
                    '{}__{}'.format(player, k[-1]), 'action',
                    max(0, int(mid - fps * config.window_before)),
                    int(mid + fps * config.window_after), fps)
                break
        if label is None:
            continue
        (test_labels if base_video.startswith(test_prefixes)
         else train_labels).append(label)
    return train_labels, test_labels


def load_fs_labels(config, action_dir=None):
    action_dir = action_dir or ACTION_DATA_DIR
    meta = load_video_metadata('fs', paths.FS_VIDEO_DIR)
    actions = load_actions(os.path.join(action_dir, 'fs', 'all.txt'))
    test_prefixes = get_test_prefixes('fs')

    train_labels, test_labels = [], []
    for action, label_name in actions.items():
        if label_name not in config.classes:
            continue
        video, start_frame, end_frame = action.split(':')
        start_frame, end_frame = int(start_frame), int(end_frame)
        fps = meta[video].fps
        mid = (start_frame + end_frame) / 2
        start_frame = min(start_frame,
                          int(mid - fps * config.window_before))
        end_frame = max(end_frame, int(mid + fps * config.window_after))
        label = Label(video, 'action', start_frame, end_frame, fps)
        (test_labels if video.startswith(test_prefixes)
         else train_labels).append(label)
    return train_labels, test_labels


def load_fx_labels(config, test_frac=0.25, seed=0,
                   annotation_file=None, log=print):
    """Female-FX FineGym events -> frame Labels (reference detect.py:524-571).

    Each event_id=2 (female floor exercise) segment of the FineGym
    annotation becomes one 'action' interval on the recut
    '{video}_{event}' clip. The reference holds out 25% of videos with an
    *unseeded* train_test_split; here the split is seeded for
    reproducibility.
    """
    from ..core.io import load_json
    from ..datasets import finegym

    meta = load_video_metadata('fx', paths.FX_VIDEO_DIR, log=log)
    if annotation_file is None:
        annotation_file = finegym.ANNOTATION_FILE

    all_labels = []
    event_id = 2  # female FX
    annotations = load_json(annotation_file)
    for video, events in annotations.items():
        for event, event_data in events.items():
            if event_data['event'] != event_id:
                continue
            video_name = '{}_{}'.format(video, event)
            if event_data['segments'] is None:
                log('{} has no segments'.format(video_name))
                continue
            if video_name not in meta:
                continue
            for segment_data in event_data['segments'].values():
                assert segment_data['stages'] == 1
                assert len(segment_data['timestamps']) == 1
                start, end = segment_data['timestamps'][0]
                fps = meta[video_name].fps
                all_labels.append(Label(
                    video_name, 'action',
                    int(max(0, fps * (start - config.window_before))),
                    int(fps * (end + config.window_after)), fps))

    videos = sorted(meta.keys())
    rng = np.random.default_rng(seed)
    test_videos = set(rng.choice(
        videos, int(round(len(videos) * test_frac)), replace=False))
    train_labels = [l for l in all_labels if l.video not in test_videos]
    test_labels = [l for l in all_labels if l.video in test_videos]
    return train_labels, test_labels


def main(dataset, k, out_dir, emb_dir, n_trials, algorithm, n_examples,
         tennis_window, norm, hidden_dim, batch_size, _all=False,
         fused_ensemble=False, sequential_ensemble=False,
         action_dir=None, loc_epochs=None, samples_per_epoch=None,
         seq_len=None, device='cuda'):
    """The CLI's work; returns (AP tables per trial, thresholds)."""
    device = resolve_device(device)  # no GPU: raise before loading data
    config = DATA_CONFIGS[dataset]
    if action_dir is not None:
        assert dataset.startswith(('tennis', 'fs')), \
            '--action_dir only overrides the tennis/fs label layout'
    label_dir = action_dir or ACTION_DATA_DIR
    emb_dict = load_embs(emb_dir, norm)

    if dataset.startswith('tennis'):
        if tennis_window is not None:
            config = config._replace(window_before=tennis_window,
                                     window_after=tennis_window)
        train_labels, test_labels = load_tennis_labels(config, action_dir)
        if config.video_name_prefix:
            train_labels = [l for l in train_labels
                            if l.video.startswith(config.video_name_prefix)]
            test_labels = [l for l in test_labels
                           if l.video.startswith(config.video_name_prefix)]
    elif dataset.startswith('fs'):
        train_labels, test_labels = load_fs_labels(config, action_dir)
    else:
        train_labels, test_labels = load_fx_labels(config)

    def few_shot_videos(trial):
        path = os.path.join(
            label_dir, 'fs' if dataset.startswith('fs') else dataset,
            'train.localize.{}.txt'.format(trial))
        return load_text(path)

    del fused_ensemble  # fused is the default now; flag kept for compat
    model_kwargs = {}
    if loc_epochs is not None:
        model_kwargs['num_epochs'] = loc_epochs
        model_kwargs['min_epochs'] = min(
            loc_epochs, ProposalModel.MIN_TRAIN_EPOCHS)
    if samples_per_epoch is not None:
        model_kwargs['samples_per_epoch'] = samples_per_epoch
    if seq_len is not None:
        model_kwargs['seq_len'] = seq_len
    if sequential_ensemble:
        model_kwargs['fused'] = False
    args = (dataset, emb_dict, train_labels, test_labels)
    kwargs = dict(n_trials=n_trials, algorithm=algorithm, k=k,
                  hidden_dim=hidden_dim, batch_size=batch_size,
                  few_shot_videos_fn=few_shot_videos, n_examples=n_examples,
                  _all=_all, **model_kwargs)
    if sequential_ensemble or torchrun_world() == 1:
        trial_results, thresholds = run_localization(
            *args, out_dir=out_dir, device=device, **kwargs)
    else:
        # under torchrun the fused ensemble's members split over the
        # ranks; rank 0 writes
        with distributed(device) as mesh:
            trial_results, thresholds = run_localization(
                *args, out_dir=out_dir if is_primary() else None,
                device=mesh.device, mesh=mesh, **kwargs)
            if not is_primary():
                return trial_results, thresholds

    mean = np.mean(trial_results, axis=0)
    print('AP table (rows=thresholds {}, cols=tIoU {}):'.format(
        [round(t, 2) for t in thresholds],
        [round(t, 1) for t in LOC_TEMPORAL_IOUS]))
    print(np.array_str(mean, precision=3))
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        np.save(os.path.join(out_dir, 'ap_table.npy'), mean)
    return trial_results, thresholds


if __name__ == '__main__':
    main(**vars(get_args()))
