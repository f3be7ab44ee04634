#!/usr/bin/env python3
"""Action recognition / retrieval CLI (counterpart of
`vpd_tpu/tools/recognize.py`; parity: reference `recognize.py`).

    python -m vpd_tpu_torch.tools.recognize <emb_dir> -d fs
    python -m vpd_tpu_torch.tools.recognize <emb_dir> -d fs --algorithm dtw
    python -m vpd_tpu_torch.tools.recognize <emb_dir> -d fs --retrieve \\
        -ne 1 10 25 50

Everything runs on `--device` (default cuda; cpu runs the same code on
the CPU). The default head is a GRU (`--algorithm gru|lstm|cnn`, with
`--attn`, `--hidden_dim`, `--num_epochs`, `-vf`): all trials of a
few-shot size train as one batched model (the fused sweep) unless
`--sequential_sweep`; `-w` loads a saved head (either package's) instead
of training. DTW kNN and retrieval run as one batched sweep (kernel B2 on
cuda, its plain twin on cpu); `--device_knn` and `--device_retrieval` are
accepted for flag parity: the sweep is always on. Under `torchrun
--nproc_per_node N` the fused sweep's trials split over the N GPUs and
rank 0 writes `-o`.
"""

import argparse
import os

from .. import resolve_device
from ..core.io import load_json
from ..core.mesh import distributed, torchrun_world
from ..datasets import diving48, finegym
from ..datasets.metadata_cache import load_video_metadata
from ..datasets.recognition_data import (
    ACTION_DATA_DIR, load_fs_data, load_tennis_data)
from ..tasks.recognize import (
    KNN_MODELS, SEQ_MODELS, run_action_recognition, run_action_retrieval)
from . import paths

DEFAULT_NUM_EPOCHS = 500
DIVING48_FULL_NUM_EPOCHS = 200
DIVING48_LOW_SHOT_NUM_EPOCHS = 500

DATASETS = ['fx', 'diving48', 'diving48v1', 'tennis', 'fs']
_ALWAYS_ON = 'accepted for flag parity: the port always runs the batched ' \
    'DTW sweep on --device'


def get_args():
    parser = argparse.ArgumentParser()
    parser.add_argument('emb_dir', type=str)
    parser.add_argument('-d', '--dataset', type=str, required=True,
                        choices=DATASETS)
    parser.add_argument('-o', '--out_dir', type=str)
    parser.add_argument('--algorithm', type=str, default='gru',
                        choices=KNN_MODELS + SEQ_MODELS)
    parser.add_argument('--retrieve', action='store_true')
    parser.add_argument('-ne', '--num_train_examples', nargs='+', type=int,
                        default=[-1])
    parser.add_argument('-k', type=int, default=1)
    parser.add_argument('--norm', action='store_true')
    parser.add_argument('--target_fps', type=int, default=25)
    parser.add_argument('--hidden_dim', type=int, default=128)
    parser.add_argument('--attn', action='store_true')
    parser.add_argument('--num_epochs', type=int)
    parser.add_argument('-vf', '--val_freq', type=int, default=10)
    parser.add_argument('-nt', '--n_trials', type=int, default=1)
    parser.add_argument('-ntf', '--no_test_flip', action='store_true')
    parser.add_argument('--device_retrieval', action='store_true',
                        help=_ALWAYS_ON)
    parser.add_argument('--device_knn', action='store_true',
                        help=_ALWAYS_ON)
    parser.add_argument('-w', '--load_weights', type=str,
                        help='Load a pretrained head checkpoint')
    parser.add_argument('--fused_sweep', action='store_true',
                        help='accepted for compatibility: the fused '
                             'sweep (all trials of a few-shot size as '
                             'one batched model, sequence heads only) is '
                             'the default; sizes that are not fusable '
                             'fall back to sequential trials '
                             'automatically')
    parser.add_argument('--sequential_sweep', action='store_true',
                        help='train few-shot trials one-by-one (the '
                             'reference-shaped loop; same results as '
                             'the fused sweep)')
    parser.add_argument('--action_dir', type=str,
                        help='override the packaged action_dataset dir '
                             '(labels, val ids, few-shot split files) — '
                             'tennis/fs only; lets synthetic corpora '
                             'drive the full CLI')
    parser.add_argument('--device', type=str, default='cuda',
                        help='torch device (default cuda; cpu runs '
                             'the plain twin of the DTW kernel)')
    return parser.parse_args()


def load_finegym_data(emb_dir, norm, target_fps):
    meta = load_video_metadata('fx', paths.FX_VIDEO_DIR)
    annotations = load_json(finegym.ANNOTATION_FILE)
    categories = finegym.load_categories()
    train_labels = finegym.load_labels(finegym.GYM99_TRAIN_FILE)
    test_labels = finegym.load_labels(finegym.GYM99_VAL_FILE)

    kwargs = {'pre_seconds': 0.25, 'target_fps': target_fps,
              'emb_dir': emb_dir, 'norm': norm}
    train = finegym.load_actions(annotations, train_labels, meta, **kwargs)
    test = finegym.load_actions(annotations, test_labels, meta, **kwargs)
    return (categories, {k: v[1] for k, v in train.items()}, train_labels,
            {k: v[1] for k, v in test.items()}, test_labels)


def load_diving48_data(emb_dir, norm, target_fps, use_v1):
    meta = load_video_metadata('diving48', paths.DIVING48_VIDEO_DIR)
    categories = diving48.load_categories()
    kwargs = {'meta_dict': meta, 'emb_dir': emb_dir, 'norm': norm,
              'target_fps': target_fps}
    train_labels, train = diving48.load_labels_and_embeddings(
        diving48.DIVING48_V1_TRAIN_FILE if use_v1
        else diving48.DIVING48_V2_TRAIN_FILE, **kwargs)
    test_labels, test = diving48.load_labels_and_embeddings(
        diving48.DIVING48_V1_TEST_FILE if use_v1
        else diving48.DIVING48_V2_TEST_FILE, **kwargs)
    return (categories, {k: v[1] for k, v in train.items()}, train_labels,
            {k: v[1] for k, v in test.items()}, test_labels)


def main(emb_dir, dataset, out_dir, algorithm, num_train_examples, norm, k,
         hidden_dim, attn, target_fps, num_epochs, val_freq, n_trials,
         no_test_flip, retrieve, device_retrieval=False,
         device_knn=False, load_weights=None, fused_sweep=False,
         sequential_sweep=False, action_dir=None, device='cuda',
         stats=None):
    """The CLI's work. `stats`, when a dict, receives what
    `run_action_recognition` / `run_action_retrieval` put in theirs.
    Returns their result: {ne: [trial accs]} or (hit@k, prec@k)."""
    del device_retrieval, device_knn  # always the sweep
    del fused_sweep  # fused is the default; flag kept for compat
    if not retrieve and algorithm in SEQ_MODELS and k != 1:
        # fail before minutes of dataset loading
        raise ValueError('sequence heads vote with k = 1, got k = {}'
                         .format(k))
    device = resolve_device(device)  # no GPU: raise before loading data
    val_embs = val_labels = None
    if action_dir is not None:
        assert dataset in ('tennis', 'fs'), \
            '--action_dir only overrides the tennis/fs label layout'
    label_dir = action_dir or ACTION_DATA_DIR
    if dataset.startswith('diving48'):
        (categories, train_embs, train_labels, test_embs,
         test_labels) = load_diving48_data(
            emb_dir, norm, target_fps, use_v1=dataset == 'diving48v1')
        few_shot_file = os.path.join(
            ACTION_DATA_DIR, 'diving48', 'train_{}_{}.ids.txt')
        if num_epochs is None:
            num_epochs = (DIVING48_LOW_SHOT_NUM_EPOCHS
                          if len(num_train_examples) > 1
                          else DIVING48_FULL_NUM_EPOCHS)
    elif dataset == 'fx':
        (categories, train_embs, train_labels, test_embs,
         test_labels) = load_finegym_data(emb_dir, norm, target_fps)
        few_shot_file = os.path.join(
            ACTION_DATA_DIR, 'finegym99', 'train_{}_{}.ids.txt')
        num_epochs = num_epochs or DEFAULT_NUM_EPOCHS
    elif dataset == 'tennis':
        meta = load_video_metadata('tennis', paths.TENNIS_VIDEO_DIR)
        (categories, train_embs, train_labels, val_embs, val_labels,
         test_embs, test_labels, _) = load_tennis_data(
            dataset, emb_dir, norm, meta, action_dir=action_dir)
        few_shot_file = os.path.join(
            label_dir, dataset, 'train_{}_{}.ids.txt')
        num_epochs = num_epochs or DEFAULT_NUM_EPOCHS
    elif dataset == 'fs':
        meta = load_video_metadata('fs', paths.FS_VIDEO_DIR)
        (categories, train_embs, train_labels, val_embs, val_labels,
         test_embs, test_labels, _) = load_fs_data(
            emb_dir, norm, meta, action_dir=action_dir)
        few_shot_file = os.path.join(
            label_dir, 'fs', 'train_{}_{}.ids.txt')
        num_epochs = num_epochs or DEFAULT_NUM_EPOCHS
    else:
        raise NotImplementedError(dataset)

    if retrieve:
        train_embs.update(test_embs)
        train_labels.update(test_labels)
        if val_embs is not None:
            train_embs.update(val_embs)
            train_labels.update(val_labels)
        assert num_train_examples != [-1], \
            'Specify -ne retrieval thresholds, e.g. "-ne 1 10 25 50"'
        return run_action_retrieval(
            train_embs, train_labels, num_train_examples,
            set(test_embs.keys()) if dataset == 'diving48' else None,
            device=device, stats=stats)
    if val_embs is None:
        val_embs, val_labels = test_embs, test_labels
    train_embs = {a: b for a, b in train_embs.items() if b is not None}
    args = (categories, train_embs, train_labels, val_embs, val_labels,
            test_embs, test_labels, out_dir, algorithm, k,
            num_train_examples, few_shot_file, hidden_dim, attn,
            num_epochs, val_freq, n_trials, no_test_flip)
    kwargs = dict(load_weights=load_weights,
                  fused_sweep=not sequential_sweep, stats=stats)
    if sequential_sweep or torchrun_world() == 1:
        return run_action_recognition(*args, device=device, **kwargs)
    # under torchrun the fused sweep's trials split over the ranks
    with distributed(device) as mesh:
        return run_action_recognition(*args, mesh=mesh, **kwargs)


if __name__ == '__main__':
    main(**vars(get_args()))
