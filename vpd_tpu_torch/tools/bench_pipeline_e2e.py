#!/usr/bin/env python3
"""Whole-pipeline benchmark: every stage from crops to downstream results
chained through the REAL CLI entry points and the on-disk interchange
formats.

Counterpart of `vpd_tpu/tools/bench_pipeline_e2e.py`. Mirrors the
reference README workflow (teacher embeddings -> student distillation ->
feature extraction -> downstream recognition and temporal localization)
on a self-contained synthetic figure-skating corpus, with each stage run
as its own `python -m vpd_tpu_torch.tools.<name>` process from the repo
root — exactly how a user drives the port — and timed wall to wall,
process start included. `--device` is passed on to each stage that runs
on a device (train_vpd, apply_vpd, recognize, detect); they default to
cuda.

Stages:
  0. synthesize corpus (crops + masks + tiny mp4s + teacher .emb.pkl
     + an --action_dir label layout)            [host]
  1. tools.pack_crops        (optional, --shards / --hbm_cache)
  2. tools.train_vpd         student distillation
  3. tools.apply_vpd         embedding extraction -> .emb.pkl
  4. tools.recognize         few-shot action recognition (--action_dir)
  5. tools.detect            temporal localization (--action_dir)

Usage:
    python -m vpd_tpu_torch.tools.bench_pipeline_e2e                # PNG path
    python -m vpd_tpu_torch.tools.bench_pipeline_e2e --shards
"""

import argparse
import json
import os
import pickle
import subprocess
import sys
import tempfile
import time

import numpy as np

FPS = 25.0
FS_CLASSES = ('axel', 'lutz', 'flip', 'loop', 'salchow', 'toe_loop')
# held-out prefix from datasets/eval_splits.FS_TEST_PREFIXES
TEST_PREFIX = 'men_olympic_short_program_2018'
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def get_args():
    p = argparse.ArgumentParser()
    p.add_argument('--work_dir', default=None,
                   help='keep/reuse the corpus + outputs here '
                        '(default: fresh tmp, deleted on success)')
    p.add_argument('--num_train_videos', type=int, default=6)
    p.add_argument('--num_test_videos', type=int, default=2)
    p.add_argument('--frames', type=int, default=256,
                   help='frames (crops) per video')
    p.add_argument('--img_dim', type=int, default=128)
    p.add_argument('--emb_dim', type=int, default=32)
    p.add_argument('--arch', default='resnet34')
    p.add_argument('--num_epochs', type=int, default=3)
    p.add_argument('--batch_size', type=int, default=256)
    p.add_argument('--algorithm', default='dtw',
                   help='recognition head (dtw is the kNN over the DTW '
                        'kernel; gru trains the sequence head on device)')
    p.add_argument('--hidden_dim', type=int, default=32)
    p.add_argument('--n_trials', type=int, default=1)
    p.add_argument('--shards', action='store_true',
                   help='pack crops and train from the memmap shards')
    p.add_argument('--hbm_cache', action='store_true',
                   help='implies --shards; stage shards in device memory')
    p.add_argument('--loc_epochs', type=int,
                   help='shrink the localization training schedule '
                        '(smoke runs); default keeps the reference 200')
    p.add_argument('--samples_per_epoch', type=int,
                   help='shrink the localization per-epoch sample count')
    p.add_argument('--seq_len', type=int,
                   help='shrink the 250-frame localization window '
                        '(required when --frames < 250)')
    p.add_argument('--device', default=None,
                   help="passed on as each device stage's --device "
                        "(default: theirs, cuda)")
    return p.parse_args()


def _write_video_stub(path, num_frames=3, dim=32):
    """Tiny real mp4 so load_video_metadata picks up the corpus fps."""
    import cv2

    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*'mp4v'), FPS,
                         (dim, dim))
    if not vw.isOpened():
        raise RuntimeError('cv2 VideoWriter failed for ' + path)
    frame = np.zeros((dim, dim, 3), np.uint8)
    for _ in range(num_frames):
        vw.write(frame)
    vw.release()


def make_corpus(work, num_train, num_test, frames, img_dim, emb_dim,
                n_trials, log=print):
    """Synthetic fs-layout corpus with a learnable color->class signal,
    byte-equal to vpd_tpu's under the same arguments.

    Each video carries a handful of action windows; inside a window the
    crops take a per-class color tint and the teacher embedding points
    3 sigma along the class axis, so the distilled student embedding is
    linearly separable downstream (the recognition stage discriminates
    rather than coin-flips).
    """
    from .bench_extract_e2e import PngWriter

    rng = np.random.default_rng(0)
    t0 = time.perf_counter()

    sports = os.path.join(work, 'sports')
    crop_root = os.path.join(sports, 'fs', 'crops')
    video_root = os.path.join(sports, 'fs', 'videos')
    teacher_dir = os.path.join(work, 'teacher_embs')
    action_dir = os.path.join(work, 'action_dataset')
    fs_label_dir = os.path.join(action_dir, 'fs')
    for d in (crop_root, video_root, teacher_dir, fs_label_dir):
        os.makedirs(d, exist_ok=True)

    names = ['fs_train_video_{:02d}'.format(i) for i in range(num_train)]
    names += ['{}_v{:02d}'.format(TEST_PREFIX, i) for i in range(num_test)]

    # class tints: distinct hues, strong enough to survive color jitter
    tints = np.stack([np.roll([90.0, 30.0, -60.0], c % 3) * (1 if c < 3
                      else -1) for c in range(len(FS_CLASSES))])

    # persistent mask blob (person silhouette stand-in)
    yy, xx = np.mgrid[0:img_dim, 0:img_dim].astype(np.float32)
    blob = (((yy - img_dim / 2) ** 2 + (xx - img_dim / 2) ** 2)
            < (img_dim * 0.35) ** 2).astype(np.uint8) * 255

    actions = []  # (video, start, end, class_idx)
    with PngWriter(2 * len(names) * frames) as writer:
        for vi, video in enumerate(names):
            vdir = os.path.join(crop_root, video)
            os.makedirs(vdir, exist_ok=True)
            _write_video_stub(os.path.join(video_root, video + '.mp4'))

            # non-overlapping action windows away from the clip edges (the
            # fs window dilation is -2.5s, so keep mid >= 2.5 * fps +
            # slack)
            frame_cls = np.full(frames, -1, np.int64)
            cursor = int(FPS * 2.5) + 12
            while cursor + 40 < frames:
                length = int(rng.integers(20, 32))
                cls = int(rng.integers(len(FS_CLASSES)))
                actions.append((video, cursor, cursor + length, cls))
                frame_cls[cursor:cursor + length] = cls
                cursor += length + int(rng.integers(24, 40))

            rows = []
            for f in range(frames):
                base = (128 + 40 * np.sin(xx / 17 + vi)
                        * np.cos(yy / 23 + f / 7))
                img = base[..., None] + rng.normal(0, 12,
                                                   (img_dim, img_dim, 3))
                emb = rng.normal(0, 0.3, emb_dim)
                if frame_cls[f] >= 0:
                    img = img + tints[frame_cls[f]]
                    emb[frame_cls[f]] += 3.0
                writer.save(os.path.join(vdir, '{}.png'.format(f)),
                            np.clip(img, 0, 255).astype(np.uint8))
                writer.save(os.path.join(vdir, '{}.mask.png'.format(f)),
                            blob)
                rows.append((f, emb.astype(np.float32), {'kp_score': 1.0}))
            with open(os.path.join(teacher_dir, video + '.emb.pkl'),
                      'wb') as fp:
                pickle.dump(rows, fp)

    # ---- action_dataset label layout -------------------------------
    action_ids = ['{}:{}:{}'.format(v, s, e) for v, s, e, _ in actions]
    with open(os.path.join(fs_label_dir, 'all.txt'), 'w') as fp:
        for (v, s, e, c), aid in zip(actions, action_ids):
            fp.write('{} {}\n'.format(aid, FS_CLASSES[c]))

    train_ids = [(aid, c) for (v, _, _, c), aid in zip(actions, action_ids)
                 if not v.startswith(TEST_PREFIX)]
    # every 5th train action becomes validation
    val_ids = [aid for i, (aid, _) in enumerate(train_ids) if i % 5 == 4]
    with open(os.path.join(fs_label_dir, 'val.ids.txt'), 'w') as fp:
        fp.write('\n'.join(val_ids) + '\n')

    # premade few-shot splits (ne=2 per class) + localization splits
    by_cls = {}
    for aid, c in train_ids:
        if aid not in val_ids:
            by_cls.setdefault(c, []).append(aid)
    for trial in range(n_trials):
        trng = np.random.default_rng(100 + trial)
        picks = []
        for c in sorted(by_cls):
            picks.extend(trng.choice(by_cls[c], min(2, len(by_cls[c])),
                                     replace=False))
        with open(os.path.join(fs_label_dir,
                               'train_2_{}.ids.txt'.format(trial)),
                  'w') as fp:
            fp.write('\n'.join(sorted(picks)) + '\n')
        order = [v for v in names if not v.startswith(TEST_PREFIX)]
        trng.shuffle(order)
        with open(os.path.join(fs_label_dir,
                               'train.localize.{}.txt'.format(trial)),
                  'w') as fp:
            fp.write('\n'.join(order) + '\n')

    n_crops = len(names) * frames
    log('corpus: {} crops, {} actions in {:.1f}s'.format(
        n_crops, len(actions), time.perf_counter() - t0))
    return sports, teacher_dir, action_dir, n_crops


def run_stage(name, argv, env_extra, log=print):
    """Run one CLI stage as a subprocess from the repo root; return its
    wall time."""
    env = dict(os.environ, **env_extra)
    log('>> ' + ' '.join(argv))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, '-m'] + argv, env=env,
                          cwd=REPO_ROOT)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError('{} failed (rc={})'.format(name, proc.returncode))
    log('<< {}: {:.1f}s'.format(name, wall))
    return wall


def main():
    args = get_args()
    if args.hbm_cache:
        args.shards = True

    tmp = None
    work = args.work_dir
    if work is None:
        tmp = tempfile.mkdtemp(prefix='vpd_pipeline_')
        work = tmp
    os.makedirs(work, exist_ok=True)

    stages = {}
    t0 = time.perf_counter()
    sports, teacher_dir, action_dir, n_crops = make_corpus(
        work, args.num_train_videos, args.num_test_videos, args.frames,
        args.img_dim, args.emb_dim, args.n_trials)
    stages['corpus_s'] = round(time.perf_counter() - t0, 1)

    env = {'VPD_SPORTS_DIR': sports}
    device = ['--device', args.device] if args.device else []
    crop_dir = os.path.join(sports, 'fs', 'crops')
    student_dir = os.path.join(work, 'student')
    student_embs = os.path.join(work, 'student_embs')
    recog_out = os.path.join(work, 'recognize_out')
    detect_out = os.path.join(work, 'detect_out')

    shard_dir = None
    if args.shards:
        shard_dir = os.path.join(work, 'shards')
        stages['pack_s'] = round(run_stage(
            'pack_crops', ['vpd_tpu_torch.tools.pack_crops',
                           '--img_dir', crop_dir, '--out_dir', shard_dir,
                           '--dim', str(args.img_dim)],
            env), 1)

    train_argv = [
        'vpd_tpu_torch.tools.train_vpd', 'fs', '--save_dir', student_dir,
        '--emb_dir', teacher_dir, '--num_epochs', str(args.num_epochs),
        '--batch_size', str(args.batch_size),
        '--img_dim', str(args.img_dim), '--encoder_arch', args.arch,
        '--checkpoint_frequency', '1']
    if shard_dir:
        train_argv += ['--crop_shards', shard_dir]
    if args.hbm_cache:
        train_argv += ['--hbm_cache']
    stages['train_s'] = round(run_stage('train_vpd', train_argv + device,
                                        env), 1)

    stages['extract_s'] = round(run_stage(
        'apply_vpd',
        ['vpd_tpu_torch.tools.apply_vpd', student_dir, '-d', 'fs',
         '-o', student_embs, '-m', str(args.num_epochs),
         '--batch_size', str(args.batch_size)] + device, env), 1)

    stages['recognize_s'] = round(run_stage(
        'recognize',
        ['vpd_tpu_torch.tools.recognize', student_embs, '-d', 'fs',
         '-o', recog_out, '--algorithm', args.algorithm,
         '--action_dir', action_dir, '-ne', '2', '-1',
         '--n_trials', str(args.n_trials),
         '--hidden_dim', str(args.hidden_dim), '--num_epochs', '50']
        + device, env), 1)

    detect_argv = [
        'vpd_tpu_torch.tools.detect', 'fs_jump', '--emb_dir', student_embs,
        '-o', detect_out, '--action_dir', action_dir,
        '-ne', '-1', '--n_trials', '1',
        '--hidden_dim', str(args.hidden_dim)]
    if args.loc_epochs:
        detect_argv += ['--loc_epochs', str(args.loc_epochs)]
    if args.samples_per_epoch:
        detect_argv += ['--samples_per_epoch', str(args.samples_per_epoch)]
    if args.seq_len:
        detect_argv += ['--seq_len', str(args.seq_len)]
    stages['detect_s'] = round(run_stage('detect', detect_argv + device,
                                         env), 1)

    total = round(time.perf_counter() - t0, 1)

    # downstream evidence: the chain actually discriminated
    summary = {}
    for fn in sorted(os.listdir(recog_out)):
        if fn.endswith('.test_pred.csv'):
            with open(os.path.join(recog_out, fn)) as fp:
                header = fp.readline()
            summary['recognize_' + fn.split('.')[0] + '_acc'] = float(
                header.split('acc=')[1].split(')')[0])
    ap = np.load(os.path.join(detect_out, 'ap_table.npy'))
    if not np.isfinite(ap).all():
        raise RuntimeError('non-finite AP table')
    summary['detect_ap_max'] = round(float(ap.max()), 4)

    from ..core.profiling import device_name
    from .train_vpd import TRAIN_LEN  # train_vpd's samples an epoch

    train_crops = args.num_epochs * TRAIN_LEN
    result = {
        'metric': 'pipeline_e2e_wall_s',
        'value': total,
        'unit': 's',
        'stages': stages,
        'n_crops': n_crops,
        'train_crops_per_sec': round(train_crops / stages['train_s'], 1),
        'extract_crops_per_sec': round(n_crops / stages['extract_s'], 1),
        'mode': ('hbm_cache' if args.hbm_cache
                 else 'shards' if args.shards else 'png'),
        'device': device_name(args.device or 'cuda'),
        **summary,
    }
    print(json.dumps(result))
    if tmp is not None:
        import shutil
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == '__main__':
    main()
