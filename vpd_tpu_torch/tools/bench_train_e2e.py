#!/usr/bin/env python3
"""Honest end-to-end student TRAINING benchmark.

Counterpart of `vpd_tpu/tools/bench_train_e2e.py`. Measures the real
training loop — batch assembly (PNG decode, packed shard gather, or
device-cache index gather), the upload, and the augment + fwd/bwd +
AdamW step — on a generated corpus, one card. Epoch 1 warms (cuDNN's
algorithm choice, the allocator); later epochs are timed, each ending in
the trainer's one metrics readback, which waits for its steps.
Companion to `bench_extract_e2e`. Usage:

    python -m vpd_tpu_torch.tools.bench_train_e2e                # PNG decode
    python -m vpd_tpu_torch.tools.bench_train_e2e --shards       # memmap gather
    python -m vpd_tpu_torch.tools.bench_train_e2e --hbm_cache    # device gather
"""

import argparse
import json
import os
import tempfile
import time

import numpy as np


def get_args():
    p = argparse.ArgumentParser()
    p.add_argument('--corpus_dir', default=None,
                   help='reuse/keep the PNG corpus here (default: tmp)')
    p.add_argument('--num_videos', type=int, default=4)
    p.add_argument('--num_crops', type=int, default=1024)
    p.add_argument('--img_dim', type=int, default=128)
    p.add_argument('--batch_size', type=int, default=512)
    p.add_argument('--batches_per_epoch', type=int, default=8)
    p.add_argument('--epochs', type=int, default=3,
                   help='epoch 1 warms up; later epochs are timed')
    p.add_argument('--arch', default='resnet34')
    p.add_argument('--emb_dim', type=int, default=32)
    p.add_argument('--shards', action='store_true')
    p.add_argument('--hbm_cache', action='store_true',
                   help='implies --shards')
    p.add_argument('--device', default=None,
                   help='torch device (default: cuda; cpu runs the plain '
                        'PyTorch path)')
    return p.parse_args()


def main():
    args = get_args()
    if args.hbm_cache:
        args.shards = True
    if args.epochs < 2:
        raise SystemExit('--epochs must be >= 2: epoch 1 warms up, later '
                         'epochs are timed')

    from .. import resolve_device
    from ..core.profiling import device_name
    from .bench_extract_e2e import make_corpus

    device = resolve_device(args.device)
    tmp = None
    corpus_dir = args.corpus_dir
    if corpus_dir is None:
        tmp = tempfile.mkdtemp(prefix='vpd_bench_train_')
        corpus_dir = os.path.join(tmp, 'crops')
    sentinel = os.path.join(
        corpus_dir, 'video{:03d}'.format(args.num_videos - 1),
        '{}.png'.format(args.num_crops // args.num_videos - 1))
    if not os.path.exists(sentinel):
        make_corpus(corpus_dir, args.num_videos, args.num_crops,
                    args.img_dim, False, print)

    # synthetic teacher targets, one per crop
    rng = np.random.default_rng(0)
    per_video = args.num_crops // args.num_videos
    samples = [
        ('video{:03d}'.format(v), None, f,
         rng.normal(size=args.emb_dim).astype(np.float32))
        for v in range(args.num_videos) for f in range(per_video)]

    from ..train.vpd_loop import VPDTrainer, default_config

    src_common = dict(target_len=args.batch_size * args.batches_per_epoch,
                      use_mask=False, seed=1)
    # Shards live next to the corpus they were packed from, so a reused
    # --corpus_dir also reuses its shards across runs instead of
    # re-transcoding into a fresh (and leaked) temp dir every time.
    work = args.corpus_dir or tmp
    if args.shards:
        from ..data.shards import ShardReader, pack_crops

        shard_dir = os.path.join(work, 'shards')
        if not os.path.exists(os.path.join(shard_dir, 'shards_meta.json')):
            pack_crops(corpus_dir, shard_dir, args.img_dim,
                       use_mask=False, log=lambda *a: None)
        if args.hbm_cache:
            from ..data.hbm_cache import (CacheIndexSource,
                                          DeviceCropCache)

            reader = ShardReader(shard_dir, crop_root=corpus_dir)
            t0 = time.perf_counter()
            cache = DeviceCropCache(reader, device=device)
            stage_s = time.perf_counter() - t0
            src = CacheIndexSource(samples, corpus_dir, args.img_dim,
                                   args.batch_size, cache=cache,
                                   **src_common)
        else:
            from ..data.crops import CropBatchSource

            stage_s = None
            src = CropBatchSource(samples, corpus_dir, args.img_dim,
                                  args.batch_size, shard_dir=shard_dir,
                                  **src_common)
    else:
        from ..data.crops import CropBatchSource

        stage_s = None
        src = CropBatchSource(samples, corpus_dir, args.img_dim,
                              args.batch_size, **src_common)

    config = default_config('tennis', args.emb_dim,
                            num_epochs=args.epochs,
                            batch_size=args.batch_size,
                            img_dim=args.img_dim,
                            encoder_arch=args.arch)
    trainer = VPDTrainer(src, None, config, device=device)
    trainer.train_one_epoch(1)  # warm up
    best = np.inf
    for epoch in range(2, args.epochs + 1):
        t0 = time.perf_counter()
        trainer.train_one_epoch(epoch)
        best = min(best, (time.perf_counter() - t0)
                   / (src.num_batches * args.batch_size))

    mode = ('hbm_cache' if args.hbm_cache
            else 'shards' if args.shards else 'png')
    result = {
        'metric': 'train_e2e_crops_per_sec_per_chip',
        'value': round(1 / best, 1),
        'unit': 'crops/sec/chip',
        'mode': mode,
        'batch_size': args.batch_size,
        'num_crops': args.num_crops,
        'arch': args.arch,
        'host_cores': os.cpu_count(),
        'device': device_name(device),
    }
    if stage_s is not None:
        result['cache_stage_s'] = round(stage_s, 2)
    print(json.dumps(result))
    if tmp is not None:
        import shutil
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == '__main__':
    main()
