#!/usr/bin/env python3
"""Train the VPD student on the GPU (CLI parity: `train_vpd_model.py`).

Same flags as `python -m vpd_tpu.tools.train_vpd`, plus `--device`
(default cuda; without a GPU it raises unless told `--device cpu`). Usage:

    python -m vpd_tpu_torch.tools.train_vpd fs --save_dir <dir> \
        --emb_dir <teacher .emb.pkl dir> [--crop_shards <raw shards>] \
        [--flow_img flow] [--motion] [--resume]

Crops are read from `<VPD_SPORTS_DIR>/<dataset>/crops` (PNGs, decoded by
the native decoder where it builds, else cv2 or PIL) or from packed raw
shards (`--crop_shards`, written by `tools/pack_crops`). `--hbm_cache`
stages the shards in device memory once and trains on index batches
gathered there; `--hbm_cache_sharded` splits the cache by rows over the
GPUs (the same as `--hbm_cache` on one). On N GPUs, one process each:

    torchrun --nproc_per_node N -m vpd_tpu_torch.tools.train_vpd fs ...

The global batch is `--batch_size`; each rank decodes its rows of it
(`core/mesh.py`), and rank 0 writes the save dir.
`--num_workers N` decodes in N spawned worker processes (N // 2 for
validation). `--pretrained --init_weights <torchvision .pth>` starts a
ResNet backbone from ImageNet weights; `--encoder_arch effnet0`..`effnet7`
trains an EfficientNet student (from random init). The `penn` ablation
cuts its crops on the fly from Penn Action's full frames:

    python -m vpd_tpu_torch.tools.train_vpd penn --save_dir <dir> \
        --penn_dir <dir of pose_embs.pkl + boxes.json> \
        [--penn_frame_dir <frames>/<seq>/<frame:06d>.jpg]
"""

import argparse
import functools
import os

import numpy as np

from .. import resolve_device
from ..data.crops import (CropBatchSource, PrefetchedSource, scan_emb_dir,
                          train_val_split)
from ..data.hbm_cache import CacheIndexSource, DeviceCropCache
from ..core.mesh import distributed
from ..data.parallel_batcher import MultiprocessBatcher
from ..data.shards import ShardReader
from ..datasets.eval_splits import get_test_prefixes
from ..train.vpd_loop import VPDTrainer, default_config
from . import paths

DATASETS = ['tennis', 'fs', 'fx', 'diving48', 'penn']

CROP_DIRS = {
    'tennis': paths.TENNIS_CROP_DIR,
    'fs': paths.FS_CROP_DIR,
    'fx': paths.FX_CROP_DIR,
    'diving48': paths.DIVING48_CROP_DIR,
}
ROOT_DIRS = {
    'tennis': paths.TENNIS_ROOT_DIR,
    'fs': paths.FS_ROOT_DIR,
    'fx': paths.FX_ROOT_DIR,
    'diving48': paths.DIVING48_ROOT_DIR,
}
# samples per virtual epoch (reference `train_vpd_model.py:205`)
TRAIN_LEN, VAL_LEN = 20000, 4000


def get_args():
    parser = argparse.ArgumentParser()
    parser.add_argument('dataset', type=str, choices=DATASETS)
    parser.add_argument('--save_dir', type=str, required=True)
    parser.add_argument('--checkpoint_frequency', type=int)
    parser.add_argument('--num_epochs', type=int, default=1000)
    parser.add_argument('--batch_size', type=int, default=100)
    parser.add_argument('--learning_rate', type=float, default=0.0005)
    parser.add_argument('--img_dim', type=int, default=128)
    parser.add_argument('--flow_img', type=str)
    parser.add_argument('--motion', action='store_true')
    parser.add_argument('--encoder_arch', type=str, default='resnet34')
    parser.add_argument('--model_select_window', type=int, default=5)
    parser.add_argument('--pretrained', action='store_true')
    parser.add_argument('--init_weights', type=str,
                        help='torchvision ImageNet state_dict (.pth) to '
                             'initialize the backbone from (required with '
                             '--pretrained; reference models/rgb.py:56-66)')
    parser.add_argument('--no_test_video', action='store_true')
    parser.add_argument('--min_pose_score', type=float)
    parser.add_argument('--emb_dir', type=str)
    parser.add_argument('--penn_dir', type=str,
                        help='Penn Action dir holding pose_embs.pkl + '
                             'boxes.json (required for the penn '
                             'ablation, train_vpd_model.py:49)')
    parser.add_argument('--penn_frame_dir', type=str,
                        help='Penn Action full-frame dir (default '
                             'paths.PENN_FRAME_DIR; the reference '
                             'hardcodes this path)')
    parser.add_argument('--seed', type=int, default=0)
    parser.add_argument('--resume', action='store_true',
                        help='continue from the last epoch checkpoint in '
                             '--save_dir; epoch checkpoints carry the '
                             'AdamW moments')
    parser.add_argument('--num_workers', type=int, default=0,
                        help='decode/sample worker processes '
                             '(reference DataLoader num_workers)')
    parser.add_argument('--crop_shards', type=str,
                        help='packed raw crop-shard dir; replaces PNG '
                             'decode with a memmap gather')
    parser.add_argument('--augment_val', action='store_true',
                        help='augment validation batches like the '
                             'reference does (vpd_dataset/common.py:'
                             '83-108); default is deterministic val')
    parser.add_argument('--hbm_cache', action='store_true',
                        help='stage the packed crop shards in device '
                             'memory once and gather batches there '
                             '(requires --crop_shards)')
    parser.add_argument('--jitter_order', type=str, default='batch',
                        choices=('batch', 'per_sample'),
                        help='colour-jitter op order: one per batch '
                             '(default) or per image (QUIRKS.md)')
    parser.add_argument('--hbm_cache_sharded', action='store_true',
                        help='row-shard the device cache over the GPUs '
                             '(torchrun ranks) instead of replicating it; '
                             'on one GPU the same as --hbm_cache')
    parser.add_argument('--device', type=str, default='cuda',
                        help='torch device (default cuda; cpu runs the '
                             'plain PyTorch path)')
    return parser.parse_args()


def get_exclude_prefixes(dataset):
    if dataset in ('tennis', 'fs'):
        return get_test_prefixes(dataset)
    if dataset == 'fx':
        from ..datasets import finegym
        return tuple(l.split('_A_')[0] for l in
                     finegym.load_labels(finegym.GYM99_VAL_FILE))
    if dataset == 'diving48':
        from ..datasets import diving48
        return tuple(diving48.load_labels_and_embeddings(
            diving48.DIVING48_V2_TEST_FILE)[0].keys())
    raise NotImplementedError(dataset)


def make_penn_sources(penn_dir, frame_dir, img_dim, batch_size, *,
                      motion=False, min_pose_score=None, seed=0,
                      batch_part=(0, 1)):
    """Penn Action ablation sources (reference PennDataset.load_default,
    `vpd_dataset/single_frame.py:316-358`): scan, 80/20 split (the
    validation share rounded up, as sklearn's `train_test_split`; each
    half sorted, as the reference's), train augmented and validation
    deterministic. Returns (train, val, emb_dim)."""
    from ..data.penn import PennBatchSource, scan_penn_dir

    scan_kw = {'embed_time': motion}
    if min_pose_score is not None:
        scan_kw['min_pose_score'] = min_pose_score
    samples, emb_dim = scan_penn_dir(penn_dir, **scan_kw)
    order = np.random.default_rng(seed).permutation(len(samples))
    n_val = int(np.ceil(0.2 * len(samples)))
    val = sorted(samples[i] for i in order[:n_val])
    train = sorted(samples[i] for i in order[n_val:])
    return (PennBatchSource(train, frame_dir, img_dim, batch_size,
                            target_len=TRAIN_LEN, seed=seed,
                            batch_part=batch_part),
            PennBatchSource(val, frame_dir, img_dim, batch_size,
                            target_len=VAL_LEN, seed=seed + 1,
                            batch_part=batch_part),
            emb_dim)


def worker_source(samples, img_dir, img_dim, batch_size, target_len, seed,
                  augment, src_kwargs, worker_id):
    """Decode worker `worker_id`'s `CropBatchSource`, seeded seed + 1000 *
    (worker_id + 1) as vpd_tpu seeds its workers. Module-level, so that a
    `functools.partial` of it pickles into spawned workers."""
    return CropBatchSource(samples, img_dir, img_dim, batch_size,
                           target_len=target_len, augment=augment,
                           seed=seed + 1000 * (worker_id + 1), **src_kwargs)


def make_sources(train, val, crop_dir, img_dim, batch_size, seed, *,
                 flow_img=None, crop_shards=None, augment_val=False,
                 hbm_cache=False, hbm_cache_sharded=False, num_workers=0,
                 device=None, mesh=None):
    """(train, val, owned): the batch sources of a run and what the caller
    closes, last first. With the cache: index sources over one
    `DeviceCropCache`; else crop sources (in worker processes with
    `num_workers`) behind a prefetcher that stages batches on `device`.
    On a data `mesh` each source gives this rank's rows of the global
    batches, and the cache is built on the mesh."""
    src_kwargs = {'flow_img_name': flow_img, 'shard_dir': crop_shards}
    if mesh is not None:
        device = mesh.device
        src_kwargs['batch_part'] = mesh.batch_part
    if hbm_cache or hbm_cache_sharded:
        # stage the packed shards on the device once; batches become
        # index gathers there, so no decode workers and no prefetch
        if not crop_shards:
            raise ValueError('--hbm_cache requires --crop_shards')
        if num_workers:
            raise ValueError('--hbm_cache needs no decode workers')
        cache = DeviceCropCache(ShardReader(crop_shards, crop_root=crop_dir),
                                use_flow=flow_img is not None, mesh=mesh,
                                shard_rows=hbm_cache_sharded, device=device)
        return (CacheIndexSource(train, crop_dir, img_dim, batch_size,
                                 target_len=TRAIN_LEN, seed=seed,
                                 cache=cache, **src_kwargs),
                CacheIndexSource(val, crop_dir, img_dim, batch_size,
                                 target_len=VAL_LEN, augment=augment_val,
                                 seed=seed + 1, cache=cache, **src_kwargs),
                [])
    owned = []
    if num_workers > 0:
        train_src = MultiprocessBatcher(
            functools.partial(worker_source, train, crop_dir, img_dim,
                              batch_size, TRAIN_LEN, seed, True, src_kwargs),
            num_workers, max(1, TRAIN_LEN // batch_size))
        owned.append(train_src)
        # augment_val: the reference samples val with flips too
        # (single_frame.py:173 with augment=True)
        val_src = MultiprocessBatcher(
            functools.partial(worker_source, val, crop_dir, img_dim,
                              batch_size, VAL_LEN, seed + 1, augment_val,
                              src_kwargs),
            max(1, num_workers // 2), max(1, VAL_LEN // batch_size))
        owned.append(val_src)
    else:
        train_src = CropBatchSource(train, crop_dir, img_dim, batch_size,
                                    target_len=TRAIN_LEN, seed=seed,
                                    **src_kwargs)
        val_src = CropBatchSource(val, crop_dir, img_dim, batch_size,
                                  target_len=VAL_LEN, augment=augment_val,
                                  seed=seed + 1, **src_kwargs)
    # decode ahead on a thread that also stages each batch on the device
    train_src = PrefetchedSource(train_src, device=device)
    val_src = PrefetchedSource(val_src, device=device)
    return train_src, val_src, owned + [train_src, val_src]


def main(dataset, save_dir, checkpoint_frequency, num_epochs, batch_size,
         learning_rate, img_dim, flow_img, motion, encoder_arch,
         model_select_window, pretrained, no_test_video, min_pose_score,
         emb_dir, seed, num_workers=0, init_weights=None,
         crop_shards=None, augment_val=False, hbm_cache=False,
         hbm_cache_sharded=False, penn_dir=None, penn_frame_dir=None,
         resume=False, jitter_order='batch', device='cuda'):
    if dataset == 'penn':
        # full-frame crops cut on the fly; no crop dir, shards or flow
        # (the reference PennDataset raises NotImplementedError for flow)
        assert penn_dir is not None, 'penn requires --penn_dir'
        assert flow_img is None, 'penn has no optical flow'
        assert not (crop_shards or hbm_cache or hbm_cache_sharded
                    or num_workers or augment_val), \
            'penn supports none of shards/hbm_cache/workers/augment_val'
    resolve_device(device)  # no GPU: raise before loading data
    with distributed(device) as mesh:
        trainer = _train(mesh, dataset, save_dir, checkpoint_frequency,
                         num_epochs, batch_size, learning_rate, img_dim,
                         flow_img, motion, encoder_arch, model_select_window,
                         pretrained, no_test_video, min_pose_score, emb_dir,
                         seed, num_workers, init_weights, crop_shards,
                         augment_val, hbm_cache, hbm_cache_sharded, penn_dir,
                         penn_frame_dir, resume, jitter_order)
    if trainer.primary:
        print('Done!')
    return trainer


def _train(mesh, dataset, save_dir, checkpoint_frequency, num_epochs,
           batch_size, learning_rate, img_dim, flow_img, motion,
           encoder_arch, model_select_window, pretrained, no_test_video,
           min_pose_score, emb_dir, seed, num_workers, init_weights,
           crop_shards, augment_val, hbm_cache, hbm_cache_sharded, penn_dir,
           penn_frame_dir, resume, jitter_order):
    if batch_size % mesh.data_size:
        raise SystemExit('--batch_size {} must be divisible by the {} '
                         'ranks'.format(batch_size, mesh.data_size))
    device = mesh.device
    if dataset == 'penn':
        train_src, val_src, emb_dim = make_penn_sources(
            penn_dir, penn_frame_dir or paths.PENN_FRAME_DIR, img_dim,
            batch_size, motion=motion, min_pose_score=min_pose_score,
            seed=seed, batch_part=mesh.batch_part)
        train_src = PrefetchedSource(train_src, device=device)
        val_src = PrefetchedSource(val_src, device=device)
        owned = [train_src, val_src]
    else:
        if emb_dir is None:
            emb_dir = os.path.join(ROOT_DIRS[dataset], 'embs')
        exclude = get_exclude_prefixes(dataset) if no_test_video else None
        samples, emb_dim = scan_emb_dir(
            emb_dir, embed_time=motion, min_pose_score=min_pose_score,
            exclude_prefixes=exclude, tennis_layout=(dataset == 'tennis'))
        train, val = train_val_split(samples, 0.2, seed=seed)
        train_src, val_src, owned = make_sources(
            train, val, CROP_DIRS[dataset], img_dim, batch_size, seed,
            flow_img=flow_img, crop_shards=crop_shards,
            augment_val=augment_val, hbm_cache=hbm_cache,
            hbm_cache_sharded=hbm_cache_sharded, num_workers=num_workers,
            mesh=mesh)

    config = default_config(
        dataset, emb_dim, num_epochs=num_epochs, batch_size=batch_size,
        learning_rate=learning_rate, img_dim=img_dim,
        use_flow=flow_img is not None, motion=motion,
        encoder_arch=encoder_arch, pretrained=pretrained,
        model_select_window=model_select_window,
        checkpoint_frequency=checkpoint_frequency,
        augment_val=augment_val, jitter_order=jitter_order)
    try:
        trainer = VPDTrainer(train_src, val_src, config, save_dir=save_dir,
                             mesh=mesh, seed=seed,
                             pretrained_weights=init_weights)
        start_epoch = 1
        if resume:
            start_epoch = trainer.resume()
            print('Resuming from epoch', start_epoch)
        else:
            trainer.save_config()
        trainer.fit(start_epoch=start_epoch)
    finally:
        for src in reversed(owned):
            src.close()
    return trainer


if __name__ == '__main__':
    main(**vars(get_args()))
