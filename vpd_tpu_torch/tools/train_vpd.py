#!/usr/bin/env python3
"""Train the VPD student on the GPU (CLI parity: `train_vpd_model.py`).

Same flags as `python -m vpd_tpu.tools.train_vpd`, plus `--device`
(default cuda; without a GPU it raises unless told `--device cpu`). Usage:

    python -m vpd_tpu_torch.tools.train_vpd fs --save_dir <dir> \
        --emb_dir <teacher .emb.pkl dir> [--crop_shards <raw shards>] \
        [--flow_img flow] [--motion] [--resume]

Crops are read from `<VPD_SPORTS_DIR>/<dataset>/crops` (PNGs) or from
packed raw shards (`--crop_shards`). Not ported yet, and raising
NotImplementedError: the device crop cache (`--hbm_cache`,
`--hbm_cache_sharded`), decode worker processes (`--num_workers` > 0) and
ImageNet weights (`--pretrained`), all ROADMAP A4 part 3; the penn
ablation and EfficientNet students (A10).
"""

import argparse
import os

from .. import resolve_device
from ..data.crops import (CropBatchSource, PrefetchedSource, scan_emb_dir,
                          train_val_split)
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
    parser.add_argument('--pretrained', action='store_true',
                        help='not ported yet (ROADMAP A4 part 3): needs '
                             'torchvision ImageNet weights')
    parser.add_argument('--init_weights', type=str,
                        help='torchvision ImageNet state_dict for '
                             '--pretrained (not ported yet)')
    parser.add_argument('--no_test_video', action='store_true')
    parser.add_argument('--min_pose_score', type=float)
    parser.add_argument('--emb_dir', type=str)
    parser.add_argument('--penn_dir', type=str,
                        help='penn ablation: not ported yet (ROADMAP A10)')
    parser.add_argument('--penn_frame_dir', type=str,
                        help='penn ablation: not ported yet (ROADMAP A10)')
    parser.add_argument('--seed', type=int, default=0)
    parser.add_argument('--resume', action='store_true',
                        help='continue from the last epoch checkpoint in '
                             '--save_dir; epoch checkpoints carry the '
                             'AdamW moments')
    parser.add_argument('--num_workers', type=int, default=0,
                        help='decode worker processes: not ported yet '
                             '(ROADMAP A4 part 3), must be 0')
    parser.add_argument('--crop_shards', type=str,
                        help='packed raw crop-shard dir; replaces PNG '
                             'decode with a memmap gather')
    parser.add_argument('--augment_val', action='store_true',
                        help='augment validation batches like the '
                             'reference does (vpd_dataset/common.py:'
                             '83-108); default is deterministic val')
    parser.add_argument('--hbm_cache', action='store_true',
                        help='device crop cache: not ported yet (ROADMAP '
                             'A4 part 3)')
    parser.add_argument('--jitter_order', type=str, default='batch',
                        choices=('batch', 'per_sample'),
                        help='colour-jitter op order: one per batch '
                             '(default) or per image (QUIRKS.md)')
    parser.add_argument('--hbm_cache_sharded', action='store_true',
                        help='row-sharded device crop cache: not ported '
                             'yet (ROADMAP A4 part 3)')
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


def _not_ported(dataset, encoder_arch, pretrained, num_workers, hbm_cache,
                hbm_cache_sharded):
    if dataset == 'penn':
        raise NotImplementedError(
            'the penn ablation is not ported yet (ROADMAP A10)')
    if 'effnet' in encoder_arch:
        raise NotImplementedError(
            'EfficientNet students are not ported yet (ROADMAP A10)')
    if pretrained:
        raise NotImplementedError(
            '--pretrained needs torchvision ImageNet weights, which are not '
            'in the repository (ROADMAP A4 part 3)')
    if num_workers:
        raise NotImplementedError(
            '--num_workers > 0 (decode worker processes) is not ported yet '
            '(ROADMAP A4 part 3)')
    if hbm_cache or hbm_cache_sharded:
        raise NotImplementedError(
            'the device crop cache (--hbm_cache, --hbm_cache_sharded) is '
            'not ported yet (ROADMAP A4 part 3)')


def main(dataset, save_dir, checkpoint_frequency, num_epochs, batch_size,
         learning_rate, img_dim, flow_img, motion, encoder_arch,
         model_select_window, pretrained, no_test_video, min_pose_score,
         emb_dir, seed, num_workers=0, init_weights=None,
         crop_shards=None, augment_val=False, hbm_cache=False,
         hbm_cache_sharded=False, penn_dir=None, penn_frame_dir=None,
         resume=False, jitter_order='batch', device='cuda'):
    _not_ported(dataset, encoder_arch, pretrained, num_workers, hbm_cache,
                hbm_cache_sharded)
    device = resolve_device(device)
    if emb_dir is None:
        emb_dir = os.path.join(ROOT_DIRS[dataset], 'embs')
    exclude = get_exclude_prefixes(dataset) if no_test_video else None

    samples, emb_dim = scan_emb_dir(
        emb_dir, embed_time=motion, min_pose_score=min_pose_score,
        exclude_prefixes=exclude, tennis_layout=(dataset == 'tennis'))
    train, val = train_val_split(samples, 0.2, seed=seed)

    crop_dir = CROP_DIRS[dataset]
    src_kwargs = {'flow_img_name': flow_img, 'shard_dir': crop_shards}
    # decode ahead on a thread that also stages each batch on the device
    train_src = PrefetchedSource(CropBatchSource(
        train, crop_dir, img_dim, batch_size, target_len=TRAIN_LEN,
        seed=seed, **src_kwargs), device=device)
    val_src = PrefetchedSource(CropBatchSource(
        val, crop_dir, img_dim, batch_size, target_len=VAL_LEN,
        augment=augment_val, seed=seed + 1, **src_kwargs), device=device)

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
                             seed=seed, device=device)
        start_epoch = 1
        if resume:
            start_epoch = trainer.resume()
            print('Resuming from epoch', start_epoch)
        else:
            trainer.save_config()
        trainer.fit(start_epoch=start_epoch)
    finally:
        train_src.close()
        val_src.close()
    print('Done!')
    return trainer


if __name__ == '__main__':
    main(**vars(get_args()))
