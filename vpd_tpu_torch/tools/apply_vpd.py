#!/usr/bin/env python3
"""Extract VPD student embeddings on the GPU (CLI parity: `apply_vpd_model.py`).

Same flags as `python -m vpd_tpu.tools.apply_vpd`, plus `--device`, minus
`--preprocess`: the port has one preprocess, the CUDA kernel on the GPU
(its plain twin on the CPU). Usage:

    python -m vpd_tpu_torch.tools.apply_vpd <model_dir> -d fs -o <out_dir>
        [--crop_shards <shards>] [--upload_codec yuv420]
"""

import argparse

from ..data.upload_codec import CODECS
from ..infer.apply_vpd import apply_vpd, scan_crop_dir, scan_tennis_crop_dir
from . import paths

DATASETS = ['tennis', 'fs', 'fx', 'diving48']


def get_args():
    parser = argparse.ArgumentParser(
        description='Extract VPD student embeddings. There is no '
                    '--preprocess flag: the preprocess is always the '
                    'fused CUDA kernel on the GPU (its plain PyTorch twin '
                    'with --device cpu).')
    parser.add_argument('model_dir', type=str)
    parser.add_argument('-d', '--dataset', type=str, required=True,
                        choices=DATASETS)
    parser.add_argument('-o', '--out_dir', type=str, required=True)
    parser.add_argument('-m', '--model_epoch', type=int)
    parser.add_argument('--jitter', type=int, default=0,
                        help='colour-jitter variants per crop (and per '
                             'flip); built by the plain transforms')
    parser.add_argument('--no_flip', action='store_true')
    parser.add_argument('--flow_img', type=str)
    parser.add_argument('--batch_size', type=int, default=512)
    parser.add_argument('--crop_shards', type=str,
                        help='packed raw crop-shard dir (vpd_tpu '
                             'tools/pack_crops); replaces PNG decode with '
                             'a memmap gather')
    parser.add_argument('--upload_codec', type=str, default='raw',
                        choices=CODECS,
                        help='host->device crop encoding: yuv420 packs '
                             'RGB to half the bytes (lossy chroma) and '
                             'decodes it on the device; required for '
                             'shards packed with --codec yuv420')
    parser.add_argument('--data_parallel', action='store_true',
                        help='multi-GPU fan-out: not ported yet '
                             '(ROADMAP A11)')
    parser.add_argument('--device', type=str, default='cuda',
                        help='torch device (default cuda; cpu runs the '
                             'plain PyTorch path)')
    return parser.parse_args()


def main(model_dir, dataset, out_dir, model_epoch, jitter, no_flip,
         flow_img, batch_size, crop_shards=None, upload_codec='raw',
         data_parallel=False, device='cuda'):
    if data_parallel:
        raise NotImplementedError(
            '--data_parallel is not ported yet (ROADMAP A11)')
    if dataset == 'tennis':
        crop_dir = paths.TENNIS_CROP_DIR
        videos, tasks = scan_tennis_crop_dir(
            paths.TENNIS_VIDEO_DIR, crop_dir)
    else:
        crop_dir = {'fs': paths.FS_CROP_DIR, 'fx': paths.FX_CROP_DIR,
                    'diving48': paths.DIVING48_CROP_DIR}[dataset]
        videos, tasks = scan_crop_dir(crop_dir)

    # reference batch scaling (`apply_vpd_model.py:145-149`): divide the
    # base batch by the jitter variants and double it when flips are off,
    # which keeps device memory constant as the variant count changes
    batch_size = batch_size // (jitter + 1)
    if no_flip:
        batch_size *= 2

    shard_reader = None
    if crop_shards:
        from ..data.shards import ShardReader
        shard_reader = ShardReader(crop_shards, crop_root=crop_dir)

    apply_vpd(videos, tasks, model_dir, out_dir, model_epoch=model_epoch,
              flow_img_name=flow_img, jitter=jitter, no_flip=no_flip,
              batch_size=batch_size, shard_reader=shard_reader,
              upload_codec=None if upload_codec == 'raw' else upload_codec,
              device=device)
    print('Done!')


if __name__ == '__main__':
    main(**vars(get_args()))
