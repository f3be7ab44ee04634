#!/usr/bin/env python3
"""Pack a crop PNG directory into contiguous uint8 shards (a decode-free
cache; see `data/shards.py`). Same flags as `python -m
vpd_tpu.tools.pack_crops`, and the same files:

    python -m vpd_tpu_torch.tools.pack_crops --img_dir <crops> \
        --out_dir <shards> --dim 128 [--flow_img flow] [--no_mask]

The shards feed `tools/train_vpd --crop_shards` (and `--hbm_cache`) and
`apply_vpd`'s shard reader. `--codec yuv420` stores the rgb stream in the
upload codec's packed planes, for `apply_vpd --upload_codec yuv420` only.
"""

import argparse

from ..data.shards import DEFAULT_ROWS_PER_SHARD, pack_crops
from ..data.upload_codec import CODECS


def get_args():
    parser = argparse.ArgumentParser()
    parser.add_argument('--img_dir', type=str, required=True)
    parser.add_argument('--out_dir', type=str, required=True)
    parser.add_argument('--dim', type=int, default=128)
    parser.add_argument('--flow_img', type=str,
                        help='also pack <frame>.<flow_img>.png streams')
    parser.add_argument('--no_mask', action='store_true',
                        help='skip <frame>.mask.png streams')
    parser.add_argument('--rows_per_shard', type=int,
                        default=DEFAULT_ROWS_PER_SHARD)
    parser.add_argument('--codec', default='raw', choices=CODECS,
                        help='rgb stream encoding: yuv420 stores the '
                             'upload codec\'s packed planes (half the '
                             'bytes; extraction with --upload_codec '
                             'yuv420 only)')
    return parser.parse_args()


def main(img_dir, out_dir, dim, flow_img, no_mask, rows_per_shard, codec):
    n = pack_crops(img_dir, out_dir, dim, flow_img_name=flow_img,
                   use_mask=not no_mask, rows_per_shard=rows_per_shard,
                   codec=codec)
    print('Done!')
    return n


if __name__ == '__main__':
    main(**vars(get_args()))
