#!/usr/bin/env python3
"""Extract VIPE* teacher embeddings on the GPU (CLI parity:
`apply_vipe_model.py`).

Same flags as `python -m vpd_tpu.tools.apply_vipe`, plus `--device`
(default cuda; without a GPU it raises unless told `--device cpu`):

    python -m vpd_tpu_torch.tools.apply_vipe <pose_dir> <model_dir> \
        -o <out_dir> [--no_flip] [--allow_many_per_frame] [--invert]
"""

import argparse

from ..infer.apply_vipe import apply_vipe


def get_args():
    parser = argparse.ArgumentParser()
    parser.add_argument('pose_dir')
    parser.add_argument('model_dir')
    parser.add_argument('-o', '--out_dir', type=str, required=True)
    parser.add_argument('-m', '--model_epoch', type=int)
    parser.add_argument('--allow_many_per_frame', action='store_true')
    parser.add_argument('--min_score', type=float, default=0)
    parser.add_argument('--no_flip', action='store_true')
    parser.add_argument('--invert', action='store_true',
                        help='Embed upside-down poses (diving48/fx)')
    parser.add_argument('--device', type=str, default='cuda',
                        help='torch device (default cuda; cpu runs the '
                             'plain PyTorch path)')
    return parser.parse_args()


def main(pose_dir, model_dir, out_dir, model_epoch, allow_many_per_frame,
         min_score, no_flip, invert, device='cuda'):
    apply_vipe(pose_dir, model_dir, out_dir, model_epoch=model_epoch,
               min_score=min_score, no_flip=no_flip, invert=invert,
               allow_many_per_frame=allow_many_per_frame, device=device)
    print('Done!')


if __name__ == '__main__':
    main(**vars(get_args()))
