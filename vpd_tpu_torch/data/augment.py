"""Eval-time image transforms for the VPD student (NHWC tensors).

Counterpart of `vpd_tpu/data/augment.py:35-53,253-260,319-332`: the
per-sport channel statistics and the deterministic extraction transforms.
These plain tensor functions are also the reference twin of the CUDA
preprocess kernel (`ops/preprocess.py`). Training augmentation (colour
jitter, mask noise, random resized crop) is not ported yet (ROADMAP A4).
"""

import torch

# Per-sport channel statistics (reference vpd_dataset/common.py:14-36).
RGB_MEAN_STD = {
    'tennis': (
        (0.44157383614877077, 0.47029633580897046, 0.4534017568516162),
        (0.13526736314774856, 0.1208027074415591, 0.1261687563723076)),
    'fs': (
        (0.5747710337842444, 0.5644043210903272, 0.6334494151377134),
        (0.21349823115367886, 0.21827191146692457, 0.20393919008463163)),
    'fx': (
        (0.38402001736617936, 0.34764328219285123, 0.4099846773620623),
        (0.19505844565544309, 0.18984186888162677, 0.1989230425908947)),
    'diving48': (
        (0.3411329922282787, 0.46349889258964044, 0.5162481674015696),
        (0.16302619019820488, 0.17092395707914718, 0.19266662199338647)),
    'penn': (
        (0.43258389316320306, 0.4293850246457961, 0.383481774195889),
        (0.18936336742486998, 0.18502009571154798, 0.18244625387985822)),
    'resnet': ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225)),
}


def normalize_rgb(rgb01, mean, std):
    return ((rgb01 - torch.tensor(mean, dtype=rgb01.dtype,
                                  device=rgb01.device))
            / torch.tensor(std, dtype=rgb01.dtype, device=rgb01.device))


def decode_flow(flow_u8, dtype=torch.float32):
    """(..., H, W, >=2) uint8 flow PNG -> 2ch float in [-0.5, 0.5]."""
    return flow_u8[..., :2].to(dtype) / 255. - 0.5


def eval_transform_batch(rgb_u8, mean, std, flow_u8=None):
    """Deterministic extraction path: normalize (+flow concat), float32."""
    x = normalize_rgb(rgb_u8.to(torch.float32) / 255., mean, std)
    if flow_u8 is not None:
        x = torch.cat([x, decode_flow(flow_u8)], dim=-1)
    return x


def flip_batch(x, has_flow):
    """Horizontal flip with x-flow negation (extraction flip variants)."""
    x = torch.flip(x, dims=(2,))
    if has_flow:
        x = torch.cat([x[..., :3], -x[..., 3:4], x[..., 4:]], dim=-1)
    return x
