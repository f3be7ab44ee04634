"""The extraction input in plain float32: what kernel B1 computes.

Each uint8 crop becomes RGB / 255 normalised by the sport's channel
statistics, followed by its flow's first two channels as uint8 / 255 -
0.5 (reference `vpd_dataset/single_frame.py`, `apply_vpd_model.py`);
the flipped variant mirrors the crop along its width and negates the
x-flow. Out come the originals, then the flipped variants, as (2B, 5,
H, W) float32 for the encoder.
"""

import torch


def orig_and_flip(rgb, flow, mean, std):
    """uint8 (B, H, W, 3) and (B, H, W, >=2) -> (2B, 5, H, W) float32."""
    dev = rgb.device
    x = (rgb.float() / 255. - torch.tensor(mean, device=dev)) / torch.tensor(
        std, device=dev)
    x = torch.cat([x, flow[..., :2].float() / 255. - 0.5], dim=-1)
    mirrored = torch.flip(x, dims=(2,)) * torch.tensor(
        [1., 1., 1., -1., 1.], device=dev)
    return torch.cat([x, mirrored]).permute(0, 3, 1, 2)
