"""Dense optical flow on the card and the quantized flow-PNG interchange.

Counterpart of `vpd_tpu/ops/flow.py`. The flow PNGs are uint8: x and y
clipped to +/-clip and mapped affinely to [0, 255], third channel
constant 128 (`raft/flow.py:80-84`), with optional per-image median
subtraction (`:87-93`). `flow_to_img` and `subtract_median` are numpy
copies; `quantize_flow_device` is the same arithmetic on tensors and
gives the same bytes as vpd_tpu's. The estimator is vpd_tpu's batched
coarse-to-fine Lucas-Kanade: average-pooled pyramids, bilinear warps and
windowed normal equations, all plain tensor ops (vpd_tpu computes it in
XLA and reaches no Pallas kernel). RAFT lives in `models/raft.py`.
"""

import numpy as np
import torch
import torch.nn.functional as F


def flow_to_img(flow, clip=20):
    """(H, W, 2) float flow -> (H, W, 3) uint8 PNG payload (parity)."""
    flow = np.clip(np.asarray(flow), -clip, clip) + clip
    flow = flow * (255 / (2 * clip + 1))
    h, w, _ = flow.shape
    return np.dstack((flow.astype(np.uint8),
                      np.full((h, w, 1), 128, np.uint8)))


def subtract_median(flow):
    """Remove per-image median flow (camera motion), parity :87-93."""
    flow = np.asarray(flow)
    return flow - np.median(flow, axis=(0, 1))


def _median_hw(flow):
    """Per-image, per-channel median over H and W of (B, H, W, C), as
    `jnp.median` computes it: the midpoint (lo + hi) * 0.5 of the two
    middle values (`torch.median` would return the lower one)."""
    b, h, w, c = flow.shape
    n = h * w
    srt = flow.reshape(b, n, c).sort(dim=1).values
    lo = srt[:, (n - 1) // 2]
    hi = srt[:, n // 2]
    return ((lo + hi) * 0.5)[:, None, None, :]


def quantize_flow_device(flow, clip=20, subtract_median=False):
    """(B, H, W, 2) float flow -> (B, H, W, 2) uint8 on its device, the
    arithmetic of `flow_to_img` (less the constant channel), optionally
    after per-image median subtraction. Quantizing before the readback
    cuts it 4x."""
    flow = flow.to(torch.float32)
    if subtract_median:
        flow = flow - _median_hw(flow)
    q = flow.clamp(-clip, clip) + clip
    # truncation toward zero, as numpy's astype(uint8) on [0, 255)
    return (q * (255. / (2 * clip + 1))).to(torch.uint8)


def make_quantized_flow_fn(flow_fn, clip=20, subtract_median=False):
    """(prev_u8, curr_u8) -> (B, H, W, 2) uint8 payloads: a float-flow
    estimator followed by the PNG quantization, without autograd."""

    @torch.inference_mode()
    def fn(prev_u8, curr_u8):
        return quantize_flow_device(flow_fn(prev_u8, curr_u8), clip=clip,
                                    subtract_median=subtract_median)

    return fn


def div255(x):
    """A tensor (uint8 or 0-255 floats) -> float32 / 255, an IEEE division
    on any device (a Python-float divisor becomes a multiply by its
    reciprocal on CUDA)."""
    return x.to(torch.float32) / torch.full((), 255., device=x.device)


def _gray(img):
    """(B, H, W, 3) [0,1] -> (B, H, W) luminance."""
    return (0.299 * img[..., 0] + 0.587 * img[..., 1]
            + 0.114 * img[..., 2])


def _avg_pool2(x):
    b, h, w = x.shape
    return x.reshape(b, h // 2, 2, w // 2, 2).mean(dim=(2, 4))


def _bilinear_warp(img, flow):
    """Sample img (B, H, W) at (x + u, y + v); border-clamped."""
    b, h, w = img.shape
    dev = img.device
    ys = torch.arange(h, dtype=torch.float32, device=dev)[None, :, None] \
        + flow[..., 1]
    xs = torch.arange(w, dtype=torch.float32, device=dev)[None, None, :] \
        + flow[..., 0]
    y0 = torch.floor(ys).to(torch.int64).clamp(0, h - 1)
    x0 = torch.floor(xs).to(torch.int64).clamp(0, w - 1)
    y1 = (y0 + 1).clamp(0, h - 1)
    x1 = (x0 + 1).clamp(0, w - 1)
    wy = (ys - y0).clamp(0., 1.)
    wx = (xs - x0).clamp(0., 1.)
    flat = img.reshape(b, h * w)

    def gather(yy, xx):
        return flat.gather(1, (yy * w + xx).reshape(b, -1)).reshape(b, h, w)

    return (gather(y0, x0) * (1 - wy) * (1 - wx)
            + gather(y0, x1) * (1 - wy) * wx
            + gather(y1, x0) * wy * (1 - wx)
            + gather(y1, x1) * wy * wx)


def _box_blur(x, radius):
    """(B, H, W) box blur: the window sum over in-bounds pixels divided by
    their count ('SAME' windows shrink at the border)."""
    k = 2 * radius + 1
    return F.avg_pool2d(x[:, None], k, stride=1, padding=radius,
                        count_include_pad=False)[:, 0]


def _lk_refine(i1, i2, flow, radius=3, num_iters=3, eps=1e-9):
    """Iterative Lucas-Kanade refinement at one pyramid level."""
    # spatial gradients of i2 (central differences, wrapping as jnp.roll)
    gx = (torch.roll(i2, -1, dims=2) - torch.roll(i2, 1, dims=2)) / 2
    gy = (torch.roll(i2, -1, dims=1) - torch.roll(i2, 1, dims=1)) / 2
    ixx = _box_blur(gx * gx, radius)
    iyy = _box_blur(gy * gy, radius)
    ixy = _box_blur(gx * gy, radius)
    det = ixx * iyy - ixy * ixy + eps
    for _ in range(num_iters):
        warped = _bilinear_warp(i1, -flow)  # i1 sampled back along flow
        it = i2 - warped
        ixt = _box_blur(gx * it, radius)
        iyt = _box_blur(gy * it, radius)
        # solve A d = -b for the incremental flow (b = grad . residual)
        du = -(iyy * ixt - ixy * iyt) / det
        dv = -(ixx * iyt - ixy * ixt) / det
        # clamp per-iteration updates (ill-conditioned flat regions)
        flow = flow + torch.stack([du, dv], dim=-1).clamp(-2., 2.)
    return flow


def lucas_kanade_flow(img1, img2, levels=3, radius=3, num_iters=3):
    """Dense flow img1 -> img2 for uint8 (B, H, W, 3) tensors.

    Returns (B, H, W, 2) float32 on their device. H and W must be
    divisible by 2**(levels-1).
    """
    return _lk_pyramid(_gray(div255(img1)), _gray(div255(img2)),
                       levels, radius, num_iters)


def lucas_kanade_flow_gray(y1_u8, y2_u8, levels=3, radius=3, num_iters=3):
    """`lucas_kanade_flow` fed uint8 (B, H, W) luma planes (the y8 upload
    codec, `data.upload_codec.encode_luma`)."""
    return _lk_pyramid(div255(y1_u8), div255(y2_u8), levels, radius,
                       num_iters)


def _upsample2(flow):
    """(B, h, w, 2) -> (B, 2h, 2w, 2) bilinear with half-pixel centres,
    `jax.image.resize(..., 'bilinear')` at scale 2."""
    up = F.interpolate(flow.permute(0, 3, 1, 2), scale_factor=2,
                       mode='bilinear', align_corners=False)
    return up.permute(0, 2, 3, 1)


@torch.inference_mode()
def _lk_pyramid(i1, i2, levels, radius, num_iters):
    pyr1, pyr2 = [i1], [i2]
    for _ in range(levels - 1):
        pyr1.append(_avg_pool2(pyr1[-1]))
        pyr2.append(_avg_pool2(pyr2[-1]))

    b, h, w = pyr1[-1].shape
    flow = torch.zeros((b, h, w, 2), dtype=torch.float32, device=i1.device)
    for lvl in reversed(range(levels)):
        if lvl < levels - 1:
            flow = 2. * _upsample2(flow)
        flow = _lk_refine(pyr1[lvl], pyr2[lvl], flow, radius=radius,
                          num_iters=num_iters)
    return flow
