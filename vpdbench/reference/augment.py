"""The student's train-time augmentation in plain float32, and a frozen
copy of the order in which the port draws its random values.

What the augmentation computes is the VPD reference's
(github.com/jhong93/vpd, `vpd_dataset/common.py:39-108`,
`single_frame.py:49-88`), as the port states it: colour jitter
(brightness 0.2, contrast 0.2, saturation 0.05, hue 0.05, the four in
one of their 24 orders), normalisation by the sport's channel
statistics, Gaussian noise of variance 0.05 on the person pixels (mask
> 0) of the samples drawn for it, the 2-channel flow decoded as
uint8 / 255 - 0.5, a horizontal flip that negates the x-flow, and a
random resized crop (scale 0.5-1, aspect 0.9-1.1) resampled bilinearly
at pixel centres, clamped at the border. Contrast blends with each
image's mean grey, saturation with each pixel's grey, hue is shifted in
HSV modulo 1.

The random values are drawn as the port draws them, from generators
seeded with the step's seed: the comparison needs the same draws, and
the draw order is the one part of the port's logic copied here. It is
frozen: a change to the port's draws must show as a failed comparison.
"""

import itertools
import math

import torch

BRIGHTNESS, CONTRAST, SATURATION, HUE = 0.2, 0.2, 0.05, 0.05
ORDERS = tuple(itertools.permutations(range(4)))
NOISE_SD = math.sqrt(0.05)
SCALE, RATIO = (0.5, 1.0), (0.9, 1.1)
GREY = (0.299, 0.587, 0.114)
DROPOUT_STREAM = 0x9E3779B97F4A7C15


def fold_in(seed, step):
    """The seed of step `step` of a run whose steps are keyed by `seed`."""
    return (seed << 32) + step


def dropout_seed(seed, step):
    return fold_in(seed, step) ^ DROPOUT_STREAM


def draw(seed, step, b, h, w, device, noise_dtype):
    """Every random value of one step's augmentation of a (b, h, w) batch,
    in the port's order: four factor vectors, the batch's jitter order
    (from a CPU generator), the mask noise and which samples take it, and
    the crop boxes."""
    s = fold_in(seed, step)
    gen = torch.Generator(device=device)
    gen.manual_seed(s)
    host = torch.Generator()
    host.manual_seed(s)

    def uniform(lo, hi):
        return lo + (hi - lo) * torch.rand(b, generator=gen, device=device)

    d = {'fb': uniform(1 - BRIGHTNESS, 1 + BRIGHTNESS),
         'fc': uniform(1 - CONTRAST, 1 + CONTRAST),
         'fs': uniform(1 - SATURATION, 1 + SATURATION),
         'fh': uniform(-HUE, HUE),
         'order': int(torch.randint(len(ORDERS), (), generator=host))}
    d['noise'] = torch.randn((b, h, w, 3), generator=gen, device=device,
                             dtype=noise_dtype).float()
    d['apply_noise'] = torch.rand(b, generator=gen, device=device) <= 0.5
    area = h * w * uniform(*SCALE)
    aspect = torch.exp(uniform(math.log(RATIO[0]), math.log(RATIO[1])))
    d['crop_w'] = torch.sqrt(area * aspect).clamp(1., w)
    d['crop_h'] = torch.sqrt(area / aspect).clamp(1., h)
    d['top'] = uniform(0., 1.) * (h - d['crop_h'])
    d['left'] = uniform(0., 1.) * (w - d['crop_w'])
    return d


def dropout_masks(seed, step, shapes, device):
    """The keep masks of one train step, drawn in the port's order."""
    gen = torch.Generator(device=device)
    gen.manual_seed(dropout_seed(seed, step))
    return [torch.rand(shape, generator=gen, device=device) < keep
            for shape, keep in shapes]


def _grey(x):
    return GREY[0] * x[..., 0] + GREY[1] * x[..., 1] + GREY[2] * x[..., 2]


def _hue_shift(x, shift):
    """Add `shift` (b,) to the hue of (b, h, w, 3) RGB in [0, 1]."""
    r, g, b = x.unbind(-1)
    v, _ = x.max(dim=-1)
    mn, _ = x.min(dim=-1)
    c = v - mn
    s = torch.where(v > 0, c / torch.clamp(v, min=1e-8), 0.)
    cc = torch.clamp(c, min=1e-8)
    hue = torch.where(r == v, (g - b) / cc,
                      torch.where(g == v, 2. + (b - r) / cc,
                                  4. + (r - g) / cc))
    hue = torch.where(c > 0, torch.remainder(hue / 6., 1.), 0.)
    hue = torch.remainder(hue + shift.view(-1, 1, 1), 1.)
    # HSV back to RGB, sector by sector
    sector = torch.floor(hue * 6.)
    f = hue * 6. - sector
    sector = sector.long() % 6
    p = v * (1. - s)
    q = v * (1. - s * f)
    t = v * (1. - s * (1. - f))
    table = torch.stack([torch.stack(c3, -1) for c3 in (
        (v, t, p), (q, v, p), (p, v, t), (p, q, v), (t, p, v), (v, p, q))])
    idx = sector[None, ..., None].expand(1, *sector.shape, 3)
    return table.gather(0, idx)[0]


def jitter(x, d):
    """Colour jitter of (b, h, w, 3) in [0, 1], in the drawn order."""
    def brightness(y):
        return torch.clamp(y * d['fb'].view(-1, 1, 1, 1), 0., 1.)

    def contrast(y):
        m = _grey(y).mean(dim=(1, 2)).view(-1, 1, 1, 1)
        return torch.clamp((y - m) * d['fc'].view(-1, 1, 1, 1) + m, 0., 1.)

    def saturation(y):
        m = _grey(y)[..., None]
        return torch.clamp((y - m) * d['fs'].view(-1, 1, 1, 1) + m, 0., 1.)

    def hue(y):
        return _hue_shift(y, d['fh'])

    ops = (brightness, contrast, saturation, hue)
    for i in ORDERS[d['order']]:
        x = ops[i](x)
    return x


def _axis_weights(start, extent, out, size):
    """Bilinear sampling of `out` pixel centres over [start, start +
    extent) of an axis of `size` pixels: (lower index, upper index, upper
    weight), each (b, out), clamped at the border."""
    pos = (start[:, None] + (torch.arange(out, device=start.device) + 0.5)
           * extent[:, None] / out - 0.5)
    lo = torch.clamp(torch.floor(pos), 0, size - 1)
    hi = torch.clamp(lo + 1, 0, size - 1)
    return lo.long(), hi.long(), torch.clamp(pos - lo, 0., 1.)


def resized_crop(x, d, out):
    """Crop (b, h, w, c) to the drawn boxes and resample to (b, out, out,
    c): rows first, then columns."""
    b, h, w, c = x.shape
    y0, y1, wy = _axis_weights(d['top'], d['crop_h'], out, h)
    x0, x1, wx = _axis_weights(d['left'], d['crop_w'], out, w)

    def rows(idx):
        return x.gather(1, idx[:, :, None, None].expand(b, out, w, c))

    x = rows(y0) * (1 - wy)[:, :, None, None] + rows(y1) * wy[:, :, None,
                                                             None]

    def cols(idx):
        return x.gather(2, idx[:, None, :, None].expand(b, out, out, c))

    return cols(x0) * (1 - wx)[:, None, :, None] + cols(x1) * wx[:, None, :,
                                                                 None]


def augment(rgb, flow, mask, flip, d, mean, std, out):
    """uint8 (b, h, w, 3) rgb, (b, h, w, >=2) flow, (b, h, w) mask and (b,)
    flips -> the (b, out, out, 5) float32 training input."""
    x = jitter(rgb.float() / 255., d)
    x = (x - torch.tensor(mean, device=x.device)) / torch.tensor(
        std, device=x.device)
    noisy = d['apply_noise'].view(-1, 1, 1, 1) & (mask > 0)[..., None]
    x = x + torch.where(noisy, d['noise'] * NOISE_SD, 0.)
    x = torch.cat([x, flow[..., :2].float() / 255. - 0.5], dim=-1)
    mirrored = torch.flip(x, dims=(2,)) * torch.tensor(
        [1., 1., 1., -1., 1.], device=x.device)
    x = torch.where(flip.view(-1, 1, 1, 1), mirrored, x)
    return resized_crop(x, d, out)
