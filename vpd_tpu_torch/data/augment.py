"""Image transforms for the VPD student (NHWC tensors).

Counterpart of `vpd_tpu/data/augment.py`: the per-sport channel
statistics, the deterministic extraction transforms (also the reference
twin of the CUDA preprocess kernel, `ops/preprocess.py`) and the training
augmentation (reference `vpd_dataset/common.py:39-108`,
`single_frame.py:49-88`): colour jitter, normalize, mask noise, flow
concat, flip with x-flow negation, RandomResizedCrop.

Randomness is drawn apart from its use. `sample_train_augment` draws every
random value of a batch from explicit generators; `train_augment_batch`
is a deterministic function of the uint8 batch and those draws. So a test
can feed vpd_tpu's draws to the port (JAX's threefry and torch's Philox
never give the same stream) and hold the two equal.

The formulas are vpd_tpu's, not torchvision's: its own HSV round trip;
contrast blends with each image's mean grey, saturation with each pixel's
grey, hue is added mod 1; the 24 op orders in `itertools.permutations`
order; Gaussian noise on person pixels (mask > 0); RandomResizedCrop with
separable bilinear weights at pixel centres, clamped at the border. In
`dtype` bf16 every step runs in bf16 as vpd_tpu's does: constants are
rounded to the dtype before use, as JAX's weakly typed Python floats are.
"""

import itertools
import math

import torch

JITTER = {'brightness': 0.2, 'contrast': 0.2,
          'saturation': 0.05, 'hue': 0.05}
JITTER_ORDERS = tuple(itertools.permutations(range(4)))
RANDOM_NOISE_SD = 0.05 ** 0.5  # sqrt(0.05), single_frame.py:21
CROP_SCALE = (0.5, 1.0)
CROP_RATIO = (0.9, 1.1)

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


def _c(value, dtype):
    """`value` rounded to `dtype`, as a Python float (JAX rounds a weakly
    typed Python float to the array's dtype before the operation)."""
    return float(torch.tensor(value, dtype=dtype))


def normalize_rgb(rgb01, mean, std):
    """(x - mean) / std; `mean` and `std` are sequences, or tensors of
    `rgb01`'s dtype on its device (no host-to-device copy per call)."""
    kw = {'dtype': rgb01.dtype, 'device': rgb01.device}
    return ((rgb01 - torch.as_tensor(mean, **kw))
            / torch.as_tensor(std, **kw))


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


# ------------------------------------------------------------ colour jitter

def _rgb_to_hsv(rgb):
    dt = rgb.dtype
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    maxc = torch.maximum(torch.maximum(r, g), b)
    minc = torch.minimum(torch.minimum(r, g), b)
    v = maxc
    delta = maxc - minc
    tiny = _c(1e-8, dt)
    s = torch.where(maxc > 0, delta / maxc.clamp_min(tiny), 0.)
    safe = delta.clamp_min(tiny)
    rc = (maxc - r) / safe
    gc = (maxc - g) / safe
    bc = (maxc - b) / safe
    h = torch.where(r == maxc, bc - gc,
                    torch.where(g == maxc, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.where(delta > 0, (h / 6.0) % 1.0, 0.)
    return h, s, v


def _hsv_to_rgb(h, s, v):
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = i.to(torch.int32) % 6

    def pick(options):
        out = options[5]
        for sector in range(5):
            out = torch.where(i == sector, options[sector], out)
        return out

    return torch.stack([pick([v, q, p, p, t, v]), pick([t, v, v, q, p, p]),
                        pick([p, p, t, v, v, q])], dim=-1)


def sample_color_jitter(gen, host_gen, b, per_sample_order=False,
                        brightness=JITTER['brightness'],
                        contrast=JITTER['contrast'],
                        saturation=JITTER['saturation'], hue=JITTER['hue']):
    """Draws of `batch_color_jitter` for `b` images: factors `fb`, `fc`,
    `fs`, `fh`, each (b,) float32 on `gen`'s device, and the op order:
    `perms` (b, 4) on the device when the order is per sample, else
    `order`, an index into JITTER_ORDERS drawn from the CPU generator
    `host_gen`, so that the step dispatches the batch's order without
    reading the device (vpd_tpu switches on it inside its program)."""
    dev = gen.device

    def uniform(lo, hi):
        return lo + (hi - lo) * torch.rand(b, generator=gen, device=dev)

    draws = {'fb': uniform(1 - brightness, 1 + brightness),
             'fc': uniform(1 - contrast, 1 + contrast),
             'fs': uniform(1 - saturation, 1 + saturation),
             'fh': uniform(-hue, hue)}
    if per_sample_order:
        draws['perms'] = torch.rand(b, 4, generator=gen,
                                    device=dev).argsort(dim=1)
    else:
        draws['order'] = int(torch.randint(len(JITTER_ORDERS), (),
                                           generator=host_gen))
    return draws


def batch_color_jitter(rgb, draws, order=None):
    """Jitter a (B, H, W, 3) batch in [0, 1] in its own dtype.

    `draws` as `sample_color_jitter` gives them. The ops brightness,
    contrast, saturation, hue (0-3) run in the order JITTER_ORDERS
    [draws['order']] for the whole batch, or per sample along
    draws['perms'] (each step computes the four ops and selects one per
    sample, as vpd_tpu does). `order` forces a tuple of ops (testing).
    """
    dt = rgb.dtype
    fb, fc, fs = (draws[k].to(dt).view(-1, 1, 1, 1)
                  for k in ('fb', 'fc', 'fs'))
    fh = draws['fh'].to(dt).view(-1, 1, 1)
    wr, wg, wb = _c(0.299, dt), _c(0.587, dt), _c(0.114, dt)

    def gray_px(x):
        return wr * x[..., 0] + wg * x[..., 1] + wb * x[..., 2]

    def op_brightness(x):
        return torch.clamp(x * fb, 0., 1.)

    def op_contrast(x):  # blend with the per-image mean grey
        g = gray_px(x).mean(dim=(1, 2), keepdim=True)[..., None]
        return torch.clamp((x - g) * fc + g, 0., 1.)

    def op_saturation(x):  # blend with the per-pixel grey
        g = gray_px(x)[..., None]
        return torch.clamp((x - g) * fs + g, 0., 1.)

    def op_hue(x):
        h, s, v = _rgb_to_hsv(x)
        return _hsv_to_rgb((h + fh) % 1.0, s, v)

    ops = (op_brightness, op_contrast, op_saturation, op_hue)
    if order is None and 'perms' in draws:
        x = rgb
        for step in range(4):
            sel = draws['perms'][:, step].view(-1, 1, 1, 1)
            cand = [op(x) for op in ops]
            x = torch.where(sel == 0, cand[0],
                            torch.where(sel == 1, cand[1],
                                        torch.where(sel == 2, cand[2],
                                                    cand[3])))
        return x
    if order is None:
        order = JITTER_ORDERS[draws['order']]
    x = rgb
    for i in order:
        x = ops[i](x)
    return x


# ---------------------------------------------------- random resized crop

def _interp_matrix(coords, size):
    """(..., out) float32 source coordinates -> (..., out, size) bilinear
    weight rows: (1 - w) at floor(coord) and w at floor(coord) + 1,
    clamped at the border (a clamped pair collapses onto one index)."""
    i = torch.arange(size, device=coords.device)
    c0 = torch.floor(coords).to(torch.int32).clamp(0, size - 1)
    c1 = (c0 + 1).clamp(0, size - 1)
    w = (coords - c0).clamp(0., 1.)
    m0 = (i == c0[..., None]) * (1. - w)[..., None]
    m1 = (i == c1[..., None]) * w[..., None]
    return m0 + m1


def bilinear_resample(img, top, left, crop_h, crop_w, out_h, out_w):
    """Crop (top, left, crop_h, crop_w), each (B,) float32, from (B, H, W,
    C) and resize bilinearly to (B, out_h, out_w, C): out = Wy @ img @
    Wx^T per sample, two batched products in `img`'s dtype."""
    b, h, w, c = img.shape
    ar_h = torch.arange(out_h, device=img.device, dtype=torch.float32)
    ar_w = torch.arange(out_w, device=img.device, dtype=torch.float32)
    ys = top[:, None] + (ar_h + 0.5) * crop_h[:, None] / out_h - 0.5
    xs = left[:, None] + (ar_w + 0.5) * crop_w[:, None] / out_w - 0.5
    wy = _interp_matrix(ys, h).to(img.dtype)  # (B, out_h, H)
    wx = _interp_matrix(xs, w).to(img.dtype)  # (B, out_w, W)
    tmp = torch.bmm(wy, img.reshape(b, h, w * c))  # (B, out_h, W*C)
    tmp = tmp.view(b, out_h, w, c).transpose(1, 2).reshape(b, w, out_h * c)
    out = torch.bmm(wx, tmp)  # (B, out_w, out_h*C)
    return out.view(b, out_w, out_h, c).transpose(1, 2).contiguous()


def sample_crop(gen, b, h, w, scale=CROP_SCALE, ratio=CROP_RATIO):
    """RandomResizedCrop boxes (torchvision's scale and log-uniform
    ratio, common.py:49-50, vpd_tpu's clamps): (top, left, crop_h,
    crop_w), each (b,) float32 on `gen`'s device."""
    dev = gen.device

    def uniform(lo, hi):
        return lo + (hi - lo) * torch.rand(b, generator=gen, device=dev)

    area = h * w * uniform(*scale)
    aspect = torch.exp(uniform(math.log(ratio[0]), math.log(ratio[1])))
    crop_w = torch.sqrt(area * aspect).clamp(1., w)
    crop_h = torch.sqrt(area / aspect).clamp(1., h)
    top = uniform(0., 1.) * (h - crop_h)
    left = uniform(0., 1.) * (w - crop_w)
    return top, left, crop_h, crop_w


# ------------------------------------------------------ the whole augment

def sample_train_augment(gen, host_gen, b, h, w, *, jitter=True,
                         per_sample_order=False, mask=True, flip=False,
                         noise_dtype=torch.float32, mask_noise_prob=0.5):
    """Every random value `train_augment_batch` needs for a (b, h, w)
    batch, drawn from `gen` (on the batch's device) and `host_gen` (a CPU
    generator, for the batch's jitter order only):

      jitter    fb, fc, fs, fh (b,); order (int) or perms (b, 4)
      mask      noise (b, h, w, 3) N(0, 1) in `noise_dtype`; apply_noise
                (b,) bool, True with probability `mask_noise_prob`
      crop      top, left, crop_h, crop_w (b,) float32
      flip      (b,) bool, when `flip` is set (the sources give flips)
    """
    dev = gen.device
    draws = (sample_color_jitter(gen, host_gen, b, per_sample_order)
             if jitter else {})
    if mask:
        draws['noise'] = torch.randn((b, h, w, 3), generator=gen, device=dev,
                                     dtype=noise_dtype)
        draws['apply_noise'] = torch.rand(b, generator=gen,
                                          device=dev) <= mask_noise_prob
    draws.update(zip(('top', 'left', 'crop_h', 'crop_w'),
                     sample_crop(gen, b, h, w)))
    if flip:
        draws['flip'] = torch.rand(b, generator=gen, device=dev) < 0.5
    return draws


def add_mask_noise(x, mask_u8, noise, apply_noise):
    """x + noise * sqrt(0.05) on the person pixels (mask > 0) of the
    samples whose `apply_noise` is set (the reference's FIXME direction,
    QUIRKS.md)."""
    noise = noise.to(x.dtype) * _c(RANDOM_NOISE_SD, x.dtype)
    where = apply_noise.view(-1, 1, 1, 1) & (mask_u8 > 0)[..., None]
    return x + torch.where(where, noise, 0.)


def flip_samples(x, flip, has_flow):
    """Mirror the samples whose `flip` is set along W, negating the x-flow
    (channel 3) of those samples."""
    return torch.where(flip.view(-1, 1, 1, 1), flip_batch(x, has_flow), x)


def train_augment_batch(rgb_u8, draws, mean, std, flow_u8=None,
                        mask_u8=None, out_size=128, jitter=True,
                        dtype=torch.float32):
    """The train-time augmentation of a uint8 NHWC batch.

    rgb_u8: (B, H, W, 3); flow_u8: (B, H, W, >=2) or None; mask_u8:
    (B, H, W) person mask or None. `draws` as `sample_train_augment`
    gives them, with the batch's `flip` (B,) bool. Returns (B, out, out,
    C) in `dtype` with C = 3 or 5, normalized. `mean` and `std` as in
    `normalize_rgb`.
    """
    x = rgb_u8.to(dtype) / 255.
    if jitter:
        x = batch_color_jitter(x, draws)
    x = normalize_rgb(x, mean, std)
    if mask_u8 is not None:
        x = add_mask_noise(x, mask_u8, draws['noise'], draws['apply_noise'])
    if flow_u8 is not None:
        x = torch.cat([x, decode_flow(flow_u8, dtype)], dim=-1)
    x = flip_samples(x, draws['flip'], flow_u8 is not None)
    return bilinear_resample(x, draws['top'], draws['left'],
                             draws['crop_h'], draws['crop_w'], out_size,
                             out_size)
