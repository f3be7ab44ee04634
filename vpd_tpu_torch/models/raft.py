"""RAFT optical flow (Teed & Deng, ECCV 2020), basic and small.

Counterpart of `vpd_tpu/models/raft.py`. The modules carry the official
princeton-vl names, so `state_dict()` has the keys `export_torch_raft`
writes and an official checkpoint (raft-things.pth, raft-small.pth)
loads with `load_state_dict`: a load hook strips DataParallel's `module.`
prefix and drops what the official modules hold twice or count (each
strided batch-norm block's `norm3` alias of `downsample.1`, BatchNorm's
`num_batches_tracked`). `is_small_state_dict` picks the architecture.

Public functions keep vpd_tpu's layouts: images (B, H, W, 3) 0-255,
flows and coordinates (B, H, W, 2) as (x, y). Inside, the convolutions
run NCHW on channels_last memory, which a permuted NHWC tensor already
is.

* The correlation volume is one float32 batched product over feature
  maps upcast to float32 (vpd_tpu accumulates and stores it in float32
  under bf16), with a 4-level average-pooled pyramid.
* The lookup is vpd_tpu's separable hat-weight form (`_tap_weights`,
  `corr_lookup`): two small batched products a level. `grid_sample`'s
  `2x/(W-1)-1` rescale gives NaN on the 1x1 level a 64-px input makes.
  Taps are x-offset-major, as the official meshgrid(dy, dx) quirk makes
  them.
* `dtype=torch.bfloat16` runs every convolution in bf16 over float32
  parameters; the correlation, the lookup, the flow updates and the
  upsampling stay float32.

InstanceNorm is affine-free with the biased variance (eps 1e-5); the
basic context encoder's BatchNorm has flax's train-mode semantics
(`models/resnet.FlaxBatchNorm2d`), and uses its running statistics in
eval mode; the small context encoder has no norm.
"""

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.flow import div255
from .resnet import FlaxBatchNorm2d


class _Conv(nn.Conv2d):
    """`nn.Conv2d` computing in its input's dtype (float32 parameters,
    bf16 compute under `dtype=torch.bfloat16`)."""

    def forward(self, x):
        w = self.weight.to(x.dtype)
        b = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, w, b)


class _BatchNorm(FlaxBatchNorm2d):
    """The basic context encoder's BatchNorm, without the
    `num_batches_tracked` counter, which neither flax nor the exported
    state_dict has (an official checkpoint's counters are dropped)."""

    def __init__(self, channels):
        super().__init__(channels)
        self.num_batches_tracked = None

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        state_dict.pop(prefix + 'num_batches_tracked', None)
        nn.Module._load_from_state_dict(self, state_dict, prefix, *args,
                                        **kwargs)


def _norm(norm_fn, planes):
    """The official norms: BatchNorm, or InstanceNorm2d's defaults
    (affine-free, biased variance, eps 1e-5), or none; only BatchNorm has
    state."""
    if norm_fn == 'batch':
        return _BatchNorm(planes)
    if norm_fn == 'instance':
        return nn.InstanceNorm2d(planes)
    return nn.Identity()


class ResidualBlock(nn.Module):
    def __init__(self, in_planes, planes, norm_fn, stride=1):
        super().__init__()
        self.conv1 = _Conv(in_planes, planes, 3, padding=1, stride=stride)
        self.conv2 = _Conv(planes, planes, 3, padding=1)
        self.norm1 = _norm(norm_fn, planes)
        self.norm2 = _norm(norm_fn, planes)
        self.downsample = None
        if stride != 1:
            self.downsample = nn.Sequential(
                _Conv(in_planes, planes, 1, stride=stride),
                _norm(norm_fn, planes))

    def forward(self, x):
        y = F.relu(self.norm1(self.conv1(x)))
        y = F.relu(self.norm2(self.conv2(y)))
        if self.downsample is not None:
            x = self.downsample(x)
        return F.relu(x + y)


class BottleneckBlock(nn.Module):
    def __init__(self, in_planes, planes, norm_fn, stride=1):
        super().__init__()
        q = planes // 4
        self.conv1 = _Conv(in_planes, q, 1)
        self.conv2 = _Conv(q, q, 3, padding=1, stride=stride)
        self.conv3 = _Conv(q, planes, 1)
        self.norm1 = _norm(norm_fn, q)
        self.norm2 = _norm(norm_fn, q)
        self.norm3 = _norm(norm_fn, planes)
        self.downsample = None
        if stride != 1:
            self.downsample = nn.Sequential(
                _Conv(in_planes, planes, 1, stride=stride),
                _norm(norm_fn, planes))

    def forward(self, x):
        y = F.relu(self.norm1(self.conv1(x)))
        y = F.relu(self.norm2(self.conv2(y)))
        y = F.relu(self.norm3(self.conv3(y)))
        if self.downsample is not None:
            x = self.downsample(x)
        return F.relu(x + y)


def _kaiming_init(module):
    """The official encoders' init: kaiming-normal conv weights (fan
    out), unit / zero norm affines."""
    for m in module.modules():
        if isinstance(m, nn.Conv2d):
            nn.init.kaiming_normal_(m.weight, mode='fan_out',
                                    nonlinearity='relu')
        elif isinstance(m, nn.BatchNorm2d):
            nn.init.ones_(m.weight)
            nn.init.zeros_(m.bias)


class BasicEncoder(nn.Module):
    """fnet/cnet trunk: 7x7/2 stem + 3 residual stages -> 1x1 head (1/8)."""

    def __init__(self, output_dim=256, norm_fn='instance'):
        super().__init__()
        self.conv1 = _Conv(3, 64, 7, stride=2, padding=3)
        self.norm1 = _norm(norm_fn, 64)
        in_planes = 64
        for li, (planes, stride) in enumerate(
                [(64, 1), (96, 2), (128, 2)], start=1):
            setattr(self, 'layer{}'.format(li), nn.Sequential(
                ResidualBlock(in_planes, planes, norm_fn, stride),
                ResidualBlock(planes, planes, norm_fn, 1)))
            in_planes = planes
        self.conv2 = _Conv(128, output_dim, 1)
        _kaiming_init(self)

    def forward(self, x):
        x = F.relu(self.norm1(self.conv1(x)))
        return self.conv2(self.layer3(self.layer2(self.layer1(x))))


class SmallEncoder(nn.Module):
    """raft-small fnet/cnet: 7x7/2 stem + 3 bottleneck stages (1/8)."""

    def __init__(self, output_dim=128, norm_fn='instance'):
        super().__init__()
        self.conv1 = _Conv(3, 32, 7, stride=2, padding=3)
        self.norm1 = _norm(norm_fn, 32)
        in_planes = 32
        for li, (planes, stride) in enumerate(
                [(32, 1), (64, 2), (96, 2)], start=1):
            setattr(self, 'layer{}'.format(li), nn.Sequential(
                BottleneckBlock(in_planes, planes, norm_fn, stride),
                BottleneckBlock(planes, planes, norm_fn, 1)))
            in_planes = planes
        self.conv2 = _Conv(96, output_dim, 1)
        _kaiming_init(self)

    def forward(self, x):
        x = F.relu(self.norm1(self.conv1(x)))
        return self.conv2(self.layer3(self.layer2(self.layer1(x))))


def coords_grid(batch, ht, wd, device=None):
    """(B, H, W, 2) pixel coordinates, channels (x, y)."""
    y, x = torch.meshgrid(torch.arange(ht, device=device),
                          torch.arange(wd, device=device), indexing='ij')
    grid = torch.stack([x, y], dim=-1).to(torch.float32)
    return grid[None].expand(batch, ht, wd, 2)


def corr_pyramid(fmap1, fmap2, num_levels=4):
    """All-pairs correlation + pooled pyramid, in float32.

    fmap1/fmap2 (B, H, W, C) -> [num_levels x (B*H*W, H/2^l, W/2^l)].
    """
    b, h, w, c = fmap1.shape
    f1 = fmap1.reshape(b, h * w, c).to(torch.float32)
    f2 = fmap2.reshape(b, h * w, c).to(torch.float32)
    corr = torch.bmm(f1, f2.transpose(1, 2)) / torch.full(
        (), c, dtype=torch.float32, device=f1.device).sqrt()
    corr = corr.reshape(b * h * w, 1, h, w)
    pyramid = [corr[:, 0]]
    for _ in range(num_levels - 1):
        corr = F.avg_pool2d(corr, 2, stride=2)
        pyramid.append(corr[:, 0])
    return pyramid


def _tap_weights(centers, d, size):
    """(N,) centers + (K,) offsets -> (N, K, size) bilinear hat weights.

    The hat max(0, 1 - |pos - u|) over integer source positions u is
    grid_sample(align_corners=True, padding_mode='zeros'): out-of-range
    taps fade to zero contribution.
    """
    pos = centers[:, None, None] + d[None, :, None]
    idx = torch.arange(size, dtype=torch.float32,
                       device=centers.device)[None, None, :]
    return (1. - (pos - idx).abs()).clamp_min(0.)


def corr_lookup(pyramid, coords, radius=4):
    """Sample (2r+1)^2 neighbourhoods around coords at every level.

    coords (B, H, W, 2) at 1/8 resolution -> (B, H, W, levels*(2r+1)^2),
    each level's taps x-offset-major (k = i*(2r+1) + j for x offset i and
    y offset j): the separable weights make two batched products a level,
    x-interpolation then y-interpolation.
    """
    b, h, w, _ = coords.shape
    flat = coords.reshape(b * h * w, 2)
    d = torch.arange(-radius, radius + 1, dtype=torch.float32,
                     device=coords.device)
    out = []
    for lvl, corr in enumerate(pyramid):
        hl, wl = corr.shape[1], corr.shape[2]
        wx = _tap_weights(flat[:, 0] / (2. ** lvl), d, wl)  # (N, K, wl)
        wy = _tap_weights(flat[:, 1] / (2. ** lvl), d, hl)  # (N, K, hl)
        tmp = torch.bmm(corr, wx.transpose(1, 2))  # (N, hl, K): v, i
        vals = torch.bmm(tmp.transpose(1, 2), wy.transpose(1, 2))  # i, j
        out.append(vals.reshape(b, h, w, -1))
    return torch.cat(out, dim=-1)


class MotionEncoder(nn.Module):
    def __init__(self, corr_planes):
        super().__init__()
        self.convc1 = _Conv(corr_planes, 256, 1)
        self.convc2 = _Conv(256, 192, 3, padding=1)
        self.convf1 = _Conv(2, 128, 7, padding=3)
        self.convf2 = _Conv(128, 64, 3, padding=1)
        self.conv = _Conv(64 + 192, 128 - 2, 3, padding=1)

    def forward(self, flow, corr):
        c = F.relu(self.convc1(corr))
        c = F.relu(self.convc2(c))
        f = F.relu(self.convf1(flow))
        f = F.relu(self.convf2(f))
        out = F.relu(self.conv(torch.cat([c, f], dim=1)))
        return torch.cat([out, flow], dim=1)


class SmallMotionEncoder(nn.Module):
    def __init__(self, corr_planes):
        super().__init__()
        self.convc1 = _Conv(corr_planes, 96, 1)
        self.convf1 = _Conv(2, 64, 7, padding=3)
        self.convf2 = _Conv(64, 32, 3, padding=1)
        self.conv = _Conv(128, 80, 3, padding=1)

    def forward(self, flow, corr):
        c = F.relu(self.convc1(corr))
        f = F.relu(self.convf1(flow))
        f = F.relu(self.convf2(f))
        out = F.relu(self.conv(torch.cat([c, f], dim=1)))
        return torch.cat([out, flow], dim=1)


class SepConvGRU(nn.Module):
    def __init__(self, hidden_dim=128, input_dim=192 + 128):
        super().__init__()
        k = hidden_dim + input_dim
        for suffix, ksize, pad in (('1', (1, 5), (0, 2)),
                                   ('2', (5, 1), (2, 0))):
            for gate in 'zrq':
                setattr(self, 'conv{}{}'.format(gate, suffix),
                        _Conv(k, hidden_dim, ksize, padding=pad))

    def forward(self, h, x):
        for convz, convr, convq in ((self.convz1, self.convr1, self.convq1),
                                    (self.convz2, self.convr2, self.convq2)):
            hx = torch.cat([h, x], dim=1)
            z = torch.sigmoid(convz(hx))
            r = torch.sigmoid(convr(hx))
            q = torch.tanh(convq(torch.cat([r * h, x], dim=1)))
            h = (1 - z) * h + z * q
        return h


class ConvGRU(nn.Module):
    def __init__(self, hidden_dim=96, input_dim=82 + 64):
        super().__init__()
        k = hidden_dim + input_dim
        self.convz = _Conv(k, hidden_dim, 3, padding=1)
        self.convr = _Conv(k, hidden_dim, 3, padding=1)
        self.convq = _Conv(k, hidden_dim, 3, padding=1)

    def forward(self, h, x):
        hx = torch.cat([h, x], dim=1)
        z = torch.sigmoid(self.convz(hx))
        r = torch.sigmoid(self.convr(hx))
        q = torch.tanh(self.convq(torch.cat([r * h, x], dim=1)))
        return (1 - z) * h + z * q


class FlowHead(nn.Module):
    def __init__(self, input_dim, hidden_dim):
        super().__init__()
        self.conv1 = _Conv(input_dim, hidden_dim, 3, padding=1)
        self.conv2 = _Conv(hidden_dim, 2, 3, padding=1)

    def forward(self, x):
        return self.conv2(F.relu(self.conv1(x)))


class BasicUpdateBlock(nn.Module):
    def __init__(self, corr_planes, hidden_dim=128):
        super().__init__()
        self.encoder = MotionEncoder(corr_planes)
        self.gru = SepConvGRU(hidden_dim, 128 + hidden_dim)
        self.flow_head = FlowHead(hidden_dim, 256)
        self.mask = nn.Sequential(_Conv(hidden_dim, 256, 3, padding=1),
                                  nn.ReLU(inplace=True),
                                  _Conv(256, 64 * 9, 1))

    def forward(self, net, inp, corr, flow):
        motion = self.encoder(flow, corr)
        net = self.gru(net, torch.cat([inp, motion], dim=1))
        delta = self.flow_head(net)
        mask = 0.25 * self.mask(net)
        return net, mask.float(), delta.float()


class SmallUpdateBlock(nn.Module):
    def __init__(self, corr_planes, hidden_dim=96):
        super().__init__()
        self.encoder = SmallMotionEncoder(corr_planes)
        self.gru = ConvGRU(hidden_dim, 82 + 64)
        self.flow_head = FlowHead(hidden_dim, 128)

    def forward(self, net, inp, corr, flow):
        motion = self.encoder(flow, corr)
        net = self.gru(net, torch.cat([inp, motion], dim=1))
        return net, None, self.flow_head(net).float()


def upsample_flow_convex(flow, mask):
    """Convex-combination 8x upsampling. flow (B,H,W,2), mask (B,H,W,576).

    Mask channels as the official view(N, 1, 9, 8, 8, H, W): neighbour
    k = (dy+1)*3 + (dx+1) major, then the 8x8 subpixel grid.
    """
    b, h, w, _ = flow.shape
    mask = torch.softmax(mask.reshape(b, h, w, 9, 64), dim=3)
    fp = F.pad(8. * flow, (0, 0, 1, 1, 1, 1))
    nbrs = torch.stack(
        [fp[:, 1 + dy:1 + dy + h, 1 + dx:1 + dx + w]
         for dy in (-1, 0, 1) for dx in (-1, 0, 1)], dim=3)
    up = torch.einsum('bhwks,bhwkc->bhwsc', mask, nbrs)  # (B,H,W,64,2)
    up = up.reshape(b, h, w, 8, 8, 2)
    return up.permute(0, 1, 3, 2, 4, 5).reshape(b, 8 * h, 8 * w, 2)


def _align_corners_up_matrix(out_size, in_size, device):
    """(out, in) bilinear weights for align_corners=True interpolation."""
    if in_size == 1:
        return torch.ones((out_size, 1), dtype=torch.float32, device=device)
    src = torch.arange(out_size, dtype=torch.float32, device=device) * (
        (in_size - 1) / (out_size - 1))
    idx = torch.arange(in_size, dtype=torch.float32, device=device)
    return (1. - (src[:, None] - idx[None, :]).abs()).clamp_min(0.)


def upsample_flow_bilinear8(flow):
    """8x flow upsampling for raft-small (no convex mask):
    8 * F.interpolate(scale_factor=8, mode='bilinear',
    align_corners=True), as two separable interpolation products."""
    b, h, w, _ = flow.shape
    wy = _align_corners_up_matrix(8 * h, h, flow.device)
    wx = _align_corners_up_matrix(8 * w, w, flow.device)
    return 8. * torch.einsum('oh,bhwc,pw->bopc', wy, flow, wx)


class RAFT(nn.Module):
    """RAFT in basic (default) or small form. Call with 0-255 RGB
    (B, H, W, 3); H and W divisible by 8. Returns the (B, H, W, 2) flow,
    or with `train=True` the list of every iteration's upsampled flow
    (autograd through each; coordinates detached between iterations, as
    the official model does). The context encoder's BatchNorm follows the
    module's train/eval mode.

    `small=True` is the official raft-small architecture: bottleneck
    encoders (fnet instance-norm, cnet norm-free), hidden 96 + context
    64, radius-3 lookup, plain ConvGRU, bilinear 8x upsampling.
    """

    corr_levels = 4

    def __init__(self, small=False):
        super().__init__()
        self.small = small
        self.hidden_dim = 96 if small else 128
        self.context_dim = 64 if small else 128
        self.corr_radius = 3 if small else 4
        corr_planes = self.corr_levels * (2 * self.corr_radius + 1) ** 2
        cdim = self.hidden_dim + self.context_dim
        if small:
            self.fnet = SmallEncoder(128, 'instance')
            self.cnet = SmallEncoder(cdim, 'none')
            self.update_block = SmallUpdateBlock(corr_planes,
                                                 self.hidden_dim)
        else:
            self.fnet = BasicEncoder(256, 'instance')
            self.cnet = BasicEncoder(cdim, 'batch')
            self.update_block = BasicUpdateBlock(corr_planes,
                                                 self.hidden_dim)
        self._register_load_state_dict_pre_hook(_official_keys)

    def forward(self, image1, image2, iters=12, train=False, dtype=None):
        if iters < 1:
            raise ValueError('iters must be >= 1')
        if image1.shape[1] % 8 or image1.shape[2] % 8:
            raise ValueError(
                'H and W must be divisible by 8 (the official repo pads with '
                'InputPadder); got {}'.format(tuple(image1.shape)))
        dt = torch.float32 if dtype is None else dtype
        b = image1.shape[0]

        def prep(img):  # NHWC 0-255 -> NCHW (channels_last) in [-1, 1]
            return (2. * div255(img) - 1.).permute(0, 3, 1, 2).to(dt)

        im1, im2 = prep(image1), prep(image2)
        fmaps = self.fnet(torch.cat([im1, im2]))  # per-sample norms only
        fmap1, fmap2 = fmaps[:b], fmaps[b:]
        cnet = self.cnet(im1)
        net = torch.tanh(cnet[:, :self.hidden_dim])
        inp = F.relu(cnet[:, self.hidden_dim:])

        h, w = fmap1.shape[2], fmap1.shape[3]
        min_dim = 2 ** (self.corr_levels - 1)
        if h < min_dim or w < min_dim:
            raise ValueError(
                'images too small for a {}-level correlation pyramid: '
                '1/8-res grid is {}x{}, need >= {}'.format(
                    self.corr_levels, h, w, min_dim))
        pyramid = corr_pyramid(fmap1.permute(0, 2, 3, 1),
                               fmap2.permute(0, 2, 3, 1), self.corr_levels)
        coords0 = coords_grid(b, h, w, device=image1.device)
        coords1 = coords0

        def up(flow, mask):
            if mask is None:
                return upsample_flow_bilinear8(flow)
            return upsample_flow_convex(flow, mask.permute(0, 2, 3, 1))

        predictions = []
        for _ in range(iters):
            coords1 = coords1.detach()
            corr = corr_lookup(pyramid, coords1, self.corr_radius)
            flow = coords1 - coords0
            net, mask, delta = self.update_block(
                net, inp, corr.permute(0, 3, 1, 2).to(dt),
                flow.permute(0, 3, 1, 2).to(dt))
            coords1 = coords1 + delta.permute(0, 2, 3, 1)
            if train:
                predictions.append(up(coords1 - coords0, mask))
        if train:
            return predictions
        return up(coords1 - coords0, mask)


def sequence_loss(predictions, flow_gt, gamma=0.8, max_flow=400.):
    """Exponentially-weighted L1 over refinement iterations (RAFT paper)."""
    mag = (flow_gt ** 2).sum(-1, keepdim=True).sqrt()
    valid = (mag < max_flow).to(torch.float32)
    n = len(predictions)
    loss = 0.
    for i, pred in enumerate(predictions):
        loss = loss + gamma ** (n - i - 1) * (
            valid * (pred - flow_gt).abs()).mean()
    return loss


def is_small_state_dict(sd):
    """Detect the raft-small layout (bottleneck blocks have a conv3)."""
    return any(k.endswith('fnet.layer1.0.conv3.weight') for k in sd)


def _official_keys(state_dict, prefix, *args):
    """Load hook: an official checkpoint as the port's modules hold it.
    Strips DataParallel's `module.` and drops each strided batch-norm
    block's `norm3.*` alias of `downsample.1.*` (the official module
    registers one BatchNorm under both names)."""
    for key in list(state_dict):
        if not key.startswith(prefix):
            continue
        rel = key[len(prefix):]
        if rel.startswith('module.'):
            state_dict[prefix + rel[len('module.'):]] = state_dict.pop(key)
    for key in list(state_dict):
        head, sep, leaf = key.rpartition('.norm3.')
        if sep and head + '.downsample.1.' + leaf in state_dict:
            del state_dict[key]


def build_raft(state_dict=None, small=False, seed=0):
    """A RAFT module on the CPU in eval mode: an official (or exported)
    state_dict's architecture and weights, or random init from `seed`
    (a smoke path only: the weights mean nothing)."""
    if state_dict is not None:
        small = is_small_state_dict(state_dict)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = RAFT(small=small)
    if state_dict is not None:
        model.load_state_dict(dict(state_dict))
    return model.eval()


def raft_flow_fn(model, iters=20, dtype=None):
    """(prev_u8, curr_u8) -> (B, H, W, 2) float32 flow on the inputs'
    device, `raft/flow.py` parity (eval mode, no autograd). `dtype` is the
    convolutions' compute type (bf16 for `--mixed_precision`)."""
    model.eval()

    @torch.inference_mode()
    def fn(prev_u8, curr_u8):
        return model(prev_u8, curr_u8, iters=iters, train=False,
                     dtype=dtype)

    return fn
