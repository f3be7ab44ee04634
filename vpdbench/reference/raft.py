"""RAFT basic (Teed and Deng, ECCV 2020) in plain float32 PyTorch, written
from the published code (github.com/princeton-vl/RAFT: `core/raft.py`,
`extractor.py`, `corr.py`, `update.py`, `utils/utils.py`), functional
over the official state_dict names: `fnet.*` and `cnet.*` (the
encoders), `update_block.*`. Each convolution goes through an
`arith.Arith`; the correlation volume is a plain float32 product, as the
official code computes it out of autocast.

What the forward does, as the official `RAFT.forward` in test mode:
images to [-1, 1]; `fnet` (instance norm) on both frames, `cnet` (batch
norm) on the first, split into tanh(hidden) and relu(context); the
all-pairs correlation over sqrt(256) and its 4-level average-pooled
pyramid; then `iters` times: the radius-4 lookup around the current
coordinates by `F.grid_sample(align_corners=True)`, taps in the official
meshgrid(dy, dx) order, the motion encoder, the separable ConvGRU, the
flow head and the mask head (times 0.25); at the end the convex 8x
upsampling by `F.unfold` over the mask viewed (N, 1, 9, 8, 8, H, W).

Departures from the official code:

* Everything is float32 (the official model runs its encoders and
  update block under autocast with `--mixed_precision`); the
  configuration's bf16 is the program's.
* Instance norm is `F.instance_norm` without affine (InstanceNorm2d's
  defaults) and batch norm reads its running statistics (eval mode),
  eps 1e-5 both; dropout is off, as in eval.
* A pyramid level one pixel wide or high (a 64-px input) is padded by
  one zero pixel on each side and sampled one pixel further in: the
  official `2x/(W-1) - 1` divides by zero there. With `grid_sample`'s
  zero padding this samples the same values.
* `quantize` is `raft/flow.py`'s `flow_to_img` (VPD) on tensors: clip,
  shift, scale by 255 / (2 clip + 1) in float32, truncate to uint8; the
  constant third channel is left out.
"""

import torch
import torch.nn.functional as F

from .arith import tf32_off

EPS = 1e-5
# the official BasicEncoder's stages: (planes, stride)
STAGES = ((64, 1), (96, 2), (128, 2))


def _conv_shapes(out, prefix, cin, cout, kh, kw=None):
    out[prefix + 'weight'] = (cout, cin, kh, kh if kw is None else kw)
    out[prefix + 'bias'] = (cout,)


def _encoder_shapes(params, stats, prefix, out_dim, batch_norm):
    def norm(name, c):
        if batch_norm:
            params[prefix + name + 'weight'] = (c,)
            params[prefix + name + 'bias'] = (c,)
            stats[prefix + name + 'running_mean'] = (c,)
            stats[prefix + name + 'running_var'] = (c,)

    _conv_shapes(params, prefix + 'conv1.', 3, 64, 7)
    norm('norm1.', 64)
    cin = 64
    for li, (planes, stride) in enumerate(STAGES, start=1):
        for bi in range(2):
            block = 'layer{}.{}.'.format(li, bi)
            _conv_shapes(params, prefix + block + 'conv1.',
                         cin if bi == 0 else planes, planes, 3)
            _conv_shapes(params, prefix + block + 'conv2.', planes, planes,
                         3)
            norm(block + 'norm1.', planes)
            norm(block + 'norm2.', planes)
            if bi == 0 and stride != 1:
                _conv_shapes(params, prefix + block + 'downsample.0.', cin,
                             planes, 1)
                norm(block + 'downsample.1.', planes)
        cin = planes
    _conv_shapes(params, prefix + 'conv2.', 128, out_dim, 1)


def shapes(config):
    """({name: shape} of RAFT basic's parameters, {name: shape} of the
    context encoder's BatchNorm statistics), the official names less the
    `norm3` alias of each strided block's `downsample.1`."""
    params, stats = {}, {}
    hdim, cdim = config['hidden_dim'], config['context_dim']
    _encoder_shapes(params, stats, 'fnet.', config['fnet_dim'], False)
    _encoder_shapes(params, stats, 'cnet.', hdim + cdim, True)
    u = 'update_block.'
    planes = config['corr_levels'] * (2 * config['corr_radius'] + 1) ** 2
    for name, cin, cout, k in (('convc1', planes, 256, 1),
                               ('convc2', 256, 192, 3),
                               ('convf1', 2, 128, 7), ('convf2', 128, 64, 3),
                               ('conv', 64 + 192, 128 - 2, 3)):
        _conv_shapes(params, u + 'encoder.' + name + '.', cin, cout, k)
    for gate in 'zrq':
        _conv_shapes(params, u + 'gru.conv{}1.'.format(gate),
                     hdim + cdim + hdim, hdim, 1, 5)
        _conv_shapes(params, u + 'gru.conv{}2.'.format(gate),
                     hdim + cdim + hdim, hdim, 5, 1)
    _conv_shapes(params, u + 'flow_head.conv1.', hdim, 256, 3)
    _conv_shapes(params, u + 'flow_head.conv2.', 256, 2, 3)
    _conv_shapes(params, u + 'mask.0.', hdim, 256, 3)
    _conv_shapes(params, u + 'mask.2.', 256, 64 * 9, 1)
    return params, stats


def _conv(p, name, x, arith, stride=1, padding=0):
    return arith.conv(x, p[name + '.weight'], p[name + '.bias'], stride,
                      padding)


def _norm(p, s, name, x, batch_norm):
    if batch_norm:
        return F.batch_norm(x, s[name + '.running_mean'],
                            s[name + '.running_var'], p[name + '.weight'],
                            p[name + '.bias'], False, 0., EPS)
    return F.instance_norm(x, eps=EPS)


def _residual(p, s, name, x, stride, batch_norm, arith):
    y = F.relu(_norm(p, s, name + '.norm1',
                     _conv(p, name + '.conv1', x, arith, stride, 1),
                     batch_norm))
    y = F.relu(_norm(p, s, name + '.norm2',
                     _conv(p, name + '.conv2', y, arith, 1, 1), batch_norm))
    if stride != 1:
        x = _norm(p, s, name + '.downsample.1',
                  _conv(p, name + '.downsample.0', x, arith, stride),
                  batch_norm)
    return F.relu(x + y)


def encoder(p, s, prefix, x, batch_norm, arith):
    """The official BasicEncoder: (N, 3, H, W) -> (N, D, H/8, W/8)."""
    x = F.relu(_norm(p, s, prefix + 'norm1',
                     _conv(p, prefix + 'conv1', x, arith, 2, 3), batch_norm))
    for li, (_, stride) in enumerate(STAGES, start=1):
        x = _residual(p, s, '{}layer{}.0'.format(prefix, li), x, stride,
                      batch_norm, arith)
        x = _residual(p, s, '{}layer{}.1'.format(prefix, li), x, 1,
                      batch_norm, arith)
    return _conv(p, prefix + 'conv2', x, arith)


def corr_pyramid(fmap1, fmap2, levels):
    """The official CorrBlock's pyramid: (N*H*W, 1, H/2^l, W/2^l) float32
    levels of the all-pairs correlation over sqrt(D)."""
    n, d, h, w = fmap1.shape
    corr = torch.matmul(fmap1.reshape(n, d, h * w).transpose(1, 2),
                        fmap2.reshape(n, d, h * w))
    corr = corr.reshape(n * h * w, 1, h, w) / torch.sqrt(
        torch.tensor(d, device=fmap1.device).float())
    pyramid = [corr]
    for _ in range(levels - 1):
        corr = F.avg_pool2d(corr, 2, stride=2)
        pyramid.append(corr)
    return pyramid


def bilinear_sampler(img, coords):
    """The official `bilinear_sampler`: img (N, 1, H, W) at pixel
    coordinates (N, h, w, 2) as (x, y), zero outside. A dimension of one
    pixel is padded by a zero pixel each side first (see the module's
    departures)."""
    hgt, wid = img.shape[-2:]
    if hgt == 1 or wid == 1:
        img = F.pad(img, (1, 1, 1, 1))
        coords = coords + 1.
        hgt, wid = hgt + 2, wid + 2
    xgrid, ygrid = coords.split([1, 1], dim=-1)
    xgrid = 2 * xgrid / (wid - 1) - 1
    ygrid = 2 * ygrid / (hgt - 1) - 1
    return F.grid_sample(img, torch.cat([xgrid, ygrid], dim=-1),
                         align_corners=True)


def lookup(pyramid, coords, radius):
    """The official CorrBlock.__call__: coords (N, 2, H, W) -> (N,
    levels*(2r+1)^2, H, W), each level's taps in the order of
    stack(meshgrid(dy, dx)) read as (x, y)."""
    coords = coords.permute(0, 2, 3, 1)
    n, h, w, _ = coords.shape
    r = radius
    dx = torch.linspace(-r, r, 2 * r + 1, device=coords.device)
    dy = torch.linspace(-r, r, 2 * r + 1, device=coords.device)
    delta = torch.stack(torch.meshgrid(dy, dx, indexing='ij'), dim=-1)
    out = []
    for i, corr in enumerate(pyramid):
        centroid = coords.reshape(n * h * w, 1, 1, 2) / 2 ** i
        sampled = bilinear_sampler(
            corr, centroid + delta.view(1, 2 * r + 1, 2 * r + 1, 2))
        out.append(sampled.view(n, h, w, -1))
    return torch.cat(out, dim=-1).permute(0, 3, 1, 2).contiguous().float()


def update_block(p, net, inp, corr, flow, arith):
    """The official BasicUpdateBlock: (net, mask, delta_flow)."""
    u = 'update_block.'
    e = u + 'encoder.'
    cor = F.relu(_conv(p, e + 'convc1', corr, arith))
    cor = F.relu(_conv(p, e + 'convc2', cor, arith, 1, 1))
    flo = F.relu(_conv(p, e + 'convf1', flow, arith, 1, 3))
    flo = F.relu(_conv(p, e + 'convf2', flo, arith, 1, 1))
    out = F.relu(_conv(p, e + 'conv', torch.cat([cor, flo], dim=1), arith,
                       1, 1))
    x = torch.cat([inp, out, flow], dim=1)
    h = net
    for suffix, pad in (('1', (0, 2)), ('2', (2, 0))):
        g = u + 'gru.conv{}' + suffix
        hx = torch.cat([h, x], dim=1)
        z = torch.sigmoid(_conv(p, g.format('z'), hx, arith, 1, pad))
        r = torch.sigmoid(_conv(p, g.format('r'), hx, arith, 1, pad))
        q = torch.tanh(_conv(p, g.format('q'), torch.cat([r * h, x], dim=1),
                             arith, 1, pad))
        h = (1 - z) * h + z * q
    delta = _conv(p, u + 'flow_head.conv2', F.relu(
        _conv(p, u + 'flow_head.conv1', h, arith, 1, 1)), arith, 1, 1)
    mask = 0.25 * _conv(p, u + 'mask.2', F.relu(
        _conv(p, u + 'mask.0', h, arith, 1, 1)), arith)
    return h, mask, delta


def upsample(flow, mask):
    """The official RAFT.upsample_flow: (N, 2, H, W) -> (N, 2, 8H, 8W),
    a convex combination of each pixel's 3x3 neighbours."""
    n, _, h, w = flow.shape
    mask = torch.softmax(mask.view(n, 1, 9, 8, 8, h, w), dim=2)
    up = F.unfold(8 * flow, [3, 3], padding=1).view(n, 2, 9, 1, 1, h, w)
    up = torch.sum(mask * up, dim=2).permute(0, 1, 4, 2, 5, 3)
    return up.reshape(n, 2, 8 * h, 8 * w)


@torch.no_grad()
def forward(p, s, image1, image2, config, arith, iters=None):
    """uint8 (N, H, W, 3) pairs -> their (N, H, W, 2) float32 flow after
    `iters` (the configuration's by default) refinements."""
    iters = config['iters'] if iters is None else iters
    hdim = config['hidden_dim']
    with tf32_off():
        im1, im2 = (2 * (x.permute(0, 3, 1, 2).float() / 255.0) - 1.0
                    for x in (image1, image2))
        fmaps = encoder(p, s, 'fnet.', torch.cat([im1, im2]), False, arith)
        fmap1, fmap2 = fmaps.split(im1.shape[0])
        pyramid = corr_pyramid(fmap1.float(), fmap2.float(),
                               config['corr_levels'])
        cnet = encoder(p, s, 'cnet.', im1, True, arith)
        net, inp = torch.split(cnet, [hdim, config['context_dim']], dim=1)
        net, inp = torch.tanh(net), torch.relu(inp)
        n, _, h, w = fmap1.shape
        ys, xs = torch.meshgrid(torch.arange(h, device=im1.device),
                                torch.arange(w, device=im1.device),
                                indexing='ij')
        coords0 = torch.stack([xs, ys], dim=0).float()[None].repeat(
            n, 1, 1, 1)
        coords1 = coords0.clone()
        for _ in range(iters):
            corr = lookup(pyramid, coords1, config['corr_radius'])
            net, mask, delta = update_block(p, net, inp, corr,
                                            coords1 - coords0, arith)
            coords1 = coords1 + delta
        return upsample(coords1 - coords0, mask).permute(0, 2, 3, 1)


def quantize(flow, clip):
    """`raft/flow.py`'s flow_to_img on a tensor, less the constant
    channel: (..., 2) float -> uint8."""
    q = flow.float().clamp(-clip, clip) + clip
    return (q * (255 / (2 * clip + 1))).to(torch.uint8)
