"""Plain float32 ResNet (He et al. 2016, "Deep Residual Learning for Image
Recognition", basic blocks) as the VPD student's encoder.

Written from the paper and torchvision's layout of it: a 7x7 stride-2
stem, BatchNorm, ReLU and a 3x3 stride-2 max pool; four stages of basic
blocks (two 3x3 convolutions) at 64, 128, 256 and 512 channels, the
first block of stages 2-4 at stride 2 with a 1x1 projection shortcut;
global average pool and a dense layer to the embedding. Parameters are a
flat {name: tensor} dict under torchvision's names with the prefix
`encoder.`, so the benchmark can hand one set of weights to the program
and to this file.

Departures from the paper, all taken from the VPD reference
(github.com/jhong93/vpd, `models/rgb.py`): the input has 5 channels (RGB
and a 2-channel flow), the images are 128 x 128, the last layer
outputs the embedding (32-d) instead of 1,000 classes. BatchNorm in
train mode normalises with the batch's biased variance (epsilon 1e-5);
in eval mode it uses the running statistics it is given.
"""

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

LAYERS = {'resnet18': (2, 2, 2, 2), 'resnet34': (3, 4, 6, 3)}
BN_EPS = 1e-5
PREFIX = 'encoder.'


def _blocks(arch):
    """(name, in_channels, out_channels, stride, projection) of each block."""
    out, cin = [], 64
    for stage, n in enumerate(LAYERS[arch]):
        planes = 64 * 2 ** stage
        for i in range(n):
            stride = 2 if stage > 0 and i == 0 else 1
            out.append(('layer{}.{}'.format(stage + 1, i), cin, planes,
                        stride, i == 0 and (stride != 1 or cin != planes)))
            cin = planes
    return out


def shapes(config):
    """({name: shape} of the parameters, {name: shape} of the BatchNorm
    running statistics)."""
    params, stats = {}, {}

    def conv(name, cin, cout, k):
        params[PREFIX + name + '.weight'] = (cout, cin, k, k)

    def bn(name, c):
        params[PREFIX + name + '.weight'] = (c,)
        params[PREFIX + name + '.bias'] = (c,)
        stats[PREFIX + name + '.running_mean'] = (c,)
        stats[PREFIX + name + '.running_var'] = (c,)

    conv('conv1', config['in_channels'], 64, 7)
    bn('bn1', 64)
    for name, cin, cout, _, proj in _blocks(config['encoder_arch']):
        conv(name + '.conv1', cin, cout, 3)
        bn(name + '.bn1', cout)
        conv(name + '.conv2', cout, cout, 3)
        bn(name + '.bn2', cout)
        if proj:
            conv(name + '.downsample.0', cin, cout, 1)
            bn(name + '.downsample.1', cout)
    params[PREFIX + 'fc.weight'] = (config['emb_dim'], 512)
    params[PREFIX + 'fc.bias'] = (config['emb_dim'],)
    return params, stats


def batch_norm(x, p, stats, name, train, eps):
    """BatchNorm over (N, C, H, W): the batch's mean and biased variance
    in train mode, the running statistics in eval mode."""
    if train:
        mean = x.mean(dim=(0, 2, 3))
        var = ((x - mean[None, :, None, None]) ** 2).mean(dim=(0, 2, 3))
    else:
        mean = stats[name + '.running_mean']
        var = stats[name + '.running_var']
    scale = p[name + '.weight'] / torch.sqrt(var + eps)
    shift = p[name + '.bias'] - mean * scale
    return x * scale[None, :, None, None] + shift[None, :, None, None]


def forward(p, stats, x, arith, train, config, drops=None, remat=False):
    """(N, C, H, W) float32 -> (N, emb_dim) embeddings. `remat`
    recomputes each block's activations in the backward pass instead of
    keeping them (the same numbers, less memory). `drops` is unused: a
    ResNet draws no dropout."""
    def bn(y, name):
        return batch_norm(y, p, stats, PREFIX + name, train, BN_EPS)

    def conv(y, name, stride=1, pad=1):
        return arith.conv(y, p[PREFIX + name + '.weight'], None, stride, pad)

    def block(y, name, stride, proj):
        out = F.relu(bn(conv(y, name + '.conv1', stride), name + '.bn1'))
        out = bn(conv(out, name + '.conv2'), name + '.bn2')
        if proj:
            y = bn(conv(y, name + '.downsample.0', stride, 0),
                   name + '.downsample.1')
        return F.relu(out + y)

    x = F.relu(bn(conv(x, 'conv1', 2, 3), 'bn1'))
    x = F.max_pool2d(x, 3, 2, 1)
    for name, _, _, stride, proj in _blocks(config['encoder_arch']):
        if remat:
            x = checkpoint(block, x, name, stride, proj, use_reentrant=False)
        else:
            x = block(x, name, stride, proj)
    x = x.mean(dim=(2, 3))
    return arith.linear(x, p[PREFIX + 'fc.weight'], p[PREFIX + 'fc.bias'])


def dropout_shapes(config, batch):
    """A ResNet draws no dropout masks."""
    return []
