"""Weights and seeds made from the run's seed, handed alike to the program
and to the reference.

`make` draws every parameter of a student from one normal draw on the
device, in one call, and shapes it by the kind of leaf: a kernel of two
or more dimensions is scaled to He's (convolutions) or LeCun's (dense
layers) fan-in variance, a 1-d `weight` (BatchNorm's scale) lies near 1,
a bias near 0, running means near 0 and running variances near 1.
"""

import hashlib

import torch


def derive(seed, tag, bits=63):
    """A seed of `bits` bits for the stream `tag` of a run seeded `seed`."""
    digest = hashlib.sha256('{}:{}'.format(seed, tag).encode()).digest()
    return int.from_bytes(digest[:8], 'little') >> (64 - bits)


def _numel(shape):
    n = 1
    for s in shape:
        n *= s
    return n


def make(shapes, seed, device, tag='weights'):
    """{name: float32 tensor} for {name: shape}, drawn on `device`."""
    total = sum(_numel(s) for s in shapes.values())
    gen = torch.Generator(device=device)
    gen.manual_seed(derive(seed, tag))
    flat = torch.randn(total, generator=gen, device=device)
    out, offset = {}, 0
    for name in sorted(shapes):
        shape = shapes[name]
        v = flat[offset:offset + _numel(shape)].view(shape)
        offset += _numel(shape)
        if len(shape) >= 2:
            gain = 2. if len(shape) == 4 else 1.
            v = v * (gain / _numel(shape[1:])) ** 0.5
        elif name.endswith('running_var'):
            v = torch.exp(0.2 * v)
        elif name.endswith('running_mean'):
            v = 0.1 * v
        elif name.endswith('weight'):
            v = 1 + 0.1 * v
        else:
            v = 0.1 * v
        out[name] = v.contiguous()
    return out


@torch.no_grad()
def load(module, params, stats=None):
    """Copy {name: tensor} into `module`'s parameters (and BatchNorm
    statistics), in each one's own dtype; the names and shapes must be
    the module's, all of them."""
    own = dict(module.named_parameters())
    if set(own) != set(params) or any(
            tuple(own[k].shape) != tuple(v.shape) for k, v in params.items()):
        missing = sorted(set(own) ^ set(params))
        raise ValueError('the program\'s parameters are not the reference\'s'
                         ' (names {} differ)'.format(missing[:8]))
    for k, v in params.items():
        own[k].copy_(v)
    if stats:
        buffers = dict(module.named_buffers())
        for k, v in stats.items():
            buffers[k].copy_(v)
