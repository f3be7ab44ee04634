"""Fully-connected models: the VIPE* teacher's encoder and pose decoders,
and `FCNet`, also the MLP behind the student's motion head.

Counterpart of `vpd_tpu/models/fc.py` (reference `models/module.py:
133-227`):

* `FCNet`      — plain MLP with ReLU/dropout.
* `FCResNet`   — linear stem + stacked residual MLP blocks; the VIPE*
  encoder. Each block computes ``block(x) - x``, the reference's sign
  (QUIRKS.md), which trained VIPE* weights depend on.
* `FCPoseDecoder` / `FCResNetPoseDecoder` — a trunk + one linear head per
  3D mocap dataset. All heads are one (k, h, d) parameter evaluated as one
  einsum; each row then takes its own head's output by `dataset_id`, so
  one step serves every dataset of a fused batch.

Layers behave as flax's: Dense layers start lecun-normal with zero bias,
BatchNorm is `FlaxBatchNorm1d` (momentum 0.9, eps 1e-5, the biased
variance into the running statistics) and dropout is flax's inverted
dropout (`FlaxDropout`), whose keep mask the train step draws from a
seeded generator (`set_dropout_draw`).

Each module's `columns` says where its layers' output columns live:
`WHOLE` keeps them on this process; `models/tensor_parallel.py` swaps in
a model group that splits them, and the forwards below then enter a
split layer and gather its full rows through it.
"""

import torch
from torch import nn

from .resnet import FlaxBatchNorm1d


class Columns:
    """Where a layer's output columns live: this one keeps every layer
    whole, so `enter` and `gather` pass their input through.
    `enter(x, layer)` is x on its way into `layer`, `gather(y, layer)`
    the full rows of `layer`'s output y."""

    def enter(self, x, layer):
        return x

    def gather(self, y, layer):
        return y

    def dense(self, x, layer, *then):
        """`layer` on x, then each of `then` on the columns it
        computes, gathered whole."""
        y = layer(self.enter(x, layer))
        for fn in then:
            y = fn(y)
        return self.gather(y, layer)


WHOLE = Columns()


def _dense(in_dim, out_dim):
    """`nn.Linear` initialised as flax's Dense: lecun normal, zero bias."""
    layer = nn.Linear(in_dim, out_dim)
    nn.init.normal_(layer.weight, std=in_dim ** -0.5)
    nn.init.zeros_(layer.bias)
    return layer


class FlaxDropout(nn.Module):
    """flax's `nn.Dropout`: in train mode each element is kept with
    probability 1 - rate and scaled by 1 / (1 - rate), else zeroed; eval
    mode and rate 0 pass the input through. Along `broadcast_dims` one
    keep bit serves every element (flax's `broadcast_dims`; (1, 2, 3) on
    an (N, C, H, W) input keeps or drops each sample whole, stochastic
    depth).

    The keep mask is `draw(shape, keep_prob, device)`, of the input's
    shape with `broadcast_dims` set to 1, set with `set_dropout_draw`
    (the train step's seeded generator; tests feed masks): train mode at
    a rate above 0 without one raises.
    """

    def __init__(self, rate, broadcast_dims=()):
        super().__init__()
        self.rate = rate
        self.broadcast_dims = tuple(broadcast_dims)
        self.draw = None

    def forward(self, x):
        if not self.training or self.rate == 0:
            return x
        keep = 1. - self.rate
        if keep == 0:
            return torch.zeros_like(x)
        if self.draw is None:
            raise RuntimeError('FlaxDropout in train mode needs a mask '
                               'source: set_dropout_draw(model, draw)')
        shape = tuple(1 if d in self.broadcast_dims else n
                      for d, n in enumerate(x.shape))
        mask = self.draw(shape, keep, x.device)
        return torch.where(mask, x / keep, torch.zeros_like(x))


def set_dropout_draw(model, draw):
    """Give every `FlaxDropout` in `model` the mask source `draw` (None
    clears it)."""
    for m in model.modules():
        if isinstance(m, FlaxDropout):
            m.draw = draw


class FCNet(nn.Module):
    """MLP: in -> hidden[0] -> ... -> out with ReLU between layers.

    Dropout sits between hidden layers only (reference models/module.py:152).
    `layers` are the Linear layers in order (flax's Dense_0, Dense_1, ...).
    """

    def __init__(self, input_dim, hidden_dims, output_dim, dropout=0.3):
        super().__init__()
        dims = [input_dim, *hidden_dims, output_dim]
        self.layers = nn.ModuleList(
            _dense(a, b) for a, b in zip(dims[:-1], dims[1:]))
        self.dropout = FlaxDropout(dropout)
        self.columns = WHOLE

    def forward(self, x):
        x = self.columns.dense(x, self.layers[0])
        last = len(self.layers) - 1
        for k in range(1, last + 1):
            x = self.columns.dense(x.relu(), self.layers[k])
            if k < last:
                x = self.dropout(x)
        return x


class FcResidualBlock(nn.Module):
    """(Linear-BN-ReLU-Drop) x2, returning ``block(x) - x`` (QUIRKS.md)."""

    def __init__(self, hidden_dim, dropout):
        super().__init__()
        self.dense = nn.ModuleList(_dense(hidden_dim, hidden_dim)
                                   for _ in range(2))
        self.bn = nn.ModuleList(FlaxBatchNorm1d(hidden_dim)
                                for _ in range(2))
        self.dropout = FlaxDropout(dropout)
        self.columns = WHOLE

    def forward(self, x):
        h = x
        for dense, bn in zip(self.dense, self.bn):
            h = self.dropout(self.columns.dense(h, dense, bn).relu())
        return h - x


class FCResNet(nn.Module):
    """Linear stem + ReLU + `num_blocks` residual MLP blocks (+ out linear;
    `out_dim` None exposes the trunk's features). The VIPE* encoder
    (reference `models/module.py:178-190`)."""

    def __init__(self, input_dim, out_dim, num_blocks, hidden_dim,
                 dropout=0.3):
        super().__init__()
        self.stem = _dense(input_dim, hidden_dim)
        self.blocks = nn.ModuleList(FcResidualBlock(hidden_dim, dropout)
                                    for _ in range(num_blocks))
        self.out = _dense(hidden_dim, out_dim) if out_dim is not None \
            else None
        self.columns = WHOLE

    def forward(self, x):
        x = self.columns.dense(x, self.stem).relu()
        for block in self.blocks:
            x = block(x)
        return (self.columns.dense(x, self.out) if self.out is not None
                else x)


class _MultiHead(nn.Module):
    """All per-dataset linear heads as one einsum + dataset_id gather.

    Heads output `head_dim` (the largest target) features; each dataset
    reads only its own first columns (the train step masks the rest).
    """

    def __init__(self, num_heads, in_dim, head_dim):
        super().__init__()
        # flax's lecun normal on a (k, h, d) kernel: fan_in = k * h
        self.kernel = nn.Parameter(
            torch.randn(num_heads, in_dim, head_dim)
            * (num_heads * in_dim) ** -0.5)
        self.bias = nn.Parameter(torch.zeros(num_heads, head_dim))
        self.columns = WHOLE

    def forward(self, x, dataset_id):
        c = self.columns
        all_heads = c.gather(torch.einsum(
            'nh,khd->nkd', c.enter(x, self), self.kernel) + self.bias, self)
        idx = dataset_id.to(torch.long)[:, None, None].expand(
            -1, 1, all_heads.shape[-1])
        return all_heads.gather(1, idx).squeeze(1)


class FCPoseDecoder(nn.Module):
    """FCNet trunk -> ReLU -> per-dataset linear head (ref module.py:211-227).

    `target_dims` are the flattened 3D-feature sizes per dataset; heads are
    padded to the max and selected by `dataset_id`.
    """

    def __init__(self, input_dim, hidden_dims, target_dims, dropout=0.):
        super().__init__()
        assert len(hidden_dims) >= 2
        self.trunk = FCNet(input_dim, hidden_dims[:-1], hidden_dims[-1],
                           dropout=dropout)
        self.head = _MultiHead(len(target_dims), hidden_dims[-1],
                               max(target_dims))

    def forward(self, emb, dataset_id):
        return self.head(self.trunk(emb).relu(), dataset_id)


class FCResNetPoseDecoder(nn.Module):
    """FCResNet trunk -> per-dataset head (ref module.py:193-208)."""

    def __init__(self, input_dim, num_blocks, hidden_dim, target_dims,
                 dropout=0.):
        super().__init__()
        self.trunk = FCResNet(input_dim, None, num_blocks, hidden_dim,
                              dropout=dropout)
        self.head = _MultiHead(len(target_dims), hidden_dim,
                               max(target_dims))

    def forward(self, emb, dataset_id):
        return self.head(self.trunk(emb), dataset_id)
