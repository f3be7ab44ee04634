"""Tensor parallelism for the VIPE* teacher on a (data, model) grid.

Counterpart of vpd_tpu's tensor-parallel placement (`vpd_tpu/core/mesh.
py`, `tensor_parallel_shardings`; `vpd_tpu/train/vipe_loop.py`), where
GSPMD partitions the jitted step. Here the partition is explicit, on the
model group of `core.mesh.get_mesh_2d`:

- The arrays vpd_tpu's shape rule shards are split by their output
  features (flax's trailing dimension: dim 0 of an `nn.Linear` weight,
  which torch stores transposed): each model rank holds one contiguous
  block of columns of every Dense kernel and bias, BatchNorm scale,
  bias and statistics, and per-dataset decoder head whose width divides
  by m and is at least 2m. AdamW's moments follow their parameters.
- Each rank computes its block of a split layer's outputs, and a
  BatchNorm after it acts on the block (its statistics over the data
  group alone, the features being whole on each rank); the full row is
  gathered over the model group before ReLU, dropout, the next
  contraction, the residual subtraction and the decoder's head
  selection. The fc modules' own forwards do this through their
  `columns` (`models/fc.Columns`), which this module sets.
- The gather's backward keeps this rank's slice of the incoming
  gradient, which every model rank holds whole (the layers after it run
  replicated), as Megatron's gather does; a sharded layer's input passes
  through an identity whose backward sums the input's gradient over the
  model group, each rank having contributed its columns' share.
- Dropout acts on the gathered rows, so the grid draws the masks one
  process draws.

`shard_vipe_model` splits a replicated model in place and sets its
columns; `full_tensors` and `local_tensors` move a model's named
tensors (parameters, buffers or AdamW moments) between the two layouts.
"""

import numpy as np
import torch
from torch import nn

from ..core.mesh import _dist, part_rows, tensor_parallel_shardings
from .fc import Columns, FCNet, FCResNet, FcResidualBlock, _MultiHead
from .resnet import FlaxBatchNorm1d


class _Gather(torch.autograd.Function):
    """The full rows from every model rank's column block (all-gather on
    the last dimension); backward: this rank's columns of the gradient."""

    @staticmethod
    def forward(ctx, x, group, rank, size):
        ctx.cols = (rank, size)
        parts = [torch.empty_like(x) for _ in range(size)]
        _dist().all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=-1)

    @staticmethod
    def backward(ctx, grad):
        cols = part_rows(grad.shape[-1], ctx.cols)
        return grad[..., cols].contiguous(), None, None, None


class _Enter(torch.autograd.Function):
    """Identity into a column-sharded layer; backward sums the input's
    gradient over the model group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous()
        _dist().all_reduce(grad, group=ctx.group)
        return grad, None


class _Columns(Columns):
    """The model group's split of the layers in `sharded`: each rank
    computes its block of their output columns."""

    def __init__(self, mesh, sharded):
        self.group = mesh.model_group
        self.rank = mesh.model_rank
        self.size = mesh.model_size
        self.sharded = sharded

    def enter(self, x, layer):
        return _Enter.apply(x, self.group) if layer in self.sharded else x

    def gather(self, y, layer):
        return (_Gather.apply(y, self.group, self.rank, self.size)
                if layer in self.sharded else y)


def _slice_(module, name, dim, cols):
    """Replace parameter or buffer `name` of `module` by its columns."""
    t = getattr(module, name)
    idx = [slice(None)] * t.dim()
    idx[dim] = cols
    local = t.detach()[tuple(idx)].clone()
    if isinstance(t, nn.Parameter):
        setattr(module, name, nn.Parameter(local,
                                           requires_grad=t.requires_grad))
    else:
        setattr(module, name, local)


def sharded_dims(model, mesh):
    """{tensor name: the dim split over the model group} of a replicated
    teacher's parameters and buffers (`model.state_dict()` names): those
    `core.mesh.tensor_parallel_shardings` shards in flax's layout, where
    an `nn.Linear` weight is the transposed kernel (so its dim 0 splits)
    and every other tensor splits its last dim."""
    flax_shapes, dims = {}, {}
    for name, t in model.state_dict().items():
        mod = model.get_submodule(name.rpartition('.')[0])
        linear = isinstance(mod, nn.Linear) and name.endswith('.weight')
        flax_shapes[name] = np.broadcast_to(
            np.float32(0), tuple(t.shape)[::-1] if linear else t.shape)
        dims[name] = 0 if linear else t.dim() - 1
    specs = tensor_parallel_shardings(flax_shapes, mesh)
    out = {name: dims[name] for name, spec in specs.items() if spec}
    for name in out:
        mod = model.get_submodule(name.rpartition('.')[0])
        if not isinstance(mod, (nn.Linear, FlaxBatchNorm1d, _MultiHead)):
            raise ValueError('{} would be split, but a {} has no column-'
                             'split forward'.format(name, type(mod).__name__))
    return out


def shard_vipe_model(model, mesh):
    """Split a replicated teacher (`train.vipe.VIPEModel`) over the mesh's
    model group in place, and give its fc modules the group's columns.
    Returns `sharded_dims`' map."""
    dims = sharded_dims(model, mesh)
    for name, dim in dims.items():
        path, leaf = name.rsplit('.', 1)
        mod = model.get_submodule(path)
        _slice_(mod, leaf, dim, part_rows(getattr(mod, leaf).shape[dim],
                                          (mesh.model_rank,
                                           mesh.model_size)))
    sharded = set()
    for mod_name, mod in model.named_modules():
        if isinstance(mod, nn.Linear):
            mod.out_features = mod.weight.shape[0]
            if mod_name + '.weight' in dims:
                sharded.add(mod)
        elif isinstance(mod, FlaxBatchNorm1d):
            mod.num_features = mod.weight.shape[0]
        elif isinstance(mod, _MultiHead) and mod_name + '.kernel' in dims:
            sharded.add(mod)
    columns = _Columns(mesh, sharded)
    for mod in model.modules():
        if isinstance(mod, (FCNet, FcResidualBlock, FCResNet, _MultiHead)):
            mod.columns = columns
    return dims


def full_tensors(tensors, dims, mesh):
    """{name: full tensor} from {name: this rank's tensor}: the sharded
    ones gathered over the model group (a collective every model rank
    makes), the rest as they are."""
    out = {}
    for name, t in tensors.items():
        if name not in dims:
            out[name] = t
            continue
        parts = [torch.empty_like(t) for _ in range(mesh.model_size)]
        _dist().all_gather(parts, t.contiguous(), group=mesh.model_group)
        out[name] = torch.cat(parts, dim=dims[name])
    return out


def local_tensors(tensors, dims, mesh):
    """This rank's blocks of {name: full tensor}."""
    out = {}
    for name, t in tensors.items():
        if name in dims:
            idx = [slice(None)] * t.dim()
            idx[dims[name]] = part_rows(t.shape[dims[name]],
                                        (mesh.model_rank, mesh.model_size))
            t = t[tuple(idx)]
        out[name] = t
    return out
