"""Process groups for data and tensor parallelism: one process per GPU.

Counterpart of `vpd_tpu/core/mesh.py`. vpd_tpu runs one process over a
`jax.sharding.Mesh` of devices and lets jit insert the collectives; the
port runs one process (a rank) per card, launched by `torchrun`, and its
collectives are explicit `torch.distributed` calls. A step on the mesh
computes what the same step computes on one device:

- the global batch is drawn on every rank from the same seeded streams,
  and rank r takes rows [r*B/n, (r+1)*B/n) of it (`shard_batch`,
  `batch_part`), decoding only those;
- the losses are raw sums over the global batch, so gradients are summed
  over the data group (`all_reduce_grads`), never averaged;
- BatchNorm statistics are global: `models/resnet._FlaxBatchNorm` sums
  its per-channel statistics over the data group in train mode;
- metrics are summed over the data group, and only the primary rank
  (`is_primary`) writes files.

A (data, model) grid (`get_mesh_2d`) adds the teacher's tensor
parallelism (`models/tensor_parallel.py`): the arrays
`tensor_parallel_shardings` shards are split by columns over the model
group. Every process group is made with a timeout (`TIMEOUT`), so a rank
that fails cannot leave its peers blocked in a collective for longer.

vpd_tpu's `step_sync_needed` works around a deadlock of XLA's CPU
communicator when two sharded programs are in flight; torch's collectives
run in program order on every backend, so it has no counterpart here.
"""

import contextlib
import dataclasses
import datetime
import multiprocessing as mp
import os
import pickle
import tempfile
import time
import traceback

import numpy as np
import torch

DATA_AXIS = 'data'
MODEL_AXIS = 'model'
TIMEOUT = datetime.timedelta(seconds=60)
SPAWN_SECONDS = 110


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """This rank's place on a (data, model) grid of processes.

    `data_group` joins the ranks that hold the same model shard (the ones
    a data-parallel collective runs over), `model_group` the ranks of one
    data shard; either is None where its axis has size 1. `axis_names`
    are the mesh's axes, as JAX's: ('data',) for `get_mesh`, ('data',
    'model') for `get_mesh_2d`."""

    device: torch.device
    world: int = 1
    rank: int = 0
    data_size: int = 1
    data_rank: int = 0
    model_size: int = 1
    model_rank: int = 0
    data_group: object = None
    model_group: object = None
    axis_names: tuple = (DATA_AXIS,)

    @property
    def size(self):
        return self.world

    @property
    def shape(self):
        sizes = {DATA_AXIS: self.data_size, MODEL_AXIS: self.model_size}
        return {a: sizes[a] for a in self.axis_names}

    @property
    def batch_part(self):
        """(index, count): this rank's block of every global batch."""
        return self.data_rank, self.data_size


def _dist():
    import torch.distributed as dist
    return dist if dist.is_available() and dist.is_initialized() else None


def get_mesh(device=None, axis_name=DATA_AXIS):
    """The 1-D data mesh over every rank of the process group (world 1
    without one), on `device` (CUDA by default: the current device, which
    `init_distributed` sets to the rank's card)."""
    from .. import resolve_device

    assert axis_name == DATA_AXIS, axis_name
    device = resolve_device(device)
    dist = _dist()
    if dist is None or dist.get_world_size() == 1:
        return Mesh(device)
    n, r = dist.get_world_size(), dist.get_rank()
    return Mesh(device, world=n, rank=r, data_size=n, data_rank=r,
                data_group=dist.group.WORLD)


def get_mesh_2d(num_model=2, device=None):
    """A (data, model) grid: rank r is data index r // num_model and model
    index r % num_model, so a model group is num_model adjacent ranks (the
    GPUs of one NVLink island under torchrun's numbering), as vpd_tpu puts
    the model axis on adjacent devices. Every rank must call it, in the
    same order: it makes the groups."""
    base = get_mesh(device)
    n = base.world
    if n % num_model:
        raise ValueError('{} ranks do not split into model groups of {}'
                         .format(n, num_model))
    d = n // num_model
    dist = _dist()
    data_group = model_group = None
    if dist is not None:
        # every rank makes every group, in one order (new_group's rule)
        for j in range(num_model):
            g = dist.new_group([i * num_model + j for i in range(d)],
                               timeout=TIMEOUT)
            if j == base.rank % num_model:
                data_group = g
        for i in range(d):
            g = dist.new_group(list(range(i * num_model,
                                          (i + 1) * num_model)),
                               timeout=TIMEOUT)
            if i == base.rank // num_model:
                model_group = g
    return Mesh(base.device, world=n, rank=base.rank, data_size=d,
                data_rank=base.rank // num_model, model_size=num_model,
                model_rank=base.rank % num_model,
                data_group=data_group if d > 1 else None,
                model_group=model_group if num_model > 1 else None,
                axis_names=(DATA_AXIS, MODEL_AXIS))


def torchrun_world():
    """The world size torchrun's environment gives this process (1
    without torchrun)."""
    return int(os.environ.get('WORLD_SIZE', '1'))


def init_distributed(device=None, backend=None, init_method=None,
                     world_size=None, rank=None, timeout=TIMEOUT):
    """Join the process group and return the data mesh.

    Without arguments it reads torchrun's environment (WORLD_SIZE, RANK,
    LOCAL_RANK, MASTER_ADDR, MASTER_PORT): on CUDA rank r takes
    `cuda:LOCAL_RANK` and NCCL (at world 1 too); with `device='cpu'` the
    ranks take gloo. Outside torchrun (no WORLD_SIZE) no group is made:
    world 1 on `device`. Callers that spawn their own ranks pass
    `init_method`, `world_size` and `rank`, and may pass `backend` and
    `device` explicitly (gloo ranks sharing one card). A second call
    returns the mesh of the group already joined."""
    from .. import resolve_device
    import torch.distributed as dist

    if dist.is_initialized():
        return get_mesh(device)
    if world_size is None:
        if 'WORLD_SIZE' not in os.environ:
            return get_mesh(device)
        world_size = torchrun_world()
        rank = int(os.environ.get('RANK', '0'))
        init_method = init_method or 'env://'
    device = torch.device('cuda' if device is None else device)
    if device.type == 'cuda' and device.index is None:
        device = torch.device('cuda', int(os.environ.get('LOCAL_RANK', '0')))
    device = resolve_device(device)
    if backend is None:
        backend = 'nccl' if device.type == 'cuda' else 'gloo'
    if device.type == 'cuda':
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank,
                            timeout=timeout)
    return get_mesh(device)


def shutdown():
    """Leave the process group, if this process joined one."""
    dist = _dist()
    if dist is not None:
        dist.destroy_process_group()


@contextlib.contextmanager
def distributed(device=None):
    """`init_distributed(device)` for an entry point: yields the mesh and
    leaves on exit the group it joined (one joined before is kept), and
    prints the world size it runs at on the primary rank."""
    joined = _dist() is None
    mesh = init_distributed(device)
    if is_primary():
        dist = _dist()
        print('world size {} ({} on {})'.format(
            mesh.world, dist.get_backend() if dist is not None
            else 'no process group', mesh.device.type), flush=True)
    try:
        yield mesh
    finally:
        if joined:
            shutdown()


def refuse_devices_without_torchrun(device):
    """`--data_parallel` outside torchrun on a host with several visible
    GPUs: raise rather than run on one of them."""
    if ('WORLD_SIZE' not in os.environ
            and torch.device(device).type == 'cuda'
            and torch.cuda.is_available() and torch.cuda.device_count() > 1):
        raise SystemExit(
            '--data_parallel runs one process per GPU: launch it with '
            'torchrun --nproc_per_node {} -m ... (this host has {} GPUs)'
            .format(torch.cuda.device_count(), torch.cuda.device_count()))


def is_primary():
    """True on the rank that writes checkpoints and outputs (rank 0)."""
    dist = _dist()
    return dist is None or dist.get_rank() == 0


def local_batch_size(global_batch_size, mesh=None):
    """Rows of a global batch each data rank holds."""
    n = (mesh if mesh is not None else get_mesh('cpu')).data_size
    assert global_batch_size % n == 0, \
        'global batch {} not divisible by {} devices'.format(
            global_batch_size, n)
    return global_batch_size // n


def part_rows(n, part):
    """The slice of rows [i*n/k, (i+1)*n/k) of an n-row global batch that
    part (i, k) holds."""
    i, k = part
    if n % k:
        raise ValueError('global batch {} not divisible by {} ranks'
                         .format(n, k))
    return slice(i * n // k, (i + 1) * n // k)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return None if tree is None else fn(tree)


def shard_batch(batch, mesh, axis_name=DATA_AXIS):
    """This rank's rows of a global host batch (a tree of arrays or
    tensors), on the mesh's device. At world 1 the whole batch."""
    assert axis_name == DATA_AXIS, axis_name

    def take(x):
        t = torch.as_tensor(x)
        if mesh.data_size > 1:
            t = t[part_rows(t.shape[0], mesh.batch_part)]
        return t.to(mesh.device, non_blocking=True)

    return _tree_map(take, batch)


class LocalRows:
    """A batch source's global batches cut to part `part`'s rows (host
    arrays): each rank of a data mesh draws the global batch from the
    same seeded streams and keeps its rows. Other attributes are the
    source's."""

    def __init__(self, source, part):
        self.source = source
        self.part = part

    def __getattr__(self, name):
        if name == 'source':  # not set yet (a copy being built)
            raise AttributeError(name)
        return getattr(self.source, name)

    def next_batch(self):
        batch = self.source.next_batch()
        if self.part[1] == 1:
            return batch
        rows = part_rows(len(next(iter(batch.values()))), self.part)
        return {k: v[rows] for k, v in batch.items()}


def replicate(tree, mesh):
    """Broadcast a tree of tensors (or a module's parameters and buffers)
    from rank 0 to every rank, in place; returns the tree."""
    dist = _dist()
    tensors = (list(tree.parameters()) + list(tree.buffers())
               if isinstance(tree, torch.nn.Module) else None)
    if dist is not None and mesh.world > 1:
        if tensors is None:
            tensors = []
            _tree_map(tensors.append, tree)
        with torch.no_grad():
            for t in tensors:
                dist.broadcast(t.data, src=0)
    return tree


def member_axis_placement(mesh, members, axis_name=DATA_AXIS):
    """Stacked-member fan-out (fused sweeps and ensembles): vpd_tpu's rule.

    A mesh is usable only when it has more than one rank along
    `axis_name`; the member list is then padded to a multiple of the
    axis size with copies of member 0 (pad members train but are never
    read back), and rank i holds the i-th contiguous block of members.
    Returns (mesh or None, the padded members, put_m, put_r): `put_m`
    takes this rank's block of the leading axis of a list, array or
    tensor (or of each leaf of a dict); `put_r` returns its argument
    (every rank holds the replicated values already)."""
    size = 0 if mesh is None else mesh.shape.get(axis_name, 1)
    members = list(members)
    ident = lambda t: t  # noqa: E731
    if size <= 1:
        return None, members, ident, ident
    members += [members[0]] * ((-len(members)) % size)
    rows = part_rows(len(members), (mesh.data_rank if axis_name == DATA_AXIS
                                    else mesh.model_rank, size))

    def put_m(t):
        if isinstance(t, dict):
            return {k: put_m(v) for k, v in t.items()}
        return t[rows]

    return mesh, members, put_m, ident


def pad_batch_to(batch, n, pad_mask_key=None):
    """Pad every leaf's dim 0 to `n` (static shapes => no re-jitting).

    Optionally adds a {pad_mask_key: bool (n,)} marking real rows.
    """
    def pad(x):
        x = np.asarray(x)
        if x.shape[0] == n:
            return x
        pad_width = [(0, n - x.shape[0])] + [(0, 0)] * (x.ndim - 1)
        return np.pad(x, pad_width)

    size = len(next(iter(batch.values())))
    out = {k: pad(v) for k, v in batch.items()}
    if pad_mask_key is not None:
        mask = np.zeros(n, dtype=bool)
        mask[:size] = True
        out[pad_mask_key] = mask
    return out


# ------------------------------------------------------------ collectives

def all_reduce_grads(params, group):
    """Sum the gradients of `params` over `group` (a no-op for None): the
    losses are raw sums over the global batch, so the global gradient is
    the sum of the ranks' gradients. One flat buffer a dtype and device."""
    dist = _dist()
    if group is None or dist is None:
        return
    grads = {}
    for p in params:
        if p.grad is not None:
            grads.setdefault((p.grad.dtype, p.grad.device), []).append(p.grad)
    for gs in grads.values():
        flat = torch.cat([g.reshape(-1) for g in gs])
        dist.all_reduce(flat, group=group)
        pos = 0
        for g in gs:
            g.copy_(flat[pos:pos + g.numel()].view_as(g))
            pos += g.numel()


class _AllReduceSum(torch.autograd.Function):
    """Sum over a group whose backward sums the incoming gradients over it
    too (each rank's loss depends on the sum): what torch.distributed.nn.
    functional.all_reduce computes, without its deprecation."""

    @staticmethod
    def forward(ctx, tensor, group):
        ctx.group = group
        out = tensor.clone(memory_format=torch.contiguous_format)
        _dist().all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return _AllReduceSum.apply(grad, ctx.group), None


def differentiable_all_reduce(tensor, group):
    """The sum of `tensor` over `group`, differentiable (see
    `_AllReduceSum`)."""
    return _AllReduceSum.apply(tensor, group)


def all_reduce_sum(values, mesh):
    """Sum float64 host values (a number or an array) over the data group
    of `mesh`; the values as they are without a mesh or a data group. The
    sum runs on the mesh's device, since NCCL takes no host tensor."""
    dist = _dist()
    if mesh is None or mesh.data_group is None or dist is None:
        return values
    t = torch.tensor(np.asarray(values, np.float64), device=mesh.device)
    dist.all_reduce(t, group=mesh.data_group)
    t = t.cpu()
    return t.item() if t.ndim == 0 else t.numpy()


def all_gather_object(obj, group=None):
    """Every rank's `obj` in rank order of `group` (the whole world for
    None); [obj] without a process group."""
    dist = _dist()
    if dist is None:
        return [obj]
    out = [None] * dist.get_world_size(group)
    dist.all_gather_object(out, obj, group=group)
    return out


def gather_object(obj, mesh):
    """Every rank's `obj` in rank order on rank 0 (None on the others);
    [obj] without a mesh or at world 1."""
    dist = _dist()
    if dist is None or mesh is None or mesh.world == 1:
        return [obj]
    out = [None] * mesh.world if mesh.rank == 0 else None
    dist.gather_object(obj, out, dst=0)
    return out


def barrier():
    dist = _dist()
    if dist is not None:
        dist.barrier()


def broadcast_object(obj, mesh):
    """Rank 0's `obj` on every rank."""
    dist = _dist()
    if dist is None or mesh is None or mesh.world == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


# ------------------------------------------------------- tensor parallel

def tensor_parallel_shardings(tree, mesh, model_axis=MODEL_AXIS,
                              min_cols=None):
    """vpd_tpu's shape rule, in flax's layout: an array whose trailing
    (output-feature) dimension divides by the model axis and is at least
    `min_cols` (2m by default) is split along it, every other one is
    replicated. Returns the tree of specs as tuples, as JAX's
    PartitionSpec lists them: (None, ..., 'model') or ()."""
    m = mesh.shape[model_axis]
    min_cols = 2 * m if min_cols is None else min_cols

    def spec(x):
        shape = np.shape(x)
        if len(shape) >= 1 and shape[-1] % m == 0 and shape[-1] >= min_cols:
            return (None,) * (len(shape) - 1) + (model_axis,)
        return ()

    return _tree_map(spec, tree)


# ------------------------------------------------ ranks in one host's CPU

def _spawned_rank(fn, rank, n, init, out, device, backend, args, kwargs):
    torch.set_num_threads(1)
    try:
        mesh = init_distributed(device=device, backend=backend,
                                init_method=init, world_size=n, rank=rank)
        result = ('ok', fn(mesh, *args, **kwargs))
    except BaseException:
        with open(out, 'wb') as f:
            pickle.dump(('error', traceback.format_exc()), f)
        raise
    with open(out, 'wb') as f:
        pickle.dump(result, f)
    shutdown()


def spawn_ranks(fn, n, *args, workdir=None, timeout=SPAWN_SECONDS,
                device='cpu', backend='gloo', **kwargs):
    """fn(mesh, *args, **kwargs) on n spawned processes joined in one group
    (gloo ranks on the CPU by default; `device='cuda:0'` puts every rank
    on that one card, which gloo allows and NCCL does not); their results
    in rank order. The rendezvous is a file under `workdir` (a new
    temporary dir by default), so concurrent callers never race for a
    port. Each child re-imports the module that defines `fn`. The
    children are joined within `timeout` seconds and killed after it; a
    rank that fails or hangs raises here."""
    if workdir is not None:
        os.makedirs(workdir, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=workdir) as tmp:
        init = 'file://' + os.path.join(tmp, 'rendezvous')
        outs = [os.path.join(tmp, 'rank{}.pkl'.format(r)) for r in range(n)]
        ctx = mp.get_context('spawn')
        procs = [ctx.Process(target=_spawned_rank,
                             args=(fn, r, n, init, outs[r], device, backend,
                                   args, kwargs))
                 for r in range(n)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        try:
            for p in procs:
                p.join(max(0., deadline - time.monotonic()))
        finally:
            hung = [r for r, p in enumerate(procs) if p.is_alive()]
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
        results = []
        for r, out in enumerate(outs):
            if not os.path.exists(out):
                raise RuntimeError(
                    'rank {} gave no result (exit code {}{})'.format(
                        r, procs[r].exitcode, ', killed after {} s'.format(
                            timeout) if r in hung else ''))
            with open(out, 'rb') as f:
                status, value = pickle.load(f)
            if status != 'ok':
                raise RuntimeError('rank {} failed:\n{}'.format(r, value))
            results.append(value)
        return results
