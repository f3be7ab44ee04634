"""Ranks of the port's data mesh for the tests of `vpd_tpu_torch.core.mesh`.

`run_ranks(fn, n, tmp_path, ...)` spawns n processes that join one gloo
group on the CPU (`core.mesh.spawn_ranks`: rendezvous through a file
under `tmp_path`, so no two test workers race for a port; each spawn
joined within 110 s and killed after it, so a rank that hangs fails its
test), calls `fn(mesh, ...)` on each and returns their results in rank
order. A spawned child re-imports this module to find `fn`, so it
imports torch, numpy and the port only: never jax, vpd_tpu or the
tests' conftest.
"""

import os

import numpy as np
import torch

from vpd_tpu_torch.core.mesh import spawn_ranks


def run_ranks(fn, n, tmp_path, *args, **kwargs):
    """fn(mesh, *args, **kwargs) on n spawned gloo ranks; their results."""
    return spawn_ranks(fn, n, *args, workdir=str(tmp_path), **kwargs)


def rows(x, mesh):
    """This rank's rows of a global array."""
    from vpd_tpu_torch.core.mesh import part_rows
    return x[part_rows(len(x), mesh.batch_part)]


def numpy_state(model):
    return {k: v.detach().cpu().numpy().copy()
            for k, v in model.state_dict().items()}


def grads_of(model):
    return {k: p.grad.detach().cpu().numpy().copy()
            for k, p in model.named_parameters() if p.grad is not None}


# ----------------------------------------------------------- BatchNorm

def synced_bn(mesh, x, weight, bias, gy, momentum=0.9):
    """Rank's rows through a synced FlaxBatchNorm2d (x's dtype, on the
    mesh's device): output, input gradient, the affine terms' gradients
    (this rank's share) and the running statistics."""
    from vpd_tpu_torch.models.resnet import FlaxBatchNorm2d, set_bn_sync

    dev = mesh.device
    bn = FlaxBatchNorm2d(x.shape[1], momentum=momentum).to(
        dev, torch.from_numpy(x).dtype)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(weight))
        bn.bias.copy_(torch.from_numpy(bias))
    set_bn_sync(bn, mesh.data_group)
    xl = torch.from_numpy(rows(x, mesh)).to(dev).requires_grad_()
    y = bn.train()(xl)
    y.backward(torch.from_numpy(rows(gy, mesh)).to(dev))
    out = {'y': y, 'gx': xl.grad, 'gw': bn.weight.grad, 'gb': bn.bias.grad,
           'mean': bn.running_mean, 'var': bn.running_var}
    return {k: v.detach().cpu().numpy() for k, v in out.items()}


# ------------------------------------------------------------- student

def port_student(cfg, params, stats, dtype=torch.float64):
    """The port's student on flax trees (`tests/test_torch_train`)."""
    from vpd_tpu_torch.models.flax_weights import (load_encoder_from_flax,
                                                   load_motion_from_flax)
    from vpd_tpu_torch.train.vpd_loop import build_student

    model = build_student(cfg, dtype=dtype).to(dtype)
    load_encoder_from_flax(model.encoder, {
        'params': params['encoder'], 'batch_stats': stats['encoder']})
    if model.motion is not None:
        load_motion_from_flax(model.motion, {'params': params['motion'],
                                             'batch_stats': {}})
    return model


def student_update(mesh, cfg, params, stats, imgs, emb, lr, n_steps,
                   grad_scales=(1.,)):
    """For each scale in `grad_scales`: `n_steps` of fwd/bwd and AdamW on
    the rank's rows of one pre-augmented global batch, the gradients
    multiplied by the scale before AdamW (0.5 at world 2 is DDP's default
    mean): each step's local loss, the first step's gradients (summed
    over the ranks) and the final state."""
    from vpd_tpu_torch.train import vpd as tvpd

    runs = []
    for scale in grad_scales:
        model = port_student(cfg, params, stats)
        state = tvpd.create_state(model, lr, mesh=mesh)
        x, e = (torch.from_numpy(rows(a, mesh)) for a in (imgs, emb))
        losses, grads = [], None
        for _ in range(n_steps):
            losses.append(float(tvpd.forward_backward(state, x, e)))
            for p in model.parameters():
                p.grad.mul_(scale)
            if grads is None:
                grads = grads_of(model)
            tvpd.optimizer_step(state)
        runs.append({'losses': losses, 'grads': grads,
                     'state': numpy_state(model)})
    return runs


def student_step(mesh, cfg, params, stats, batch, seed, n_steps,
                 orders=('batch',)):
    """For each jitter order: `n_steps` of the port's fused train step
    (augmentation draws of the global batch, sliced) on the rank's rows
    of one uint8 global batch, all in float64: local losses and the final
    state."""
    from vpd_tpu_torch.train import vpd as tvpd

    runs = []
    for order in orders:
        model = port_student(cfg, params, stats)
        state = tvpd.create_state(model, cfg['learning_rate'], mesh=mesh)
        mean, std = cfg['rgb_mean_std']
        step = tvpd.make_train_step(mean, std, img_dim=cfg['img_dim'],
                                    use_flow=cfg['use_flow'],
                                    aug_dtype=torch.float64,
                                    jitter_order=order)
        local = {k: torch.from_numpy(rows(v, mesh))
                 for k, v in batch.items()}
        losses = [float(step(state, local, seed)['emb_loss_sum'])
                  for _ in range(n_steps)]
        runs.append({'losses': losses, 'state': numpy_state(model)})
    return runs


# ------------------------------------------------------------ the cache

def sharded_cache(mesh, samples, crop_dir, shard_dir, img_dim, batch_size,
                  n_batches):
    """A row-sharded DeviceCropCache and its index source on the rank:
    the staged partition, and `n_batches` local index batches with the
    pixel rows gathered by `cache_gather`."""
    from vpd_tpu_torch.data.hbm_cache import (CacheIndexSource,
                                              DeviceCropCache)
    from vpd_tpu_torch.data.shards import ShardReader
    from vpd_tpu_torch.train.vpd import cache_gather

    cache = DeviceCropCache(ShardReader(shard_dir, crop_root=crop_dir),
                            mesh=mesh, shard_rows=True, log=lambda *a: None)
    src = CacheIndexSource(samples, crop_dir, img_dim, batch_size,
                           target_len=2 * batch_size, seed=3, cache=cache,
                           batch_part=mesh.batch_part)
    batches = []
    for _ in range(n_batches):
        b = src.next_batch()
        b['rgb'] = cache_gather(cache.arrays, torch.from_numpy(b['idx']),
                                ('rgb',), cache.row_offset)['rgb'].numpy()
        batches.append(b)
    return {'rows_per_device': cache.rows_per_device,
            'arrays': {k: v.numpy() for k, v in cache.arrays.items()},
            'batches': batches}


def train_vpd_cli(mesh, emb_dir, crop_dir, shard_dir, save_dir):
    """`tools.train_vpd` on the rank with --hbm_cache_sharded: an epoch,
    then --resume to two; the (train, val) loss of every epoch."""
    from vpd_tpu_torch.tools import train_vpd as tcli

    tcli.CROP_DIRS['fs'] = crop_dir
    tcli.TRAIN_LEN, tcli.VAL_LEN = 8, 8
    kw = dict(dataset='fs', save_dir=save_dir, checkpoint_frequency=None,
              batch_size=8, learning_rate=5e-4, img_dim=32, flow_img=None,
              motion=False, encoder_arch='resnet18', model_select_window=5,
              pretrained=False, no_test_video=False, min_pose_score=None,
              emb_dir=emb_dir, seed=0, crop_shards=shard_dir,
              hbm_cache_sharded=True, device='cpu')
    tcli.main(num_epochs=1, **kw)
    trainer = tcli.main(num_epochs=2, resume=True, **kw)
    assert trainer.state.step == 2
    return [(r['train'], r['val']) for r in trainer.losses]


# ---------------------------------------------------------------- tasks

def apply_vpd_dp(mesh, videos, tasks, model_dir, out_dir, batch_size,
                 flow_img_name=None, cli=None):
    """`infer.apply_vpd` with the mesh, float32 (rank 0 writes), with
    kernel B1's twin counted on each rank; then, with `cli` (a kwargs
    dict), `tools.apply_vpd --data_parallel`, whose refusal message is
    returned."""
    from vpd_tpu_torch.infer import apply_vpd as tapply
    from vpd_tpu_torch.ops import preprocess as pre
    from vpd_tpu_torch.tools import apply_vpd as tcli

    calls = []
    twin = pre.preprocess_orig_and_flip
    tapply.preprocess_orig_and_flip = lambda *a, **k: (
        calls.append(a[0].shape[0]), twin(*a, **k))[1]
    prepared = tapply.load_student_dir(model_dir, dtype=torch.float32,
                                       device='cpu')
    tapply.apply_vpd(videos, tasks, model_dir, out_dir,
                     flow_img_name=flow_img_name, batch_size=batch_size,
                     prepared=prepared, mesh=mesh, log=lambda *a: None)
    refusal = None
    if cli is not None:
        try:
            tcli.main(data_parallel=True, device='cpu', **cli)
        except SystemExit as exc:
            refusal = str(exc)
    return {'chunks': calls, 'refusal': refusal}


def compute_flow_dp(mesh, root, out_name, batch_size):
    """`tools.compute_flow --data_parallel --model lk` on the rank: the
    count it returns and the pairs this rank wrote."""
    from vpd_tpu_torch.tools import compute_flow as tcli

    import cv2

    written = []
    imwrite = cv2.imwrite

    def counted(path, *a):
        written.append(path)
        return imwrite(path, *a)

    cv2.imwrite = counted
    n = tcli.main(root, out_name, 20, 32, batch_size, False,
                  data_parallel=True, device='cpu')
    return {'count': n, 'written': sorted(written)}


def _fed_heads(init_variables):
    """Make every member of the port's sequence heads start from
    vpd_tpu's initial weights."""
    from vpd_tpu_torch.models.flax_weights import load_seq_head_from_flax
    from vpd_tpu_torch.train import classifier as tc
    from vpd_tpu_torch.train import fused_sweep as tfs

    make = tc.make_model

    def fed(*args, **kwargs):
        return load_seq_head_from_flax(make(*args, **kwargs).double(),
                                       init_variables)

    tfs.make_model = fed


def fused_sweep_dp(mesh, init_variables, X, y, member_rows, X_val, y_val,
                   kwargs):
    """The fused sweep with its members split over the ranks (float64,
    from vpd_tpu's initial weights): every member's trees, on each
    rank."""
    from vpd_tpu_torch.train.fused_sweep import FusedSweepTrainer

    _fed_heads(init_variables)
    fused = FusedSweepTrainer('gru', X, y, member_rows, X_val=X_val,
                              y_val=y_val, mesh=mesh, dtype=torch.float64,
                              **kwargs)
    return {'members': [fused.member(i) for i in range(len(member_rows))],
            'best_epoch': fused.best_epoch, 'stopped': fused.stopped,
            'local': next(fused.model.parameters()).shape[0]}


def recognition_dp(mesh, args, out_dir, kwargs):
    """`run_action_recognition` (gru, fused) with the mesh; the
    accuracies, and whether this rank wrote `out_dir`."""
    from vpd_tpu_torch.tasks import recognize as trec

    accs = trec.run_action_recognition(*args, out_dir, 'gru', mesh=mesh,
                                       fused_sweep=True,
                                       log=lambda *a: None, **kwargs)
    return accs


def localization_dp(mesh, inits, emb, train, test, kwargs):
    """`tasks.detect.run_localization` with the fused ensemble's members
    split over the ranks, each member from vpd_tpu's initial weights
    (`inits` by fold seed): the AP tables."""
    from vpd_tpu_torch.models.flax_weights import load_proposal_from_flax
    from vpd_tpu_torch.tasks import detect as tdet
    from vpd_tpu_torch.train import proposal as tprop

    tprop.init_member = lambda model, m, s: load_proposal_from_flax(
        model, inits[s], member=m)
    got, thresholds = tdet.run_localization(
        'fs_jump', emb, train, test, device='cpu', mesh=mesh,
        log=lambda *a: None, **kwargs)
    return got, thresholds


# -------------------------------------------------------------- teacher

def teacher_model(kp_dims, emb, hidden, dec, in_dim, dropout=0.):
    """The port's teacher of tests/test_torch_vipe.py's shape."""
    from vpd_tpu_torch.models.fc import FCPoseDecoder, FCResNet
    from vpd_tpu_torch.train.vipe import VIPEModel

    targets = tuple(max(d, 1) for d in kp_dims)
    return VIPEModel(FCResNet(in_dim, emb, 2, hidden, dropout=dropout),
                     FCPoseDecoder(emb, (dec, dec), targets))


def teacher_steps(mesh, variables, shapes, kp_mask, batches, lr,
                  dropouts=(0.,), model_group=1):
    """For each dropout rate: the teacher's float64 train steps on the
    rank's rows of each global batch, from flax `variables`; on a (data,
    model) grid of `model_group` columns when above 1. Each step's local
    loss sum, the first step's gradients before AdamW and the final
    state (whole arrays, gathered over the model group), and the names
    split over it."""
    from vpd_tpu_torch.core.mesh import get_mesh_2d, shard_batch
    from vpd_tpu_torch.models.flax_weights import load_vipe_from_flax
    from vpd_tpu_torch.models.tensor_parallel import (full_tensors,
                                                      shard_vipe_model)
    from vpd_tpu_torch.train import vipe as tvipe
    from vpd_tpu_torch.train.vpd import create_state

    if model_group > 1:
        mesh = get_mesh_2d(model_group, device='cpu')
    runs = []
    for rate in dropouts:
        model = teacher_model(**shapes, dropout=rate).double()
        load_vipe_from_flax(model, variables)
        dims = {}
        if model_group > 1:
            dims = shard_vipe_model(model, mesh)
        state = create_state(model, lr, mesh=mesh)
        step = tvipe.make_train_step(kp_mask)
        losses, grads = [], None
        for b in batches:
            local = {k: v.double() if v.dtype == torch.float32 else v
                     for k, v in shard_batch(b, mesh).items()}
            losses.append(float(step(state, local, 0)['loss_sum']))
            if grads is None:
                grads = full_tensors({k: p.grad for k, p in
                                      model.named_parameters()}, dims, mesh)
        full = full_tensors(model.state_dict(), dims, mesh)
        runs.append({'losses': losses,
                     'grads': {k: v.numpy() for k, v in grads.items()},
                     'state': {k: v.numpy() for k, v in full.items()},
                     'sharded': sorted(dims)})
    return runs


class _Batches:
    """A fused batcher's interface over given global batches."""

    def __init__(self, batches, kp_dims, kp_mask):
        self.batches = list(batches)
        self.kp_dims = kp_dims
        self._mask = kp_mask
        self.num_batches = len(self.batches) - 1
        self.i = 0

    def kp_mask(self):
        return self._mask

    def next_batch(self):
        b = self.batches[self.i % len(self.batches)]
        self.i += 1
        return b


def teacher_trainer_tp(mesh, config, batches, kp_dims, kp_mask, save_dir):
    """`VIPETrainer` on a (1, 2) grid: an epoch with a checkpoint that rank
    0 writes whole, then a second trainer resuming it; the epoch's loss,
    and whether the resumed trainer's blocks equal the first's."""
    from vpd_tpu_torch.core.mesh import get_mesh_2d
    from vpd_tpu_torch.train.vipe_loop import VIPETrainer

    grid = get_mesh_2d(2, device='cpu')

    def trainer():
        return VIPETrainer(_Batches(batches, kp_dims, kp_mask), None,
                           config, save_dir=save_dir, mesh=grid, seed=0)

    first = trainer()
    first.save_config()
    train_m, _ = first.train_one_epoch(1)
    first.close()
    second = trainer()
    assert second.resume() == 2
    second.close()
    same = all(torch.equal(a, b) for a, b in zip(
        first.model.state_dict().values(),
        second.model.state_dict().values()))
    moments = [first.state.optimizer.state[p]['exp_avg']
               for p in first.model.parameters()]
    again = [second.state.optimizer.state[p]['exp_avg']
             for p in second.model.parameters()]
    return {'loss': train_m['loss'], 'same': same and all(
        torch.equal(a, b) for a, b in zip(moments, again)),
        'step': second.state.step}


def card_student_step(mesh, batch, dtype=torch.float32):
    """One step in `dtype` (TF32 off) of a ResNet-18 student with flow and
    masks on the rank's rows, on the mesh's card: the local loss, rank
    0's gradients before AdamW and the BN running statistics."""
    from vpd_tpu_torch.train import vpd as tvpd
    from vpd_tpu_torch.train.vpd_loop import build_student, default_config

    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = default_config('fs', 8, img_dim=32, use_flow=True,
                         encoder_arch='resnet18')
    torch.manual_seed(0)
    model = build_student(cfg, dtype=dtype).to(mesh.device, dtype)
    state = tvpd.create_state(model, 1e-3, mesh=mesh)
    step = tvpd.make_train_step(*cfg['rgb_mean_std'], img_dim=32,
                                use_flow=True, aug_dtype=dtype)
    local = {k: torch.from_numpy(rows(v, mesh)).to(mesh.device)
             for k, v in batch.items()}
    local['emb'] = local['emb'].to(dtype)
    try:
        out = {'loss': float(step(state, local, 3)['emb_loss_sum'])}
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
    if mesh.rank == 0:
        out['grads'] = {k: p.grad.cpu().numpy()
                        for k, p in model.named_parameters()}
        out['stats'] = {k: b.cpu().numpy() for k, b in model.named_buffers()
                        if 'running' in k}
    return out


def epoch_sums_over_world(mesh):
    """The epoch metrics' all-reduces (`core.mesh.all_reduce_sum`, through
    the teacher's `run_epoch`) over the world group of the rank's backend,
    which a one-process mesh never reduces over: NCCL takes no host
    tensor. Returns the backend, the sums and the epoch's metrics."""
    import dataclasses
    import types

    import torch.distributed as dist
    from vpd_tpu_torch.core.mesh import all_reduce_sum
    from vpd_tpu_torch.train.vipe import run_epoch

    grouped = dataclasses.replace(mesh, data_group=dist.group.WORLD)
    dev = mesh.device
    metrics = {'loss_sum': torch.tensor(3., device=dev),
               'contra_sum': torch.tensor(1., device=dev),
               'n': torch.tensor(2., device=dev),
               'ds_loss_sum': torch.tensor([1., 2.], device=dev),
               'ds_count': torch.tensor([1., 4.], device=dev)}
    epoch = run_epoch(types.SimpleNamespace(next_batch=lambda: None),
                      types.SimpleNamespace(mesh=grouped),
                      lambda state, batch: metrics, 2, train=False)
    return {'backend': dist.get_backend(),
            'scalar': all_reduce_sum(5., grouped),
            'array': all_reduce_sum([1., 2.], grouped).tolist(),
            'epoch': epoch}


def train_vipe_cli(mesh, root, save_dir, kwargs):
    """`tools.train_vipe` on the rank, its loaders pointed at chip_smoke's
    mocap corpus under `root` and each family's virtual epoch cut to 64
    train and 32 val rows (as tests/test_torch_apply_vipe.py's `mocap`
    fixture does in process); the epochs' (train, val) losses."""
    import dataclasses

    import chip_smoke
    from vpd_tpu_torch.data import vipe_sampler as tvs
    from vpd_tpu_torch.tools import train_vipe as tcli

    for fam, (loader, _, _) in list(tcli.LOADERS.items()):
        base = os.path.join(root, chip_smoke.MOCAP_DIRS[fam])
        tcli.LOADERS[fam] = (loader, os.path.join(base, 'cocopose'),
                             os.path.join(base, 'ground_truth_3d_pose.pkl'))
        tvs.FAMILIES[fam] = dataclasses.replace(
            tvs.FAMILIES[fam], train_target_len=64, val_target_len=32)
    tcli.paths.PEOPLE_3D_KEYPOINT_DIR = os.path.join(root, '3dpeople',
                                                     'cocopose')
    trainer = tcli.main(save_dir=save_dir, **kwargs)
    return [(r['train'], r['val']) for r in trainer.losses]
