"""VPD student training loop: epochs, loss.json, best/periodic checkpoints.

Counterpart of `vpd_tpu/train/vpd_loop.py` (loop parity with reference
`train_vpd_model.py:171-281`). A student dir holds `config.json` (the
manifest `apply_vpd` rebuilds the student from) plus `{name}.encoder.ckpt`
(and `{name}.decoder.ckpt` for the motion head) in vpd_tpu's flax-msgpack
format; `epoch%04d` checkpoints also hold `{name}.optimizer.ckpt`, AdamW's
state in optax's layout. So a student written by either package loads,
and a run resumes, in the other.

Sources whose batches are cache row indices (`data/hbm_cache.
CacheIndexSource`, carrying the `DeviceCropCache` as `device_cache`)
train through the cached steps, which gather the pixels on the device.
`pretrained` ResNet students start from a torchvision ImageNet state_dict
(`models/torch_compat.py`); EfficientNet students (`effnet0`..`effnet7`,
`models/efficientnet.py`) always start from random init, as vpd_tpu's do.

Under a profiler (`core/profiling.span`) an epoch is the span
`vpd.train.epoch` (training, validation, checkpoints; id `epoch`), and
each `next_batch` inside it `vpd.train.sampler` (ids `epoch`, `batch`).

On a data mesh of several ranks (`core/mesh.py`, one process per GPU
under torchrun) every rank runs the trainer on its sources' rows of the
global batches: the step sums gradients and BatchNorm statistics over
the data group (`train/vpd.py`), the epoch losses are summed over it, so
every rank selects the same checkpoints, and only the primary rank writes
config.json, loss.json and the checkpoints. `resume` reads on every rank.
"""

import os
import time
import warnings

import torch

from .. import resolve_device
from ..core import checkpoint as ckpt
from ..core.io import load_json, store_json
from ..core.mesh import all_reduce_sum, get_mesh, is_primary, replicate
from ..core.metrics import fetch_metrics
from ..core.profiling import span
from ..data.augment import RGB_MEAN_STD
from ..models import build_effnet, build_encoder
from ..models.flax_weights import (encoder_to_flax, load_encoder_from_flax,
                                   load_motion_from_flax, motion_to_flax)
from ..models.torch_compat import (imagenet_init_variables,
                                   load_torch_state_dict)
from .vpd import (MotionHead, VPDStudent, create_state,
                  load_optimizer_from_flax, make_aug_eval_step,
                  make_cached_eval_step, make_cached_train_step,
                  make_eval_step, make_train_step, optimizer_to_flax)


def build_student(config, dtype=None, param_dtype=None):
    """Randomly initialised `VPDStudent` for a config.json manifest; the
    encoder body computes in `dtype` (bf16 by default) with its parameters
    stored in `param_dtype` (by default `dtype`), heads in float32."""
    dtype = dtype if dtype is not None else torch.bfloat16
    arch = config['encoder_arch']
    if 'resnet' in arch:
        build = build_encoder
    elif 'effnet' in arch:  # reference models/rgb.py:62-66
        build = build_effnet
    else:
        raise NotImplementedError(arch)
    encoder = build(arch, config['emb_dim'],
                    in_channels=5 if config['use_flow'] else 3, dtype=dtype,
                    param_dtype=param_dtype)
    motion = MotionHead(config['emb_dim']) if config['motion'] else None
    return VPDStudent(encoder, motion)


def student_components(model):
    """{'encoder': ..., 'decoder': ...} flax trees of a student."""
    comps = {'encoder': encoder_to_flax(model.encoder)}
    if model.motion is not None:
        comps['decoder'] = motion_to_flax(model.motion)
    return comps


def save_student(save_dir, model, config, name='best_epoch'):
    """Write config.json and the encoder (+ decoder) checkpoints."""
    os.makedirs(save_dir, exist_ok=True)
    store_json(os.path.join(save_dir, 'config.json'), config)
    ckpt.save_bundle(save_dir, name, student_components(model))


def _to_device(batch, device):
    return {k: torch.as_tensor(v).to(device, non_blocking=True)
            for k, v in batch.items()}


def _same_device(a, b):
    """Whether torch devices a and b are one device ('cuda' is the current
    CUDA device)."""
    def index(d):
        if d.index is not None or d.type != 'cuda':
            return d.index
        return torch.cuda.current_device()
    return a.type == b.type and index(a) == index(b)


class VPDTrainer:
    """Trains a student from batch sources (`next_batch()` dicts of host
    arrays or device tensors, `num_batches` per epoch) on `device` (CUDA
    by default), float32 master parameters computing in `dtype` (bf16 by
    default; the augmentation runs in the same dtype).

    A train source with a `device_cache` (`data/hbm_cache.
    CacheIndexSource`) selects the cached steps; the val source must
    share that cache, and `augment_val` is refused with it, as in
    vpd_tpu. `pretrained_weights` (a path or a state_dict) initialises a
    `pretrained` student's backbone. `mesh` is the data mesh
    (`core.mesh.get_mesh()` by default: one rank without a process
    group); the sources give this rank's rows of each global batch, and
    the trainer runs on the mesh's device."""

    def __init__(self, train_source, val_source, config, save_dir=None,
                 mesh=None, seed=0, dtype=None, device=None,
                 pretrained_weights=None):
        self.train_source = train_source
        self.val_source = val_source
        self.config = dict(config)
        self.save_dir = save_dir
        self.mesh = mesh if mesh is not None else get_mesh(device)
        self.device = resolve_device(self.mesh.device)
        self.primary = is_primary()
        cache = getattr(train_source, 'device_cache', None)
        self.cache = cache.arrays if cache is not None else None
        if cache is not None:
            if not _same_device(cache.device, self.device):
                raise ValueError('the DeviceCropCache is on {}, the trainer '
                                 'on {}'.format(cache.device, self.device))
            if cache.row_sharded and cache.mesh is not self.mesh:
                raise ValueError('a row-sharded DeviceCropCache must be '
                                 'built on the trainer\'s mesh')
            if self.config.get('augment_val'):
                raise ValueError('augment_val with the device crop cache is '
                                 'not implemented')
            if val_source is not None and \
                    getattr(val_source, 'device_cache', None) is not cache:
                raise ValueError('train and val sources must share one '
                                 'DeviceCropCache')

        model_dtype = dtype if dtype is not None else torch.bfloat16
        # the initial weights follow `seed` (vpd_tpu inits from
        # jax.random.key(seed)), without touching the global generator
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            model = build_student(self.config, dtype=model_dtype,
                                  param_dtype=torch.promote_types(
                                      model_dtype, torch.float32))
        model.to(self.device)
        if self.device.type == 'cuda':
            model.to(memory_format=torch.channels_last)
        self.state = create_state(model, config['learning_rate'],
                                  mesh=self.mesh)
        if self.config.get('pretrained'):
            self._init_pretrained(pretrained_weights,
                                  5 if config['use_flow'] else 3)
        # every rank starts from rank 0's weights
        replicate(model, self.mesh)

        mean, std = config['rgb_mean_std']
        # augmentation inputs follow the SOURCE's configuration: the
        # cached step would otherwise add mask noise whenever the cache
        # happens to hold masks
        use_mask = getattr(train_source, 'use_mask', True)
        jitter_order = self.config.get('jitter_order', 'batch')
        cache_kw = ({} if self.cache is None
                    else {'row_offset': cache.row_offset})
        make_train = (make_cached_train_step if self.cache is not None
                      else make_train_step)
        self.train_step = make_train(
            mean, std, img_dim=config['img_dim'],
            use_flow=config['use_flow'], use_mask=use_mask,
            aug_dtype=model_dtype, jitter_order=jitter_order, **cache_kw)
        if self.config.get('augment_val'):
            self.eval_step = None
            self.aug_eval_step = make_aug_eval_step(
                mean, std, img_dim=config['img_dim'],
                use_flow=config['use_flow'], use_mask=use_mask,
                aug_dtype=model_dtype, jitter_order=jitter_order)
        else:
            make_eval = (make_cached_eval_step if self.cache is not None
                         else make_eval_step)
            self.eval_step = make_eval(mean, std,
                                       use_flow=config['use_flow'],
                                       **cache_kw)
            self.aug_eval_step = None
        self.seed = seed + 1
        self.val_seed = seed + 2
        self._val_steps = 0

        self.losses = []
        self.epoch_seconds = []
        self.selector = ckpt.MovingAvgSelector(
            self.config.get('model_select_window', 5))

    @property
    def model(self):
        return self.state.model

    def _init_pretrained(self, weights, num_channels):
        """ImageNet-init the encoder (reference `models/rgb.py:56-66`):
        every backbone tensor from a torchvision state_dict (a path, read
        with `weights_only`, or a dict), the stem mean-expanded for
        5-channel students; the embedding head stays fresh."""
        arch = self.config['encoder_arch']
        if 'resnet' not in arch:
            # reference parity: the effnet path builds with from_name
            # (models/rgb.py:62-66), which ignores pretrained
            warnings.warn(
                'pretrained=True is ignored for {} (reference parity: '
                'models/rgb.py:62-66 builds effnet with from_name, i.e. '
                'random init)'.format(arch))
            return
        if weights is None:
            raise ValueError(
                'pretrained=True requires ImageNet weights: pass '
                '--init_weights <torchvision {} state_dict .pth> (none can '
                'be downloaded here, so the file must be supplied)'.format(
                    arch))
        sd = (load_torch_state_dict(weights)
              if isinstance(weights, (str, os.PathLike)) else weights)
        missing, _ = self.model.encoder.load_state_dict(
            imagenet_init_variables(sd, arch, num_channels), strict=False)
        kept = [k for k in missing if not (k.startswith('fc.') or
                                           k.endswith('num_batches_tracked'))]
        if kept:
            raise ValueError('ImageNet init left {} uninitialised'.format(
                kept))

    def save_config(self):
        if not self.primary:
            return
        os.makedirs(self.save_dir, exist_ok=True)
        store_json(os.path.join(self.save_dir, 'config.json'), self.config)

    def save_model(self, name, with_optimizer=False):
        """Write a checkpoint (the primary rank alone)."""
        if not self.primary:
            return
        comps = student_components(self.model)
        if with_optimizer:
            # epoch checkpoints (the --resume source) carry the AdamW
            # moments; best_epoch stays weights-only
            comps['optimizer'] = optimizer_to_flax(self.state)
        ckpt.save_bundle(self.save_dir, name, comps)

    def _epoch(self, source, epoch, train):
        # metrics stay on the device until the epoch ends: one readback
        metrics = []
        for i in range(source.num_batches):
            with span('vpd.train.sampler', epoch=epoch, batch=i):
                host = source.next_batch()
            batch = _to_device(host, self.device)
            if train and self.cache is not None:
                m = self.train_step(self.state, batch, self.seed, self.cache)
            elif train:
                m = self.train_step(self.state, batch, self.seed)
            elif self.aug_eval_step is not None:
                m = self.aug_eval_step(self.state, batch, self.val_seed,
                                       self._val_steps)
                self._val_steps += 1
            elif self.cache is not None:
                m = self.eval_step(self.state, batch, self.cache)
            else:
                m = self.eval_step(self.state, batch)
            metrics.append(m)
        metrics = fetch_metrics(metrics)
        total, n = all_reduce_sum(
            [sum(m['emb_loss_sum'] for m in metrics),
             sum(m['n'] for m in metrics)], self.state.mesh)
        return total / max(n, 1)

    def train_one_epoch(self, epoch):
        with span('vpd.train.epoch', self.device, epoch=epoch):
            t0 = time.perf_counter()
            train_loss = self._epoch(self.train_source, epoch, train=True)
            val_loss = (self._epoch(self.val_source, epoch, train=False)
                        if self.val_source is not None else float('nan'))
            self.epoch_seconds.append(time.perf_counter() - t0)

            dataset = self.config.get('dataset', '')
            self.losses.append({
                'epoch': epoch, 'train': train_loss, 'val': val_loss,
                'dataset_train': [(dataset, train_loss)],
                'dataset_val': [(dataset, val_loss)]})
            if self.save_dir and self.primary:
                store_json(os.path.join(self.save_dir, 'loss.json'),
                           self.losses)

            is_best = self.selector.update(val_loss)
            if self.save_dir:
                if is_best:
                    self.save_model('best_epoch')
                freq = self.config.get('checkpoint_frequency')
                if freq and epoch % freq == 0:
                    self.save_model('epoch{:04d}'.format(epoch),
                                    with_optimizer=True)
            return train_loss, val_loss

    def fit(self, start_epoch=1, log=print):
        epoch = 0
        for epoch in range(start_epoch, self.config['num_epochs'] + 1):
            train_loss, val_loss = self.train_one_epoch(epoch)
            if self.primary:
                log('Epoch {} - train loss: {:0.4f} val loss: {:0.4f} '
                    '({:0.2f} s)'.format(epoch, train_loss, val_loss,
                                         self.epoch_seconds[-1]))
        if self.save_dir and epoch:
            self.save_model('epoch{:04d}'.format(epoch),
                            with_optimizer=True)

    def load_model(self, name):
        """Load a checkpoint written by either package; its optimizer
        state too where the checkpoint has one (epoch checkpoints), else
        AdamW starts afresh."""
        load_encoder_from_flax(self.model.encoder, ckpt.load_component(
            self.save_dir, name, 'encoder'))
        if self.model.motion is not None:
            load_motion_from_flax(self.model.motion, ckpt.load_component(
                self.save_dir, name, 'decoder'))
        if os.path.exists(ckpt.component_path(self.save_dir, name,
                                              'optimizer')):
            load_optimizer_from_flax(self.state, ckpt.load_component(
                self.save_dir, name, 'optimizer'))

    def resume(self):
        """Restore the last epoch checkpoint and the loss history; returns
        the next epoch."""
        last = ckpt.last_checkpoint_epoch(self.save_dir)
        if last < 0:
            raise FileNotFoundError('nothing to resume in {}'.format(
                self.save_dir))
        self.load_model('epoch{:04d}'.format(last))
        loss_file = os.path.join(self.save_dir, 'loss.json')
        if os.path.exists(loss_file):
            self.losses = [x for x in load_json(loss_file)
                           if x['epoch'] <= last]
            for rec in self.losses:
                self.selector.update(rec['val'])
        return last + 1


def default_config(dataset, emb_dim, num_epochs=1000, batch_size=100,
                   learning_rate=5e-4, img_dim=128, use_flow=False,
                   motion=False, encoder_arch='resnet34', pretrained=False,
                   model_select_window=5, checkpoint_frequency=None,
                   augment_val=False, jitter_order='batch'):
    """Manifest schema parity with `train_vpd_model.py:222-228`.

    `jitter_order` is recorded only when non-default ('per_sample') so
    the manifest stays schema-identical to reference-written configs.
    """
    extra = ({'jitter_order': jitter_order}
             if jitter_order != 'batch' else {})
    return {
        **extra,
        'augment_val': augment_val,
        'dataset': dataset,
        'num_epochs': num_epochs,
        'batch_size': batch_size,
        'learning_rate': learning_rate,
        'img_dim': img_dim,
        'use_flow': use_flow,
        'motion': motion,
        'emb_dim': emb_dim,
        'encoder_arch': encoder_arch,
        'pretrained': pretrained,
        'rgb_mean_std': [list(x) for x in
                         RGB_MEAN_STD['resnet' if pretrained else dataset]],
        'model_select_window': model_select_window,
        'checkpoint_frequency': checkpoint_frequency,
    }
