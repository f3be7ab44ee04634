"""VIPE* training loop: epochs, loss history, checkpoint selection, resume.

Counterpart of `vpd_tpu/train/vipe_loop.py` (loop parity with reference
`train_vipe_model.py:232-425`): the config.json manifest (the contract
`apply_vipe` rebuilds models from), loss.json epoch history with the
per-dataset breakdown, moving-average-val best checkpoint + periodic
checkpoints, and `--resume` from the last epoch checkpoint.

A save dir holds `{name}.encoder.ckpt`, `{name}.decoder-3d.ckpt` and
`{name}.optimizer.ckpt` (AdamW's state in optax's layout) in vpd_tpu's
flax-msgpack format, so a teacher written by either package serves, and
a run resumes, in the other. A resume restores the step count from the
optimizer's, so a resumed run draws the dropout masks an uninterrupted
one would (vpd_tpu restarts its step at 0).

On a data mesh (`mesh`, one process per GPU) every rank samples the
global batches from the same seeded batchers and steps on its rows
(`train/vipe.py`); the epoch metrics are global, so every rank selects
the same checkpoints, and only the primary rank writes. On a (data,
model) grid (`core.mesh.get_mesh_2d`) the wide layers are split by
columns over the model group as well (`models/tensor_parallel.py`), and
the primary rank writes full arrays, as a one-device run does.
"""

import os
import time

import numpy as np
import torch

from .. import resolve_device
from ..core import checkpoint as ckpt
from ..core.io import load_json, store_json
from ..core.mesh import LocalRows, get_mesh, is_primary, replicate
from ..data.crops import PrefetchedSource
from ..geometry.coco import pose_input_dim
from ..models.fc import FCPoseDecoder, FCResNet
from ..models.flax_weights import (load_vipe_from_flax, vipe_params_from_flax,
                                   vipe_params_to_flax, vipe_to_flax)
from ..models.tensor_parallel import (full_tensors, local_tensors,
                                      shard_vipe_model)
from .vipe import VIPEModel, make_eval_step, make_train_step, run_epoch
from .vpd import (create_state, load_moments, load_optimizer_from_flax,
                  moments_to_flax, optimizer_moments, optimizer_to_flax)

ENCODER_DROPOUT = 0.2
DECODER_DROPOUT = 0.0
LIFT_3D_WEIGHT = 1


def build_model(config, kp_dims):
    """Randomly initialised `VIPEModel` for a config.json manifest and the
    batcher's per-dataset 3D feature widths (0 for pairwise datasets)."""
    encoder = FCResNet(
        pose_input_dim(config['embed_bones']),
        out_dim=config['embedding_dim'],
        num_blocks=config['encoder_arch'][0],
        hidden_dim=config['encoder_arch'][1],
        dropout=ENCODER_DROPOUT)
    decoder = None
    if any(d > 0 for d in kp_dims):
        # reference decoder: FCPoseDecoder(emb, [h]*n, targets)
        # (`train_vipe_model.py:304-307` with USE_RESNET_DECODER=False),
        # i.e. an (n-1)-layer FCNet trunk + width-h last layer. n == 1 is
        # reference-invalid (module.py:215 asserts len(hidden_dims) >= 2);
        # tiny test configs use it, so pad to the minimum legal depth.
        n, h = config['decoder_arch']
        decoder = FCPoseDecoder(
            config['embedding_dim'], hidden_dims=(h,) * max(n, 2),
            target_dims=tuple(max(d, 1) for d in kp_dims),
            dropout=DECODER_DROPOUT)
    return VIPEModel(encoder, decoder)


def load_vipe_components(model, save_dir, name):
    """Fill `model` from `{name}.encoder.ckpt` (and `{name}.decoder-3d.
    ckpt` when it has a decoder), as either package writes them."""
    enc = ckpt.load_component(save_dir, name, 'encoder')
    variables = {'params': {'encoder': enc['params']},
                 'batch_stats': {'encoder': enc['batch_stats']}}
    if model.decoder is not None:
        dec = ckpt.load_component(save_dir, name, 'decoder-3d')
        variables['params']['decoder'] = dec['params']
        if dec['batch_stats']:
            variables['batch_stats']['decoder'] = dec['batch_stats']
    return load_vipe_from_flax(model, variables)


class VIPETrainer:
    """Trains the teacher from fused batchers (`data/vipe_sampler.
    FusedBatcher` or a `MultiprocessBatcher` templated on one) on `device`
    (CUDA by default), float32. Batches are staged on the device by a
    prefetch thread; `close()` stops it. `mesh`: the data mesh
    (`core.mesh.get_mesh()` by default), on whose device the trainer
    runs; the batchers give global batches, of which each rank keeps its
    rows."""

    def __init__(self, train_batcher, val_batcher, config, save_dir=None,
                 mesh=None, seed=0, device=None):
        self.config = dict(config)
        self.save_dir = save_dir
        self.mesh = mesh if mesh is not None else get_mesh(device)
        self.device = resolve_device(self.mesh.device)
        self.primary = is_primary()

        # the initial weights follow `seed` (vpd_tpu inits from
        # jax.random.key(seed)), without touching the global generator
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            model = build_model(self.config, train_batcher.kp_dims)
        model.to(self.device)
        replicate(model, self.mesh)  # every rank starts from rank 0's
        # a (data, model) grid: the wide layers split by columns; a
        # whole-width copy (on the host) is the checkpoints' layout
        self.tp_dims = self._whole = None
        if self.mesh.model_size > 1:
            self._whole = build_model(self.config, train_batcher.kp_dims)
            self.tp_dims = shard_vipe_model(model, self.mesh)
        # vpd_tpu draws one training batch to build its state; draw and drop
        # it, so that the batches that follow are vpd_tpu's
        train_batcher.next_batch()
        self.state = create_state(model, self.config['learning_rate'],
                                  mesh=self.mesh)
        kp_mask = train_batcher.kp_mask()
        self.train_step = make_train_step(kp_mask, weight_3d=LIFT_3D_WEIGHT)
        self.eval_step = make_eval_step(kp_mask, weight_3d=LIFT_3D_WEIGHT)
        self.seed = seed + 1

        # sample ahead on a thread that also stages each batch on the
        # device, so the host sampler overlaps the step in flight
        part = self.state.part
        self.train_batcher = PrefetchedSource(
            LocalRows(train_batcher, part), device=self.device)
        self.val_batcher = (PrefetchedSource(LocalRows(val_batcher, part),
                                             device=self.device)
                            if val_batcher is not None else None)

        self.losses = []
        self.epoch_seconds = []
        self.selector = ckpt.MovingAvgSelector(
            self.config.get('model_select_window', 1))

    @property
    def model(self):
        return self.state.model

    # -- persistence ------------------------------------------------------

    def save_config(self):
        if not self.primary:
            return
        os.makedirs(self.save_dir, exist_ok=True)
        store_json(os.path.join(self.save_dir, 'config.json'), self.config)

    def _components(self):
        if self.tp_dims is None:
            model = self.model
            opt = optimizer_to_flax(self.state, vipe_params_to_flax)
        else:  # whole arrays from the model group (a collective)
            model = self._whole
            model.load_state_dict({k: v.cpu() for k, v in full_tensors(
                self.model.state_dict(), self.tp_dims, self.mesh).items()})
            count, moments = optimizer_moments(self.state)
            opt = moments_to_flax(model, count, {
                k: {n: t.cpu() for n, t in full_tensors(
                    v, self.tp_dims, self.mesh).items()}
                for k, v in moments.items()}, vipe_params_to_flax)
        tree = vipe_to_flax(model)
        comps = {
            'encoder': {'params': tree['params']['encoder'],
                        'batch_stats': tree['batch_stats'].get('encoder',
                                                               {})},
            'optimizer': opt,
        }
        if model.decoder is not None:
            comps['decoder-3d'] = {
                'params': tree['params']['decoder'],
                'batch_stats': tree['batch_stats'].get('decoder', {})}
        return comps

    def save_model(self, name):
        """Write a checkpoint (the primary rank alone; on a model grid
        every rank takes part in gathering the whole arrays)."""
        if self.primary or self.tp_dims is not None:
            comps = self._components()
            if self.primary:
                ckpt.save_bundle(self.save_dir, name, comps)

    def load_model(self, name):
        """Load a checkpoint written by either package. A dir without an
        optimizer component (a serving-only import) resumes with fresh
        AdamW moments, as vpd_tpu does. On a model grid every rank reads
        the whole arrays and keeps its blocks."""
        has_opt = os.path.exists(ckpt.component_path(self.save_dir, name,
                                                     'optimizer'))
        tree = (ckpt.load_component(self.save_dir, name, 'optimizer')
                if has_opt else None)
        if self.tp_dims is None:
            load_vipe_components(self.model, self.save_dir, name)
            if has_opt:
                load_optimizer_from_flax(self.state, tree,
                                         vipe_params_from_flax)
        else:
            load_vipe_components(self._whole, self.save_dir, name)
            local = local_tensors(self._whole.state_dict(), self.tp_dims,
                                  self.mesh)
            with torch.no_grad():
                for k, t in self.model.state_dict().items():
                    t.copy_(local[k])
            if has_opt:
                load_moments(self.state, int(tree['0']['count']), *(
                    local_tensors(vipe_params_from_flax(
                        self._whole, tree['0'][k]), self.tp_dims,
                        self.mesh) for k in ('mu', 'nu')))
        if not has_opt:
            print('WARNING: {} has no optimizer checkpoint; resuming '
                  'with fresh optimizer state'.format(name))

    # -- training ---------------------------------------------------------

    def _run(self, batcher, train):
        # the prefetchers hand over batches already on the device
        return run_epoch(batcher, self.state,
                         self.train_step if train else self.eval_step,
                         batcher.num_batches, seed=self.seed, train=train)

    def train_one_epoch(self, epoch):
        t0 = time.perf_counter()
        train_m = self._run(self.train_batcher, train=True)
        # val_batcher=None: select on the train metrics instead
        val_m = (self._run(self.val_batcher, train=False)
                 if self.val_batcher is not None else train_m)
        self.epoch_seconds.append(time.perf_counter() - t0)

        names = self.config.get('dataset_names')

        def per_ds(m):
            return [(names[i] if names else str(i), v)
                    for i, v in sorted(m['per_dataset'].items())]

        select_key = ('contra' if self.config.get('model_select_contrast')
                      else 'loss')
        self.losses.append({
            'epoch': epoch,
            'train': train_m[select_key], 'val': val_m[select_key],
            'dataset_train': [('contrast', train_m['contra'])]
                             + per_ds(train_m),
            'dataset_val': [('contrast', val_m['contra'])] + per_ds(val_m),
        })
        if self.save_dir and self.primary:
            store_json(os.path.join(self.save_dir, 'loss.json'), self.losses)

        is_best = self.selector.update(val_m[select_key])
        if self.save_dir:
            if is_best:
                self.save_model('best_epoch')
            freq = self.config.get('checkpoint_frequency', 25)
            if epoch % freq == 0:
                self.save_model('epoch{:04d}'.format(epoch))
        return train_m, val_m

    def fit(self, start_epoch=1, log=print):
        for epoch in range(start_epoch, self.config['num_epochs'] + 1):
            train_m, val_m = self.train_one_epoch(epoch)
            log('Epoch {} - train loss: {:0.5f}, contra: {:0.3f} | '
                'val loss: {:0.5f}, contra: {:0.3f} ({:0.2f} s)'.format(
                    epoch, train_m['loss'], train_m['contra'],
                    val_m['loss'], val_m['contra'], self.epoch_seconds[-1]))

    def close(self):
        """Stop the prefetch threads."""
        for b in (self.train_batcher, self.val_batcher):
            if b is not None:
                b.close()

    def render_previews(self, samplers, specs, epoch, count=10,
                        log=print):
        """Write true-vs-predicted skeleton preview MP4s.

        Parity with `train_vipe_model.py:63-100,396-411`: for each 3D
        family, decode predicted features back to joint positions and
        render front/side views alongside ground truth. Every rank
        calls it; the primary rank renders (on a model grid, with the
        whole-width copy its ranks gather).
        """
        from ..geometry.render import render_3d_skeleton_views, \
            save_video_preview

        model, device = self.model, self.device
        if self.tp_dims is not None:
            model, device = self._whole, torch.device('cpu')
            model.load_state_dict({k: v.cpu() for k, v in full_tensors(
                self.model.state_dict(), self.tp_dims, self.mesh).items()})
        if not self.primary:
            return
        model = model.eval()

        def predict(pose, ds_id):
            with torch.no_grad():
                emb = model.embed(torch.as_tensor(
                    pose, dtype=torch.float32, device=device))
                return model.decode(emb, torch.tensor(
                    [ds_id], device=device)).cpu().numpy()

        def frames():
            for ds_id, (sampler, spec) in enumerate(zip(samplers, specs)):
                if spec is None:
                    continue
                for i in range(min(count, len(sampler.sequences))):
                    for data in sampler.get_sequence(i):
                        norms = data['kp_offset_norms']
                        norms = norms / np.max(norms)
                        true3d = data['kp_offsets'] * norms[:, None]
                        pred = predict(data['pose'].reshape(1, -1), ds_id)
                        kp_dim = spec.num_edges * 7
                        pred3d = pred[0, :kp_dim].reshape(
                            spec.num_edges, 7)[:, :3] * norms[:, None]
                        yield render_3d_skeleton_views(
                            [spec.decode_all_positions(true3d),
                             spec.decode_all_positions(pred3d)],
                            spec,
                            '[{}] {} frame={}'.format(
                                spec.name, data['key'], data['frame']),
                            labels=['true', 'pred'])

        out = os.path.join(self.save_dir,
                           'epoch{:04d}.preview.mp4'.format(epoch))
        save_video_preview(out, frames())
        log('Saved video: {}'.format(out))

    def resume(self):
        """Restore state + loss history from the last epoch checkpoint;
        returns the next epoch."""
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


def default_config(dataset_names, kp_shapes, mean_norms, num_epochs=500,
                   learning_rate=1e-4, batch_size=100, embedding_dim=32,
                   encoder_arch=(2, 1024), decoder_arch=(2, 512),
                   embed_bones=False, augment_camera=True,
                   model_select_window=1, checkpoint_frequency=25):
    """The config.json manifest (schema parity: train_vipe_model.py:330-344)."""
    return {
        'datasets': [
            {'name': n, '3d_pose_shape': list(s) if s else None,
             'mean_kp_offset_norms': m.tolist() if m is not None else None}
            for n, s, m in zip(dataset_names, kp_shapes, mean_norms)],
        'dataset_names': list(dataset_names),
        'num_epochs': num_epochs,
        'learning_rate': learning_rate,
        'batch_size': batch_size,
        'embedding_dim': embedding_dim,
        'encoder_arch': list(encoder_arch),
        'decoder_arch': list(decoder_arch),
        'embed_bones': embed_bones,
        'augment_camera': augment_camera,
        'model_select_window': model_select_window,
        'checkpoint_frequency': checkpoint_frequency,
    }
