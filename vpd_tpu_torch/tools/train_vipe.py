#!/usr/bin/env python3
"""Train the VIPE* teacher on the GPU (CLI parity: `train_vipe_model.py`).

Same flags as `python -m vpd_tpu.tools.train_vipe`, plus `--device`
(default cuda; without a GPU it raises unless told `--device cpu`):

    python -m vpd_tpu_torch.tools.train_vipe --dataset 3d --save_dir <dir> \
        [--embed_bones] [--num_workers N] [--resume]

The mocap families are read from `$VPD_VIPE_DATA_DIR/<family>/` as
`ground_truth_3d_pose.pkl` + `cocopose/*.json.gz` (`tools/paths.py`).
`--num_workers N` samples in N spawned worker processes (N // 2 for
validation), seeded as vpd_tpu seeds its workers. On N GPUs, one process
each, the teacher trains data parallel, and `--tensor_parallel m` splits
its wide layers by columns over groups of m ranks as well (a (N/m, m)
grid, `core/mesh.get_mesh_2d`):

    torchrun --nproc_per_node N -m vpd_tpu_torch.tools.train_vipe \
        --dataset 3d --save_dir <dir> [--tensor_parallel m]

Every rank samples the global batches from the same seeds and keeps its
rows; rank 0 writes the save dir, whole arrays as one device writes them.
"""

import argparse
import copy
import functools

import numpy as np

from .. import resolve_device
from ..core.mesh import distributed, get_mesh_2d
from ..data.parallel_batcher import MultiprocessBatcher
from ..data.vipe_sampler import (
    FAMILIES, FusedBatcher, PairwiseSampler, VIPESampler, load_3dpeople,
    load_amass, load_human36m, load_keyed, load_nba2k, people3d_key)
from ..train.vipe_loop import VIPETrainer, default_config
from . import paths

DATASETS_3D = ['3dpeople', 'human36m', 'nba2k', 'amass']
DATASETS_PAIR = ['3dpeople_pair']
DATASETS = DATASETS_3D + DATASETS_PAIR

LOADERS = {
    'human36m': (load_human36m, paths.HUMAN36M_KEYPOINT_DIR,
                 paths.HUMAN36M_3D_POSE_FILE),
    '3dpeople': (load_3dpeople, paths.PEOPLE_3D_KEYPOINT_DIR,
                 paths.PEOPLE_3D_3D_POSE_FILE),
    'nba2k': (load_nba2k, paths.NBA2K_KEYPOINT_DIR,
              paths.NBA2K_3D_POSE_FILE),
    'amass': (load_amass, paths.AMASS_KEYPOINT_DIR,
              paths.AMASS_3D_POSE_FILE),
}


def get_args():
    parser = argparse.ArgumentParser()
    parser.add_argument('--dataset', type=str, nargs='+')
    parser.add_argument('--save_dir', type=str, required=True)
    parser.add_argument('--checkpoint_frequency', type=int, default=25)
    parser.add_argument('--render_preview_frequency', type=int, default=100)
    parser.add_argument('--num_epochs', type=int, default=500)
    parser.add_argument('--learning_rate', type=float, default=0.0001)
    parser.add_argument('--batch_size', type=int, default=100)
    parser.add_argument('--embedding_dim', type=int, default=32)
    parser.add_argument('--encoder_arch', type=int, nargs=2,
                        default=(2, 1024))
    parser.add_argument('--decoder_arch', type=int, nargs=2, default=(2, 512))
    parser.add_argument('--embed_bones', action='store_true')
    parser.add_argument('--model_select_contrast', action='store_true')
    parser.add_argument('--model_select_window', type=int, default=1)
    parser.add_argument('--resume', action='store_true')
    parser.add_argument('--no_camera_aug', action='store_true')
    parser.add_argument('--seed', type=int, default=0)
    parser.add_argument('--num_workers', type=int, default=0,
                        help='sampler worker processes '
                             '(reference DataLoader num_workers)')
    parser.add_argument('--tensor_parallel', type=int, default=1,
                        help='model-axis size of a 2-D data x model mesh '
                             '(column-shards the wide FC kernels over '
                             'groups of this many torchrun ranks)')
    parser.add_argument('--device', type=str, default='cuda',
                        help='torch device (default cuda; cpu runs the '
                             'plain PyTorch path)')
    return parser.parse_args()


def build_samplers(names, embed_bones, augment_camera, seed):
    train_samplers, val_samplers = [], []
    shapes, norms = [], []
    for i, name in enumerate(names):
        if name == '3dpeople_pair':
            (train_seqs, val_seqs), _ = load_keyed(
                paths.PEOPLE_3D_KEYPOINT_DIR, None, '3dpeople', people3d_key)
            train_samplers.append(PairwiseSampler(
                train_seqs, embed_bones=embed_bones, seed=seed + i))
            val_samplers.append(PairwiseSampler(
                val_seqs, embed_bones=embed_bones, seed=seed + 100 + i))
            shapes.append(None)
            norms.append(None)
            continue
        loader, pose2d_dir, pose3d_file = LOADERS[name]
        (train_seqs, val_seqs), poses_3d = loader(pose2d_dir, pose3d_file)
        fam = FAMILIES[name]
        train_samplers.append(VIPESampler(
            fam, train_seqs, poses_3d, augment_camera=augment_camera,
            embed_bones=embed_bones, target_len=fam.train_target_len,
            seed=seed + i))
        val_samplers.append(VIPESampler(
            fam, val_seqs, poses_3d, augment_camera=augment_camera,
            embed_bones=embed_bones, target_len=fam.val_target_len,
            seed=seed + 100 + i))
        shapes.append((fam.spec.num_edges, 7))
        norms.append(train_samplers[-1].mean_kp_offset_norms)
    return train_samplers, val_samplers, shapes, norms


def worker_batcher(samplers, batch_size, seed, salt, worker_id, divisor=1):
    """Worker `worker_id`'s `FusedBatcher`: copies of the samplers (the
    pose data shared), sampler i seeded seed + salt + 7919 * (worker_id +
    1) + i as vpd_tpu seeds its workers; its batch a multiple of
    `divisor` (the data ranks). Module-level, so that a
    `functools.partial` of it pickles into spawned workers."""
    clones = []
    for si, smp in enumerate(samplers):
        c = copy.copy(smp)
        c.rng = np.random.default_rng(seed + salt + 7919 * (worker_id + 1)
                                      + si)
        clones.append(c)
    return FusedBatcher(clones, batch_size, divisor=divisor)


def main(dataset, save_dir, checkpoint_frequency, num_epochs, learning_rate,
         batch_size, embedding_dim, encoder_arch, decoder_arch, embed_bones,
         model_select_contrast, model_select_window, resume, no_camera_aug,
         seed, render_preview_frequency=100, num_workers=0,
         tensor_parallel=1, device='cuda'):
    resolve_device(device)  # no GPU: raise before loading data
    if dataset and 'all' in dataset:
        dataset = DATASETS
    elif dataset and '3d' in dataset:
        dataset = DATASETS_3D
    if not dataset:
        raise ValueError('no datasets selected')

    with distributed(device) as mesh:
        if mesh.world % tensor_parallel:
            raise SystemExit(
                '--tensor_parallel {} splits the teacher over groups of {} '
                'ranks: launch a multiple of {} processes with torchrun '
                '--nproc_per_node (this run has {})'.format(
                    tensor_parallel, tensor_parallel, tensor_parallel,
                    mesh.world))
        if tensor_parallel > 1:
            mesh = get_mesh_2d(tensor_parallel, device=mesh.device)
        return _train(mesh, dataset, save_dir, checkpoint_frequency,
                      num_epochs, learning_rate, batch_size, embedding_dim,
                      encoder_arch, decoder_arch, embed_bones,
                      model_select_contrast, model_select_window, resume,
                      no_camera_aug, seed, render_preview_frequency,
                      num_workers)


def _train(mesh, dataset, save_dir, checkpoint_frequency, num_epochs,
           learning_rate, batch_size, embedding_dim, encoder_arch,
           decoder_arch, embed_bones, model_select_contrast,
           model_select_window, resume, no_camera_aug, seed,
           render_preview_frequency, num_workers):
    train_samplers, val_samplers, shapes, norms = build_samplers(
        dataset, embed_bones, not no_camera_aug, seed)
    div = mesh.data_size
    train_b = FusedBatcher(train_samplers, batch_size, divisor=div)
    val_b = FusedBatcher(val_samplers, batch_size, divisor=div)
    owned = []
    if num_workers > 0:
        train_b = MultiprocessBatcher(
            functools.partial(worker_batcher, train_samplers, batch_size,
                              seed, 0, divisor=div),
            num_workers, train_b.num_batches, template=train_b)
        val_b = MultiprocessBatcher(
            functools.partial(worker_batcher, val_samplers, batch_size,
                              seed, 104729, divisor=div),
            max(1, num_workers // 2), val_b.num_batches, template=val_b)
        owned = [train_b, val_b]

    config = default_config(
        dataset, shapes, norms, num_epochs=num_epochs,
        learning_rate=learning_rate, batch_size=batch_size,
        embedding_dim=embedding_dim, encoder_arch=encoder_arch,
        decoder_arch=decoder_arch, embed_bones=embed_bones,
        augment_camera=not no_camera_aug,
        model_select_window=model_select_window,
        checkpoint_frequency=checkpoint_frequency)
    config['model_select_contrast'] = model_select_contrast

    trainer = None
    try:
        trainer = VIPETrainer(train_b, val_b, config, save_dir=save_dir,
                              mesh=mesh, seed=seed)
        start_epoch = 1
        if resume:
            start_epoch = trainer.resume()
        else:
            trainer.save_config()
        specs = [FAMILIES[n].spec if n in FAMILIES else None
                 for n in dataset]
        for epoch in range(start_epoch, num_epochs + 1):
            train_m, val_m = trainer.train_one_epoch(epoch)
            if trainer.primary:
                print('Epoch {} - train loss: {:0.5f} val loss: {:0.5f} '
                      '({:0.2f} s)'.format(epoch, train_m['loss'],
                                           val_m['loss'],
                                           trainer.epoch_seconds[-1]),
                      flush=True)
            if render_preview_frequency and \
                    epoch % render_preview_frequency == 0:
                trainer.render_previews(train_samplers, specs, epoch)
    finally:
        if trainer is not None:
            trainer.close()
        for b in owned:
            b.close()
    print('Done!')
    return trainer


if __name__ == '__main__':
    main(**vars(get_args()))
