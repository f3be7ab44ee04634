"""vpd_tpu_torch: the PyTorch/CUDA port of vpd_tpu for NVIDIA Hopper.

The layout mirrors `vpd_tpu/` module for module, so each file's JAX
counterpart sits at the same relative path. This package imports torch and
numpy only: never jax, flax or anything of `vpd_tpu` (tests import both
packages to hold one against the other).

Layer map (the ported slices: student feature extraction; DTW
recognition and retrieval; student training):
  core/      io + `.emb.pkl` interchange, flax-msgpack checkpoints, pipeline,
             single-readback metrics
  data/      eval transforms and the train augmentation, crop PNG decode,
             packed raw shards, training batch sources and prefetch
  datasets/  dense embedding matrices, action windows and splits
  ops/       hand-written CUDA kernels (csrc/) with their plain twins; DTW
  models/    ResNet student, FCNet, flax weight mapping
  train/     student modules, the train step and the epoch loop
  infer/     batched embedding extraction (.emb.pkl writers)
  tasks/     kNN / retrieval over DTW, the few-shot protocol
  tools/     CLI entry points
  utils/     video metadata

Entry points run on the GPU unless the caller passes `device='cpu'`.
"""

import torch

__version__ = "0.1.0"


def resolve_device(device=None):
    """The torch device an entry point runs on: `None` means CUDA.

    Raises when CUDA is asked for (explicitly or by default) but no GPU is
    present, instead of silently running on the CPU.
    """
    device = torch.device('cuda' if device is None else device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            'no CUDA device is available; pass device="cpu" to run the '
            'plain PyTorch path on the CPU')
    return device
