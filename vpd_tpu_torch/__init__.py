"""vpd_tpu_torch: the PyTorch/CUDA port of vpd_tpu for NVIDIA Hopper.

The layout mirrors `vpd_tpu/` module for module, so each file's JAX
counterpart sits at the same relative path. This package imports torch and
numpy only: never jax, flax or anything of `vpd_tpu` (tests import both
packages to hold one against the other).

Layer map (the ported slices: student feature extraction; DTW
recognition and retrieval; student training and its input, EfficientNet
students and the Penn ablation; the teacher; the heads on frozen
embeddings; optical flow and the upload codec; the data-prep tools from
video to crops; the reference's torch checkpoints both ways; several
GPUs under torchrun):
  core/      io + `.emb.pkl` interchange, flax-msgpack checkpoints, pipeline,
             single-readback metrics, the device mesh (process groups,
             one rank a GPU, `mesh`)
  data/      eval transforms and the train augmentation, crop PNG decode
             (native C++ decoder, cv2, PIL), packed shards and
             pack_crops, training batch sources, prefetch, decode worker
             processes, the device crop cache, the yuv420 upload codec,
             Penn Action crops cut from full frames
  datasets/  dense embedding matrices, action windows and splits
  ops/       hand-written CUDA kernels (csrc/) with their plain twins; DTW
             (the host DP in numpy and the native C++ core,
             `dtw_native`); the LK flow pyramid and flow-PNG
             quantization; the nvcc and g++ builds
  models/    ResNet and EfficientNet students, FCNet, RAFT, flax weight
             mapping, the reference's torch state_dicts (ImageNet
             init, import and export), the teacher's tensor parallelism
  train/     student modules, the train step and the epoch loop
  infer/     batched embedding extraction (.emb.pkl writers)
  tasks/     kNN / retrieval over DTW, the few-shot protocol
  tools/     CLI entry points, the data-prep tools among them (crop
             extraction, 2D features, feature stacking, mocap
             preprocessing, pose overlay, loss plots, recutting), and
             torch checkpoint import and export
  utils/     video metadata, decode, segment cutting and the square
             crop (`video`), boxes (`box`), the DISPLAY-gated preview
             (`display`)

Entry points run on the GPU unless the caller passes `device='cpu'`.
Importing the package does not import torch, so the host-only tools
(crop extraction and its spawned workers) start without it.
"""

__version__ = "0.1.0"


def resolve_device(device=None):
    """The torch device an entry point runs on: `None` means CUDA.

    Raises when CUDA is asked for (explicitly or by default) but no GPU is
    present, instead of silently running on the CPU.
    """
    import torch

    device = torch.device('cuda' if device is None else device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            'no CUDA device is available; pass device="cpu" to run the '
            'plain PyTorch path on the CPU')
    return device
