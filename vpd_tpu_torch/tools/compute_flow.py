#!/usr/bin/env python3
"""Compute optical flow PNGs for crop directories (raft/flow.py parity).

Same flags as `python -m vpd_tpu.tools.compute_flow`, plus `--device`:

    python -m vpd_tpu_torch.tools.compute_flow <crop_root> --out_name flow \
        [--model lk|raft|<raft.pth>] [--raft_weights <raft.pth>] \
        [--upload_codec raw|yuv420|y8] [--subtract_median] [--device cpu]

Walks crop dirs for ('<frame>.prev.png', '<frame>.png') pairs, estimates
flow on the card and writes '<frame>.<out_name>.png' in the reference's
quantized format (clip +/-20, optional median subtraction). Estimators:
the batched Lucas-Kanade pyramid (`--model lk`, the default, no weights)
or RAFT (`--model raft --raft_weights <ckpt.pth>`; official princeton-vl
checkpoints load as they are, and `--model <ckpt.pth>` is the
reference's own argv; iters=20 as in raft/flow.py:111). Without weights
RAFT is random init from a fixed seed: a smoke path only.

Decode runs one chunk ahead and PNG writes one chunk behind
(`core/pipeline`); frames upload on a side stream, and the flow is
quantized to uint8 on the card before the readback. `--upload_codec`
shrinks the upload: `yuv420` (half the bytes, lossy chroma, any model)
or `y8` (the luma plane alone, `--model lk` only), both decoded on the
card. `--data_parallel` splits the chunks over the GPUs, one process
each (`torchrun --nproc_per_node N -m vpd_tpu_torch.tools.compute_flow
... --data_parallel`): rank 0 lists the pairs, chunk i goes to rank i mod
n, and each rank writes its chunks' PNGs. On one GPU (or the CPU) it runs
as world 1; on a host with several GPUs it refuses to run outside
torchrun.
"""

import argparse
import concurrent.futures
import os
import time

import numpy as np
import torch

from .. import resolve_device
from ..core.mesh import (barrier, broadcast_object, distributed,
                         refuse_devices_without_torchrun)
from ..core.pipeline import run_pipelined
from ..core.profiling import span
from ..data.crops import decode_crop_batch
from ..data.upload_codec import (FLOW_CODECS, decode_yuv420, encode_luma,
                                 encode_yuv420, packed_nbytes, packer_calls)
from ..ops.flow import (lucas_kanade_flow, lucas_kanade_flow_gray,
                        make_quantized_flow_fn)


def get_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('path', help='crop root (videos as subdirs)')
    parser.add_argument('--out_name', type=str, required=True,
                        help='suffix: <frame>.<out_name>.png')
    parser.add_argument('--clip', type=int, default=20)
    parser.add_argument('--img_dim', type=int, default=128)
    parser.add_argument('--batch_size', type=int, default=256)
    parser.add_argument('--overwrite', action='store_true')
    parser.add_argument('--subtract_median', action='store_true')
    parser.add_argument('--model', default='lk',
                        help="'lk' (Lucas-Kanade), 'raft', or, for "
                             "reference argv compatibility "
                             "(raft/flow.py:128-129), a torch RAFT "
                             "checkpoint path, which implies "
                             "--model raft --raft_weights <path>")
    parser.add_argument('--raft_weights', type=str,
                        help='torch RAFT checkpoint (.pth) for --model raft')
    parser.add_argument('--raft_iters', type=int, default=20)
    parser.add_argument('--small', action='store_true',
                        help='raft-small architecture (auto-detected from '
                             '--raft_weights; needed only without weights)')
    # reference raft/flow.py:133-135 knobs, kept for argv compatibility
    # (incl. the reference's type=bool quirk where any non-empty value
    # parses as True)
    parser.add_argument('--mixed_precision', type=bool, default=True,
                        help='bf16 RAFT convolutions; ignored for --model '
                             'lk')
    parser.add_argument('--alternate_corr', action='store_true',
                        help='accepted for reference compatibility and '
                             'ignored: the correlation volume is already '
                             'one batched product')
    parser.add_argument('--data_parallel', action='store_true',
                        help='split the chunks over the GPUs, one '
                             'process each (launch with torchrun)')
    parser.add_argument('--upload_codec', choices=FLOW_CODECS,
                        default='raw',
                        help='host->device frame encoding: yuv420 halves '
                             'the bytes (lossy chroma, any model); y8 '
                             'ships only the luma plane (1/3 the bytes; '
                             '--model lk only, which grays its input '
                             'anyway)')
    parser.add_argument('--device', type=str, default='cuda',
                        help='torch device (default cuda; cpu runs on the '
                             'CPU)')
    return parser.parse_args(argv)


def build_flow_fn(model, raft_weights=None, raft_iters=20, small=False,
                  mixed_precision=True, device=None):
    """(prev_u8, curr_u8) -> (B, H, W, 2) float32 flow on `device`."""
    if model == 'lk':
        return lucas_kanade_flow
    from ..models.raft import build_raft, raft_flow_fn
    from ..models.torch_compat import load_torch_state_dict
    sd = load_torch_state_dict(raft_weights) if raft_weights else None
    net = build_raft(sd, small=small).to(resolve_device(device))
    return raft_flow_fn(net, iters=raft_iters,
                        dtype=torch.bfloat16 if mixed_precision else None)


def make_flow_compute(qfn, device):
    """The card's half of a chunk: `compute(frames)` takes the
    (prev, curr) uint8 host frames (pinned on the card) and returns
    (uint8 payloads as a host array, the event after which they are
    there, or None on the CPU). The frames upload on a side stream, which
    the compute stream waits for; `qfn` (`make_quantized_flow_fn`) runs
    on the compute stream, and the payloads come back into fresh pinned
    memory behind it. Under a profiler the whole is the span
    `vpd.flow.chunk`."""
    device = torch.device(device)
    on_cuda = device.type == 'cuda'
    copy_stream = torch.cuda.Stream(device) if on_cuda else None

    def compute(frames):
        # runs sequentially on the calling thread (run_pipelined)
        with span('vpd.flow.chunk', device):
            if not on_cuda:
                return qfn(*frames).numpy(), None
            compute_stream = torch.cuda.current_stream(device)
            with torch.cuda.stream(copy_stream):
                frames = [f.to(device, non_blocking=True) for f in frames]
            compute_stream.wait_stream(copy_stream)
            for f in frames:
                f.record_stream(compute_stream)
            q = qfn(*frames)
            host = torch.empty(q.shape, dtype=torch.uint8, pin_memory=True)
            host.copy_(q, non_blocking=True)
            done = torch.cuda.Event()
            done.record(compute_stream)
            return host.numpy(), done

    return compute


def get_pairs(crop_dir, out_suffix, overwrite):
    pairs = []
    for root, _, files in os.walk(crop_dir):
        for f in files:
            if f.endswith('.prev.png'):
                prefix = os.path.join(root, f[:-len('.prev.png')])
                if os.path.isfile(prefix + '.png') and (
                        overwrite or
                        not os.path.exists(prefix + out_suffix)):
                    pairs.append(prefix)
    return sorted(pairs)


def _resolve_model(model, raft_weights):
    if model in ('lk', 'raft'):
        return model, raft_weights
    # the reference's argv: a checkpoint path in --model
    if raft_weights is not None:
        raise SystemExit(
            '--model {!r} looks like a checkpoint path but --raft_weights '
            '{!r} was also given; pass one or the other'.format(
                model, raft_weights))
    if not os.path.isfile(model):
        raise SystemExit(
            "--model must be 'lk', 'raft', or an existing torch RAFT "
            'checkpoint path (got {!r})'.format(model))
    return 'raft', model


def main(path, out_name, clip, img_dim, batch_size, overwrite,
         subtract_median_flag=False, model='lk', raft_weights=None,
         raft_iters=20, small=False, mixed_precision=True,
         alternate_corr=False, upload_codec='raw', data_parallel=False,
         device='cuda'):
    """Returns the number of pairs written (by all ranks)."""
    kwargs = dict(subtract_median_flag=subtract_median_flag, model=model,
                  raft_weights=raft_weights, raft_iters=raft_iters,
                  small=small, mixed_precision=mixed_precision,
                  alternate_corr=alternate_corr, upload_codec=upload_codec)
    if not data_parallel:
        return _run(path, out_name, clip, img_dim, batch_size, overwrite,
                    device=device, **kwargs)
    refuse_devices_without_torchrun(device)
    with distributed(device) as mesh:
        if batch_size % mesh.world:
            raise SystemExit(
                '--batch_size {} must be divisible by the {} ranks for the '
                'batch-dim fan-out'.format(batch_size, mesh.world))
        return _run(path, out_name, clip, img_dim, batch_size, overwrite,
                    mesh=mesh, **kwargs)


def _run(path, out_name, clip, img_dim, batch_size, overwrite,
         subtract_median_flag=False, model='lk', raft_weights=None,
         raft_iters=20, small=False, mixed_precision=True,
         alternate_corr=False, upload_codec='raw', device='cuda',
         mesh=None):
    del alternate_corr  # the corr volume is already one batched product
    model, raft_weights = _resolve_model(model, raft_weights)
    if upload_codec == 'y8' and model != 'lk':
        raise SystemExit(
            '--upload_codec y8 ships luma only, which is valid for the '
            'luminance-only --model lk (RAFT consumes RGB; use yuv420)')
    device = resolve_device(device if mesh is None else mesh.device)
    rank, world = (0, 1) if mesh is None else (mesh.rank, mesh.world)
    out_suffix = '.{}.png'.format(out_name)
    # one listing for every rank: no rank sees another's new PNGs
    pairs = (get_pairs(path, out_suffix, overwrite) if rank == 0
             else None)
    if mesh is not None:
        pairs = broadcast_object(pairs, mesh)
    if rank == 0:
        print('{} frame pairs to process'.format(len(pairs)))
    flow_fn = build_flow_fn(model, raft_weights, raft_iters, small=small,
                            mixed_precision=mixed_precision, device=device)
    if upload_codec == 'yuv420':
        rgb_flow_fn = flow_fn

        def flow_fn(prev_p, curr_p):  # packed (B, H*W*3//2) planes
            return rgb_flow_fn(decode_yuv420(prev_p, img_dim, img_dim),
                               decode_yuv420(curr_p, img_dim, img_dim))
        encode = encode_yuv420
        row = (packed_nbytes(img_dim, img_dim),)
    elif upload_codec == 'y8':
        def flow_fn(prev_p, curr_p):  # packed (B, H*W) luma planes
            b = prev_p.shape[0]
            return lucas_kanade_flow_gray(
                prev_p.reshape(b, img_dim, img_dim),
                curr_p.reshape(b, img_dim, img_dim))
        encode = encode_luma
        row = (img_dim * img_dim,)
    else:
        encode = None
        row = (img_dim, img_dim, 3)
    qfn = make_quantized_flow_fn(flow_fn, clip=clip,
                                 subtract_median=subtract_median_flag)

    import cv2
    png_compression = [cv2.IMWRITE_PNG_COMPRESSION, 9]
    on_cuda = device.type == 'cuda'
    compute = make_flow_compute(qfn, device)

    def decode_chunk(chunk):
        # fresh pinned buffers a chunk: none is rewritten while its async
        # copy is in flight
        frames = []
        for suffix in ('.prev.png', '.png'):
            rgb, _, _ = decode_crop_batch([p + suffix for p in chunk],
                                          img_dim)
            out = torch.empty((len(chunk),) + row, dtype=torch.uint8,
                              pin_memory=on_cuda)
            np.copyto(out.numpy(), rgb if encode is None else encode(rgb))
            frames.append(out)
        return frames

    def write_chunk(chunk, result):
        q, done = result  # (n, H, W, 2) uint8
        if done is not None:
            done.synchronize()
        third = np.full(q.shape[1:3] + (1,), 128, np.uint8)

        def write(j):
            if not cv2.imwrite(chunk[j] + out_suffix,
                               np.concatenate([q[j], third], axis=-1),
                               png_compression):
                raise IOError('cannot write ' + chunk[j] + out_suffix)

        # level-9 deflate of a quantized flow takes tens of ms; cv2
        # releases the GIL, so the chunk's PNGs encode in parallel
        list(writers.map(write, range(len(chunk))))

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(
            max_workers=min(8, os.cpu_count() or 1)) as writers:
        chunks = [pairs[i:i + batch_size]
                  for i in range(0, len(pairs), batch_size)]
        run_pipelined(chunks[rank::world], decode_chunk, compute,
                      write_chunk)
    if mesh is not None:
        barrier()  # every rank's PNGs are written
    if rank == 0:
        print('{} pairs in {:.3f} s'.format(len(pairs),
                                            time.perf_counter() - t0))
        if encode is not None:
            print('upload packer batches: {}'.format(dict(packer_calls)))
        print('Done!')
    return len(pairs)


if __name__ == '__main__':
    a = get_args()
    main(a.path, a.out_name, a.clip, a.img_dim, a.batch_size, a.overwrite,
         subtract_median_flag=a.subtract_median, model=a.model,
         raft_weights=a.raft_weights, raft_iters=a.raft_iters,
         small=a.small, mixed_precision=a.mixed_precision,
         alternate_corr=a.alternate_corr, upload_codec=a.upload_codec,
         data_parallel=a.data_parallel, device=a.device)
