"""VPD student feature extraction: crops -> per-video .emb.pkl.

Counterpart of `vpd_tpu/infer/apply_vpd.py` (reference
`apply_vpd_model.py` + `FrameDataset`): every crop is embedded as the
variants [orig, jitter x j, flip, flip-jitter x j] and written as (frame,
(k, D), {}) rows per video, sorted by frame. Flipped variants use flipped
flow with the x channel negated. Only the encoder runs (the motion head is
train-only).

On CUDA the host decodes each chunk into pinned uint8 buffers, a side
stream copies them to the card, the preprocess kernel (`ops/preprocess`)
writes the orig and flipped variants of the chunk into one (2B, H, W, C)
bf16 channels_last buffer, and the encoder runs once over it. Decode runs
one chunk ahead and readback one chunk behind (`core/pipeline`). With
colour-jitter variants (`jitter` > 0) every variant is built by the plain
transforms instead, as vpd_tpu builds them without its Pallas kernel.
Under a profiler the encoder's run over a chunk's variants is the span
`vpd.extract.encode` (`core/profiling.span`, id `chunk`).

`upload_codec='yuv420'` ships the rgb stream as packed YUV 4:2:0 planes
(`data/upload_codec.py`, half the bytes): packed on the host, or gathered
packed from yuv420 shards, and decoded on the card before the preprocess.
Flow planes ship raw.

On a data mesh (`mesh`, one process per GPU under torchrun) the ranks
split the chunks, chunk i going to rank i mod n: each rank decodes and
embeds its chunks on its own card (kernel B1 included; jitter draws are
keyed by the global chunk index), and rank 0 gathers the rows and writes
every `.emb.pkl`, so the files equal a one-process run's.
"""

import os
import re

import numpy as np
import torch

from .. import resolve_device
from ..core import checkpoint as ckpt
from ..core.io import load_json, store_pickle
from ..core.mesh import gather_object
from ..core.pipeline import run_pipelined
from ..core.profiling import span
from ..data.augment import (batch_color_jitter, eval_transform_batch,
                            flip_batch, normalize_rgb, sample_color_jitter)
from ..data.crops import decode_crop_batch
from ..data.shards import fill_or_decode
from ..data.upload_codec import decode_yuv420, encode_yuv420, packed_nbytes
from ..models.flax_weights import load_encoder_from_flax, load_motion_from_flax
from ..ops.preprocess import preprocess_crops, preprocess_orig_and_flip
from ..train.vpd import fold_in
from ..train.vpd_loop import build_student

EXTRACT_BATCH = 512


def _check_codec(upload_codec):
    if upload_codec not in (None, 'raw', 'yuv420'):
        raise ValueError('unknown upload_codec "{}"'.format(upload_codec))
    return upload_codec == 'yuv420'


def load_student_dir(model_dir, model_epoch=None, dtype=None, device=None):
    """(model, config) of a student dir written by either package (or
    imported from the reference), in eval mode on `device` (CUDA by
    default). A motion head loads where its checkpoint is there; only the
    encoder embeds, and a dir exported to the reference and imported back
    has none, as vpd_tpu's loader reads none."""
    device = resolve_device(device)
    config = load_json(os.path.join(model_dir, 'config.json'))
    model = build_student(config, dtype=dtype)
    name = ('best_epoch' if model_epoch is None
            else 'epoch{:04d}'.format(model_epoch))
    load_encoder_from_flax(model.encoder, ckpt.load_component(
        model_dir, name, 'encoder'))
    if model.motion is not None and os.path.exists(
            ckpt.component_path(model_dir, name, 'decoder')):
        load_motion_from_flax(model.motion, ckpt.load_component(
            model_dir, name, 'decoder'))
    return model.to(device).eval(), config


def make_variant_embed(model, config, jitter=0, flip=True,
                       upload_codec=None, device=None, seed=0):
    """fn(rgb_u8, flow_u8, chunk_i=0, jitter_draws=None) -> (B, k, D)
    float32 variant embeddings.

    Inputs are (B, S, S, 3) uint8 tensors on `device` (flow None for RGB
    models); with `upload_codec='yuv420'` rgb is the packed (B, S*S*3//2)
    planes, decoded first on the device. Variants are [orig, jitter x
    `jitter`, flip, flip-jitter x `jitter`] (the flips only with `flip`).
    Moves `model` to `device` (CUDA by default). Without jitter, on CUDA
    the preprocess kernel writes bf16, the kernel's one output type; on
    the CPU the plain twin writes the encoder's type. Jitter variant j of chunk `chunk_i` draws
    its factors from `fold_in(seed, chunk_i * jitter + j)`, unless
    `jitter_draws` gives them (`data.augment.sample_color_jitter`'s
    layout, one dict per variant).
    """
    yuv420 = _check_codec(upload_codec)
    device = resolve_device(device)
    mean, std = config['rgb_mean_std']
    use_flow = config['use_flow']
    encoder = model.encoder.to(device).eval()
    if device.type == 'cuda':
        # conv weights in NHWC order: the kernel's output feeds cuDNN as is
        encoder.to(memory_format=torch.channels_last)
        out_dtype = torch.bfloat16
    else:
        out_dtype = encoder.compute_dtype

    if jitter:
        fn = _make_jitter_embed(encoder, mean, std, use_flow, jitter, flip,
                                device, seed)
    else:
        fn = _make_kernel_embed(encoder, mean, std, use_flow, flip,
                                out_dtype)
    if not yuv420:
        return fn
    img_dim = config['img_dim']

    def decode_then(rgb_packed, flow_u8, chunk_i=0, jitter_draws=None):
        with torch.inference_mode():
            rgb_u8 = decode_yuv420(rgb_packed, img_dim, img_dim)
        return fn(rgb_u8, flow_u8, chunk_i, jitter_draws)

    return decode_then


def _make_kernel_embed(encoder, mean, std, use_flow, flip, out_dtype):
    """The path of `make_variant_embed` without jitter: kernel B1 builds
    the orig (and flipped) variants, the encoder runs once over them."""

    @torch.inference_mode()
    def fn(rgb_u8, flow_u8, chunk_i=0, jitter_draws=None):
        fl = flow_u8 if use_flow else None
        b = rgb_u8.shape[0]
        if flip:
            x = preprocess_orig_and_flip(rgb_u8, fl, mean, std,
                                         out_dtype=out_dtype)
        else:
            x = preprocess_crops(
                rgb_u8, fl, torch.zeros(b, dtype=torch.int32,
                                        device=rgb_u8.device),
                mean, std, out_dtype=out_dtype)
        with span('vpd.extract.encode', x.device, chunk=chunk_i):
            embs = encoder(x.permute(0, 3, 1, 2))  # NHWC buffer, NCHW view
        return embs.reshape(x.shape[0] // b, b, -1).transpose(0, 1)

    return fn


def _make_jitter_embed(encoder, mean, std, use_flow, jitter, flip, device,
                       seed):
    """The plain path of `make_variant_embed` with jitter variants: each
    variant in float32 (vpd_tpu's `make_variant_embed` without Pallas),
    the encoder once over all of them."""
    stats = [torch.tensor(v, dtype=torch.float32, device=device)
             for v in (mean, std)]
    gen = torch.Generator(device=device)
    host_gen = torch.Generator()

    @torch.inference_mode()
    def fn(rgb_u8, flow_u8, chunk_i=0, jitter_draws=None):
        b = rgb_u8.shape[0]
        x = eval_transform_batch(rgb_u8, *stats,
                                 flow_u8=flow_u8 if use_flow else None)
        variants = [x]
        for j in range(jitter):
            if jitter_draws is not None:
                draws = jitter_draws[j]
            else:
                s = fold_in(seed, chunk_i * jitter + j)
                gen.manual_seed(s)
                host_gen.manual_seed(s)
                draws = sample_color_jitter(gen, host_gen, b)
            xj = normalize_rgb(batch_color_jitter(
                rgb_u8.to(torch.float32) / 255., draws), *stats)
            if use_flow:
                xj = torch.cat([xj, x[..., 3:]], dim=-1)
            variants.append(xj)
        if flip:
            variants += [flip_batch(v, use_flow) for v in variants]
        x = torch.cat(variants)
        with span('vpd.extract.encode', x.device, chunk=chunk_i):
            embs = encoder(x.permute(0, 3, 1, 2))
        return embs.reshape(len(variants), b, -1).transpose(0, 1)

    return fn


def scan_crop_dir(crop_dir):
    """Generic layout: crop_dir/<video>/<frame>.png
    (`apply_vpd_model.py:69-89`)."""
    img_re = re.compile(r'^\d+\.png$')
    videos = []
    tasks = []
    for video_name in sorted(os.listdir(crop_dir)):
        video_crop_dir = os.path.join(crop_dir, video_name)
        if not os.path.isdir(video_crop_dir):
            continue
        video_id = len(videos)
        videos.append(video_name)
        for img_file in sorted(os.listdir(video_crop_dir)):
            if img_re.match(img_file):
                frame_num = int(os.path.splitext(img_file)[0])
                tasks.append((video_id, frame_num,
                              os.path.join(video_crop_dir,
                                           str(frame_num))))
    return videos, tasks


def scan_tennis_crop_dir(video_dir, crop_dir):
    """Tennis layout: per-player crops named by source-video frame; output
    videos are '<player>__<clip>' (`apply_vpd_model.py:36-66`)."""
    videos = []
    tasks = []
    for video_file in sorted(os.listdir(video_dir)):
        if not video_file.endswith('.mp4'):
            continue
        video_name = os.path.splitext(video_file)[0]
        src_video_name, start_frame, end_frame = video_name.rsplit('_', 2)
        start_frame, end_frame = int(start_frame), int(end_frame)
        for player in ('front', 'back'):
            video_id = len(videos)
            videos.append('{}__{}'.format(player, video_name))
            for frame_num in range(start_frame, end_frame + 1):
                prefix = os.path.join(crop_dir, src_video_name, player,
                                      str(frame_num))
                if os.path.isfile(prefix + '.png'):
                    tasks.append((video_id, frame_num - start_frame, prefix))
    return videos, tasks


def apply_vpd(videos, tasks, model_dir, out_dir, model_epoch=None,
              flow_img_name=None, jitter=0, no_flip=False,
              batch_size=EXTRACT_BATCH, mesh=None, log=print,
              prepared=None, embed_fn=None, shard_reader=None,
              upload_codec=None, device=None, seed=0):
    """Extract embeddings for `tasks` [(video_id, frame, path prefix)] into
    `out_dir`/<video>.emb.pkl, on `device` (CUDA by default).

    `prepared=(model, config)` and `embed_fn` (the `make_variant_embed`
    contract, called as fn(rgb, flow, chunk_i)) let repeated calls reuse
    the loaded weights. `shard_reader` (`data.shards.ShardReader` built
    with crop_root) replaces PNG decode with a memmap gather for packed
    crops. `seed` seeds the jitter variants' draws.

    `upload_codec='yuv420'` packs RGB on the host (half the bytes) and
    decodes it on the device; `embed_fn`, if given, must be built with the
    same codec. Shards packed with `--codec yuv420` are gathered packed
    and need `upload_codec='yuv420'`. `mesh` (`core.mesh`) fans the
    chunks out over its ranks, each on the mesh's device; rank 0 writes.
    """
    yuv420 = _check_codec(upload_codec)
    device = resolve_device(device if mesh is None else mesh.device)
    rank, world = (0, 1) if mesh is None else (mesh.rank, mesh.world)
    model, config = (prepared if prepared is not None
                     else load_student_dir(model_dir, model_epoch,
                                           device=device))
    use_flow = config['use_flow']
    if use_flow and not flow_img_name:
        raise ValueError('model uses flow; pass flow_img_name')
    img_dim = config['img_dim']
    shard_codec = 'raw' if shard_reader is None else shard_reader.codec
    if shard_codec != 'raw' and upload_codec != shard_codec:
        raise ValueError(
            'shards are packed with codec "{}"; pass upload_codec="{}" '
            '(raw pixels cannot be reconstructed from lossy shards)'
            .format(shard_codec, shard_codec))
    if embed_fn is not None and (jitter or no_flip):
        raise ValueError(
            'embed_fn bakes in its own variant set; passing jitter/no_flip '
            'alongside it would be silently ignored')
    embed = embed_fn if embed_fn is not None else make_variant_embed(
        model, config, jitter=jitter, flip=not no_flip,
        upload_codec=upload_codec, device=device, seed=seed)
    on_cuda = device.type == 'cuda'
    copy_stream = torch.cuda.Stream(device) if on_cuda else None

    def decode_chunk(chunk):
        # fresh pinned buffers per chunk: one is never rewritten while its
        # async copy is in flight (the caching host allocator holds each
        # block until the copy that read it has finished)
        n = len(chunk)
        raw = (n, img_dim, img_dim, 3)
        rgb = torch.empty((n, packed_nbytes(img_dim, img_dim)) if yuv420
                          else raw, dtype=torch.uint8, pin_memory=on_cuda)
        flow = (torch.empty(raw, dtype=torch.uint8, pin_memory=on_cuda)
                if use_flow else None)
        prefixes = [prefix for _, _, prefix in chunk]
        flow_np = flow.numpy() if flow is not None else None
        # raw pixels land in the upload buffer, or in a host array that
        # the packer encodes into it
        rgb_np = (rgb.numpy() if shard_codec == 'yuv420' or not yuv420
                  else np.empty(raw, np.uint8))
        if shard_reader is not None:
            fill_or_decode(shard_reader, prefixes, img_dim,
                           flow_img_name=flow_img_name, rgb_out=rgb_np,
                           flow_out=flow_np, codec=shard_codec)
        else:
            decode_crop_batch(
                [p + '.png' for p in prefixes], img_dim,
                flow_paths=(['{}.{}.png'.format(p, flow_img_name)
                             for p in prefixes] if use_flow else None),
                rgb_out=rgb_np, flow_out=flow_np)
        if yuv420 and shard_codec == 'raw':
            np.copyto(rgb.numpy(), encode_yuv420(rgb_np))
        return rgb, flow

    chunks = [tasks[i:i + batch_size]
              for i in range(0, len(tasks), batch_size)]
    # this rank's chunks, by global index (the jitter draws' key)
    mine = list(range(rank, len(chunks), world))
    chunk_ids = iter(mine)

    def compute(host):
        # runs sequentially on the calling thread (run_pipelined)
        rgb, flow = host
        chunk_i = next(chunk_ids)
        if not on_cuda:
            return embed(rgb, flow, chunk_i), None
        # upload on a side stream so it overlaps the previous chunk's
        # encoder; the compute stream waits for it before the kernel
        compute_stream = torch.cuda.current_stream(device)
        with torch.cuda.stream(copy_stream):
            rgb = rgb.to(device, non_blocking=True)
            flow = (flow.to(device, non_blocking=True)
                    if flow is not None else None)
        compute_stream.wait_stream(copy_stream)
        for t in (rgb, flow):
            if t is not None:
                t.record_stream(compute_stream)
        out = embed(rgb, flow, chunk_i)
        done = torch.cuda.Event()
        done.record(compute_stream)
        return out, done

    outs = []

    def collect(chunk, result):
        dev_out, done = result
        if done is not None:
            done.synchronize()  # the chunk's stream is done with the output
        outs.append(dev_out.float().cpu().numpy())

    run_pipelined([chunks[i] for i in mine], decode_chunk, compute, collect)
    gathered = gather_object(outs, mesh)
    if gathered is None:  # rank > 0: rank 0 writes
        return
    # astype: an array unpickled from another rank carries its own copy
    # of the float32 dtype, which the .emb.pkl pickle would then repeat;
    # the canonical one keeps the files byte-equal to a one-process run's
    by_chunk = {i: embs.astype(np.float32)
                for r, rank_outs in enumerate(gathered)
                for i, embs in zip(range(r, len(chunks), world), rank_outs)}
    all_embs = [[] for _ in videos]
    for i, chunk in enumerate(chunks):
        embs = by_chunk[i]
        for j, (video_id, frame_num, _) in enumerate(chunk):
            row = embs[j] if embs.shape[1] > 1 else embs[j, 0]
            all_embs[video_id].append((frame_num, row, {}))

    os.makedirs(out_dir, exist_ok=True)
    written = 0
    for video_name, embs in zip(videos, all_embs):
        if embs:
            embs.sort(key=lambda x: x[0])
            store_pickle(
                os.path.join(out_dir, '{}.emb.pkl'.format(video_name)), embs)
            written += 1
        else:
            log('{} has no crops'.format(video_name))
    log('Wrote {} videos'.format(written))
