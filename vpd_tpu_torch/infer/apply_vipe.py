"""VIPE* teacher feature extraction: pose gz-JSON -> per-video .emb.pkl.

Counterpart of `vpd_tpu/infer/apply_vipe.py` (parity with reference
`apply_vipe_model.py`): walks a pose dir (flat `<video>.json.gz` or nested
`<video>/coco_keypoints.json.gz`), normalizes every detection (+ flipped
copy), embeds it, mean-pools multiple detections per frame (flip rows
stacked), and writes the interchange pickle.

The embed call runs on the device: the raw (N, 17, 3) poses and flip
flags go up once, `geometry.coco.normalize_2d_batch_torch` normalizes
them there and the encoder (eval mode) embeds them in chunks of 256.
vpd_tpu pads the last chunk so that XLA runs one program; eval-mode rows
are independent, so the port needs no padding. Videos stream through
`core/pipeline.run_pipelined`: the JSON parse of video i+1 and the pickle
write of video i-1 overlap the embedding of video i.
"""

import os
from collections import defaultdict

import numpy as np
import torch

from .. import resolve_device
from ..core.io import load_gz_json, load_json, store_pickle
from ..core.pipeline import run_pipelined
from ..geometry.coco import normalize_2d_batch_torch, pose_input_dim
from ..models.fc import FCResNet
from ..train.vipe import VIPEModel
from ..train.vipe_loop import load_vipe_components

EMBED_BATCH_SIZE = 256


def iter_pose_videos(pose_dir):
    """Yield (video_name, pose_json_path) for flat or nested layouts."""
    for name in sorted(os.listdir(pose_dir)):
        if name.endswith('.json.gz'):
            yield name[:-len('.json.gz')], os.path.join(pose_dir, name)
        else:
            nested = os.path.join(pose_dir, name, 'coco_keypoints.json.gz')
            if os.path.exists(nested):
                yield name, nested


def collect_video_poses(pose_path, min_score=0, augment_flip=True,
                        invert=False):
    """Parse one video's pose JSON into stacked raw arrays."""
    frames, scores, is_flip, poses = [], [], [], []
    for frame_num, pose_data in load_gz_json(pose_path):
        for score, *_rest, kp in pose_data:
            if score < min_score:
                continue
            kp = np.array(kp, dtype=np.float32)
            if invert:
                kp[:, 1] *= -1
            kp_score = float(np.mean(kp[:, 2]))
            for flip in ((False, True) if augment_flip else (False,)):
                frames.append(frame_num)
                scores.append(kp_score)
                is_flip.append(flip)
                poses.append(kp)
    return (np.array(frames), np.array(scores),
            np.array(is_flip), np.stack(poses) if poses else
            np.zeros((0, 17, 3), np.float32))


def load_model_dir(model_dir, model_epoch=None, device=None):
    """(encoder-only `VIPEModel` in eval mode on `device`, config): the
    encoder rebuilt from the save dir's config.json manifest and its
    `best_epoch` (or `epoch%04d`) checkpoint."""
    config = load_json(os.path.join(model_dir, 'config.json'))
    encoder = FCResNet(
        pose_input_dim(config['embed_bones']),
        out_dim=config['embedding_dim'],
        num_blocks=config['encoder_arch'][0],
        hidden_dim=config['encoder_arch'][1])
    model = VIPEModel(encoder)
    name = ('best_epoch' if model_epoch is None
            else 'epoch{:04d}'.format(model_epoch))
    load_vipe_components(model, model_dir, name)
    return model.to(resolve_device(device)).eval(), config


def make_batched_embed(model, embed_bones):
    """embed(kps, flips) -> (N, D) tensor on the model's device: raw (N,
    17, 3) numpy poses and (N,) flip flags, normalized and embedded there
    in chunks of EMBED_BATCH_SIZE."""
    device = next(model.parameters()).device

    def embed(kps, flips):
        kps = torch.from_numpy(np.ascontiguousarray(kps, np.float32)).to(
            device)
        flips = torch.from_numpy(np.asarray(flips, bool)).to(device)
        out = []
        with torch.no_grad():
            for i in range(0, kps.shape[0], EMBED_BATCH_SIZE):
                normed = normalize_2d_batch_torch(
                    kps[i:i + EMBED_BATCH_SIZE],
                    flips[i:i + EMBED_BATCH_SIZE],
                    include_bone_features=embed_bones)
                out.append(model.embed(normed))
        return torch.cat(out)

    return embed


def mean_embs_by_frame(pred_embs, flip):
    """Average multi-detection frames; stack (orig, flip) rows.

    Parity with `apply_vipe_model.py:39-68` including the min-score /
    `is_mean` metadata.
    """
    grouped = defaultdict(list)
    for frame_num, emb, meta in pred_embs:
        grouped[frame_num].append((emb, meta))

    def get_mean(emb_and_metas):
        embs, metas = zip(*emb_and_metas)
        if len(embs) == 1:
            return embs[0], metas[0]
        return np.mean(embs, axis=0), {
            'kp_score': min(m['kp_score'] for m in metas), 'is_mean': True}

    result = []
    for frame_num, emb_and_metas in grouped.items():
        if flip:
            emb, meta = get_mean(
                [x for x in emb_and_metas if not x[1]['is_flip']])
            emb_flip, _ = get_mean(
                [x for x in emb_and_metas if x[1]['is_flip']])
            result.append((frame_num, np.stack((emb, emb_flip)), meta))
        else:
            emb, meta = get_mean(emb_and_metas)
            result.append((frame_num, emb, meta))
    result.sort(key=lambda x: x[0])
    return result


def apply_vipe(pose_dir, model_dir, out_dir, model_epoch=None,
               min_score=0, no_flip=False, invert=False,
               allow_many_per_frame=False, device=None, log=print):
    """Embed every video of `pose_dir` with the teacher in `model_dir` on
    `device` (CUDA by default) into `out_dir/<video>.emb.pkl`."""
    model, config = load_model_dir(model_dir, model_epoch, device)
    embed = make_batched_embed(model, config['embed_bones'])
    os.makedirs(out_dir, exist_ok=True)

    def parse(task):
        _, pose_path = task
        return collect_video_poses(
            pose_path, min_score=min_score, augment_flip=not no_flip,
            invert=invert)

    def compute(parsed):
        frames, _, is_flip, kps = parsed
        if len(frames) == 0:
            return parsed, None
        return parsed, embed(kps, is_flip)

    def collect(task, result):
        video_name, _ = task
        (frames, scores, is_flip, _), embs_arr = result
        if embs_arr is None:
            return
        embs_arr = embs_arr.cpu().numpy()
        embs = [
            (int(frames[j]), embs_arr[j],
             {'kp_score': float(scores[j]), 'is_mean': False,
              'is_flip': bool(is_flip[j])})
            for j in range(len(frames))]
        if not allow_many_per_frame:
            embs = mean_embs_by_frame(embs, not no_flip)
        store_pickle(
            os.path.join(out_dir, '{}.emb.pkl'.format(video_name)), embs)
        log('{}: {} rows'.format(video_name, len(embs)))

    run_pipelined(list(iter_pose_videos(pose_dir)), parse, compute, collect)
