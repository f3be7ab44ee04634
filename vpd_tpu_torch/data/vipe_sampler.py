"""Host-side samplers for VIPE* teacher training.

The port's copy of `vpd_tpu/data/vipe_sampler.py` (numpy only), so that
`vpd_tpu_torch` imports nothing of `vpd_tpu`. One change: a family's
3D frame-index map and the loaders' file-name keys are module-level
functions (`same_frame`, `people3d_frame`, `amass_frame`, `*_key`) where
vpd_tpu has lambdas, so that samplers pickle into the spawned workers of
`data/parallel_batcher`. Batches are numpy; the trainer stages them on
the device.

Behavioral parity with reference `vipe_dataset/keypoint.py` (the four mocap
dataset classes + pairwise dataset) re-designed as one parameterized
sampler: the per-family differences are a `SkeletonSpec`, a 3D frame-index
function, and a sampling style ('multiview' real camera pairs vs 'synth2'
always-synthetic second view, used by NBA2K).
"""

import math
import os
from collections import defaultdict
from dataclasses import dataclass
from typing import Callable

import numpy as np

from ..core.io import load_gz_json, load_pickle
from ..geometry import amass, human36m, nba2k, people3d
from ..geometry.camera import (random_project_offsets,
                               random_project_offsets_batch)
from ..geometry.coco import (normalize_2d_skeleton,
                             normalize_2d_skeleton_batch)
from ..geometry.features3d import (
    get_3d_features, is_good_3d_neg_sample, mean_offset_norms,
    neg_sample_valid_batch, normalize_3d_offsets)

MAX_NEG_SAMPLE_TRIES = 10
CAMERA_AUG_PROB = 0.5

# Reference `vipe_dataset/keypoint.py:19-20`.
USE_EXTREMITIES = True
USE_ROOT_DIRECTIONS = True


def same_frame(frame_num):
    return frame_num


def people3d_frame(frame_num):
    """3DPeople numbers its 2D frames from 1."""
    return frame_num - 1


def amass_frame(frame_num):
    """AMASS keeps one 3D pose per 25 frames."""
    return frame_num // 25


def people3d_key(fname):
    return tuple(fname.split('.', 1)[0].split('__', 1))


def nba2k_key(fname):
    return (fname.split('.', 1)[0],)


def amass_key(fname):
    return tuple(fname.split('.', 1)[0].split('_', 1))


@dataclass
class FamilyConfig:
    """Per-mocap-family sampling behavior."""
    name: str
    spec: object
    # maps the 2D frame number to the index into the 3D pose list
    pose3d_index: Callable = same_frame
    # 'multiview': two real cameras (or synthetic w/ prob); 'synth2':
    # pose2 and negatives are always synthetic projections (NBA2K).
    style: str = 'multiview'
    train_target_len: int = 20000
    val_target_len: int = 2000
    # NBA2K: the reference's load_default hardcodes camera augmentation
    # on (keypoint.py:442-465 passes True regardless of the CLI flag)
    force_camera_aug: bool = False


FAMILIES = {
    'human36m': FamilyConfig(
        'human36m', human36m.SPEC, train_target_len=20000,
        val_target_len=2000),
    '3dpeople': FamilyConfig(
        '3dpeople', people3d.SPEC,
        pose3d_index=people3d_frame,
        train_target_len=5000, val_target_len=500),
    'nba2k': FamilyConfig(
        'nba2k', nba2k.SPEC, style='synth2', force_camera_aug=True,
        train_target_len=5000, val_target_len=500),
    'amass': FamilyConfig(
        'amass', amass.SPEC,
        pose3d_index=amass_frame,
        train_target_len=20000, val_target_len=2000),
}


class VIPESampler:
    """Samples (pose1, pose2, pose_neg, 3D features) rows for one family.

    `sequences`: list of (key, frames) where frames is a list of
    (frame_num, [(camera, (17, 3) pose), ...]).
    `poses_3d`: {key: [(root, theta, (E, 3) offsets), ...]}.
    """

    def __init__(self, family, sequences, poses_3d, *, random_hflip=True,
                 augment_camera=True, embed_bones=False, target_len=None,
                 seed=0):
        self.family = family
        self.spec = family.spec
        self.sequences = sequences
        self.poses_3d = poses_3d
        self.random_hflip = random_hflip
        self.augment_camera = augment_camera or family.force_camera_aug
        self.embed_bones = embed_bones
        self.target_len = target_len or family.train_target_len
        self.rng = np.random.default_rng(seed)
        self.sample_count = 0
        self.neg_fail_count = 0

    def __len__(self):
        return max(self.target_len, len(self.sequences))

    @property
    def kp_feature_dim(self):
        """Static flattened width of sample()['kp_features']: E edges x
        (3 offset + 1 parent angle [+ 3 root direction]) — the
        get_3d_features layout. Derivable from the spec alone, so
        FusedBatcher can size its padding without drawing a sample
        (which would advance the RNG stream)."""
        per_edge = 4 + (3 if USE_ROOT_DIRECTIONS else 0)
        return self.spec.num_edges * per_edge

    @property
    def mean_kp_offset_norms(self):
        def stacks():
            for key, _ in self.sequences:
                for _, _, offsets in self.poses_3d[key]:
                    yield offsets
        return mean_offset_norms(stacks())

    def _should_flip(self):
        return self.random_hflip and self.rng.integers(2) > 0

    def _should_project(self):
        return self.augment_camera and self.rng.random() < CAMERA_AUG_PROB

    def _project(self, raw_offsets):
        return random_project_offsets(self.spec, raw_offsets, self.rng)

    def _choice(self, items):
        return items[self.rng.integers(len(items))]

    def _valid_frame(self, frames, seq_poses):
        while True:
            frame_num, cams = self._choice(frames)
            idx = self.family.pose3d_index(frame_num)
            if 0 <= idx < len(seq_poses):
                return frame_num, idx, cams

    def _negative(self, frames, seq_poses, norm_kp_offsets):
        """Rejection-sample a pose >45° away at some joint; may fail."""
        for _ in range(MAX_NEG_SAMPLE_TRIES):
            frame_num, cams = self._choice(frames)
            idx = self.family.pose3d_index(frame_num)
            if not (0 <= idx < len(seq_poses)):
                continue
            raw = seq_poses[idx][-1]
            neg_flip = self._should_flip()
            cand = self.spec.flip_offsets(raw) if neg_flip else raw
            if is_good_3d_neg_sample(
                    normalize_3d_offsets(cand)[0], norm_kp_offsets):
                if self.family.style == 'synth2' or self._should_project():
                    return self._project(raw), neg_flip
                return self._choice(cams)[1], neg_flip
        self.neg_fail_count += 1
        return None, False

    def sample(self):
        """Draw one training row (dict of numpy arrays)."""
        self.sample_count += 1
        key, frames = self._choice(self.sequences)
        seq_poses = self.poses_3d[key]
        flip = self._should_flip()

        frame_num, idx, cams = self._valid_frame(frames, seq_poses)
        _, _, raw_offsets = seq_poses[idx]

        abs_offsets = (self.spec.flip_offsets(raw_offsets) if flip
                       else raw_offsets)

        if self.family.style == 'synth2':
            pose_2d1 = np.asarray(cams[0][1])
            if self._should_project():
                pose_2d1 = self._project(raw_offsets)
            pose_2d2 = self._project(raw_offsets)
        else:
            if len(cams) > 1:
                i, j = self.rng.choice(len(cams), 2, replace=False)
            else:
                i = j = 0
            pose_2d1, pose_2d2 = np.asarray(cams[i][1]), np.asarray(cams[j][1])
            if self._should_project():
                pose_2d1 = self._project(raw_offsets)
            if self._should_project():
                pose_2d2 = self._project(raw_offsets)

        neg_pose2d, neg_flip = self._negative(
            frames, seq_poses, normalize_3d_offsets(abs_offsets)[0])

        norm1 = normalize_2d_skeleton(
            pose_2d1, flip, include_bone_features=self.embed_bones)
        return {
            'pose1': norm1,
            'pose2': normalize_2d_skeleton(
                pose_2d2, flip, include_bone_features=self.embed_bones),
            'pose_neg': (np.zeros_like(norm1) if neg_pose2d is None
                         else normalize_2d_skeleton(
                             neg_pose2d, neg_flip,
                             include_bone_features=self.embed_bones)),
            'neg_valid': np.float32(neg_pose2d is not None),
            'kp_features': get_3d_features(
                abs_offsets, self.spec,
                include_extremities=USE_EXTREMITIES,
                include_root_directions=USE_ROOT_DIRECTIONS
            ).astype(np.float32),
        }

    def sample_batch(self, n):
        """Vectorized `sample()`: n rows as stacked arrays.

        Same per-row semantics (frame/camera choices, camera-aug
        probability, rejection-sampled negatives with flip) but the
        geometry — flips, synthetic projections, 2D normalization, 3D
        features — runs batched over the whole draw, which is what makes
        the host sampler keep up with the device step on few-core hosts.
        RNG draws are batched, so the stream differs from n `sample()`
        calls; the distribution is identical.
        """
        self.sample_count += n
        rng = self.rng
        synth2 = self.family.style == 'synth2'

        flips = (rng.integers(2, size=n) > 0) if self.random_hflip \
            else np.zeros(n, bool)

        raws = []
        row_frames = []  # (frames, seq_poses) per row, for negatives
        pose1 = np.empty((n, 17, 3), np.float32)
        pose2 = np.empty((n, 17, 3), np.float32)
        proj1, proj2 = [], []
        for i in range(n):
            key, frames = self._choice(self.sequences)
            seq_poses = self.poses_3d[key]
            _, idx, cams = self._valid_frame(frames, seq_poses)
            raws.append(seq_poses[idx][-1])
            row_frames.append((frames, seq_poses))
            if synth2:
                if self._should_project():
                    proj1.append(i)
                else:
                    pose1[i] = cams[0][1]
                proj2.append(i)
            else:
                if len(cams) > 1:
                    a, b = rng.choice(len(cams), 2, replace=False)
                else:
                    a = b = 0
                if self._should_project():
                    proj1.append(i)
                else:
                    pose1[i] = cams[a][1]
                if self._should_project():
                    proj2.append(i)
                else:
                    pose2[i] = cams[b][1]
        raws = np.stack(raws)  # (n, E, 3)

        flipped_raws = self.spec.flip_offsets(raws)
        abs_offsets = np.where(flips[:, None, None], flipped_raws, raws)

        if proj1:
            pose1[proj1] = random_project_offsets_batch(
                self.spec, raws[proj1], rng)
        if proj2:
            pose2[proj2] = random_project_offsets_batch(
                self.spec, raws[proj2], rng)

        # ---- negatives: batched rejection rounds --------------------------
        norm_abs = normalize_3d_offsets(abs_offsets)[0]
        neg_pose = np.zeros((n, 17, 3), np.float32)
        neg_flip = np.zeros(n, bool)
        neg_valid = np.zeros(n, np.float32)
        unresolved = list(range(n))
        for _ in range(MAX_NEG_SAMPLE_TRIES):
            if not unresolved:
                break
            cand_rows, cand_raws = [], []
            for i in unresolved:
                frames, seq_poses = row_frames[i]
                frame_num, cams = self._choice(frames)
                idx = self.family.pose3d_index(frame_num)
                if 0 <= idx < len(seq_poses):
                    cand_rows.append((i, cams))
                    cand_raws.append(seq_poses[idx][-1])
            if not cand_rows:
                continue
            cand_raws = np.stack(cand_raws)
            cflips = (rng.integers(2, size=len(cand_rows)) > 0) \
                if self.random_hflip else np.zeros(len(cand_rows), bool)
            cand_abs = np.where(cflips[:, None, None],
                                self.spec.flip_offsets(cand_raws),
                                cand_raws)
            rows_idx = np.array([i for i, _ in cand_rows])
            ok = neg_sample_valid_batch(
                normalize_3d_offsets(cand_abs)[0], norm_abs[rows_idx])
            proj_rows, proj_src = [], []
            for k, (i, cams) in enumerate(cand_rows):
                if not ok[k]:
                    continue
                neg_flip[i] = cflips[k]
                neg_valid[i] = 1
                if synth2 or self._should_project():
                    proj_rows.append(i)
                    proj_src.append(cand_raws[k])
                else:
                    neg_pose[i] = self._choice(cams)[1]
                unresolved.remove(i)
            if proj_rows:
                neg_pose[proj_rows] = random_project_offsets_batch(
                    self.spec, np.stack(proj_src), rng)
        self.neg_fail_count += len(unresolved)

        # ---- batched 2D normalization + 3D features -----------------------
        all_poses = np.concatenate([pose1, pose2, neg_pose], axis=0)
        all_flips = np.concatenate([flips, flips, neg_flip])
        norm = normalize_2d_skeleton_batch(
            all_poses, all_flips, include_bone_features=self.embed_bones)
        n1, n2, nn = norm[:n], norm[n:2 * n], norm[2 * n:].copy()
        nn[neg_valid == 0] = 0  # sample() returns exact zeros when invalid

        return {
            'pose1': n1,
            'pose2': n2,
            'pose_neg': nn,
            'neg_valid': neg_valid,
            'kp_features': get_3d_features(
                abs_offsets, self.spec,
                include_extremities=USE_EXTREMITIES,
                include_root_directions=USE_ROOT_DIRECTIONS
            ).astype(np.float32),
        }

    def get_sequence(self, index, stride=25):
        """Strided eval sequence for preview rendering (parity with the
        reference get_sequence methods)."""
        key, frames = self.sequences[index % len(self.sequences)]
        seq_poses = self.poses_3d[key]
        out = []
        for i, (frame_num, cams) in enumerate(frames):
            if i % stride != 0:
                continue
            idx = self.family.pose3d_index(frame_num)
            if not (0 <= idx < len(seq_poses)):
                continue
            _, rotation, abs_offsets = seq_poses[idx]
            norm_offsets, dists = normalize_3d_offsets(abs_offsets)
            out.append({
                'key': key, 'frame': frame_num, 'rotation': rotation,
                'kp_offsets': norm_offsets, 'kp_offset_norms': dists,
                'pose': normalize_2d_skeleton(
                    np.asarray(self._choice(cams)[1]), False,
                    include_bone_features=self.embed_bones),
            })
        return out


class PairwiseSampler:
    """Cross-person same-action positive pairs (no 3D, no negatives).

    Parity with `Pairwise_People3dDataset` (`vipe_dataset/keypoint.py:870-926`).
    """

    def __init__(self, sequences, *, embed_bones=False, random_hflip=True,
                 target_len=None, seed=0):
        self.point_dict = {
            tuple(k): ([f for f, _ in frames], dict(frames))
            for k, frames in sequences}
        self.people = sorted({k[0] for k in self.point_dict})
        self.actions = sorted({k[1] for k in self.point_dict})
        self.embed_bones = embed_bones
        self.random_hflip = random_hflip
        self.target_len = target_len or 20 * len(self.actions)
        self.rng = np.random.default_rng(seed)

    def __len__(self):
        return self.target_len

    def sample(self):
        action = self.actions[self.rng.integers(len(self.actions))]
        p1, p2 = self.rng.choice(self.people, 2, replace=False)
        frames1, cams1 = self.point_dict[(p1, action)]
        _, cams2 = self.point_dict[(p2, action)]
        for _ in range(1000):
            frame_num = frames1[self.rng.integers(len(frames1))]
            all_cams2 = cams2.get(frame_num)
            if all_cams2 is None:
                continue
            pose1 = cams1[frame_num][self.rng.integers(
                len(cams1[frame_num]))][1]
            pose2 = all_cams2[self.rng.integers(len(all_cams2))][1]
            break
        else:
            raise RuntimeError('no shared frames for {} vs {}'.format(p1, p2))

        flip = self.random_hflip and self.rng.integers(2) > 0
        return {
            'pose1': normalize_2d_skeleton(
                np.asarray(pose1), flip,
                include_bone_features=self.embed_bones),
            'pose2': normalize_2d_skeleton(
                np.asarray(pose2), flip,
                include_bone_features=self.embed_bones),
        }


class FusedBatcher:
    """Builds one fixed-shape device batch from N family samplers.

    Per batch, each sampler contributes rows proportional to its
    target_len (mirroring the reference's per-dataset loader batch sizing,
    `train_vipe_model.py:212-225`) and rows carry `dataset_id`. 3D feature
    targets are flattened and zero-padded to the max family dim;
    `kp_dim` masks real columns. Samplers without 3D (pairwise) emit
    has_3d=0 rows.
    """

    def __init__(self, samplers, batch_size, divisor=1):
        self.samplers = list(samplers)
        total = sum(len(s) for s in self.samplers)
        self.rows = [max(1, round(batch_size * len(s) / total))
                     for s in self.samplers]
        # Per-sampler rounding drifts the summed batch; snap it to a
        # multiple of `divisor` (the mesh 'data' axis size) so
        # shard_batch's NamedSharding placement never sees a
        # non-divisible leading dim. Adjust the largest contributor.
        if divisor > 1:
            rem = sum(self.rows) % divisor
            if rem:
                big = int(np.argmax(self.rows))
                bump = divisor - rem
                if self.rows[big] > rem:
                    self.rows[big] -= rem
                else:
                    self.rows[big] += bump
        self.batch_size = sum(self.rows)
        self.num_batches = math.ceil(total / self.batch_size)

        # static per-family widths: must not draw a sample here (two
        # batchers over the same samplers would see shifted RNG streams)
        self.kp_dims = [s.kp_feature_dim if isinstance(s, VIPESampler)
                        else 0 for s in self.samplers]
        self.max_kp_dim = max(self.kp_dims) if self.kp_dims else 0

    def next_batch(self):
        blocks = defaultdict(list)
        for ds_id, (sampler, n) in enumerate(
                zip(self.samplers, self.rows)):
            if hasattr(sampler, 'sample_batch'):
                s = sampler.sample_batch(n)
            else:  # per-sample path (PairwiseSampler); stack to a block
                drawn = [sampler.sample() for _ in range(n)]
                s = {k: np.stack([d[k] for d in drawn])
                     for k in drawn[0]}
            pose1 = s['pose1'].reshape(n, -1)
            blocks['pose1'].append(pose1)
            blocks['pose2'].append(s['pose2'].reshape(n, -1))
            if 'pose_neg' in s:
                blocks['pose_neg'].append(s['pose_neg'].reshape(n, -1))
                blocks['neg_valid'].append(
                    np.asarray(s['neg_valid'], np.float32))
            else:
                blocks['pose_neg'].append(np.zeros_like(pose1))
                blocks['neg_valid'].append(np.zeros(n, np.float32))
            kp = np.zeros((n, self.max_kp_dim), dtype=np.float32)
            if 'kp_features' in s:
                flat = s['kp_features'].reshape(n, -1)
                kp[:, :flat.shape[1]] = flat
                blocks['has_3d'].append(np.ones(n, np.float32))
            else:
                blocks['has_3d'].append(np.zeros(n, np.float32))
            blocks['kp_features'].append(kp)
            blocks['dataset_id'].append(np.full(n, ds_id, np.int32))
        return {k: np.concatenate(v) for k, v in blocks.items()}

    def kp_mask(self):
        """(num_datasets, max_kp_dim) column mask for the MSE."""
        mask = np.zeros((len(self.samplers), self.max_kp_dim),
                        dtype=np.float32)
        for i, d in enumerate(self.kp_dims):
            mask[i, :d] = 1
        return mask


# ---------------------------------------------------------------------------
# Real-data loaders (reference load_default parity). Each returns
# (train_sequences, val_sequences, poses_3d).
# ---------------------------------------------------------------------------

VAL_PEOPLE = {
    'human36m': {'S9', 'S11'},
    'nba2k': {'alfred', 'allen', 'barney', 'bradley'},
    '3dpeople': {'{}{:02d}'.format(s, i + 1)
                 for s in ('man', 'woman') for i in range(4)},
    'amass': {'EyesJapanDataset'},
}

AMASS_SAMPLE_WEIGHTS = {
    'MPIHDM05': 10, 'MPILimits': 10, 'MPImosh': 10,
}


def _load_person_poses(pose_2d_dir, pose_2d_file):
    person_pose = []
    for frame, all_camera_pose_data in sorted(
            load_gz_json(os.path.join(pose_2d_dir, pose_2d_file))):
        frame_camera_pose = []
        for camera, pose_data in all_camera_pose_data:
            assert len(pose_data) > 0
            kp = np.array(pose_data[-1], dtype=np.float32)
            frame_camera_pose.append((camera, kp))
        person_pose.append((frame, frame_camera_pose))
    assert len(person_pose) > 0
    return person_pose


def load_human36m(pose_2d_dir, pose_3d_file):
    exclude_actions = {'_ALL', '_ALL 1'}
    pose_2d = defaultdict(lambda: defaultdict(list))
    for pose_2d_file in sorted(os.listdir(pose_2d_dir)):
        person, action, camera, _ = pose_2d_file.split('.', 3)
        if action in exclude_actions:
            continue
        seq_pose = load_gz_json(os.path.join(pose_2d_dir, pose_2d_file))
        for frame, pose_data in seq_pose:
            if len(pose_data) > 0:
                kp = np.array(pose_data[0][-1], dtype=np.float32)
                pose_2d[(person, action)][frame].append((camera, kp))
    sequences = sorted(
        (k, sorted(v.items())) for k, v in pose_2d.items())
    poses_3d = load_pickle(pose_3d_file)
    return _split_by_person(sequences, VAL_PEOPLE['human36m']), poses_3d


def load_keyed(pose_2d_dir, pose_3d_file, family_name, key_fn):
    sequences = []
    for pose_2d_file in sorted(os.listdir(pose_2d_dir)):
        key = key_fn(pose_2d_file)
        sequences.append((key, _load_person_poses(pose_2d_dir, pose_2d_file)))
    poses_3d = load_pickle(pose_3d_file) if pose_3d_file else None
    return _split_by_person(sequences, VAL_PEOPLE[family_name]), poses_3d


def load_3dpeople(pose_2d_dir, pose_3d_file):
    return load_keyed(
        pose_2d_dir, pose_3d_file, '3dpeople', people3d_key)


def load_nba2k(pose_2d_dir, pose_3d_file):
    return load_keyed(
        pose_2d_dir, pose_3d_file, 'nba2k', nba2k_key)


def load_amass(pose_2d_dir, pose_3d_file):
    """AMASS sequences, unweighted.

    The reference builds a duplication-weighted `all_sequences` list
    (`vipe_dataset/keypoint.py:836-851`, x10 for MPIHDM05/MPILimits/
    MPImosh) but then filters `train_2d` from the UNWEIGHTED `pose_2d`
    — the weighted list is dead code, so the reference trains AMASS
    unweighted and so do we (QUIRKS.md). `AMASS_SAMPLE_WEIGHTS` records
    the dead table for anyone who wants to opt in."""
    return load_keyed(
        pose_2d_dir, pose_3d_file, 'amass', amass_key)


def _split_by_person(sequences, val_people):
    train = sorted(x for x in sequences if x[0][0] not in val_people)
    val = sorted(x for x in sequences if x[0][0] in val_people)
    return train, val
