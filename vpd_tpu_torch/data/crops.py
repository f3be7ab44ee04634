"""Host-side crop dataset: PNG decode, teacher targets, training batches.

Counterpart of `vpd_tpu/data/crops.py` (reference
`vpd_dataset/single_frame.py`): scans a teacher `.emb.pkl` dir, filters by
pose score, optionally row-normalizes targets and builds `[e_t, e_t -
e_{t-1}]` motion targets (consecutive frames only), splits 80/20 into
train and val, and samples batches at random with a virtual epoch length.
The host only decodes PNGs (or gathers packed shards) into uint8 arrays;
all float math runs on the device (`data/augment.py`, `ops/preprocess.py`).
A prefetch thread decodes ahead and stages each batch on the device.

Decoding has one chokepoint, `decode_crop_batch`, as in vpd_tpu: the C++
thread-pool decoder (`native_loader`) when it builds, else cv2 when it is
installed, else PIL, each imported at first use. `use_native=None` probes
the native one (building it at first use), as vpd_tpu does. The decoder
that ran is counted in `decoder_calls` (one a batch), and a
`CropBatchSource` records its own in `decoder`. Channel order: RGB crops
come back RGB. Flow PNGs come back in cv2's raw BGR order — the order the
flow was written in and the one the consumers (channels 0-1 = x, y flow)
read — on every decoder: the PIL branch reverses PIL's RGB to match
(vpd_tpu's PIL branch returns RGB order instead; ROADMAP "C. Faults").
Masks are the first channel of the raw decode; a missing mask zero-fills.
"""

import os
import queue
import threading

import numpy as np
import torch

from ..core.io import EMB_FILE_SUFFIX, load_pickle
from ..core.mesh import part_rows

DEFAULT_MIN_POSE_SCORE = 0.5

# batches each decoder decoded, in this process
decoder_calls = {'native': 0, 'cv2': 0, 'PIL': 0}


def _cv2():
    try:
        import cv2
    except ImportError:
        return None
    cv2.setNumThreads(0)
    return cv2


def _imread(path, img_dim, rgb):
    cv2 = _cv2()
    if cv2 is not None:
        img = cv2.imread(path)
        if img is None:
            raise FileNotFoundError('cannot decode {}'.format(path))
        if rgb:
            img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
        if img.shape[0] != img_dim or img.shape[1] != img_dim:
            img = cv2.resize(img, (img_dim, img_dim))
        return img
    from PIL import Image

    img = Image.open(path)
    img = img.convert('RGB')
    if img.size != (img_dim, img_dim):
        img = img.resize((img_dim, img_dim))
    img = np.asarray(img)
    return img if rgb else img[..., ::-1]  # raw reads keep cv2's BGR


def resolve_decoder(use_native=None):
    """The decoder `decode_crop_batch` runs: 'native' when `use_native` is
    set, or when it is None and the native decoder builds; else 'cv2' or
    'PIL', whichever is installed."""
    from . import native_loader
    if use_native is None:
        use_native = native_loader.available()
    if use_native:
        return 'native'
    return 'cv2' if _cv2() is not None else 'PIL'


def decode_crop_batch(rgb_paths, img_dim, *, flow_paths=None,
                      mask_paths=None, rgb_out=None, flow_out=None,
                      mask_out=None, use_native=None):
    """Batch PNG decode into (n, S, S, 3) rgb [+ (n, S, S, 3) flow] [+ (n,
    S, S) mask]; returns (rgb, flow, mask), None where not asked for.

    The one native-vs-host chokepoint (`resolve_decoder`); byte-identical
    either way. `*_out` arrays, when given, are filled in place (rows
    past len(paths) are left untouched). Missing masks zero-fill; a
    missing rgb or flow file raises.
    """
    n = len(rgb_paths)
    if rgb_out is None:
        rgb_out = np.zeros((n, img_dim, img_dim, 3), np.uint8)
    if flow_paths is not None and flow_out is None:
        flow_out = np.zeros((n, img_dim, img_dim, 3), np.uint8)
    if mask_paths is not None and mask_out is None:
        mask_out = np.zeros((n, img_dim, img_dim), np.uint8)
    decoder = resolve_decoder(use_native)
    decoder_calls[decoder] += 1
    if decoder == 'native':
        from . import native_loader
        native_loader.decode_crops(
            rgb_paths, img_dim, flow_paths=flow_paths,
            mask_paths=mask_paths, rgb_out=rgb_out[:n],
            flow_out=flow_out[:n] if flow_paths is not None else None,
            mask_out=mask_out[:n] if mask_paths is not None else None)
        return rgb_out, flow_out, mask_out
    for i in range(n):
        rgb_out[i] = _imread(rgb_paths[i], img_dim, rgb=True)
        if flow_paths is not None:
            flow_out[i] = _imread(flow_paths[i], img_dim, rgb=False)
        if mask_paths is not None:
            mask_out[i] = (_imread(mask_paths[i], img_dim, rgb=False)[..., 0]
                           if os.path.exists(mask_paths[i]) else 0)
    return rgb_out, flow_out, mask_out


def get_pose_score(meta, default=None):
    for key in ('dp_score', 'kp_score'):
        if meta.get(key) is not None:
            return meta[key]
    if default is not None:
        return default
    raise NotImplementedError('no pose score in meta')


def _normalize_rows(x):
    if len(x.shape) == 1:
        return x / np.linalg.norm(x)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def scan_emb_dir(emb_dir, *, embed_time=False, min_pose_score=None,
                 normalize_target=False, exclude_prefixes=None,
                 tennis_layout=False, log=print):
    """Build the flat (video, [player,] frame, emb_target) sample list.

    Returns (samples, emb_dim) where each sample is
    (video_name, player_or_None, frame_num, emb_target (D,) or (2, D)).
    """
    score_thresh = (DEFAULT_MIN_POSE_SCORE if min_pose_score is None
                    else min_pose_score)
    samples = []
    emb_dim = None
    for emb_file in sorted(os.listdir(emb_dir)):
        if not emb_file.endswith(EMB_FILE_SUFFIX):
            continue
        video_name = emb_file[:-len(EMB_FILE_SUFFIX)]
        if exclude_prefixes is not None and \
                video_name.startswith(tuple(exclude_prefixes)):
            log('Excluded: {}'.format(video_name))
            continue

        video_embs = load_pickle(os.path.join(emb_dir, emb_file))
        if emb_dim is None and video_embs:
            emb_dim = video_embs[0][1].shape[-1]

        player = None
        frame_base = 0
        crop_video = video_name
        if tennis_layout:
            # '<player>__<video>_<start>_<end>' (single_frame.py:117-119)
            player, rest = video_name.split('__', 1)
            crop_video, start_frame, _ = rest.rsplit('_', 2)
            frame_base = int(start_frame)

        for i, (frame_num, emb_target, emb_meta) in enumerate(video_embs):
            if emb_target.shape[-1] != emb_dim:
                raise ValueError('{}: frame {} has width {}, not {}'.format(
                    emb_file, frame_num, emb_target.shape[-1], emb_dim))
            if get_pose_score(emb_meta) < score_thresh:
                continue
            if normalize_target:
                emb_target = _normalize_rows(emb_target)
            if embed_time:
                if i == 0 or video_embs[i - 1][0] != frame_num - 1:
                    continue
                emb_prev = video_embs[i - 1][1]
                if normalize_target:
                    emb_prev = _normalize_rows(emb_prev)
                emb_target = np.concatenate(
                    [emb_target, emb_target - emb_prev],
                    axis=0 if len(emb_target.shape) == 1 else 1)
            samples.append((crop_video, player, frame_base + frame_num,
                            emb_target))
    return samples, emb_dim


def train_val_split(samples, test_size=0.2, seed=0):
    rng = np.random.default_rng(seed)
    order = rng.permutation(len(samples))
    n_val = int(round(len(samples) * test_size))
    val_idx = set(order[:n_val].tolist())
    train = [s for i, s in enumerate(samples) if i not in val_idx]
    val = [s for i, s in enumerate(samples) if i in val_idx]
    return train, val


class CropBatchSource:
    """Random-sampling uint8 batch producer over crop PNG directories or
    packed raw shards.

    Produces dicts of host numpy arrays:
      {'rgb': (B,S,S,3) u8, 'emb': (B,D), 'flip': (B,) bool,
       'flow': (B,S,S,3) u8?, 'mask': (B,S,S) u8?}
    The target row (orig vs flipped teacher emb) is chosen here when the
    target has flip rows; the pixel flip happens on the device with the
    same boolean. Samples, flips and rows are drawn from
    `np.random.default_rng(seed)` in vpd_tpu's order, so a seed gives the
    same batches in both packages. PNGs (and crops missing from the
    shards) go through `decode_crop_batch` with `use_native`; `decoder`
    names the decoder that runs.

    `batch_part` (i, k) makes the source a rank's of a data mesh: it draws
    every global batch of `batch_size` rows, as one process does, and
    decodes and returns block i of k alone.
    """

    def __init__(self, samples, img_dir, img_dim, batch_size, *,
                 target_len=20000, flow_img_name=None, use_mask=True,
                 augment=True, seed=0, use_native=None, shard_dir=None,
                 batch_part=(0, 1)):
        if not samples:
            raise ValueError('empty crop dataset')
        part_rows(batch_size, batch_part)  # the batch must split
        self.batch_part = batch_part
        self.samples = samples
        self.img_dir = img_dir
        self.img_dim = img_dim
        self.batch_size = batch_size
        self.target_len = target_len
        self.flow_img_name = flow_img_name
        self.use_mask = use_mask
        self.augment = augment
        self.rng = np.random.default_rng(seed)
        self.decoder = resolve_decoder(use_native)
        self.use_native = self.decoder == 'native'
        self.shards = None
        if shard_dir is not None:  # packed-shard cache: memcpy, no codec
            from .shards import ShardReader
            self.shards = ShardReader(shard_dir, crop_root=img_dir)
            if self.shards.codec != 'raw':
                raise ValueError(
                    'training reads raw pixels; "{}" shards are extraction-'
                    'only (pack without --codec)'.format(self.shards.codec))
            packed = self.shards.meta['flow_img_name']
            if flow_img_name and packed != flow_img_name:
                raise ValueError('shards packed with flow "{}", model needs '
                                 '"{}"'.format(packed, flow_img_name))
            if use_mask and not self.shards.meta['use_mask']:
                raise ValueError('shards packed without masks but '
                                 'use_mask=True')

    @property
    def num_batches(self):
        return max(1, self.target_len // self.batch_size)

    def _prefix(self, video, player, frame):
        base = (os.path.join(self.img_dir, video, player)
                if player else os.path.join(self.img_dir, video))
        return os.path.join(base, str(frame))

    def _draw(self):
        """(sample, flip) of every row of a global batch, in vpd_tpu's
        draw order."""
        out = []
        for _ in range(self.batch_size):
            s = int(self.rng.integers(len(self.samples)))
            out.append((s, bool(self.augment and self.rng.integers(2))))
        return out

    def _target(self, s, flip):
        """The teacher row and the flip of sample `s` drawn with `flip`."""
        emb = self.samples[s][3]
        if emb.ndim == 2:  # (orig, flip) teacher rows
            return emb[int(flip)], flip
        return emb, False  # no flipped target available

    def next_batch(self):
        drawn = self._draw()[part_rows(self.batch_size, self.batch_part)]
        b = len(drawn)
        s = self.img_dim
        rgb = np.zeros((b, s, s, 3), np.uint8)
        flow = (np.zeros((b, s, s, 3), np.uint8)
                if self.flow_img_name else None)
        mask = np.zeros((b, s, s), np.uint8) if self.use_mask else None
        embs = []
        flips = np.zeros(b, bool)
        prefixes = []
        for i, (si, flip) in enumerate(drawn):
            video, player, frame, _ = self.samples[si]
            emb, flips[i] = self._target(si, flip)
            prefixes.append(self._prefix(video, player, frame))
            embs.append(emb)
        if self.shards is not None:
            from .shards import fill_or_decode
            fill_or_decode(self.shards, prefixes, s,
                           flow_img_name=self.flow_img_name, rgb_out=rgb,
                           flow_out=flow, mask_out=mask,
                           use_native=self.use_native)
        else:
            decode_crop_batch(
                [p + '.png' for p in prefixes], s,
                flow_paths=(['{}.{}.png'.format(p, self.flow_img_name)
                             for p in prefixes] if flow is not None
                            else None),
                mask_paths=([p + '.mask.png' for p in prefixes]
                            if mask is not None else None),
                rgb_out=rgb, flow_out=flow, mask_out=mask,
                use_native=self.use_native)
        out = {'rgb': rgb, 'emb': np.stack(embs).astype(np.float32),
               'flip': flips}
        if flow is not None:
            out['flow'] = flow
        if mask is not None:
            out['mask'] = mask
        return out


class _DeviceStager:
    """Copies a host batch to `device`. On CUDA the prefetch thread pins
    each array and copies it on a side stream (`stage`); the consumer's
    stream waits for that batch's copies only (`ready`), and the tensors
    are marked as used by it, so the allocator keeps them until it is
    done."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.stream = (torch.cuda.Stream(self.device)
                       if self.device.type == 'cuda' else None)

    def stage(self, batch):
        if self.stream is None:
            return {k: torch.as_tensor(v) for k, v in batch.items()}, None
        with torch.cuda.stream(self.stream):
            out = {k: torch.as_tensor(v).pin_memory().to(
                self.device, non_blocking=True) for k, v in batch.items()}
            done = torch.cuda.Event()
            done.record(self.stream)
        return out, done

    def ready(self, staged):
        batch, done = staged
        if done is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(done)
            for t in batch.values():
                t.record_stream(stream)
        return batch


class _StagedSource:
    """`source` whose batches `stager` starts copying to the device."""

    def __init__(self, source, stager):
        self.source = source
        self.stager = stager
        self.num_batches = source.num_batches

    def next_batch(self):
        return self.stager.stage(self.source.next_batch())


class PrefetchedSource:
    """Batch-source adapter decoding ahead on a background thread.

    With `device`, the thread also stages each batch on that device (on
    CUDA: pinned memory and a side-stream copy), so the upload overlaps
    the step in flight; `next_batch` then returns tensors there.
    """

    def __init__(self, source, depth=2, device=None):
        self.source = source
        self._stager = _DeviceStager(device) if device is not None else None
        self._prefetcher = Prefetcher(
            source if self._stager is None
            else _StagedSource(source, self._stager), depth)

    @property
    def num_batches(self):
        return self.source.num_batches

    def next_batch(self):
        batch = self._prefetcher.next()
        return (self._stager.ready(batch) if self._stager is not None
                else batch)

    def close(self):
        self._prefetcher.close()


class _PrefetchError:
    """Worker-exception envelope shipped through the prefetch queue."""

    def __init__(self, exc):
        self.exc = exc


class Prefetcher:
    """Double-buffered background batch producer (hides PNG decode)."""

    def __init__(self, source, depth=2):
        self.source = source
        self.q = queue.Queue(maxsize=depth)
        self._stop = False
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _run(self):
        while not self._stop:
            try:
                batch = self.source.next_batch()
            except Exception as exc:  # surface to the consumer: a dead
                # worker must not leave next() blocked forever
                batch = _PrefetchError(exc)
            # bounded put, so that a full queue cannot park the worker
            # after close() stops draining
            while not self._stop:
                try:
                    self.q.put(batch, timeout=0.1)
                    break
                except queue.Full:
                    continue
            if isinstance(batch, _PrefetchError):
                return

    def next(self):
        batch = self.q.get()
        if isinstance(batch, _PrefetchError):
            raise RuntimeError(
                'prefetch worker died: {!r}'.format(batch.exc)) \
                from batch.exc
        return batch

    def close(self, timeout=5.0):
        self._stop = True
        # drain, so that a worker blocked in put() sees _stop promptly
        while True:
            try:
                self.q.get_nowait()
            except queue.Empty:
                break
        self.thread.join(timeout)
