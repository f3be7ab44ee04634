"""Cached video metadata (parity: `data/sports.cache`, recognize.py:212-222).

Counterpart of `vpd_tpu/datasets/metadata_cache.py`. The cache pickles
were written by the reference with `util.video.VideoMetadata`; a
remapping Unpickler loads them into this package's namedtuple (any
module's `VideoMetadata`, by name), so downstream runs work without the
raw MP4s. The cache is read in place under `vpd_tpu/datasets/data/`.
"""

import os
import pickle

from ..utils.video import VideoMetadata, get_metadata
from . import DATA_DIR

CACHE_DIR = os.path.join(DATA_DIR, 'sports.cache')


class _CompatUnpickler(pickle.Unpickler):

    def find_class(self, module, name):
        if name == 'VideoMetadata':
            return VideoMetadata
        return super().find_class(module, name)


def load_meta_cache(dataset, cache_dir=CACHE_DIR):
    path = os.path.join(cache_dir, '{}.video_meta.pkl'.format(dataset))
    with open(path, 'rb') as fp:
        return _CompatUnpickler(fp).load()


def load_video_metadata(dataset, video_dir=None, log=print):
    """Scan video_dir for .mp4 metadata, else fall back to the cache."""
    if video_dir is not None and os.path.isdir(video_dir):
        return {
            os.path.splitext(v)[0]: get_metadata(os.path.join(video_dir, v))
            for v in sorted(os.listdir(video_dir)) if v.endswith('.mp4')}
    log('Raw videos not found! Using cached metadata.')
    return load_meta_cache(dataset)
