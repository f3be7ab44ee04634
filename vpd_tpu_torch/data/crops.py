"""Host-side crop PNG decoding into uint8 batches.

Counterpart of `vpd_tpu/data/crops.py:15-92` (`decode_crop_batch`). The
host only decodes PNGs into uint8 arrays; all float math runs on the
device (`ops/preprocess.py`). Decoding uses cv2 when it is installed,
else PIL, each imported at first use.

Channel order: RGB crops come back RGB. Flow PNGs come back in cv2's
raw BGR order — the order the flow was written in and the one the
consumers (channels 0-1 = x, y flow) read — on both decoders: the PIL
branch reverses PIL's RGB to match (vpd_tpu's PIL branch returns RGB
order instead; ROADMAP "C. Faults"). Person masks (training only) and
the C++ thread-pool decoder (`native_loader`) are not ported yet.
"""

import numpy as np


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


def decode_crop_batch(rgb_paths, img_dim, *, flow_paths=None,
                      rgb_out=None, flow_out=None):
    """Batch PNG decode into (n, S, S, 3) rgb [+ (n, S, S, 3) flow].

    `*_out` arrays, when given, are filled in place (rows past
    len(paths) are left untouched). A missing file raises.
    """
    n = len(rgb_paths)
    if rgb_out is None:
        rgb_out = np.zeros((n, img_dim, img_dim, 3), np.uint8)
    if flow_paths is not None and flow_out is None:
        flow_out = np.zeros((n, img_dim, img_dim, 3), np.uint8)
    for i in range(n):
        rgb_out[i] = _imread(rgb_paths[i], img_dim, rgb=True)
        if flow_paths is not None:
            flow_out[i] = _imread(flow_paths[i], img_dim, rgb=False)
    return rgb_out, flow_out
