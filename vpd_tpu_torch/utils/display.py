"""Show-or-save preview images for the --visualize debug flags.

Counterpart of `vpd_tpu/utils/display.py` (a copy: this package imports
nothing of `vpd_tpu`). The reference tools preview with bare cv2.imshow
windows (`extract_square_crops.py:118-120`, the raw-loader windows in
`vipe_dataset/*.py`). On a headless host cv2.imshow is a FATAL Qt abort
(SIGABRT — not a catchable cv2.error), which inside a multiprocessing
pool kills the worker and hangs the parent, so the gate here is on
DISPLAY: with a display the image shows in a window like the reference;
without one it is written under a hidden preview directory instead.
"""

import os


def imshow_or_save(window, bgr_img, save_path, wait_ms=100):
    """cv2.imshow(window, img) with a DISPLAY gate; headless saves to
    `save_path` (parent dirs created). `bgr_img` is BGR uint8 like every
    cv2 call site."""
    import cv2

    if os.environ.get('DISPLAY'):
        cv2.imshow(window, bgr_img)
        cv2.waitKey(wait_ms)
    else:
        os.makedirs(os.path.dirname(save_path), exist_ok=True)
        cv2.imwrite(save_path, bgr_img)
