"""Skeleton rendering for training previews.

The port's copy of `vpd_tpu/geometry/render.py` (numpy only, unchanged
below this note), so that `vpd_tpu_torch` imports nothing of `vpd_tpu`.

Parity with reference `vipe_dataset/util.py:7-54` (front/side scatter+bone
views rendered to an ndarray) and `train_vipe_model.py:91-100` (MP4
preview writer).
"""

import numpy as np


def _fig_to_array(fig):
    fig.canvas.draw()
    im = np.frombuffer(fig.canvas.buffer_rgba(), dtype=np.uint8)
    im = im.reshape(fig.canvas.get_width_height()[::-1] + (4,))[..., :3]
    return im.copy()


def render_points(x, y, c='b', segs=None):
    import matplotlib
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt

    fig = plt.figure()
    ax = plt.gca()
    ax.scatter(x, y, c=c, s=25)
    if segs is not None:
        for a, b in segs:
            ax.plot([x[a], x[b]], [y[a], y[b]], c='grey', alpha=0.5)
    ax.set_aspect('equal', 'box')
    im = _fig_to_array(fig)
    plt.close(fig)
    return im


def render_3d_skeleton_views(skeletons, spec, title, labels=None,
                             colors=('b', 'r', 'g'), axlim=2.5,
                             figsize=(12, 6)):
    """Render (J, 3)-position skeletons front/side; bones from `spec`."""
    import matplotlib
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt

    bones = list(zip(spec.parent_idx, spec.child_idx))
    fig, (ax1, ax2) = plt.subplots(1, 2, sharex=True, sharey=True,
                                   figsize=figsize)
    fig.suptitle(title)
    for i, s in enumerate(skeletons):
        s = np.asarray(s)
        label = labels[i] if labels is not None else None
        c = colors[i % len(colors)]
        ax1.scatter(s[:, 0], s[:, 2], s=50, c=c, label=label)
        ax2.scatter(s[:, 1], s[:, 2], s=50, c=c)
        for a, b in bones:
            ax1.plot([s[a, 0], s[b, 0]], [s[a, 2], s[b, 2]], c=c, alpha=0.5)
            ax2.plot([s[a, 1], s[b, 1]], [s[a, 2], s[b, 2]], c=c, alpha=0.5)
    for ax, name in ((ax1, 'front'), (ax2, 'side')):
        ax.set_xlim(-axlim, axlim)
        ax.set_ylim(-axlim, axlim)
        ax.set_aspect('equal', 'box')
        ax.set_title(name)
    if labels is not None:
        ax1.legend()
    im = _fig_to_array(fig)
    plt.close(fig)
    return im


def save_video_preview(out_file, frames, fps=10):
    import cv2

    vo = None
    for frame in frames:
        if vo is None:
            h, w, _ = frame.shape
            vo = cv2.VideoWriter(out_file, cv2.VideoWriter_fourcc(*'mp4v'),
                                 fps, (w, h))
        vo.write(cv2.cvtColor(frame, cv2.COLOR_RGB2BGR))
    if vo is not None:
        vo.release()
