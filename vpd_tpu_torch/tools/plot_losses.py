#!/usr/bin/env python3
"""Plot loss.json training curves.

Counterpart of `vpd_tpu/tools/plot_losses.py`, with its flags. matplotlib
is imported when the plot is drawn, so hosts without it can still import
this module. Usage:

    python -m vpd_tpu_torch.tools.plot_losses <model_dir> [-o plot.pdf]
"""

import argparse
import os
from collections import defaultdict

import numpy as np

from ..core.io import load_json


def get_args():
    parser = argparse.ArgumentParser()
    parser.add_argument('model_dir')
    parser.add_argument('-e', '--max_epoch', type=int)
    parser.add_argument('-o', '--out_file', type=str,
                        help='Save plot instead of showing it')
    parser.add_argument('-p', '--pause', type=int, default=60,
                        help='minutes an interactive window stays open '
                             '(reference plot_losses.py:15,66; only '
                             'used with a display and no --out_file)')
    return parser.parse_args()


def collect_dataset_losses(losses, key):
    pairs = ((name, entry['epoch'], value) for entry in losses
             for name, value in entry.get(key, ()))
    datasets = defaultdict(list)
    for name, epoch, value in pairs:
        datasets[name].append((epoch, value))
    return datasets


def smooth(x, window):
    return [float(np.mean(x[max(i - window, 0): i + 1 + window]))
            for i in range(len(x))]


def main(model_dir, max_epoch, out_file, pause=60):
    import matplotlib
    interactive = out_file is None and bool(os.environ.get('DISPLAY'))
    if not interactive:
        matplotlib.use('Agg')
    import matplotlib.pyplot as plt

    losses = load_json(os.path.join(model_dir, 'loss.json'))

    best_epoch, best_val_loss = min(
        ((entry['epoch'], entry['val']) for entry in losses),
        key=lambda pair: pair[1])
    print('Best epoch:', best_epoch)
    print('Best val loss:', best_val_loss)

    print()
    val_history = [entry['val'] for entry in losses]
    for i in range(3, 11, 2):  # reference plot_losses.py:50-52
        print('Val loss (smooth: {}):'.format(i), min(smooth(val_history, i)))

    dataset_train = collect_dataset_losses(losses, 'dataset_train')
    dataset_val = collect_dataset_losses(losses, 'dataset_val')
    has_subplots = max(len(dataset_train), len(dataset_val)) > 1

    if has_subplots:
        fig, (main_ax, sub_ax) = plt.subplots(
            2, 1, sharex=True, figsize=(7, 8))
    else:
        fig = plt.figure(figsize=(7, 4))
        main_ax, sub_ax = plt.gca(), None

    visible = [entry for entry in losses
               if max_epoch is None or entry['epoch'] <= max_epoch]
    epochs = [entry['epoch'] for entry in visible]
    curves = {}
    for split in ('train', 'val'):
        ys = [entry[split] for entry in visible]
        curves[split] = (ys, dict(lw=1, alpha=0.5))
        curves[split + ' (smooth +/-3)'] = (smooth(ys, 3),
                                            dict(lw=2, linestyle=':'))
    for label, (ys, style) in curves.items():
        main_ax.plot(epochs, ys, label=label, **style)
    main_ax.set_title('Losses: {}'.format(model_dir))
    main_ax.legend(loc='upper right')
    main_ax.set_xlabel('epoch')
    main_ax.set_ylabel('avg_loss')

    if sub_ax is not None:
        breakdown = (('train', dataset_train, {'linestyle': ':'}),
                     ('val', dataset_val, {}))
        for split, per_dataset, style in breakdown:
            for name, vals in sorted(per_dataset.items()):
                xs, ys = zip(*vals)
                sub_ax.plot(xs, ys, label='{} ({})'.format(split, name),
                            **style)
        sub_ax.set_title('Loss breakdown by dataset')
        sub_ax.legend(loc='upper right')

    plt.tight_layout()
    if interactive:
        # window auto-closes after `pause` minutes (reference :66-67)
        timer = fig.canvas.new_timer(interval=60000 * pause)
        timer.add_callback(plt.close)
        timer.start()
        plt.show()
    else:
        out_file = out_file or os.path.join(model_dir, 'losses.pdf')
        plt.savefig(out_file)
        print('Saved:', out_file)


if __name__ == '__main__':
    main(**vars(get_args()))
