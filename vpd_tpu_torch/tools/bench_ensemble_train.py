"""Load-controlled fused-vs-sequential ensemble training comparison.

Counterpart of `vpd_tpu/tools/bench_ensemble_train.py`. Alternates the
two modes ROUND-ROBIN in one process, so slow host periods hit both
modes equally, and reports per-mode medians. The first round of each
mode (cuDNN and CUDA-graph capture at these shapes) is timed apart and
left out of the statistics.

Config: the reference's localization defaults scaled down
(`util/proposal.py:56-142`): K=3 BiGRU members, H=128, 250-frame
windows, batch 100, on the port's `train/proposal.EnsembleProposal`
(`fused=True`: one batched model; `fused=False`: one trainer a member).
A `predict` readback ends each run.

Usage:
    python -m vpd_tpu_torch.tools.bench_ensemble_train --rounds 3
"""

import argparse
import json
import time

import numpy as np


def _synth_videos(rng, n_videos=24, t=500, d=32):
    X = [rng.standard_normal((t, d)).astype(np.float32) for _ in range(n_videos)]
    y = []
    for x in X:
        lab = np.zeros(t, np.int64)
        for _ in range(3):
            s = rng.integers(0, t - 40)
            lab[s:s + rng.integers(10, 40)] = 1
        y.append(lab)
    return X, y


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--rounds', type=int, default=3,
                    help='round-robin rounds per mode')
    ap.add_argument('--epochs', type=int, default=20)
    ap.add_argument('--samples_per_epoch', type=int, default=1000)
    ap.add_argument('--members', type=int, default=3)
    ap.add_argument('--device', default=None,
                    help='torch device (default: cuda)')
    args = ap.parse_args()

    from .. import resolve_device
    from ..core.profiling import device_name
    from ..train.proposal import EnsembleProposal

    device = resolve_device(args.device)
    rng = np.random.default_rng(0)
    X, y = _synth_videos(rng)
    kw = dict(hidden_dim=128, ensemble_size=args.members, splits=5,
              num_epochs=args.epochs, min_epochs=args.epochs,
              early_term_no_val_improvement=args.epochs,
              samples_per_epoch=args.samples_per_epoch,
              batch_size=100, seq_len=250, device=device)

    def run(fused, seed):
        start = time.perf_counter()
        ens = EnsembleProposal('gru', X, y, fused=fused, seed=seed, **kw)
        # the prediction's readback waits for the card's queued work
        np.asarray(ens.predict(X[0]))
        return time.perf_counter() - start

    # warm both modes once (the cold round, excluded from stats)
    cold = {'fused': run(True, 0), 'sequential': run(False, 0)}
    print(json.dumps({'stage': 'cold', **{k: round(v, 1)
                                          for k, v in cold.items()}}),
          flush=True)

    times = {'fused': [], 'sequential': []}
    for r in range(args.rounds):
        for fused in (True, False):  # interleave: load hits both equally
            mode = 'fused' if fused else 'sequential'
            dt = run(fused, seed=r + 1)
            times[mode].append(round(dt, 1))
            print(json.dumps({'round': r, 'mode': mode, 'seconds': dt}),
                  flush=True)

    out = {'stage': 'warm_medians',
           'fused_median_s': round(float(np.median(times['fused'])), 1),
           'sequential_median_s': round(
               float(np.median(times['sequential'])), 1),
           'fused_times': times['fused'],
           'sequential_times': times['sequential'],
           'speedup': round(float(np.median(times['sequential']))
                            / float(np.median(times['fused'])), 3),
           'device': device_name(device)}
    print(json.dumps(out), flush=True)


if __name__ == '__main__':
    main()
