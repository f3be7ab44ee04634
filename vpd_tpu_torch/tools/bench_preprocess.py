"""Probe: the preprocess kernel (B1) against the plain path, on the card.

Counterpart of `vpd_tpu/tools/bench_pallas_preprocess.py`, named as the
port names the kernel's module (`ops/preprocess.py`, over
`csrc/preprocess.cu`). Two comparisons at extraction batch sizes:

  (a) preprocess only;
  (b) preprocess -> ResNet-34 embed (embedding readback), what extraction
      gets from the kernel once the encoder runs after it.

Crops are made ON THE CARD from a seed (no upload). DEPTH launches a
timing round with one wait at the end, the minimum over rounds: (a)
waits by synchronizing the card, where vpd_tpu reads back a scalar mean
(on the card that mean would be a reduction kernel of its own, longer
than the preprocess); (b) reads the embeddings back. Both paths compute
the same thing, checked on the card first at atol 0.02 in bf16:
normalize + flow interleave + per-sample hflip with x-flow negation ->
bf16, i.e. `eval_transform_batch` + `flip_batch` + select.

vpd_tpu's keys map as: `xla_crops_per_s` -> `plain_crops_per_s`,
`pallas_crops_per_s` -> `kernel_crops_per_s`, `pallas_vs_xla` ->
`kernel_vs_plain`, `pallas_block_b` -> `kernel_variant` (B1 has no
block-of-samples parameter, so `--block_bs` is gone: the row names the
variant `ops.preprocess.kernel_variant` picks from the shapes, None on
the CPU, where the plain twin runs), verdict `pallas_wins` / `xla_wins`
-> `kernel_wins` / `plain_wins`. Each row also names its device.

Usage:
    python -m vpd_tpu_torch.tools.bench_preprocess --batches 1024,4096
"""

import argparse
import json
import time

DEPTH = 4
EQUALITY_BATCH = 64
EQUALITY_ATOL = 0.02


def _time_chain(run_one, bufs, rounds, wait):
    """min seconds/launch over `rounds`, DEPTH launches per round, each
    round ending in `wait(outputs)`."""
    times = []
    for _ in range(rounds):
        start = time.perf_counter()
        outs = [run_one(b) for b in bufs]
        forced = wait(outs)
        times.append((time.perf_counter() - start) / len(bufs))
        if not all(bool(f.isfinite().all()) for f in forced):
            raise RuntimeError('non-finite output')
    return min(times)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--batches', default='1024,4096')
    ap.add_argument('--rounds', type=int, default=3)
    ap.add_argument('--img_dim', type=int, default=128)
    ap.add_argument('--device', default=None,
                    help='torch device (default: cuda; cpu runs the plain '
                         'twin in place of the kernel)')
    args = ap.parse_args()

    import torch

    from .. import resolve_device
    from ..core.profiling import device_name
    from ..data.augment import (RGB_MEAN_STD, eval_transform_batch,
                                flip_batch)
    from ..models import build_encoder
    from ..ops.preprocess import kernel_variant, preprocess_crops

    device = resolve_device(args.device)
    on_cuda = device.type == 'cuda'
    name = device_name(device)
    mean, std = RGB_MEAN_STD['tennis']
    s = args.img_dim

    def synth(seed, b):
        gen = torch.Generator(device=device).manual_seed(seed)
        u8 = lambda: torch.randint(  # noqa: E731
            0, 256, (b, s, s, 3), generator=gen, dtype=torch.uint8,
            device=device)
        return (u8(), u8(),
                torch.randint(0, 2, (b,), generator=gen, dtype=torch.int32,
                              device=device))

    def plain_pre(rgb, flow, flip):
        x = eval_transform_batch(rgb, mean, std, flow_u8=flow)
        xf = flip_batch(x, True)
        return torch.where(flip.bool()[:, None, None, None],
                           xf, x).to(torch.bfloat16)

    def kernel_pre(rgb, flow, flip):
        return preprocess_crops(rgb, flow, flip, mean, std)

    def sync(outs):
        if on_cuda:
            torch.cuda.synchronize(device)
        return outs

    def readback(outs):
        return [o.float().cpu() for o in outs]

    # --- equality on the card (small batch, full readback) ---
    with torch.inference_mode():
        rgb, flow, flip = synth(0, EQUALITY_BATCH)
        want = plain_pre(rgb, flow, flip).float().cpu()
        got = kernel_pre(rgb, flow, flip).float().cpu()
    diff = float((got - want).abs().max())
    if not diff <= EQUALITY_ATOL:
        raise AssertionError('kernel against the plain path: max|diff| = {} '
                             '> {}'.format(diff, EQUALITY_ATOL))
    print(f'# equality ok on {name}: max|diff|={diff:.4f}', flush=True)

    # one encoder for every batch size
    torch.manual_seed(1)
    model = build_encoder('resnet34', 32, in_channels=5,
                          dtype=torch.bfloat16).to(device).eval()
    if on_cuda:
        model.to(memory_format=torch.channels_last)

    def embed(pre, bf):
        return model(pre(*bf).permute(0, 3, 1, 2))

    results = []
    with torch.inference_mode():
        for b in (int(x) for x in args.batches.split(',')):
            bufs = [synth(b * DEPTH + i, b) for i in range(DEPTH)]
            variant = kernel_variant(*bufs[0][:2]) if on_cuda else None
            for pre in (plain_pre, kernel_pre):  # warm: cuDNN, the build
                readback([embed(pre, bufs[0])])

            # (a) preprocess only
            t_plain = _time_chain(lambda bf: plain_pre(*bf), bufs,
                                  args.rounds, sync)
            t_kernel = _time_chain(lambda bf: kernel_pre(*bf), bufs,
                                   args.rounds, sync)
            row = {'batch': b, 'stage': 'preprocess_only',
                   'plain_crops_per_s': round(b / t_plain, 1),
                   'kernel_crops_per_s': round(b / t_kernel, 1),
                   'kernel_variant': variant,
                   'kernel_vs_plain': round(t_plain / t_kernel, 3),
                   'device': name}
            print(json.dumps(row), flush=True)
            results.append(row)

            # (b) preprocess -> embed
            t_plain = _time_chain(lambda bf: embed(plain_pre, bf), bufs,
                                  args.rounds, readback)
            t_kernel = _time_chain(lambda bf: embed(kernel_pre, bf), bufs,
                                   args.rounds, readback)
            row = {'batch': b, 'stage': 'preprocess_embed',
                   'plain_crops_per_s': round(b / t_plain, 1),
                   'kernel_crops_per_s': round(b / t_kernel, 1),
                   'kernel_variant': variant,
                   'kernel_vs_plain': round(t_plain / t_kernel, 3),
                   'device': name}
            print(json.dumps(row), flush=True)
            results.append(row)
            del bufs

    wins = all(r['kernel_vs_plain'] >= 1.0 for r in results
               if r['stage'] == 'preprocess_embed')
    print(json.dumps({'verdict': 'kernel_wins' if wins else 'plain_wins',
                      'device': name}), flush=True)


if __name__ == '__main__':
    main()
