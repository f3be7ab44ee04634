"""The benchmark's one command: run one cell of BENCHMARK.json.

    python3 -m vpdbench.run --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. It sets up the cell from the seed, measures
for `--seconds`, checks what the timed path produced against the plain
reference, and prints one JSON line last on standard output (the numbers
compared, each beside its limit, also last on standard error). It exits
with 3, printing no result, where CUDA has fewer cards than the cell
asks for, and with 4 where JAX or the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

# Triton's and PyTorch's extension caches, should anything build through
# them, at fixed paths inside the checkout (the port keeps its nvcc build
# in vpd_tpu_torch/_build/): only a checkout's first run builds
_CACHE = os.path.join(os.path.dirname(os.path.abspath(__file__)), '.cache')
os.environ['TRITON_CACHE_DIR'] = os.path.join(_CACHE, 'triton')
os.environ['TORCH_EXTENSIONS_DIR'] = os.path.join(_CACHE, 'torch_extensions')


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seed', type=int, required=True)
    p.add_argument('--seconds', type=float, required=True)
    p.add_argument('--trace', type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None):
    args = parse(argv)
    from vpdbench import bench

    root = os.getcwd()
    chips = bench.Spec(root).workload(args.workload)['chips']
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print('vpdbench: the cell needs {} CUDA device(s), {} found'.format(
            chips, torch.cuda.device_count()
            if torch.cuda.is_available() else 0), file=sys.stderr)
        return 3
    result = bench.run_cell(root, args.workload, args.seed, args.seconds,
                            bool(args.trace), T_START)
    found = bench.forbidden_modules()
    if found:
        print('vpdbench: loaded in the run: {}'.format(', '.join(found)),
              file=sys.stderr)
        return 4
    print('setup parts (s): {}'.format(json.dumps(result['setup_parts'])),
          file=sys.stderr)
    for name, c in result['checks'].items():
        print('check {}: {!r} (limit {!r})'.format(name, c['value'],
                                                   c['limit']),
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == '__main__':
    sys.exit(main())
