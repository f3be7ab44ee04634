"""k-NN and retrieval over DTW distances.

Counterpart of `vpd_tpu/tasks/neighbors.py`. Parity with reference
`util/neighbors.py:29-93` (heap top-k, majority vote with
nearest-of-majority tiebreak), with the same heap, vote and tie-break as
vpd_tpu. `batch_distances` computes an all-pairs sweep with kernel B2
(`ops/dtw_kernel.py`) on CUDA, or its plain twin on the CPU.
"""

import heapq
import multiprocessing as mp
import warnings
from collections import Counter

import numpy as np
import torch

from .. import resolve_device
from ..ops.dtw import build_dtw_distance_fn
from ..ops.dtw_kernel import dtw_matrix

# Fork-time closure hack (reference util/neighbors.py:20-26): pool workers
# read the train set + distance fn from a module global captured at fork,
# so non-picklable distance fns still parallelize.
_FORK_CTX = {}


def _fork_dist(args):
    i, x = args
    return i, _FORK_CTX['fn'](x, _FORK_CTX['X'][i])


def pooled_distances(x, X, distance_fn, processes):
    """[(i, dist)] of x against every row of X over a fork process pool.

    Parity with reference `util/neighbors.py:21-41`. Requires the 'fork'
    start method; runs serially when it is unavailable, or when CUDA is
    already initialized in this process and the distance_fn is not tagged
    `fork_safe` (a forked child cannot use the parent's CUDA context).
    """
    if not getattr(distance_fn, 'fork_safe', False) and \
            torch.cuda.is_initialized():
        warnings.warn(
            'pooled_distances: CUDA is initialized and distance_fn is not '
            'tagged fork_safe; running serially (a forked child cannot '
            'use the CUDA context).')
        return [(i, distance_fn(x, xt)) for i, xt in enumerate(X)]
    try:
        ctx = mp.get_context('fork')
    except ValueError:
        return [(i, distance_fn(x, xt)) for i, xt in enumerate(X)]
    _FORK_CTX['X'] = X
    _FORK_CTX['fn'] = distance_fn
    try:
        with ctx.Pool(processes) as pool:
            return pool.map(_fork_dist, [(i, x) for i in range(len(X))])
    finally:
        _FORK_CTX.clear()


class KNearestNeighbors:

    def __init__(self, X, y, distance_fn, k=1, processes=None):
        self.X = X
        self.y = y
        self.k = k
        self.distance_fn = distance_fn
        self.processes = processes

    def predict(self, x):
        return self.predict_n(x)

    def predict_n(self, *xs):
        top_k = []
        for x in xs:
            if self.processes and self.processes > 1 and len(self.X) > 1:
                dists = pooled_distances(x, self.X, self.distance_fn,
                                         self.processes)
            else:
                dists = ((i, self.distance_fn(x, xt))
                         for i, xt in enumerate(self.X))
            for i, d in dists:
                (heapq.heappush if len(top_k) < self.k
                 else heapq.heappushpop)(top_k, (-d, i))
        top_k = [(-d, i) for d, i in top_k]

        cls_count = Counter(self.y[i] for _, i in top_k)
        max_count = cls_count.most_common(1)[0][1]

        best_i = None
        best_cls_dist = float('inf')
        for d, i in top_k:
            if cls_count[self.y[i]] == max_count and d < best_cls_dist:
                best_cls_dist = d
                best_i = i
        return self.y[best_i], best_i


class Neighbors:
    """Retrieval ranking (`util/neighbors.py:76-93`)."""

    def __init__(self, X, distance_fn):
        self.X = X
        self.distance_fn = distance_fn

    def find(self, x, k, min_len):
        knn_pq = []
        for i, x_train in enumerate(self.X):
            if x_train is not None and x_train.shape[0] >= min_len:
                d = self.distance_fn(x, x_train)
                (heapq.heappush if len(knn_pq) < k
                 else heapq.heappushpop)(knn_pq, (-d, i))
        return [(i, -nd) for nd, i in sorted(knn_pq, key=lambda z: -z[0])]

    def dist(self, x, i):
        return self.distance_fn(x, self.X[i])


def pad_sequences(seqs, length):
    """(len(seqs), length, D) f32 zero-padded, and int32 lengths.

    Sequences are cut at `length`. An empty sequence gets length 1 (a zero
    row): the caller marks its distances +inf.
    """
    out = np.zeros((len(seqs), length, seqs[0].shape[-1]), np.float32)
    lens = np.ones(len(seqs), np.int32)
    for i, s in enumerate(seqs):
        n = min(len(s), length)
        out[i, :n] = s[:n]
        lens[i] = max(n, 1)
    return out, lens


def batch_distances(queries, targets, max_len=512,
                    step_pattern='symmetricP2', device=None, log=print):
    """(Q, T) float32 normalized DTW distances, all pairs in one sweep.

    Counterpart of `vpd_tpu.tasks.neighbors.batch_distances_tpu`, with the
    same values: queries/targets are lists of (T_i, D) arrays; sequences
    longer than max_len are cut to it (logged, with how many were cut and
    the longest length); the lengths that normalize are those after the
    cut; zero-length sequences give +inf rows and columns; pairs the step
    pattern cannot align give +inf. The sweep runs on `device` (None means
    CUDA): kernel B2 there, its plain twin on the CPU. The padded length
    is the longest sequence after the cut, so it must be <= 512 and
    D <= 128 (else ValueError).
    """
    device = resolve_device(device)
    nq, nt = len(queries), len(targets)
    if nq == 0 or nt == 0:
        return np.zeros((nq, nt), np.float32)
    lengths = [len(s) for s in list(queries) + list(targets)]
    cut = [n for n in lengths if n > max_len]
    if cut:
        log('DTW sweep: {} of {} sequences cut to max_len {} (longest {})'
            .format(len(cut), len(lengths), max_len, max(cut)))
    length = max(1, min(max_len, max(lengths)))
    q, ql = pad_sequences(queries, length)
    t, tl = pad_sequences(targets, length)
    out = dtw_matrix(
        torch.from_numpy(q).to(device), torch.from_numpy(ql).to(device),
        torch.from_numpy(t).to(device), torch.from_numpy(tl).to(device),
        step_pattern).cpu().numpy()
    # zero-length sequences are infeasible, not all-zero rows of length
    # 1: the host path errors/returns inf there (ValueError -> inf)
    out[np.array([len(s) == 0 for s in queries], bool), :] = np.inf
    out[:, np.array([len(s) == 0 for s in targets], bool)] = np.inf
    return out


def make_dtw_fns():
    """(primary symmetricP2, fallback symmetric2) distance fns
    (`recognize.py:133-135`)."""
    return (build_dtw_distance_fn('symmetricP2'),
            build_dtw_distance_fn('symmetric2'))
