"""Dynamic time warping with R-dtw step patterns.

Counterpart of `vpd_tpu/ops/dtw.py` (its host DP is copied here: this
package imports nothing of `vpd_tpu`). Two implementations of one
function:

* the host DP (`dtw_distance`, `build_dtw_distance_fn`): numpy in f64,
  exact, one pair at a time, or the same in C++ (`ops/dtw_native.py`)
  where g++ builds it;
* `dtw_matrix_reference`: all (query, target) pairs at once in PyTorch,
  one Python loop over DP rows with the pairs as a batch dimension. It is
  the plain twin of kernel B2 (`ops/dtw_kernel.py`, `csrc/dtw.cu`) and
  mirrors the JAX row scan `dtw_distance_matrix_tpu` step for step.

Step pattern semantics (R `dtw::symmetricP2`): each recursion is a
multi-step move; unreachable cells stay +inf; if the end cell is
unreachable (slope constraint violated) the distance is +inf. Distances
are normalized by (N + M).
"""

import numpy as np
import torch

from . import dtw_native

INF = np.inf
STEP_PATTERNS = ('symmetric2', 'symmetricP2')


def _cost_matrix_symmetric2(d):
    n, m = d.shape
    g = np.full((n, m), INF)
    g[0, 0] = d[0, 0]
    for i in range(n):
        for j in range(m):
            if i == 0 and j == 0:
                continue
            best = INF
            if i > 0 and j > 0:
                best = g[i - 1, j - 1] + 2 * d[i, j]
            if i > 0:
                best = min(best, g[i - 1, j] + d[i, j])
            if j > 0:
                best = min(best, g[i, j - 1] + d[i, j])
            g[i, j] = best
    return g


def _cost_matrix_symmetricP2(d):
    n, m = d.shape
    g = np.full((n, m), INF)
    g[0, 0] = d[0, 0]
    for i in range(n):
        for j in range(m):
            if i == 0 and j == 0:
                continue
            best = INF
            # pattern 2: diagonal
            if i >= 1 and j >= 1:
                best = g[i - 1, j - 1] + 2 * d[i, j]
            # pattern 1: (i-2, j-3) -> weights 2,2,1
            if i >= 2 and j >= 3:
                best = min(best, g[i - 2, j - 3] + 2 * d[i - 1, j - 2]
                           + 2 * d[i, j - 1] + d[i, j])
            # pattern 3: (i-3, j-2) -> weights 2,2,1 (the mirror of 1)
            if i >= 3 and j >= 2:
                best = min(best, g[i - 3, j - 2] + 2 * d[i - 2, j - 1]
                           + 2 * d[i - 1, j] + d[i, j])
            g[i, j] = best
    return g


_PATTERNS = {
    'symmetric2': _cost_matrix_symmetric2,
    'symmetricP2': _cost_matrix_symmetricP2,
}


def dtw_distance(d, step_pattern='symmetricP2', normalized=True):
    """DTW distance of a pairwise local-cost matrix d (N, M)."""
    d = np.asarray(d, dtype=np.float64)
    n, m = d.shape
    g = _PATTERNS[step_pattern](d)
    dist = g[n - 1, m - 1]
    if normalized:
        dist = dist / (n + m)
    return float(dist)


def pairwise_l2(a, b):
    """Euclidean pairwise distances, sklearn `pairwise_distances` parity."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    sq = (np.sum(a * a, axis=1)[:, None] + np.sum(b * b, axis=1)[None, :]
          - 2 * a @ b.T)
    return np.sqrt(np.maximum(sq, 0))


def build_dtw_distance_fn(step_pattern='symmetricP2', prefer_native=True):
    """Sequence-level distance fn (reference util/neighbors.py:9-17).

    The native C++ core (`ops/dtw_native.py`) where g++ builds it, as in
    vpd_tpu, else the numpy DP above; both in float64 (the core's L2 is
    the direct form, so on a row both sequences share it gives 0 where
    `pairwise_l2`'s expanded form leaves a rounding residue). The
    function returned says which it is in `impl` ('native' or 'numpy').
    """
    if prefer_native and dtw_native.available():
        fn = dtw_native.build_native_dtw_fn(step_pattern)
        fn.impl = 'native'
        fn.fork_safe = True  # a host library, no CUDA context
        return fn

    def dtw_fn(a, b):
        return dtw_distance(pairwise_l2(a, b), step_pattern=step_pattern)

    dtw_fn.impl = 'numpy'
    dtw_fn.fork_safe = True  # pure numpy DP, no CUDA context
    return dtw_fn


# ---------------------------------------------------------------------------
# All pairs at once: the plain twin of kernel B2
# ---------------------------------------------------------------------------

BIG = 1e30           # "unreachable" inside the twin (its prefix trick
                     # subtracts, so it cannot use inf); inf on output
_TWIN_ELEMENTS = 1 << 24  # (queries x targets x L) per block of queries


def _shift(x, k, fill):
    """Shift the last axis right by k, filling with `fill`."""
    if k == 0:
        return x
    pad = torch.full(x.shape[:-1] + (k,), fill, dtype=x.dtype,
                     device=x.device)
    return torch.cat([pad, x[..., :-k]], dim=-1)


def _rows_symmetricP2(cost_row, n_rows, valid, col, i_final, t_end):
    """Row DP of symmetricP2: no in-row dependency, only shifted mins over
    the three previous g rows and two previous cost rows."""
    final = torch.zeros(i_final.shape[0], valid.shape[0],
                        dtype=torch.float32, device=valid.device)
    big = torch.full_like(valid, BIG, dtype=torch.float32)
    g1 = g2 = g3 = big.expand(final.shape + valid.shape[-1:])
    d1 = d2 = torch.zeros_like(g1)
    for i in range(n_rows):
        dj = torch.where(valid, cost_row(i), BIG)
        diag = _shift(g1, 1, BIG) + 2 * dj
        best = diag
        if i >= 2:
            p1 = (_shift(g2, 3, BIG) + 2 * _shift(d1, 2, 0.)
                  + 2 * _shift(dj, 1, 0.) + dj)
            best = torch.minimum(best, torch.where(
                col >= 3, p1, BIG))
        if i >= 3:
            p3 = _shift(g3, 2, BIG) + 2 * _shift(d2, 1, 0.) + 2 * d1 + dj
            best = torch.minimum(best, torch.where(
                col >= 2, p3, BIG))
        if i == 0:
            best = torch.where(col == 0, dj, best)
        g = torch.where(valid, torch.clamp(best, max=BIG), BIG)
        final = _read_end(final, g, i, i_final, t_end)
        g1, g2, g3, d1, d2 = g, g1, g2, dj, d1
    return final


def _rows_symmetric2(cost_row, n_rows, valid, col, i_final, t_end):
    """Row DP of symmetric2. In-row, g[j] = min(c[j], g[j-1] + d[j]),
    which unrolls to g = S + cummin(c - S) with S the prefix sum of d
    (the (min,+) prefix trick of the JAX row scan)."""
    final = torch.zeros(i_final.shape[0], valid.shape[0],
                        dtype=torch.float32, device=valid.device)
    prev = None
    for i in range(n_rows):
        row = cost_row(i)
        dj = torch.where(valid, row, BIG)
        if i == 0:
            c = torch.where(col == 0, dj, BIG)
        else:
            c = torch.minimum(_shift(prev, 1, BIG) + 2 * dj, prev + dj)
        s = torch.cumsum(torch.where(valid, row, 0.), dim=-1)
        g = torch.clamp(s + torch.cummin(c - s, dim=-1).values, max=BIG)
        g = torch.where(valid, g, BIG)
        final = _read_end(final, g, i, i_final, t_end)
        prev = g
    return final


def _read_end(final, g, i, i_final, t_end):
    """final[q, t] = g[q, t, m_t - 1] for the pairs whose last row is i."""
    end = g.gather(-1, t_end.expand(g.shape[0], -1, 1)).squeeze(-1)
    return torch.where((i_final == i)[:, None], end, final)


def _twin_block(q, q_lens, t, t_lens, step_pattern):
    qb, L, D = q.shape
    nt = t.shape[0]
    col = torch.arange(L, device=q.device)                 # column index
    valid = col[None, :] < t_lens[:, None].long()          # (T, L)
    t_flat = t.reshape(nt * L, D)
    norm_t = (t_flat * t_flat).sum(-1)                     # (T*L,)

    def cost_row(i):
        # the JAX form, (|q|^2 + |t|^2) - 2 q.t, clamped at 0
        qi = q[:, i]                                       # (qb, D)
        sq = ((qi * qi).sum(-1)[:, None] + norm_t[None, :]
              - 2 * (qi @ t_flat.T))
        return torch.sqrt(torch.clamp(sq, min=0.)).reshape(qb, nt, L)

    rows = _rows_symmetricP2 if step_pattern == 'symmetricP2' \
        else _rows_symmetric2
    t_end = (t_lens.long() - 1).reshape(1, nt, 1)
    raw = rows(cost_row, int(q_lens.max()), valid, col,
               q_lens.long() - 1, t_end)
    norm = (q_lens[:, None] + t_lens[None, :]).to(torch.float32)
    return torch.where(raw >= BIG * 0.5, torch.full_like(raw, INF),
                       raw / norm)


def dtw_matrix_reference(q, q_lens, t, t_lens, step_pattern='symmetricP2'):
    """All-pairs normalized DTW in plain PyTorch (kernel B2's twin).

    q: (Q, L, D) f32, t: (T, L, D) f32, zero-padded past each length;
    q_lens (Q,), t_lens (T,) int in [1, L]. Returns (Q, T) f32 with +inf
    where the end cell is unreachable. Same contract and arithmetic as
    `vpd_tpu.ops.dtw.dtw_distance_matrix_tpu`; queries go in blocks so
    that one block's DP rows stay near 2^24 elements. Float32 products
    run without TF32 on CUDA.
    """
    if step_pattern not in STEP_PATTERNS:
        raise ValueError('unknown step pattern {!r}'.format(step_pattern))
    n_q, L, _ = q.shape
    out = torch.empty((n_q, t.shape[0]), dtype=torch.float32,
                      device=q.device)
    if out.numel() == 0:
        return out
    block = max(1, _TWIN_ELEMENTS // (t.shape[0] * L))
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for s in range(0, n_q, block):
            out[s:s + block] = _twin_block(q[s:s + block],
                                           q_lens[s:s + block], t, t_lens,
                                           step_pattern)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    return out
