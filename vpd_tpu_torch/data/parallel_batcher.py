"""Multiprocess batch production (the reference's DataLoader workers).

Counterpart of `vpd_tpu/data/parallel_batcher.py`. The reference
parallelises its host loop, per-sample PNG decode and sampling, with
DataLoader worker processes (`train_vpd_model.py:205-212`).
`MultiprocessBatcher` runs one batch source (`next_batch()`) per worker
process and drains them round-robin, so the batch stream is fixed by the
per-worker seeds, as vpd_tpu's is. Queues are bounded, so workers decode
ahead of the step.

Workers start with the `spawn` method, where vpd_tpu forks. The port's
trainer may already hold a CUDA context and threads (the prefetcher, the
native decoder's pool) when workers start, and a forked child of such a
process inherits locks and CUDA state it cannot use. A spawned worker
imports its source afresh, so `make_source` must pickle: a module-level
function, or a `functools.partial` of one. Workers run numpy, cv2 and the
native decoder only; they never touch `torch.cuda`.
"""

import multiprocessing as mp
import queue as queue_mod
import traceback

_ERROR = '__vpd_worker_error__'


def _worker_loop(make_source, worker_id, queue):
    try:
        source = make_source(worker_id)
        while True:
            queue.put(source.next_batch())
    except (KeyboardInterrupt, BrokenPipeError, EOFError):
        pass
    except Exception:  # surface the failure instead of hanging the parent
        try:
            queue.put((_ERROR, traceback.format_exc()))
        except Exception:
            pass


class MultiprocessBatcher:
    """Round-robin fan-in over `num_workers` spawned batch sources.

    make_source: worker_id -> source with `next_batch()`, picklable; the
    caller offsets RNG seeds by worker_id (vpd_tpu's CLI seeds worker w
    with seed + 1000 * (w + 1)). num_workers=0 runs the source inline (no
    processes), like DataLoader(num_workers=0).
    """

    def __init__(self, make_source, num_workers, num_batches, *, depth=2,
                 template=None):
        """`template`: a parent-side source whose attributes stand in for
        those the batcher lacks (a `FusedBatcher`'s `kp_dims` and
        `kp_mask`, say)."""
        self.num_batches = num_batches
        self._template = template
        self._inline = None
        self._queues = []
        self._procs = []
        self._next = 0
        if num_workers <= 0:
            self._inline = make_source(0)
            return
        ctx = mp.get_context('spawn')
        for wid in range(num_workers):
            q = ctx.Queue(maxsize=depth)
            p = ctx.Process(target=_worker_loop,
                            args=(make_source, wid, q), daemon=True)
            p.start()
            self._queues.append(q)
            self._procs.append(p)

    def next_batch(self):
        if self._inline is not None:
            return self._inline.next_batch()
        if not self._queues:
            raise RuntimeError('the batcher is closed')
        idx = self._next % len(self._queues)
        self._next += 1
        q, p = self._queues[idx], self._procs[idx]
        while True:
            try:
                item = q.get(timeout=5)
                break
            except queue_mod.Empty:
                if not p.is_alive():  # hard death (signal, OOM)
                    raise RuntimeError(
                        'batch worker {} died (exit code {})'.format(
                            idx, p.exitcode))
        if isinstance(item, tuple) and len(item) == 2 and item[0] == _ERROR:
            raise RuntimeError(
                'batch worker {} failed:\n{}'.format(idx, item[1]))
        return item

    def close(self):
        """Stop the workers; a second call does nothing."""
        for p in self._procs:
            p.terminate()
        for p in self._procs:
            p.join(timeout=5)
        for q in self._queues:
            q.close()
        self._procs, self._queues = [], []

    def __getattr__(self, name):
        template = self.__dict__.get('_template')
        if template is not None and not name.startswith('_'):
            return getattr(template, name)
        raise AttributeError(name)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
