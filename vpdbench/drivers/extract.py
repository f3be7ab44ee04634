"""The card's half of `apply_vpd`: chunks of crops from pinned host
memory through `make_variant_embed` (kernel B1, then the encoder, the
original and the flipped variant of each crop) and back to the host.

Set-up makes `pool_chunks` chunks of `chunk` crops (uint8 RGB and flow)
from the seed into pinned host buffers, builds the program's student in
its served dtype with the benchmark's weights, and embeds
`warmup_chunks` chunks. The window feeds the pool's chunks in turn
through the program's `core/pipeline.run_pipelined`, `segment_chunks` a
call, as `apply_vpd` feeds one corpus: the decode stage hands over the
next pooled chunk, the compute stage is `apply_vpd`'s (an upload on a
side stream, then the embed) and enqueues the embeddings' copy to host
memory behind the embed, the collect stage waits for that chunk's copy
alone. (`apply_vpd`'s own collect copies on the compute stream from a
worker thread, so each copy waits for every chunk enqueued after it and
the card drains between chunks: a cost of the program's, not of the
card's half that this cell measures.) Calls repeat until `seconds` have
passed.

Every embedding read back in the window is kept; after the window the
reference embeds each pooled chunk once and every answer is compared
with its chunk's.

The window counts crops whose embeddings reached host memory
(`MEASURES`); a crop costs the student encoder's forward of both
variants (`vpdbench/flops.py`).
"""

import contextlib
import gc
import time

import torch

from .. import compare, faults, flops
from ..data import SeededCrops
from ..reference import student as ref
from ..reference.arith import Arith
from ..trace import span, traced
from ..weights import load, make

MEASURES = 'infer'
# the CPU tests' cut (`vpdbench/tests/tiny.py`): 32 x 32, chunks of 8,
# float32
TINY = {'config': {'img_dim': 32, 'compute_dtype': 'float32'},
        'traffic': {'chunk': 8, 'pool_chunks': 3, 'segment_chunks': 4,
                    'warmup_chunks': 2, 'trace_chunks': 3}}
# what `correct` has to catch underneath the timed path
FAULTS = {'half_batch': faults.extract_half_batch,
          'altered': faults.extract_altered}


class Cell:

    def __init__(self, config, traffic, seed, device):
        self.config, self.traffic = config, traffic
        self.seed, self.device = seed, torch.device(device)
        self.chunk = traffic['chunk']
        self.pool_n = traffic['pool_chunks']
        self.crops = SeededCrops(seed, self.chunk * self.pool_n,
                                 config['img_dim'], self.chunk, self.device)
        self.answers = []
        self.next_chunk = 0
        self._reference = None

    def setup(self):
        from vpd_tpu_torch.core.pipeline import run_pipelined
        from vpd_tpu_torch.infer.apply_vpd import make_variant_embed
        from vpd_tpu_torch.train.vpd_loop import build_student, \
            default_config

        marks = [('start', time.perf_counter())]
        c = self.config
        pc = default_config(c['dataset'], c['emb_dim'], img_dim=c['img_dim'],
                            use_flow=c['use_flow'], motion=c['motion'],
                            encoder_arch=c['encoder_arch'])
        pc['rgb_mean_std'] = [list(v) for v in c['rgb_mean_std']]
        model = build_student(pc, dtype=getattr(torch, c['compute_dtype']))
        params, stats = ref.shapes(c)
        load(model, make(params, self.seed, self.device),
             make(stats, self.seed, self.device, tag='stats'))
        self.model = model
        self.embed = make_variant_embed(model, pc, jitter=0, flip=True,
                                        device=self.device)
        marks.append(('model', time.perf_counter()))
        cuda = self.device.type == 'cuda'
        self.pool = [tuple(self.crops.shard(s, i).cpu().pin_memory()
                           if cuda else self.crops.shard(s, i).cpu()
                           for s in ('rgb', 'flow'))
                     for i in range(self.pool_n)]
        self.copy_stream = torch.cuda.Stream(self.device) if cuda else None
        self.run_pipelined = run_pipelined
        self.spans = False
        marks.append(('pool', time.perf_counter()))
        self._call(self.traffic['warmup_chunks'])
        self.answers = []
        marks.append(('warmup', time.perf_counter()))
        self.setup_parts = {b[0]: b[1] - a[1]
                            for a, b in zip(marks[:-1], marks[1:])}

    def _span(self, name):
        return span(name) if self.spans else contextlib.nullcontext()

    def _decode(self, i):
        with self._span('vpdbench.decode'):
            return i, self.pool[i % self.pool_n]

    def _compute(self, host):
        # apply_vpd's compute stage: the upload on a side stream overlaps
        # the previous chunk's encoder; the compute stream waits for it
        with self._span('vpdbench.compute'):
            i, (rgb, flow) = host
            if self.copy_stream is None:
                return i, self.embed(rgb, flow, i).float(), None
            compute_stream = torch.cuda.current_stream(self.device)
            with torch.cuda.stream(self.copy_stream):
                rgb = rgb.to(self.device, non_blocking=True)
                flow = flow.to(self.device, non_blocking=True)
            compute_stream.wait_stream(self.copy_stream)
            for t in (rgb, flow):
                t.record_stream(compute_stream)
            out = self.embed(rgb, flow, i).float().to('cpu',
                                                      non_blocking=True)
            done = torch.cuda.Event()
            done.record(compute_stream)
            return i, out, done

    def _collect(self, _, result):
        with self._span('vpdbench.collect'):
            i, out, done = result
            if done is not None:
                done.synchronize()
            self.answers.append((i, out.numpy().copy()))

    def _call(self, n):
        first = self.next_chunk
        self.next_chunk += n
        self.run_pipelined(range(first, first + n), self._decode,
                           self._compute, self._collect)

    def window(self, seconds, timed=False):
        t0 = time.perf_counter()
        calls = 0
        while True:
            self._call(self.traffic['segment_chunks'])
            calls += 1
            if time.perf_counter() - t0 >= seconds:
                break
        dt = time.perf_counter() - t0
        n = calls * self.traffic['segment_chunks'] * self.chunk
        return {'seconds': dt, 'samples': len(self.answers) * self.chunk,
                'attempted': n, 'failed': n - len(self.answers) * self.chunk,
                'chunks': calls * self.traffic['segment_chunks']}

    def trace(self):
        """Trace one call of `trace_chunks` chunks, stages as spans."""
        self.spans = True
        _, summary = traced(lambda: self._call(self.traffic['trace_chunks']))
        self.spans = False
        return summary

    def release(self):
        del self.model, self.embed, self.pool, self.copy_stream
        gc.collect()
        if self.device.type == 'cuda':
            torch.cuda.empty_cache()

    def reference(self, arith):
        """(pool_chunks, chunk, 2, emb_dim) embeddings of each pooled
        chunk by the reference in `arith`."""
        params, stats = ref.shapes(self.config)
        p = make(params, self.seed, self.device)
        s = make(stats, self.seed, self.device, tag='stats')
        return torch.stack([ref.embed_orig_and_flip(
            self.config, p, s, self.crops.shard('rgb', i),
            self.crops.shard('flow', i), arith)
            for i in range(self.pool_n)]).cpu().numpy()

    def costs(self):
        return flops.student_costs(self.config)

    def numbers(self, control=None):
        """`emb_gap` of every answer of the window (or of the reference
        in the `control` arithmetic, one answer a pooled chunk)."""
        if self._reference is None:
            self._reference = self.reference(Arith())
        if control is not None:
            return {'emb_gap': compare.embedding_gap(
                self.reference(control), self._reference)}
        if not self.answers:
            return {'emb_gap': float('inf')}
        return {'emb_gap': max(compare.embedding_gap(
            out, self._reference[i % self.pool_n])
            for i, out in self.answers)}

