"""The card's half of `compute_flow --model raft`: chunks of frame pairs
from pinned host memory through the tool's own `make_flow_compute` (an
upload on a side stream, RAFT, the quantization on the card, the
payloads' readback into pinned memory behind an event) and back to the
host.

Set-up makes `pool_chunks` chunks of `chunk` pairs from the seed into
pinned host buffers: each pair a textured frame (bicubic-upsampled
noise) and the same frame rolled by a seeded shift of up to `max_shift`
pixels. It builds RAFT as the tool builds it (`compute_flow.
build_flow_fn` for `--model raft --raft_iters <iters>`, bf16
convolutions with `--mixed_precision`), loads the benchmark's weights
into it, wraps it in `ops/flow.make_quantized_flow_fn` (clip, no median
subtraction) and computes `warmup_chunks` chunks. It then checks the
program's correlation stage and its first refinements (below). The
window feeds the pool's chunks in turn through the program's
`core/pipeline.run_pipelined`, `segment_chunks` a call, as the tool
feeds one corpus; the collect stage waits for its chunk's readback
alone. Calls repeat until `seconds` have passed.

The weights are `vpdbench/weights.make`'s, with the flow head's last
convolution scaled by the configuration's `flow_head_scale`: at He's
scale random weights move every pixel by some 8 px an iteration, and
most of the flow would sit at the clip, where every answer agrees.

`correct` reads (`numbers`):

* `flow_q_gap_mean`: every payload read back in the window against the
  reference's payload of its pooled chunk (`vpdbench/reference/raft.py`
  in float32), the mean |difference| in quantization steps;
* `flow_q_off_share`: the share of payload values more than one step
  apart;
* `flow_early_gap`: the float flow of pooled chunk 0 after the first
  `checked_iters` refinements, by the program's own `RAFT.forward` in
  set-up, against the reference's: the mean over the pairs of the
  relative L2 gap, in units of the same gap of the reference with its
  products' operands rounded to bfloat16 (`Bf16Arith`), the
  configuration's convolutions. How far rounding moves the flow depends
  on the seed's weights (3.5x between seeds); the unit moves with it.
  The payloads' clip and truncation hide most of what rounding does at
  a few iterations; the float flow does not;
* `corr_stage_gap`: the correlation stage alone, in that same forward.
  What each of its lookups returned, against the reference's pyramid
  and `grid_sample` lookup over the forward's own feature maps at the
  coordinates the lookup was given: the largest relative L2 gap of a
  pair's lookup; inf where the forward made no lookup through
  `models/raft.corr_lookup`. The configuration states the correlation
  in float32, which the bf16 convolutions around it would hide from the
  payloads.

The window counts pairs whose payloads reached host memory (`MEASURES`);
a pair costs the reference's convolutions as `CountingArith` counts them
on `meta` tensors, and the all-pairs product (`costs`). The lookup, the
softmax and the upsampling are not charged, so the count does not
depend on how they are computed.
"""

import contextlib
import gc
import math
import time

import numpy as np
import torch
import torch.nn.functional as F

from .. import compare
from ..reference import raft as ref
from ..reference.arith import Arith, CountingArith, tf32_off
from ..flow_spans import traced_launches
from ..trace import span
from ..weights import derive, load, make

MEASURES = 'infer'
# the CPU tests' cut (`vpdbench/tests/tiny.py`): 64 x 64, chunks of 2,
# 2 iterations, float32
TINY = {'config': {'img_dim': 64, 'iters': 2, 'compute_dtype': 'float32'},
        'traffic': {'chunk': 2, 'pool_chunks': 2, 'segment_chunks': 3,
                    'warmup_chunks': 1, 'trace_chunks': 2}}
SCALED = ('update_block.flow_head.conv2.weight',
          'update_block.flow_head.conv2.bias')


# ------------------------------------------------------------ the faults
# planted underneath the timed path (`vpdbench/faults.planted`)

def _forward_changed(change):
    from vpd_tpu_torch.models import raft

    real = raft.RAFT.forward

    def forward(self, image1, image2, iters=12, train=False, dtype=None):
        return change(lambda a, b, n: real(self, a, b, n, train, dtype),
                      image1, image2, iters)

    return raft.RAFT, 'forward', forward


def half_batch():
    """The first half of a chunk is computed, the rest is its mean."""
    def change(fn, a, b, iters):
        h = a.shape[0] // 2
        out = fn(a[:h], b[:h], iters)
        rest = out.mean(dim=0, keepdim=True).expand(a.shape[0] - h,
                                                    *out.shape[1:])
        return torch.cat([out, rest])

    return _forward_changed(change)


def fewer_iters():
    """One refinement fewer than asked for."""
    return _forward_changed(lambda fn, a, b, iters: fn(a, b, iters - 1))


def corr_bf16():
    """The correlation volume and its pyramid computed and kept in bf16
    (read back as float32 by the lookup)."""
    from vpd_tpu_torch.models import raft

    def corr_pyramid(fmap1, fmap2, num_levels=4):
        b, h, w, c = fmap1.shape
        f1 = fmap1.reshape(b, h * w, c).to(torch.bfloat16)
        f2 = fmap2.reshape(b, h * w, c).to(torch.bfloat16)
        corr = (torch.bmm(f1, f2.transpose(1, 2)) / math.sqrt(c)).reshape(
            b * h * w, 1, h, w)
        pyramid = [corr[:, 0]]
        for _ in range(num_levels - 1):
            corr = F.avg_pool2d(corr, 2, stride=2)
            pyramid.append(corr[:, 0])
        return [p.float() for p in pyramid]

    return raft, 'corr_pyramid', corr_pyramid


FAULTS = {'half_batch': half_batch, 'fewer_iters': fewer_iters,
          'corr_bf16': corr_bf16}


# ---------------------------------------------------------------- inputs

def seeded_pairs(seed, i, n, size, max_shift, device):
    """Chunk `i` of a run seeded `seed`: (prev, curr) uint8 (n, S, S, 3),
    each prev bicubic-upsampled S/8 noise, curr the same frame rolled by
    a shift of up to `max_shift` pixels a pair."""
    gen = torch.Generator(device=device)
    gen.manual_seed(derive(seed, 'pairs:{}'.format(i)))
    noise = 255 * torch.rand((n, 3, size // 8, size // 8), generator=gen,
                             device=device)
    prev = F.interpolate(noise, size=(size, size), mode='bicubic',
                         align_corners=False).clamp(0, 255).round().to(
        torch.uint8).permute(0, 2, 3, 1).contiguous()
    shift = torch.randint(-max_shift, max_shift + 1, (n, 2), generator=gen,
                          device=device)
    pos = torch.arange(size, device=device)
    rows = (pos[None] - shift[:, :1]) % size
    cols = (pos[None] - shift[:, 1:]) % size
    curr = prev[torch.arange(n, device=device)[:, None, None],
                rows[:, :, None], cols[:, None, :]]
    return prev, curr


class Bf16Arith(Arith):
    """Products on operands rounded to bfloat16: the unit of
    `flow_early_gap`."""

    name = 'bfloat16'

    def cast(self, x):
        return x.to(torch.bfloat16).to(x.dtype)


def check_widths(model, config):
    """The program's RAFT has the configuration's widths."""
    got = {'hidden_dim': model.hidden_dim, 'context_dim': model.context_dim,
           'corr_radius': model.corr_radius, 'corr_levels': model.corr_levels,
           'fnet_dim': model.fnet.conv2.out_channels}
    want = {k: config[k] for k in got}
    if got != want:
        raise ValueError('the program\'s RAFT is {}, the configuration '
                         '{}'.format(got, want))


class Cell:

    def __init__(self, config, traffic, seed, device):
        self.config, self.traffic = config, traffic
        self.seed, self.device = seed, torch.device(device)
        self.chunk = traffic['chunk']
        self.pool_n = traffic['pool_chunks']
        self.answers = []
        self.next_chunk = 0
        self._reference = None
        self.corr_stage_gap = math.inf
        self.early = None

    def pairs(self, i):
        return seeded_pairs(self.seed, i, self.chunk, self.config['img_dim'],
                            self.traffic['max_shift'], self.device)

    def weights(self):
        """({name: float32} parameters, {name: float32} statistics) from
        the seed, the flow head's last convolution scaled."""
        params, stats = ref.shapes(self.config)
        p = make(params, self.seed, self.device)
        for k in SCALED:
            p[k] = p[k] * self.config['flow_head_scale']
        return p, make(stats, self.seed, self.device, tag='stats')

    def setup(self):
        from vpd_tpu_torch.core.pipeline import run_pipelined
        from vpd_tpu_torch.ops.flow import make_quantized_flow_fn
        from vpd_tpu_torch.tools.compute_flow import (build_flow_fn,
                                                      make_flow_compute)

        marks = [('start', time.perf_counter())]
        c = self.config
        flow_fn = build_flow_fn(
            'raft', raft_iters=c['iters'],
            mixed_precision=c['compute_dtype'] == 'bfloat16',
            device=self.device)
        check_widths(flow_fn.model, c)
        load(flow_fn.model, *self.weights())
        self.flow_fn = flow_fn
        self.compute = make_flow_compute(
            make_quantized_flow_fn(flow_fn, clip=c['clip'],
                                   subtract_median=c['subtract_median']),
            self.device)
        marks.append(('model', time.perf_counter()))
        cuda = self.device.type == 'cuda'
        self.pool = []
        for i in range(self.pool_n):
            self.pool.append(tuple(t.cpu().pin_memory() if cuda else t.cpu()
                                   for t in self.pairs(i)))
        self.run_pipelined = run_pipelined
        self.spans = False
        marks.append(('pool', time.perf_counter()))
        self._call(self.traffic['warmup_chunks'])
        self.answers = []
        marks.append(('warmup', time.perf_counter()))
        self._checks()
        marks.append(('checks', time.perf_counter()))
        self.setup_parts = {b[0]: b[1] - a[1]
                            for a, b in zip(marks[:-1], marks[1:])}

    def checked_iters(self):
        return min(self.traffic['checked_iters'], self.config['iters'])

    def _checks(self):
        """Set-up's checks on pooled chunk 0 (module docstring), from one
        forward of the program's own: its float flow after
        `checked_iters`, kept for `flow_early_gap`, and `corr_stage_gap`
        over each correlation lookup that forward made (the program's
        `corr_lookup`, recorded for this call alone) at the coordinates
        it was given. It stays inf where the forward made no lookup."""
        from vpd_tpu_torch.models import raft

        model, c = self.flow_fn.model, self.config
        seen, calls = [], []
        real = raft.corr_lookup

        def lookup(pyramid, coords, radius):
            out = real(pyramid, coords, radius)
            calls.append((coords.clone(), out.clone()))
            return out

        hook = model.fnet.register_forward_hook(
            lambda mod, args, out: seen.append(out))
        raft.corr_lookup = lookup
        try:
            with torch.inference_mode():
                self.early = model(
                    *self.pairs(0), iters=self.checked_iters(),
                    dtype=getattr(torch, c['compute_dtype'])).cpu()
        finally:
            raft.corr_lookup = real
            hook.remove()
        if not seen or not calls:
            return
        fmaps = seen[-1].float()
        f1, f2 = fmaps.split(fmaps.shape[0] // 2)
        gaps = []
        with tf32_off(), torch.no_grad():
            pyramid = ref.corr_pyramid(f1, f2, c['corr_levels'])
            for coords, got in calls:
                want = ref.lookup(pyramid, coords.permute(0, 3, 1, 2),
                                  c['corr_radius'])
                gaps.append(compare.image_gaps(
                    got, want.permute(0, 2, 3, 1)).max())
        self.corr_stage_gap = float(max(gaps))

    def _span(self, name):
        return span(name) if self.spans else contextlib.nullcontext()

    def _decode(self, i):
        with self._span('vpdbench.decode'):
            return i, self.pool[i % self.pool_n]

    def _compute(self, host):
        with self._span('vpdbench.compute'):
            i, frames = host
            return i, self.compute(frames)

    def _collect(self, _, result):
        with self._span('vpdbench.collect'):
            i, (q, done) = result
            if done is not None:
                done.synchronize()
            self.answers.append((i, q.copy()))

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
        """Trace one call of `trace_chunks` chunks, stages as spans; the
        summary also holds the device time of each launch, for the flow
        readers (`flow_spans.traced_launches`)."""
        self.spans = True
        try:
            return traced_launches(
                lambda: self._call(self.traffic['trace_chunks']))
        finally:
            self.spans = False

    def release(self):
        del self.flow_fn, self.compute, self.pool
        gc.collect()
        if self.device.type == 'cuda':
            torch.cuda.empty_cache()

    def reference_early(self, arith):
        """Pooled chunk 0's float flow after `checked_iters` by the
        reference in `arith`."""
        p, s = self.weights()
        return ref.forward(p, s, *self.pairs(0), self.config, arith,
                           iters=self.checked_iters())

    def reference(self, arith):
        """{'payloads': (pool_chunks, chunk, S, S, 2) uint8, 'clip_share':
        the share of float flow values at or past the clip, 'early': pooled
        chunk 0's float flow after `checked_iters`} of the reference in
        `arith`."""
        p, s = self.weights()
        c = self.config
        payloads, clipped = [], 0
        for i in range(self.pool_n):
            flow = ref.forward(p, s, *self.pairs(i), c, arith)
            clipped += int((flow.abs() >= c['clip']).sum())
            payloads.append(ref.quantize(flow, c['clip']).cpu().numpy())
            del flow
        payloads = np.stack(payloads)
        return {'payloads': payloads, 'clip_share': clipped / payloads.size,
                'early': self.reference_early(arith)}

    def costs(self):
        """FLOPs of a pair: the reference's convolutions counted on `meta`
        tensors, and the all-pairs product over the 1/8 grid."""
        c = self.config
        params, stats = ref.shapes(c)
        meta = {k: torch.empty(v, device='meta')
                for k, v in {**params, **stats}.items()}
        img = torch.empty((1, c['img_dim'], c['img_dim'], 3),
                          dtype=torch.uint8, device='meta')
        arith = CountingArith()
        ref.forward(meta, meta, img, img, c, arith)
        cells = (c['img_dim'] // 8) ** 2
        return {'infer_per_sample':
                arith.flops + 2 * cells * cells * c['fnet_dim']}

    def numbers(self, control=None):
        """The numbers of `correct` (module docstring) of every answer of
        the window and of set-up's checks, or of the reference in the
        `control` arithmetic (one answer a pooled chunk; its correlation
        stage is the reference's own, 0); and `ref_clip_share`, the
        reference's share of flow values at the clip."""
        if self._reference is None:
            self._reference = self.reference(Arith())
            self._reference['unit'] = float(np.mean(compare.image_gaps(
                self.reference_early(Bf16Arith()), self._reference['early'])))
        want = self._reference['payloads']
        out = {'ref_clip_share': self._reference['clip_share']}
        if control is not None:
            other = self.reference(control)
            answers = list(enumerate(other['payloads']))
            early = other['early']
            out['corr_stage_gap'] = 0.
        else:
            answers, early = self.answers, self.early
            out['corr_stage_gap'] = self.corr_stage_gap
        want_early = self._reference['early']
        out['flow_early_gap'] = float(np.mean(compare.image_gaps(
            None if early is None else early.to(want_early.device),
            want_early))) / max(self._reference['unit'], 1e-30)
        gap = off = total = 0
        for i, q in answers:
            if q.shape != want.shape[1:]:
                return dict(out, flow_q_gap_mean=math.inf,
                            flow_q_off_share=math.inf)
            d = np.abs(q.astype(np.int16) - want[i % self.pool_n])
            gap += int(d.sum())
            off += int((d > 1).sum())
            total += d.size
        if not total:
            return dict(out, flow_q_gap_mean=math.inf,
                        flow_q_off_share=math.inf)
        return dict(out, flow_q_gap_mean=gap / total,
                    flow_q_off_share=off / total)
