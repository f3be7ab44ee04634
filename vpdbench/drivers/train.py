"""Student training epochs over the device crop cache, as
`tools/train_vpd --hbm_cache` runs them.

Set-up makes `cache_crops` crops (RGB, flow, mask) and their teacher
targets from the seed, stages them in the program's `DeviceCropCache`
through a shard reader with nothing on disk, builds the program's
`CacheIndexSource` (batch `batch_size`, `epoch_samples` a virtual epoch,
flips drawn) and `VPDTrainer` without validation, and loads the
benchmark's weights into the student. The trainer's first epoch runs
in set-up, through the window's own call and feed, and warms up every
shape the window uses; its first `checked_steps` steps are recorded
(the rows, targets, flips and step seeds, the losses, the first
step's augmented input and predictions, the first gradient from
AdamW's first moment, the parameters after the last of them). The
window runs whole epochs until `seconds` have passed; the epoch that
crosses that point is the last.

After the window the program is freed and the reference follows the
checked steps from the same weights, rows and draws.

The window counts samples trained (`MEASURES`); a sample costs the
student's train FLOPs (`vpdbench/flops.py`).
"""

import gc
import time

import torch

from .. import compare, faults, flops
from ..data import SeededCrops, SeededReader, sample_key, targets
from ..reference import student as ref
from ..reference.arith import Arith
from ..trace import span, traced
from ..weights import derive, load, make

IMG_DIR = 'crops'
MEASURES = 'train'
# the CPU tests' cut (`vpdbench/tests/tiny.py`): 32 x 32, a few crops,
# batches of 8, float32
TINY = {'config': {'img_dim': 32, 'compute_dtype': 'float32'},
        'traffic': {'cache_crops': 48, 'rows_per_shard': 20,
                    'batch_size': 8, 'epoch_samples': 16,
                    'trace_epochs': 1}}
# what `correct` has to catch underneath the timed path
FAULTS = {'unchanged': faults.train_unchanged,
          'half_batch': faults.train_half_batch,
          'altered': faults.train_altered}


class _Recorder:
    """The trainer's train step, recording its first `n` calls."""

    def __init__(self, step, n):
        self.step, self.n = step, n
        self.feed, self.losses, self.preds = [], [], []
        self.grad1 = self.params = self.inputs = None

    def __call__(self, state, batch, seed, cache):
        i = len(self.feed)
        if i >= self.n:
            return self.step(state, batch, seed, cache)
        self.feed.append({'idx': batch['idx'].clone(),
                          'emb': batch['emb'].clone(),
                          'flip': batch['flip'].clone(),
                          'seed': seed, 'step': state.step})
        # the step's augmented input (the first step's) and the student's
        # predictions, as the step's forward saw and made them
        inputs, preds = [], []
        hooks = [state.model.register_forward_hook(
            lambda module, args, out: preds.append(out.detach().float()))]
        if i == 0:
            hooks.append(state.model.register_forward_pre_hook(
                lambda module, args: inputs.append(args[0].detach())))
        try:
            metrics = self.step(state, batch, seed, cache)
        finally:
            for hook in hooks:
                hook.remove()
        self.preds.append(preds[0] if len(preds) == 1 else None)
        if i == 0:
            self.inputs = inputs[0] if len(inputs) == 1 else None
        self.losses.append(metrics['emb_loss_sum'].detach().clone())
        named = dict(state.model.named_parameters())
        if i == 0:
            self.grad1 = first_gradient(state.optimizer, named)
        if i == self.n - 1:
            self.params = {k: p.detach().clone() for k, p in named.items()}
        return metrics


def first_gradient(optimizer, named):
    """The gradient of AdamW's first step, from its first moment
    ((1 - beta1) g after one step); zeros where it has no state."""
    beta1 = optimizer.param_groups[0]['betas'][0]
    out = {}
    for k, p in named.items():
        st = optimizer.state.get(p) or {}
        m = st.get('exp_avg')
        out[k] = (m.detach() / (1 - beta1) if m is not None
                  else torch.zeros_like(p))
    return out


class Cell:

    def __init__(self, config, traffic, seed, device):
        self.config, self.traffic = config, traffic
        self.seed, self.device = seed, torch.device(device)
        self.batch = traffic['batch_size']
        self.crops = SeededCrops(seed, traffic['cache_crops'],
                                 config['img_dim'], traffic['rows_per_shard'],
                                 self.device)
        self.epoch = 0
        self.sampler_ms = []
        self._reference = None

    def _program_config(self):
        from vpd_tpu_torch.train.vpd_loop import default_config

        c, opt = self.config, self.config['optimizer']
        pc = default_config(c['dataset'], c['emb_dim'],
                            batch_size=self.batch, learning_rate=opt['lr'],
                            img_dim=c['img_dim'], use_flow=c['use_flow'],
                            motion=c['motion'],
                            encoder_arch=c['encoder_arch'])
        pc['rgb_mean_std'] = [list(v) for v in c['rgb_mean_std']]
        return pc

    def setup(self):
        from vpd_tpu_torch.data.hbm_cache import (CacheIndexSource,
                                                  DeviceCropCache)
        from vpd_tpu_torch.train.vpd_loop import VPDTrainer

        marks = [('start', time.perf_counter())]
        reader = SeededReader(self.crops, IMG_DIR, 'flow')
        self.cache = DeviceCropCache(reader, use_flow=True, use_mask=True,
                                     device=self.device,
                                     log=lambda *a: None)
        marks.append(('cache', time.perf_counter()))
        tg = targets(self.seed, self.crops.num, 2 * self.config['emb_dim'])
        samples = [(v, None, f, tg[r])
                   for r, (v, f) in enumerate(map(sample_key,
                                                  range(self.crops.num)))]
        self.source = CacheIndexSource(
            samples, IMG_DIR, self.config['img_dim'], self.batch,
            cache=self.cache, target_len=self.traffic['epoch_samples'],
            flow_img_name='flow', use_mask=True, augment=True,
            seed=derive(self.seed, 'sampler'))
        program_seed = derive(self.seed, 'trainer', bits=31)
        self.trainer = VPDTrainer(
            self.source, None, self._program_config(), seed=program_seed,
            dtype=getattr(torch, self.config['compute_dtype']),
            device=self.device)
        params, stats = ref.shapes(self.config)
        load(self.trainer.model, make(params, self.seed, self.device),
             make(stats, self.seed, self.device, tag='stats'))
        marks.append(('trainer', time.perf_counter()))
        inner = self.trainer.train_step
        self.recorder = _Recorder(inner, self.traffic['checked_steps'])
        self.trainer.train_step = self.recorder
        while len(self.recorder.feed) < self.recorder.n:
            self._epoch()
        self.trainer.train_step = inner
        self._sync()
        marks.append(('checked_epoch', time.perf_counter()))
        self.setup_parts = {b[0]: b[1] - a[1]
                            for a, b in zip(marks[:-1], marks[1:])}

    def _epoch(self):
        with span('vpdbench.epoch'):
            self.trainer.train_one_epoch(self.epoch)
        self.epoch += 1

    def _sync(self):
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)

    @property
    def samples_per_epoch(self):
        return self.source.num_batches * self.batch

    def window(self, seconds, timed=False):
        """Whole epochs until `seconds` have passed. `timed` times the
        sampler's every batch on the host clock and marks it and the
        steps as spans."""
        if timed:
            self._instrument()
        t0 = time.perf_counter()
        epochs = 0
        while True:
            self._epoch()
            epochs += 1
            if time.perf_counter() - t0 >= seconds:
                break
        self._sync()
        dt = time.perf_counter() - t0
        n = epochs * self.samples_per_epoch
        return {'seconds': dt, 'samples': n, 'attempted': n, 'failed': 0,
                'steps': epochs * self.source.num_batches, 'epochs': epochs,
                'sampler_ms': list(self.sampler_ms) if timed else None}

    def _instrument(self):
        next_batch, step = self.source.next_batch, self.trainer.train_step

        def timed_next_batch():
            with span('vpdbench.sampler'):
                t = time.perf_counter()
                out = next_batch()
                self.sampler_ms.append((time.perf_counter() - t) * 1e3)
            return out

        def spanned_step(*args):
            with span('vpdbench.step'):
                return step(*args)

        self.source.next_batch = timed_next_batch
        self.trainer.train_step = spanned_step

    def trace(self):
        """Trace `trace_epochs` whole epochs."""
        _, summary = traced(lambda: [self._epoch() for _ in range(
            self.traffic['trace_epochs'])])
        return summary

    def release(self):
        """Keep the record of the checked steps, free the program."""
        self.record = {'feed': self.recorder.feed,
                       'losses': [float(x) for x in self.recorder.losses],
                       'preds': self.recorder.preds,
                       'inputs': self.recorder.inputs,
                       'grad1': self.recorder.grad1,
                       'params': self.recorder.params}
        del self.trainer, self.source, self.cache, self.recorder
        gc.collect()
        if self.device.type == 'cuda':
            torch.cuda.empty_cache()

    def reference(self, arith, first_input=None):
        """The reference's checked steps on the same feed, in `arith`
        (`ref.train_steps`)."""
        params, stats = ref.shapes(self.config)
        streams = {name: self.crops.stream(name)
                   for name in ('rgb', 'flow', 'mask')}

        def rows(idx):
            return tuple(streams[k].index_select(0, idx.long())
                         for k in ('rgb', 'flow', 'mask'))

        return ref.train_steps(self.config,
                               make(params, self.seed, self.device),
                               make(stats, self.seed, self.device, 'stats'),
                               self.record['feed'], rows, arith,
                               first_input)

    def costs(self):
        return flops.student_costs(self.config)

    def numbers(self, control=None):
        """The compared numbers: the program's record (or the reference
        in the `control` arithmetic in its place) against the float32
        reference. The control's augmented input is the reference's, so
        its forward alone is compared with the reference's."""
        if self._reference is None:
            self._reference = self.reference(Arith(), self.record['inputs'])
        targets = self.record['feed'][0]['emb']
        if control is None:
            program = dict(self.record, targets=targets)
            fwd = self._reference['first_input_preds']
        else:
            program = dict(self.reference(control), targets=targets)
            fwd = self._reference['preds'][0]
        start = make(ref.shapes(self.config)[0], self.seed, self.device)
        return compare.train_numbers(program, self._reference, start, fwd)
