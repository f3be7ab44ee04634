"""VPD student training: augmentation + distillation MSE + AdamW step.

Counterpart of `vpd_tpu/train/vpd.py` (reference `train_vpd_model.py:
53-112`): the ResNet student embeds a (possibly RGB+flow) crop, optionally
through the motion head (emb -> 2*emb, `--motion`); the loss is the raw
sum of squared errors against the teacher's embedding; AdamW updates
every parameter.

One train step on the card: the uint8 batch is augmented on the device
(`ops/augment.train_augment`: one CUDA kernel on the card, the plain
`data/augment.py` chain on the CPU), the student runs forward and
backward with float32 master parameters and bf16 compute
(`models/resnet.py`), and AdamW steps. The step reads nothing back from
the device: its metrics stay there until the epoch ends
(`core/metrics.fetch_metrics`). The cached steps take index batches and
augment those rows of the device crop cache (`data/hbm_cache.py`), the
kernel reading them in place, then run the same body. Under a profiler a
step's stages are spans (`core/profiling.span`) with the step's id
`step`, the optimizer's step count: `vpd.train.input` (the gather and
the augmentation), `vpd.train.fwd_bwd` (`forward_backward`) and
`vpd.train.adamw` (`optimizer_step`).

Randomness: vpd_tpu folds the step counter into one key per run
(`jax.random.fold_in(rng, state.step)`). Here a step's augmentation
draws come from generators seeded with `fold_in(seed, step)` below, one
on the batch's device and one on the CPU for the batch's jitter order
(`data.augment.sample_train_augment`). So step t draws the same values
whether a run got there in one go or through a resume. The trainer
passes `seed + 1` for training and `seed + 2` for augmented validation,
as vpd_tpu keys them. The student's dropout masks (EfficientNet's
stochastic depth and head dropout; ResNet and the motion head draw none)
come from a third generator on the batch's device, seeded
`dropout_seed(seed, step)`, so a resumed run draws them as an
uninterrupted one does.

On a data mesh (`core/mesh.py`, a state made with `mesh=`) each rank holds
its rows of the global batch. Every rank draws the augmentation and
dropout values of the whole global batch from the same generators and
keeps its rows, so the ranks together draw what one process draws; the
BatchNorm statistics are global (`models/resnet.set_bn_sync`) and the
gradients are summed over the data group before AdamW, the loss being a
raw sum over the global batch.
"""

import numpy as np
import torch
from torch import nn

from ..core.mesh import all_reduce_grads, part_rows
from ..core.profiling import span
from ..data.augment import eval_transform_batch, sample_train_augment
from ..models.fc import FCNet, FlaxDropout, set_dropout_draw
from ..models.flax_weights import (student_params_from_flax,
                                   student_params_to_flax)
from ..models.resnet import set_bn_sync
from ..ops.augment import train_augment


class MotionHead(nn.Module):
    """FCNet(emb -> [128,128] -> 2*emb), float32 under bf16 encoders."""

    def __init__(self, emb_dim):
        super().__init__()
        self.net = FCNet(emb_dim, (128, 128), 2 * emb_dim, dropout=0.)

    def forward(self, x):
        return self.net(x)


class VPDStudent(nn.Module):

    def __init__(self, encoder, motion=None):
        super().__init__()
        self.encoder = encoder
        self.motion = motion

    def forward(self, x):
        emb = self.encoder(x)
        if self.motion is not None:
            emb = self.motion(emb)
        return emb


class VPDTrainState:
    """The student (master parameters), its AdamW and the step count.
    `draws_dropout` says whether the student has a `FlaxDropout` that
    draws a mask (an EfficientNet's; a ResNet student has none), found
    once so that a step seeds no mask source it would not use. `mesh` is
    the data mesh the step runs on, kept where it has a data group to sum
    over (None: one process); `part` this rank's block of the global
    batch."""

    def __init__(self, model, optimizer, step=0, mesh=None):
        self.model = model
        self.optimizer = optimizer
        self.step = step
        self.draws_dropout = any(isinstance(m, FlaxDropout) and m.rate > 0
                                 for m in model.modules())
        self.mesh = (mesh if mesh is not None and mesh.data_group is not None
                     else None)
        set_bn_sync(model, None if self.mesh is None
                    else self.mesh.data_group)

    @property
    def part(self):
        return (0, 1) if self.mesh is None else self.mesh.batch_part

    @property
    def data_group(self):
        return None if self.mesh is None else self.mesh.data_group


def create_state(model, learning_rate, weight_decay=0.01, mesh=None):
    """AdamW(b1 0.9, b2 0.999, eps 1e-8) with weight decay on every
    parameter, BN scales and biases included, as optax.adamw without a
    mask (`vpd_tpu/train/vpd.py:57-65`). `model` lives on its device; on
    CUDA the update is torch's fused AdamW. `mesh`: the data mesh the
    steps run on."""
    cuda = next(model.parameters()).device.type == 'cuda'
    optimizer = torch.optim.AdamW(
        model.parameters(), lr=learning_rate, betas=(0.9, 0.999), eps=1e-8,
        weight_decay=weight_decay, fused=True if cuda else None)
    return VPDTrainState(model, optimizer, mesh=mesh)


def forward_backward(state, imgs, emb, dropout_draw=None):
    """Train-mode forward of (B, S, S, C) images (NHWC) and backward of
    sum((out - emb)^2), the un-normalized sum the reference backprops
    (`train_vpd_model.py:87-91`). `dropout_draw` is the mask source of the
    student's `FlaxDropout`s for this forward (`models/fc.py`), None for
    a student that draws none. On a data mesh the gradients are then
    summed over the data group. Returns this rank's loss, on the
    device."""
    with span('vpd.train.fwd_bwd', imgs.device, step=state.step):
        model = state.model.train()
        if dropout_draw is None:
            out = model(imgs.permute(0, 3, 1, 2))
        else:
            set_dropout_draw(model, dropout_draw)
            try:
                out = model(imgs.permute(0, 3, 1, 2))
            finally:
                set_dropout_draw(model, None)
        loss_sum = torch.sum(torch.square(out - emb))
        state.optimizer.zero_grad(set_to_none=True)
        loss_sum.backward()
        all_reduce_grads(state.model.parameters(), state.data_group)
        return loss_sum.detach()


def optimizer_step(state):
    group = state.optimizer.param_groups[0]
    with span('vpd.train.adamw', group['params'][0].device, step=state.step):
        state.optimizer.step()
    state.step += 1


def apply_train_update(state, imgs, emb, dropout_draw=None):
    """fwd/bwd/AdamW on an already-augmented float image batch; the
    metrics stay on the device."""
    loss_sum = forward_backward(state, imgs, emb, dropout_draw)
    optimizer_step(state)
    return {'emb_loss_sum': loss_sum, 'n': float(emb.shape[0])}


def fold_in(seed, step):
    """The seed of step `step` of a run seeded `seed`."""
    return (seed << 32) + step


# mixes every bit of a step's seed: torch's CPU generator reads only a
# seed's low 32 bits, CUDA's all 64
_DROPOUT_STREAM = 0x9E3779B97F4A7C15


def dropout_seed(seed, step):
    """The seed of step `step`'s dropout masks: `fold_in(seed, step)`
    mixed with a constant, a stream apart from the step's augmentation
    draws on either device (as vpd_tpu folds 1 into the step's key for its
    dropout)."""
    return fold_in(seed, step) ^ _DROPOUT_STREAM


class _Constants:
    """Per-device tensors of the channel statistics and the step's
    generators, made once so that a step copies nothing to the device."""

    def __init__(self, mean, std):
        self.mean, self.std = mean, std
        self._stats = {}
        self._gens = {}
        self._drop_gens = {}

    def stats(self, device, dtype):
        key = (device, dtype)
        if key not in self._stats:
            self._stats[key] = tuple(torch.tensor(v, dtype=dtype,
                                                  device=device)
                                     for v in (self.mean, self.std))
        return self._stats[key]

    def generators(self, device, seed):
        if device not in self._gens:
            self._gens[device] = (torch.Generator(device=device),
                                  torch.Generator())
        gen, host_gen = self._gens[device]
        gen.manual_seed(seed)
        host_gen.manual_seed(seed)
        return gen, host_gen

    def dropout_draw(self, device, seed, step, part=(0, 1)):
        """The mask source of step `step`: keep bits from a generator on
        `device` seeded `dropout_seed(seed, step)`. With `part` (i, k)
        each mask is drawn for the k-times larger global batch and part
        i's rows of it are kept."""
        if device not in self._drop_gens:
            self._drop_gens[device] = torch.Generator(device=device)
        gen = self._drop_gens[device]
        gen.manual_seed(dropout_seed(seed, step))
        return global_rows_draw(gen, part)


def global_rows_draw(gen, part):
    """A `FlaxDropout` mask source drawing keep bits from `gen` for the
    global batch (k times the local rows) and keeping part (i, k)'s
    rows: the ranks of a data mesh draw what one process draws."""
    k = part[1]

    def draw(shape, keep, dev):
        full = torch.rand((shape[0] * k,) + tuple(shape[1:]), generator=gen,
                          device=dev) < keep
        return full if k == 1 else full[part_rows(full.shape[0], part)]

    return draw


def _rows_of(draws, b, part):
    """Part `part`'s rows of per-sample draws of a b-row global batch
    (batch-wide values, such as the jitter order, as they are)."""
    if part[1] == 1:
        return draws
    rows = part_rows(b, part)
    return {k: v[rows] if torch.is_tensor(v) and v.dim() and v.shape[0] == b
            else v for k, v in draws.items()}


def _make_augment(consts, img_dim, use_flow, use_mask, aug_dtype,
                  jitter_order):
    def augment(batch, seed, step, part=(0, 1), rows=None, row_offset=0):
        """The batch's augmented images, from the draws of `fold_in(seed,
        step)`. `batch` holds the uint8 streams ('rgb'[, 'flow', 'mask'])
        and the flips: the batch's own rows, or with `rows` ((B,) indices)
        a crop cache's arrays, of which rows `rows - row_offset` are the
        batch (`ops/augment.train_augment`). Masks are used when the batch
        has them and `use_mask`. With `part` (i, k) the batch is rows i of
        a k-times larger global batch, whose draws are made and sliced."""
        rgb = batch['rgb']
        mask = batch.get('mask') if use_mask else None
        gen, host_gen = consts.generators(rgb.device, fold_in(seed, step))
        b = batch['flip'].shape[0]
        h, w = rgb.shape[1:3]
        draws = _rows_of(sample_train_augment(
            gen, host_gen, b * part[1], h, w,
            per_sample_order=jitter_order == 'per_sample',
            mask=mask is not None, noise_dtype=aug_dtype), b * part[1], part)
        draws['flip'] = batch['flip']
        return train_augment(
            {'rgb': rgb, 'flow': batch.get('flow') if use_flow else None,
             'mask': mask}, draws, consts.mean, consts.std, rows=rows,
            row_offset=row_offset, out_size=img_dim, dtype=aug_dtype)

    return augment


def make_train_step(mean, std, img_dim=128, use_flow=False, use_mask=True,
                    aug_dtype=torch.float32, jitter_order='batch'):
    """step(state, batch, seed) -> metrics: augment the uint8 batch
    ({'rgb', 'emb', 'flip'[, 'flow', 'mask']} tensors on the model's
    device) in `aug_dtype`, then fwd/bwd and AdamW. `jitter_order=
    'per_sample'` draws the colour-jitter op order per image (QUIRKS.md).
    `step.augment(batch, seed, step_idx)` is the augmentation alone and
    `step.dropout_draw(device, seed, step_idx)` the step's mask source."""
    consts = _Constants(mean, std)
    augment = _make_augment(consts, img_dim, use_flow, use_mask, aug_dtype,
                            jitter_order)

    def step(state, batch, seed):
        with span('vpd.train.input', batch['rgb'].device, step=state.step):
            imgs = augment(batch, seed, state.step, state.part)
        return apply_train_update(
            state, imgs, batch['emb'],
            consts.dropout_draw(imgs.device, seed, state.step, state.part)
            if state.draws_dropout else None)

    step.augment = augment
    step.dropout_draw = consts.dropout_draw
    return step


def cache_gather(cache, idx, names, row_offset=0):
    """The rows `idx` ((B,) int32 on the cache's device) of the cache
    streams in `names`: {name: (B, ...) uint8}. One `index_select` a
    stream, no host sync. A row-sharded cache holds global rows
    [row_offset, row_offset + len) on this rank, and `idx` names only
    those (the sampler homes them): the gather is `idx - row_offset`,
    with no collective."""
    if row_offset:
        idx = idx - row_offset
    return {k: cache[k].index_select(0, idx) for k in names if k in cache}


def make_cached_train_step(mean, std, img_dim=128, use_flow=False,
                           use_mask=True, aug_dtype=torch.float32,
                           jitter_order='batch', row_offset=0):
    """Train step over the device crop cache (`data/hbm_cache.py`):
    step(state, batch, seed, cache) -> metrics, where the batch carries
    row indices, targets and flips ({'idx', 'emb', 'flip'}) and `cache` is
    `DeviceCropCache.arrays`. The step is `make_train_step`'s on the same
    draws and the cache's rows `idx`, which the augmentation reads in
    place (`ops/augment.train_augment`; gathered first on the CPU). Masks
    are used when `use_mask` (the source's setting, not whether the cache
    holds masks). `row_offset`: the first global row of a row-sharded
    cache's partition on this rank (`cache_gather`)."""
    consts = _Constants(mean, std)
    augment = _make_augment(consts, img_dim, use_flow, use_mask, aug_dtype,
                            jitter_order)

    def step(state, batch, seed, cache):
        with span('vpd.train.input', batch['idx'].device, step=state.step):
            imgs = augment({**cache, 'flip': batch['flip']}, seed,
                           state.step, state.part, rows=batch['idx'],
                           row_offset=row_offset)
        return apply_train_update(
            state, imgs, batch['emb'],
            consts.dropout_draw(imgs.device, seed, state.step, state.part)
            if state.draws_dropout else None)

    return step


def _eval_metrics(state, imgs, emb):
    model = state.model.eval()
    with torch.no_grad():
        out = model(imgs.permute(0, 3, 1, 2))
        return {'emb_loss_sum': torch.sum(torch.square(out - emb)),
                'n': float(emb.shape[0])}


def make_eval_step(mean, std, use_flow=False):
    """step(state, batch) -> metrics on the deterministic eval transform,
    the student in eval mode."""
    consts = _Constants(mean, std)

    def step(state, batch):
        rgb = batch['rgb']
        imgs = eval_transform_batch(
            rgb, *consts.stats(rgb.device, torch.float32),
            flow_u8=batch.get('flow') if use_flow else None)
        return _eval_metrics(state, imgs, batch['emb'])

    return step


def make_cached_eval_step(mean, std, use_flow=False, row_offset=0):
    """Deterministic eval over the device crop cache: step(state, batch,
    cache) -> metrics on index batches ({'idx', 'emb'})."""
    eval_step = make_eval_step(mean, std, use_flow=use_flow)
    names = ('rgb', 'flow') if use_flow else ('rgb',)

    def step(state, batch, cache):
        return eval_step(state, {**cache_gather(cache, batch['idx'], names,
                                                row_offset),
                                 'emb': batch['emb']})

    return step


def make_aug_eval_step(mean, std, img_dim=128, use_flow=False,
                       use_mask=True, aug_dtype=torch.float32,
                       jitter_order='batch'):
    """Validation WITH the train-time augmentation (reference parity:
    `vpd_dataset/single_frame.py:354`), the student in eval mode:
    step(state, batch, seed, step_idx) -> metrics. `aug_dtype` and
    `jitter_order` must match the train step's."""
    augment = _make_augment(_Constants(mean, std), img_dim, use_flow,
                            use_mask, aug_dtype, jitter_order)

    def step(state, batch, seed, step_idx):
        return _eval_metrics(state, augment(batch, seed, step_idx,
                                            state.part), batch['emb'])

    return step


# ------------------------------------------------ optimizer checkpoints

def _params(state):
    return dict(state.model.named_parameters())


def optimizer_moments(state):
    """(count, {'mu': {name: tensor}, 'nu': {name: tensor}}): AdamW's step
    count and moments by parameter name (zeros before the first step)."""
    opt = state.optimizer.state
    count = 0
    moments = {'mu': {}, 'nu': {}}
    for name, p in _params(state).items():
        st = opt.get(p)
        if st:
            count = int(st['step'])
        for key, torch_key in (('mu', 'exp_avg'), ('nu', 'exp_avg_sq')):
            moments[key][name] = st[torch_key] if st else torch.zeros_like(p)
    return count, moments


def moments_to_flax(model, count, moments,
                    params_to_flax=student_params_to_flax):
    """optax.adamw's state tree (`optimizer_to_flax`) of a count and
    moments by name of `model`'s parameters."""
    return {'0': {'count': np.array(count, np.int32),
                  **{k: params_to_flax(model, v)
                     for k, v in moments.items()}},
            '1': {}, '2': {}}


def optimizer_to_flax(state, params_to_flax=student_params_to_flax):
    """AdamW's state as flax writes optax.adamw's (`to_state_dict`):
    {'0': {'count': int32 (), 'mu': params tree, 'nu': params tree},
    '1': {}, '2': {}}, the moments in flax's layouts. `params_to_flax`
    maps the model's parameters (a student's by default)."""
    count, moments = optimizer_moments(state)
    return moments_to_flax(state.model, count, moments, params_to_flax)


def load_moments(state, count, mu, nu):
    """Set AdamW's step count and moments ({name: tensor} of the model's
    parameters; nothing at count 0) and the state's step."""
    sd = state.optimizer.state_dict()
    params = _params(state)

    def like(p, value):  # the parameter's device, dtype and strides
        return torch.empty_like(p).copy_(value)

    sd['state'] = {i: {'step': torch.tensor(float(count)),
                       'exp_avg': like(p, mu[name]),
                       'exp_avg_sq': like(p, nu[name])}
                   for i, (name, p) in enumerate(params.items())
                   } if count else {}
    state.optimizer.load_state_dict(sd)
    state.step = count


def load_optimizer_from_flax(state, tree,
                             params_from_flax=student_params_from_flax):
    """Restore AdamW's moments and step count from `optimizer_to_flax`'s
    layout (as vpd_tpu writes it)."""
    load_moments(state, int(tree['0']['count']),
                 *(params_from_flax(state.model, tree['0'][k])
                   for k in ('mu', 'nu')))
