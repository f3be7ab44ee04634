"""VPD student training: augmentation + distillation MSE + AdamW step.

Counterpart of `vpd_tpu/train/vpd.py` (reference `train_vpd_model.py:
53-112`): the ResNet student embeds a (possibly RGB+flow) crop, optionally
through the motion head (emb -> 2*emb, `--motion`); the loss is the raw
sum of squared errors against the teacher's embedding; AdamW updates
every parameter.

One train step on the card: the uint8 batch is augmented on the device
(`data/augment.py`), the student runs forward and backward with float32
master parameters and bf16 compute (`models/resnet.py`), and AdamW steps.
The step reads nothing back from the device: its metrics stay there
until the epoch ends (`core/metrics.fetch_metrics`). The cached steps
take index batches and gather the pixel rows from the device crop cache
(`data/hbm_cache.py`) first, then run the same body.

Randomness: vpd_tpu folds the step counter into one key per run
(`jax.random.fold_in(rng, state.step)`). Here a step's augmentation
draws come from generators seeded with `fold_in(seed, step)` below, one
on the batch's device and one on the CPU for the batch's jitter order
(`data.augment.sample_train_augment`). So step t draws the same values
whether a run got there in one go or through a resume. The trainer
passes `seed + 1` for training and `seed + 2` for augmented validation,
as vpd_tpu keys them. The motion head's dropout is 0, so no dropout mask
is drawn.
"""

import numpy as np
import torch
from torch import nn

from ..data.augment import (eval_transform_batch, sample_train_augment,
                            train_augment_batch)
from ..models.fc import FCNet
from ..models.flax_weights import (student_params_from_flax,
                                   student_params_to_flax)


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
    """The student (master parameters), its AdamW and the step count."""

    def __init__(self, model, optimizer, step=0):
        self.model = model
        self.optimizer = optimizer
        self.step = step


def create_state(model, learning_rate, weight_decay=0.01):
    """AdamW(b1 0.9, b2 0.999, eps 1e-8) with weight decay on every
    parameter, BN scales and biases included, as optax.adamw without a
    mask (`vpd_tpu/train/vpd.py:57-65`). `model` lives on its device; on
    CUDA the update is torch's fused AdamW."""
    cuda = next(model.parameters()).device.type == 'cuda'
    optimizer = torch.optim.AdamW(
        model.parameters(), lr=learning_rate, betas=(0.9, 0.999), eps=1e-8,
        weight_decay=weight_decay, fused=True if cuda else None)
    return VPDTrainState(model, optimizer)


def forward_backward(state, imgs, emb):
    """Train-mode forward of (B, S, S, C) images (NHWC) and backward of
    sum((out - emb)^2), the un-normalized sum the reference backprops
    (`train_vpd_model.py:87-91`). Returns the loss, on the device."""
    model = state.model.train()
    out = model(imgs.permute(0, 3, 1, 2))
    loss_sum = torch.sum(torch.square(out - emb))
    state.optimizer.zero_grad(set_to_none=True)
    loss_sum.backward()
    return loss_sum.detach()


def optimizer_step(state):
    state.optimizer.step()
    state.step += 1


def apply_train_update(state, imgs, emb):
    """fwd/bwd/AdamW on an already-augmented float image batch; the
    metrics stay on the device."""
    loss_sum = forward_backward(state, imgs, emb)
    optimizer_step(state)
    return {'emb_loss_sum': loss_sum, 'n': float(emb.shape[0])}


def fold_in(seed, step):
    """The seed of step `step` of a run seeded `seed`."""
    return (seed << 32) + step


class _Constants:
    """Per-device tensors of the channel statistics and the step's
    generators, made once so that a step copies nothing to the device."""

    def __init__(self, mean, std):
        self.mean, self.std = mean, std
        self._stats = {}
        self._gens = {}

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


def _make_augment(mean, std, img_dim, use_flow, use_mask, aug_dtype,
                  jitter_order):
    consts = _Constants(mean, std)

    def augment(batch, seed, step):
        """The batch's augmented images, from the draws of `fold_in(seed,
        step)`. Masks are used when the batch has them and `use_mask`."""
        rgb = batch['rgb']
        mask = batch.get('mask') if use_mask else None
        gen, host_gen = consts.generators(rgb.device, fold_in(seed, step))
        b, h, w = rgb.shape[:3]
        draws = sample_train_augment(
            gen, host_gen, b, h, w,
            per_sample_order=jitter_order == 'per_sample',
            mask=mask is not None, noise_dtype=aug_dtype)
        draws['flip'] = batch['flip']
        return train_augment_batch(
            rgb, draws, *consts.stats(rgb.device, aug_dtype),
            flow_u8=batch.get('flow') if use_flow else None, mask_u8=mask,
            out_size=img_dim, dtype=aug_dtype)

    return augment


def make_train_step(mean, std, img_dim=128, use_flow=False, use_mask=True,
                    aug_dtype=torch.float32, jitter_order='batch'):
    """step(state, batch, seed) -> metrics: augment the uint8 batch
    ({'rgb', 'emb', 'flip'[, 'flow', 'mask']} tensors on the model's
    device) in `aug_dtype`, then fwd/bwd and AdamW. `jitter_order=
    'per_sample'` draws the colour-jitter op order per image (QUIRKS.md).
    `step.augment(batch, seed, step_idx)` is the augmentation alone."""
    augment = _make_augment(mean, std, img_dim, use_flow, use_mask,
                            aug_dtype, jitter_order)

    def step(state, batch, seed):
        imgs = augment(batch, seed, state.step)
        return apply_train_update(state, imgs, batch['emb'])

    step.augment = augment
    return step


def cache_gather(cache, idx, names):
    """The rows `idx` ((B,) int32 on the cache's device) of the cache
    streams in `names`: {name: (B, ...) uint8}. One `index_select` a
    stream, no host sync."""
    return {k: cache[k].index_select(0, idx) for k in names if k in cache}


def make_cached_train_step(mean, std, img_dim=128, use_flow=False,
                           use_mask=True, aug_dtype=torch.float32,
                           jitter_order='batch'):
    """Train step over the device crop cache (`data/hbm_cache.py`):
    step(state, batch, seed, cache) -> metrics, where the batch carries
    row indices, targets and flips ({'idx', 'emb', 'flip'}) and `cache` is
    `DeviceCropCache.arrays`. The rows are gathered on the device, then
    the step is `make_train_step`'s on the same pixels and draws. Masks are
    used when `use_mask` (the source's setting, not whether the cache
    holds masks)."""
    augment = _make_augment(mean, std, img_dim, use_flow, use_mask,
                            aug_dtype, jitter_order)
    names = ('rgb',) + (('flow',) if use_flow else ()) + (
        ('mask',) if use_mask else ())

    def step(state, batch, seed, cache):
        pixels = cache_gather(cache, batch['idx'], names)
        imgs = augment({**pixels, 'flip': batch['flip']}, seed, state.step)
        return apply_train_update(state, imgs, batch['emb'])

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


def make_cached_eval_step(mean, std, use_flow=False):
    """Deterministic eval over the device crop cache: step(state, batch,
    cache) -> metrics on index batches ({'idx', 'emb'})."""
    eval_step = make_eval_step(mean, std, use_flow=use_flow)
    names = ('rgb', 'flow') if use_flow else ('rgb',)

    def step(state, batch, cache):
        return eval_step(state, {**cache_gather(cache, batch['idx'], names),
                                 'emb': batch['emb']})

    return step


def make_aug_eval_step(mean, std, img_dim=128, use_flow=False,
                       use_mask=True, aug_dtype=torch.float32,
                       jitter_order='batch'):
    """Validation WITH the train-time augmentation (reference parity:
    `vpd_dataset/single_frame.py:354`), the student in eval mode:
    step(state, batch, seed, step_idx) -> metrics. `aug_dtype` and
    `jitter_order` must match the train step's."""
    augment = _make_augment(mean, std, img_dim, use_flow, use_mask,
                            aug_dtype, jitter_order)

    def step(state, batch, seed, step_idx):
        return _eval_metrics(state, augment(batch, seed, step_idx),
                             batch['emb'])

    return step


# ------------------------------------------------ optimizer checkpoints

def _params(state):
    return dict(state.model.named_parameters())


def optimizer_to_flax(state):
    """AdamW's state as flax writes optax.adamw's (`to_state_dict`):
    {'0': {'count': int32 (), 'mu': params tree, 'nu': params tree},
    '1': {}, '2': {}}, the moments in flax's layouts."""
    params = _params(state)
    opt = state.optimizer.state
    count = 0
    moments = {'mu': {}, 'nu': {}}
    for name, p in params.items():
        st = opt.get(p)
        if st:
            count = int(st['step'])
        for key, torch_key in (('mu', 'exp_avg'), ('nu', 'exp_avg_sq')):
            moments[key][name] = st[torch_key] if st else torch.zeros_like(p)
    return {'0': {'count': np.array(count, np.int32),
                  **{k: student_params_to_flax(state.model, v)
                     for k, v in moments.items()}},
            '1': {}, '2': {}}


def load_optimizer_from_flax(state, tree):
    """Restore AdamW's moments and step count from `optimizer_to_flax`'s
    layout (as vpd_tpu writes it)."""
    count = int(tree['0']['count'])
    mu, nu = (student_params_from_flax(state.model, tree['0'][k])
              for k in ('mu', 'nu'))
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
