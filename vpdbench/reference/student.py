"""The VPD student in plain float32: an encoder (by the configuration's
`reference`, a module of this package), the motion head, the loss and
AdamW; its train steps, and its embeddings in eval mode.

From the VPD reference (github.com/jhong93/vpd, `train_vpd_model.py:
53-112`, `models/module.py` FCNet): the motion head maps the embedding
through dense layers of 128 and 128 with ReLU to twice its width; the
loss is the sum of squared differences from the teacher's target over
the batch, unnormalised; AdamW (betas 0.9 and 0.999, epsilon 1e-8,
decoupled weight decay) updates every parameter, BatchNorm's included.
"""

import importlib

import torch
import torch.nn.functional as F

from . import augment as aug
from .arith import tf32_off
from .preprocess import orig_and_flip

MOTION = 'motion.net.layers.{}.'


def encoder_module(config):
    return importlib.import_module(__package__ + '.' + config['reference'])


def shapes(config):
    """({name: shape} of the student's parameters, {name: shape} of its
    BatchNorm statistics)."""
    params, stats = encoder_module(config).shapes(config)
    if config['motion']:
        dims = [config['emb_dim'], *config['motion_hidden'],
                2 * config['emb_dim']]
        for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
            params[MOTION.format(i) + 'weight'] = (b, a)
            params[MOTION.format(i) + 'bias'] = (b,)
    return params, stats


def forward(p, stats, x, arith, train, config, drops=None, remat=False):
    """(N, C, H, W) -> the student's output: the embedding, through the
    motion head when the configuration has one."""
    y = encoder_module(config).forward(p, stats, x, arith, train, config,
                                       drops=drops, remat=remat)
    if config['motion']:
        n = len(config['motion_hidden']) + 1
        for i in range(n):
            if i:
                y = F.relu(y)
            y = arith.linear(y, p[MOTION.format(i) + 'weight'],
                             p[MOTION.format(i) + 'bias'])
    return y


def adamw(params, grads, moments, t, opt):
    """One AdamW step (step t counts from 1) on {name: tensor} in place."""
    b1, b2 = opt['betas']
    lr, wd, eps = opt['lr'], opt['weight_decay'], opt['eps']
    for name, p in params.items():
        g = grads[name]
        m, v = moments.setdefault(name, (torch.zeros_like(p),
                                         torch.zeros_like(p)))
        m.mul_(b1).add_(g, alpha=1 - b1)
        v.mul_(b2).addcmul_(g, g, value=1 - b2)
        p.mul_(1 - lr * wd)
        denom = (v / (1 - b2 ** t)).sqrt() + eps
        p.addcdiv_(m, denom, value=-lr / (1 - b1 ** t))


def train_steps(config, weights, stats, feed, rows, arith,
                first_input=None):
    """The student's first train steps from `weights` ({name: float32}),
    one a record of `feed`: {'idx', 'emb', 'flip', 'seed', 'step'}, the
    rows' pixels from rows(idx) -> (rgb, flow, mask) uint8. Returns
    {'losses': [float], 'preds': [the student's outputs a step], 'grad1':
    {name: the first step's gradient}, 'params': {name: after the last
    step}, 'inputs': the first step's augmented (N, C, H, W) input}, and
    with `first_input` (an (N, C, H, W) input another augmentation made
    for the first step) 'first_input_preds': the first step's forward
    over it, from the same weights and dropout draws."""
    params = {k: v.detach().clone().float() for k, v in weights.items()}
    moments, losses, preds, grad1, inputs = {}, [], [], None, None
    first_input_preds = None
    mean, std = config['rgb_mean_std']
    enc = encoder_module(config)
    with tf32_off():
        for t, rec in enumerate(feed, start=1):
            rgb, flow, mask = rows(rec['idx'])
            b, h, w = rgb.shape[:3]
            d = aug.draw(rec['seed'], rec['step'], b, h, w, rgb.device,
                         getattr(torch, config['compute_dtype']))
            drops = aug.dropout_masks(rec['seed'], rec['step'],
                                      enc.dropout_shapes(config, b),
                                      rgb.device)
            with torch.no_grad():
                x = aug.augment(rgb, flow, mask, rec['flip'], d, mean, std,
                                config['img_dim']).permute(0, 3, 1, 2)
                if inputs is None and first_input is not None:
                    first_input_preds = forward(
                        params, stats, first_input.float(), arith, True,
                        config, drops).detach()
            if inputs is None:
                inputs = x
            leaves = {k: v.requires_grad_() for k, v in params.items()}
            out = forward(leaves, stats, x, arith, True, config, drops,
                          remat=True)
            loss = torch.sum((out - rec['emb'].float()) ** 2)
            grads = dict(zip(leaves, torch.autograd.grad(
                loss, list(leaves.values()))))
            losses.append(float(loss.detach()))
            preds.append(out.detach())
            if grad1 is None:
                grad1 = grads
            with torch.no_grad():
                params = {k: v.detach() for k, v in leaves.items()}
                adamw(params, grads, moments, t, config['optimizer'])
            del out, loss, d, drops
    return {'losses': losses, 'preds': preds, 'grad1': grad1,
            'params': params, 'inputs': inputs,
            'first_input_preds': first_input_preds}


@torch.no_grad()
def embed_orig_and_flip(config, weights, stats, rgb, flow, arith,
                        rows_per_block=512):
    """Eval-mode encoder embeddings of the originals and flipped variants:
    (B, 2, emb_dim) float32, computed in blocks of crops."""
    mean, std = config['rgb_mean_std']
    enc = encoder_module(config)
    out = []
    with tf32_off():
        for lo in range(0, rgb.shape[0], rows_per_block):
            hi = min(lo + rows_per_block, rgb.shape[0])
            x = orig_and_flip(rgb[lo:hi], flow[lo:hi], mean, std)
            e = enc.forward(weights, stats, x, arith, False, config)
            out.append(e.view(2, hi - lo, -1).transpose(0, 1))
    return torch.cat(out)
