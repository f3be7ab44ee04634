"""Faults planted underneath the timed path, to show that `correct` comes
out false when the program computes something else.

A driver module names the faults its cells can have in `FAULTS`, {name:
a function giving (module, attribute, patched value)}; `planted(driver,
name)` patches the program for its block. The student drivers' faults:

* train `unchanged`: the optimizer step does nothing, so the step
  returns its state unchanged;
* train `half_batch`: the step's forward runs over the whole batch, but
  its loss (and so its gradients) over the first half alone, scaled to
  the batch (the mean of the rest);
* train `altered`: the augmentation gives one image of each batch in
  another's place;
* extract `half_batch`: the embed computes the first half of a chunk and
  fills the rest with their mean;
* extract `altered`: one answer of each chunk is replaced by another's.
"""

import contextlib
import importlib


def train_unchanged():
    from vpd_tpu_torch.train import vpd

    return vpd, 'optimizer_step', lambda state: None


def train_half_batch():
    import torch

    from vpd_tpu_torch.train import vpd

    def update(state, imgs, emb, dropout_draw=None):
        model = state.model.train()
        vpd.set_dropout_draw(model, dropout_draw)
        try:
            out = model(imgs.permute(0, 3, 1, 2))
        finally:
            vpd.set_dropout_draw(model, None)
        h = emb.shape[0] // 2
        loss = torch.sum(torch.square(out[:h] - emb[:h])) * (
            emb.shape[0] / h)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        vpd.optimizer_step(state)
        return {'emb_loss_sum': loss.detach(), 'n': float(emb.shape[0])}

    return vpd, 'apply_train_update', update


def train_altered():
    from vpd_tpu_torch.train import vpd

    make = vpd._make_augment

    def wrapped(*args, **kwargs):
        augment = make(*args, **kwargs)

        def altered(*a, **k):
            imgs = augment(*a, **k).clone()
            imgs[0] = imgs[1]
            return imgs

        return altered

    return vpd, '_make_augment', wrapped


def _wrap_embed(change):
    from vpd_tpu_torch.infer import apply_vpd

    make = apply_vpd._make_kernel_embed

    def wrapped(*args, **kwargs):
        fn = make(*args, **kwargs)
        return lambda rgb, flow, chunk_i=0, jitter_draws=None: change(
            fn, rgb, flow, chunk_i)

    return apply_vpd, '_make_kernel_embed', wrapped


def extract_half_batch():
    import torch

    def change(fn, rgb, flow, i):
        h = rgb.shape[0] // 2
        out = fn(rgb[:h], flow[:h], i)
        rest = out.mean(dim=0, keepdim=True).expand(rgb.shape[0] - h,
                                                    *out.shape[1:])
        return torch.cat([out, rest])

    return _wrap_embed(change)


def extract_altered():
    def change(fn, rgb, flow, i):
        out = fn(rgb, flow, i).clone()
        out[0] = out[1]
        return out

    return _wrap_embed(change)


@contextlib.contextmanager
def planted(driver, name):
    module, attr, value = importlib.import_module(
        'vpdbench.drivers.' + driver).FAULTS[name]()
    saved = getattr(module, attr)
    setattr(module, attr, value)
    try:
        yield
    finally:
        setattr(module, attr, saved)
