"""Faults planted underneath the timed path, to show that `correct` comes
out false when the program computes something else.

Each fault patches the program for the block of `planted(kind, name)`:

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


def _train_unchanged():
    from vpd_tpu_torch.train import vpd

    return vpd, 'optimizer_step', lambda state: None


def _train_half_batch():
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


def _train_altered():
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


def _extract_half_batch():
    import torch

    def change(fn, rgb, flow, i):
        h = rgb.shape[0] // 2
        out = fn(rgb[:h], flow[:h], i)
        rest = out.mean(dim=0, keepdim=True).expand(rgb.shape[0] - h,
                                                    *out.shape[1:])
        return torch.cat([out, rest])

    return _wrap_embed(change)


def _extract_altered():
    def change(fn, rgb, flow, i):
        out = fn(rgb, flow, i).clone()
        out[0] = out[1]
        return out

    return _wrap_embed(change)


FAULTS = {'train': {'unchanged': _train_unchanged,
                    'half_batch': _train_half_batch,
                    'altered': _train_altered},
          'extract': {'half_batch': _extract_half_batch,
                      'altered': _extract_altered}}


@contextlib.contextmanager
def planted(kind, name):
    module, attr, value = FAULTS[kind][name]()
    saved = getattr(module, attr)
    setattr(module, attr, value)
    try:
        yield
    finally:
        setattr(module, attr, saved)
