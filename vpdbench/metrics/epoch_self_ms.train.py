"""epoch_self_ms.train: device milliseconds of an epoch outside its
steps. Each traced epoch's span `vpd.train.epoch` (`train/vpd_loop.
VPDTrainer.train_one_epoch`, between CUDA events on the stream) less the
device ms of its steps' `vpd.train.input`, `fwd_bwd` and `adamw` spans:
the card's wait for the epoch's first batch, the batches' uploads, the
readback and the epilogue. The mean over the traced epochs."""

from vpdbench.spans import STEP, train_epochs


def read(r):
    epochs = train_epochs(r)
    if epochs is None:
        return None
    selves = []
    for epoch, inside in epochs:
        steps = [c for c in inside if c['name'] in STEP]
        times = [epoch['device_ms']] + [c['device_ms'] for c in steps]
        if not steps or any(t is None for t in times):
            return None
        selves.append(times[0] - sum(times[1:]))
    return sum(selves) / len(selves)
