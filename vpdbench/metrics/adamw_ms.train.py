"""adamw_ms.train: device milliseconds a train step spends in the fused
AdamW update, the program's span `vpd.train.adamw`
(`train/vpd.optimizer_step`), between CUDA events on the step's stream;
the mean over the steps of the traced epochs."""

from vpdbench.spans import mean_device_ms, train_spans


def read(r):
    return mean_device_ms(train_spans(r, 'vpd.train.adamw'))
