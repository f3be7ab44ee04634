"""input_ms.train: device milliseconds a train step spends in its input
stage, the program's span `vpd.train.input` (the cache gather and the
augmentation, `train/vpd.py`), between CUDA events on the step's stream;
the mean over the steps of the traced epochs."""

from vpdbench.spans import mean_device_ms, train_spans


def read(r):
    return mean_device_ms(train_spans(r, 'vpd.train.input'))
