"""fwd_bwd_ms.train: device milliseconds a train step spends in the
student's forward and backward, the program's span `vpd.train.fwd_bwd`
(`train/vpd.forward_backward`), between CUDA events on the step's stream;
the mean over the steps of the traced epochs."""

from vpdbench.spans import mean_device_ms, train_spans


def read(r):
    return mean_device_ms(train_spans(r, 'vpd.train.fwd_bwd'))
