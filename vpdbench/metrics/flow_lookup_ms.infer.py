"""flow_lookup_ms.infer: device milliseconds a chunk spends in RAFT's
correlation lookups: the kernels launched inside its `iters` spans
`vpd.flow.lookup` (`models/raft.RAFT.forward`); the mean over the traced
chunks, read only where each chunk holds all its iterations
(`vpdbench/flow_spans.py`)."""

from vpdbench.flow_spans import chunk_device_ms


def read(r):
    return chunk_device_ms(r, 'vpd.flow.lookup')
