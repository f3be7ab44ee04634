"""flow_encode_ms.infer: device milliseconds RAFT's encoders take over a
chunk (the input, fnet on both frames, then cnet): the kernels launched
inside the program's span `vpd.flow.encode` (`models/raft.RAFT.forward`);
the mean over the traced chunks, read only where each chunk holds all
its iterations (`vpdbench/flow_spans.py`)."""

from vpdbench.flow_spans import chunk_device_ms


def read(r):
    return chunk_device_ms(r, 'vpd.flow.encode')
