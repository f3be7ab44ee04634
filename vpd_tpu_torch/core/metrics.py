"""Single-readback metric fetching.

Counterpart of `vpd_tpu/core/metrics.py`. A step returns its metrics as
device tensors; reading each with `float()` would wait for the device at
every step. `fetch_metrics` packs every tensor of an epoch's metrics into
one float32 vector on the device and copies that to the host once.
"""

import torch


def fetch_metrics(metrics):
    """List of {name: tensor or number} -> the same list with each 0-d
    tensor and number as a float and each other tensor as a float32 numpy
    array of its shape, with one device-to-host copy."""
    tensors = [v for m in metrics for v in m.values() if torch.is_tensor(v)]
    flat = (torch.cat([t.detach().float().reshape(-1) for t in tensors])
            .cpu().numpy() if tensors else None)
    offset = 0
    out = []
    for m in metrics:
        row = {}
        for k, v in m.items():
            if not torch.is_tensor(v):
                row[k] = float(v)
                continue
            chunk = flat[offset:offset + v.numel()]
            offset += v.numel()
            row[k] = (float(chunk[0]) if v.dim() == 0
                      else chunk.reshape(tuple(v.shape)).copy())
        out.append(row)
    return out
