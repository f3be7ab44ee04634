"""Single-readback metric fetching.

Counterpart of `vpd_tpu/core/metrics.py`. A step returns its metrics as
device tensors; reading each with `float()` would wait for the device at
every step. `fetch_metrics` packs every tensor of an epoch's metrics into
one float32 vector on the device and copies that to the host once.
"""

import torch


def fetch_metrics(metrics):
    """List of {name: 0-d tensor or number} -> the same list of {name:
    float}, with one device-to-host copy."""
    tensors = [v for m in metrics for v in m.values() if torch.is_tensor(v)]
    values = (iter(torch.stack([t.detach().float().reshape(())
                                for t in tensors]).cpu().tolist())
              if tensors else iter(()))
    return [{k: next(values) if torch.is_tensor(v) else float(v)
             for k, v in m.items()} for m in metrics]
