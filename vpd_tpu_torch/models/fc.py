"""Fully-connected models: `FCNet`, the MLP behind the student's motion head.

Counterpart of `vpd_tpu/models/fc.py:22-49` (reference
`models/module.py:133-153`). The FCResNet teacher and the pose decoders
are not ported yet (ROADMAP A8).
"""

from torch import nn


class FCNet(nn.Module):
    """MLP: in -> hidden[0] -> ... -> out with ReLU between layers.

    Dropout sits between hidden layers only (reference models/module.py:152).
    `layers` are the Linear layers in order (flax's Dense_0, Dense_1, ...).
    """

    def __init__(self, input_dim, hidden_dims, output_dim, dropout=0.3):
        super().__init__()
        dims = [input_dim, *hidden_dims, output_dim]
        self.layers = nn.ModuleList(
            nn.Linear(a, b) for a, b in zip(dims[:-1], dims[1:]))
        self.dropout = nn.Dropout(dropout)
        for layer in self.layers:  # flax Dense init: lecun normal, zero bias
            nn.init.normal_(layer.weight, std=layer.in_features ** -0.5)
            nn.init.zeros_(layer.bias)

    def forward(self, x):
        x = self.layers[0](x)
        last = len(self.layers) - 1
        for k in range(1, last + 1):
            x = self.layers[k](x.relu())
            if k < last:
                x = self.dropout(x)
        return x
