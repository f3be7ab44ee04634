"""VPD student modules: the encoder plus the optional motion head.

Counterpart of `vpd_tpu/train/vpd.py:27-54` (reference
`train_vpd_model.py:53-65`). The fused augment + train step is not ported
yet (ROADMAP A4); extraction uses the encoder alone.
"""

from torch import nn

from ..models.fc import FCNet


class MotionHead(nn.Module):
    """FCNet(emb -> [128,128] -> 2*emb), float32 under bf16 encoders."""

    def __init__(self, emb_dim):
        super().__init__()
        self.net = FCNet(emb_dim, (128, 128), 2 * emb_dim, dropout=0.)

    def forward(self, x):
        return self.net(x)


class VPDStudent(nn.Module):

    def __init__(self, encoder, motion=None):
        super().__init__()
        self.encoder = encoder
        self.motion = motion

    def forward(self, x):
        emb = self.encoder(x)
        if self.motion is not None:
            emb = self.motion(emb)
        return emb
