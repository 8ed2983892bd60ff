"""CONTRIQUE distortion tool — frozen ResNet-50 + MLP projector over a grid
of anchor-size patches per frame (counterpart of kvq_tpu/nn/contrique.py;
reference CONTRIQUE_model, KSVQE_model.py:1622-1665).

Per frame: split into (H/a) x (W/a) patches, encode each with the trunk
(a global 1x1 map at 32x32 input), L2-normalise, project 2048 -> 2048 -> 128
with frozen BatchNorms between, in float32 as the JAX package does.
Output: (B, T, G, 128) distortion tokens.  The BN-folding option of the JAX
package (off by default) is not ported.
"""

from __future__ import annotations

import torch.nn.functional as F
from torch import nn

from .resnet import ResNetTrunk


class CONTRIQUE(nn.Module):
    def __init__(self, anchor_size: int = 32, layers=(3, 4, 6, 3),
                 projection_dim: int = 128):
        super().__init__()
        self.anchor_size = anchor_size
        self.projection_dim = projection_dim
        self.encoder = ResNetTrunk(layers)
        self.projector = nn.Sequential(
            nn.Linear(2048, 2048, bias=False),
            nn.BatchNorm1d(2048),
            nn.ReLU(),
            nn.Linear(2048, projection_dim, bias=False),
            nn.BatchNorm1d(projection_dim),
        )

    @staticmethod
    def _bn(bn, z):
        return F.batch_norm(z, bn.running_mean.float(), bn.running_var.float(),
                            bn.weight.float(), bn.bias.float(), False, 0.0,
                            bn.eps)

    def forward(self, x):
        # x: (B, T, H, W, C) channels-last
        B, T, H, W, C = x.shape
        a = self.anchor_size
        gh, gw = H // a, W // a
        g = gh * gw
        dt = self.encoder[0].weight.dtype
        patches = (x.reshape(B, T, gh, a, gw, a, C)
                   .permute(0, 1, 2, 4, 3, 5, 6)
                   .reshape(B * T * g, a, a, C).to(dt))
        last = self.encoder(patches.permute(0, 3, 1, 2))
        h = last.mean(dim=(2, 3)).float()
        h = h / (h.norm(dim=1, keepdim=True) + 1e-12)
        p = self.projector
        z = F.relu(self._bn(p[1], F.linear(h, p[0].weight.float())))
        z = self._bn(p[4], F.linear(z, p[3].weight.float()))
        return z.reshape(B, T, g, self.projection_dim)
