"""Visual frontend: Conv3D stem + per-frame ResNet-18 trunk over lip crops
(counterpart of ``tailored_avsr_tpu/models/frontends.py``).

Conv3D 1->64 k=(5,7,7) s=(1,2,2) p=(2,3,3) + BN + activation + MaxPool3d
k=(1,3,3) s=(1,2,2) p=(0,1,1), then BasicBlock x [2,2,2,2] (64->512 channels)
and a global average pool: (B, T, 88, 88) -> (B, T, 512). BatchNorm runs in
eval mode (running statistics). The stem is the plain Conv3d; the JAX
package's space-to-depth evaluation of it holds the same weights and exists
only for the TPU.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

_BN_EPS = 1e-5

# the JAX package maps "prelu" to a parameter-free leaky ReLU
_ACTIVATIONS = {"relu": F.relu, "swish": F.silu, "prelu": F.leaky_relu}


class BasicBlock(nn.Module):
    def __init__(self, inplanes: int, planes: int, stride: int = 1, activation_type: str = "swish",
                 *, device=None, dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.act = _ACTIVATIONS[activation_type]
        self.conv1 = nn.Conv2d(inplanes, planes, 3, stride, 1, bias=False, **kw)
        self.bn1 = nn.BatchNorm2d(planes, eps=_BN_EPS, **kw)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, 1, bias=False, **kw)
        self.bn2 = nn.BatchNorm2d(planes, eps=_BN_EPS, **kw)
        self.downsample = None
        if stride != 1 or inplanes != planes:
            self.downsample = nn.Sequential(
                nn.Conv2d(inplanes, planes, 1, stride, bias=False, **kw),
                nn.BatchNorm2d(planes, eps=_BN_EPS, **kw),
            )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.act(self.bn1(self.conv1(x)))
        h = self.bn2(self.conv2(h))
        residual = x if self.downsample is None else self.downsample(x)
        return self.act(h + residual)


class ResNetTrunk(nn.Module):
    """Four stages of two BasicBlocks (``layer1`` .. ``layer4``)."""

    def __init__(self, activation_type: str = "swish", *, device=None, dtype=None):
        super().__init__()
        inplanes = 64
        for si, planes in enumerate((64, 128, 256, 512)):
            blocks = []
            for bi in range(2):
                stride = 2 if (si > 0 and bi == 0) else 1
                blocks.append(BasicBlock(inplanes, planes, stride, activation_type,
                                         device=device, dtype=dtype))
                inplanes = planes
            setattr(self, f"layer{si + 1}", nn.Sequential(*blocks))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.layer4(self.layer3(self.layer2(self.layer1(x))))


class Conv3dResNet18(nn.Module):
    def __init__(self, activation_type: str = "swish", *, device=None, dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.act = _ACTIVATIONS[activation_type]
        self.frontend3D = nn.Sequential(
            nn.Conv3d(1, 64, (5, 7, 7), (1, 2, 2), (2, 3, 3), bias=False, **kw),
            nn.BatchNorm3d(64, eps=_BN_EPS, **kw),
        )
        self.trunk = ResNetTrunk(activation_type, **kw)

    def output_size(self) -> int:
        return 512

    def forward(self, video: torch.Tensor, lengths: torch.Tensor):
        """(B, T, H, W) grayscale -> (B, T, 512), lengths unchanged."""
        b, t = video.shape[:2]
        x = self.act(self.frontend3D(video[:, None]))  # (B, 64, T, H', W')
        # max pool over H, W only; the padding reads -inf, as flax's max_pool
        x = F.max_pool3d(x, (1, 3, 3), (1, 2, 2), (0, 1, 1))
        x = x.transpose(1, 2).reshape(b * t, x.shape[1], x.shape[3], x.shape[4])
        x = self.trunk(x).mean(dim=(2, 3))  # global average pool -> (B*T, 512)
        return x.reshape(b, t, 512), lengths
