"""Visual frontend: Conv3D stem + per-frame ResNet-18 trunk over lip crops
(counterpart of ``tailored_avsr_tpu/models/frontends.py``).

Conv3D 1->64 k=(5,7,7) s=(1,2,2) p=(2,3,3) + BN + activation + MaxPool3d
k=(1,3,3) s=(1,2,2) p=(0,1,1), then BasicBlock x [2,2,2,2] (64->512 channels)
and a global average pool: (B, T, 88, 88) -> (B, T, 512). The stem is the
plain Conv3d; the JAX package's space-to-depth evaluation of it holds the
same weights and exists only for the TPU. A bf16 model in eval mode, with
nothing for autograd to track, runs the stem, its BatchNorm, activation and
max-pool as one hand-written kernel (``ops/visual_stem.py``), which rounds
to bf16 once where the modules round three times; training and f32 models
run the modules.

BatchNorm follows flax's (momentum 0.9 in flax's convention, torch's 0.1;
eps 1e-5): in training it normalises with the batch statistics over every
(B*T, H, W) position, padded frames included, and moves the running
variance with the *biased* batch variance, where torch's ``BatchNorm*d``
would use the unbiased one (``FlaxBatchNorm2d`` / ``FlaxBatchNorm3d``). In
eval mode it uses the running statistics. Inside a data-parallel step
(``parallel/host_data.data_shard``) the batch statistics are the global
batch's, as in a GSPMD step of the JAX package (the single-device step on
the global batch, so its BatchNorm sees the global batch with no
``axis_name``): each rank's sum and count are summed over the data group
(an all-reduce that autograd differentiates) for the mean, then each
rank's sum of squared deviations from it for the (biased) variance. That
is flax's E[x^2] - E[x]^2 taken in two passes: in one, f32 cancels where
a channel's mean is large against its spread, as at the stem's output on
normalised lip crops, where it moved the stem's gradient by 4x the
tolerance the data-parallel tests hold every gradient to.

``bn_axis_name`` is accepted as the JAX frontend accepts it: any value
builds and serves, and a training forward with it set raises the
``NameError`` the JAX train step raises (nothing binds the axis name
there: its data parallelism is GSPMD, ``parallel/mesh.py``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from tailored_avsr_tpu_torch.models import remat
from tailored_avsr_tpu_torch.ops import visual_stem
from tailored_avsr_tpu_torch.ops.backend import tracks_grad
from tailored_avsr_tpu_torch.parallel import host_data
from tailored_avsr_tpu_torch.utils.tracing import span

_BN_EPS = 1e-5
_BN_MOMENTUM = 0.1  # torch's convention: flax's momentum 0.9


class _BiasedRunningVar:
    """Mixin for ``nn.BatchNorm*d``: in training, the running variance moves
    by the biased batch variance, as flax's BatchNorm does."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        self._check_input_dim(x)
        if host_data.current() is not None:
            return self._global_batch_norm(x)
        if remat.recomputing():  # the forward moved the statistics already: move copies
            return F.batch_norm(x, self.running_mean.clone(), self.running_var.clone(), self.weight,
                                self.bias, True, self.momentum, self.eps)
        n = x.numel() // x.shape[1]  # positions per channel
        # torch moves a running variance to (1-m) old + m n/(n-1) var; it gets
        # a copy (autograd keeps it), and the buffer (1-m) old + m var
        moved = self.running_var.clone()
        y = F.batch_norm(x, self.running_mean, moved, self.weight, self.bias, True,
                         self.momentum, self.eps)
        with torch.no_grad():
            self.running_var.copy_(moved * ((n - 1) / n) + self.running_var * ((1.0 - self.momentum) / n))
        return y

    def _global_batch_norm(self, x: torch.Tensor) -> torch.Tensor:
        """Training mode over the data group's global batch (f32 statistics)."""
        c = x.shape[1]
        dims = [d for d in range(x.dim()) if d != 1]
        xf = x.float()
        shape = (1, c) + (1,) * (x.dim() - 2)
        total = host_data.global_sum(torch.cat([
            xf.sum(dims), torch.full((1,), x.numel() // c, dtype=torch.float32, device=x.device)]))
        n = total[-1]
        mean = total[:c] / n
        dev = xf - mean.reshape(shape)
        var = host_data.global_sum((dev * dev).sum(dims)) / n
        y = dev * torch.rsqrt(var.reshape(shape) + self.eps)
        y = y * self.weight.float().reshape(shape) + self.bias.float().reshape(shape)
        if not remat.recomputing():  # the recomputed forward moved them already
            with torch.no_grad():
                self.running_mean.lerp_(mean.detach(), self.momentum)
                self.running_var.lerp_(var.detach(), self.momentum)
        return y.to(x.dtype)


class FlaxBatchNorm1d(_BiasedRunningVar, nn.BatchNorm1d):
    """On (B, C, T): the Conformer conv module's BatchNorm, over every
    (B, T) position, padded frames included, as flax's runs over (B, T, C)."""


class FlaxBatchNorm2d(_BiasedRunningVar, nn.BatchNorm2d):
    pass


class FlaxBatchNorm3d(_BiasedRunningVar, nn.BatchNorm3d):
    pass


def _bn2d(planes: int, **kw) -> nn.BatchNorm2d:
    return FlaxBatchNorm2d(planes, eps=_BN_EPS, momentum=_BN_MOMENTUM, **kw)


class BasicBlock(nn.Module):
    def __init__(self, inplanes: int, planes: int, stride: int = 1, activation_type: str = "swish",
                 *, device=None, dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.act = visual_stem.ACTIVATIONS[activation_type]
        self.conv1 = nn.Conv2d(inplanes, planes, 3, stride, 1, bias=False, **kw)
        self.bn1 = _bn2d(planes, **kw)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, 1, bias=False, **kw)
        self.bn2 = _bn2d(planes, **kw)
        self.downsample = None
        if stride != 1 or inplanes != planes:
            self.downsample = nn.Sequential(
                nn.Conv2d(inplanes, planes, 1, stride, bias=False, **kw),
                _bn2d(planes, **kw),
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
        for stage in (self.layer1, self.layer2, self.layer3, self.layer4):
            x = remat.run(stage, x)
        return x


class Conv3dResNet18(nn.Module):
    def __init__(self, activation_type: str = "swish", bn_axis_name=None, *, device=None, dtype=None):
        super().__init__()
        self.bn_axis_name = bn_axis_name
        kw = {"device": device, "dtype": dtype}
        self.activation_type = activation_type
        self.act = visual_stem.ACTIVATIONS[activation_type]
        self.frontend3D = nn.Sequential(
            nn.Conv3d(1, 64, (5, 7, 7), (1, 2, 2), (2, 3, 3), bias=False, **kw),
            FlaxBatchNorm3d(64, eps=_BN_EPS, momentum=_BN_MOMENTUM, **kw),
        )
        self.trunk = ResNetTrunk(activation_type, **kw)

    def output_size(self) -> int:
        return 512

    def _fused_stem(self, video: torch.Tensor) -> bool:
        """Whether the stem runs as ``ops/visual_stem.py`` (on the card its
        bf16 kernel, which raises on inputs it does not take): a bf16 model
        in eval mode with nothing for autograd to track. Training (batch
        statistics, gradients) and f32 models keep the modules."""
        conv, bn = self.frontend3D
        return (not self.training and conv.weight.dtype == torch.bfloat16
                and not tracks_grad(video, conv.weight, bn.weight, bn.bias))

    def forward(self, video: torch.Tensor, lengths: torch.Tensor):
        """(B, T, H, W) grayscale -> (B, T, 512), lengths unchanged."""
        if self.training and self.bn_axis_name is not None:
            raise NameError(f"Found an unbound axis name: {self.bn_axis_name}. The BatchNorm's statistics are "
                            "the global batch's under data parallelism without an axis name; drop "
                            "bn_axis_name to train (the JAX train step raises the same)")
        b, t = video.shape[:2]
        with span("encode.visual_stem", annotate=False):
            if self._fused_stem(video):
                conv, bn = self.frontend3D
                x = visual_stem.visual_stem(video, conv.weight, bn.weight, bn.bias, bn.running_mean,
                                            bn.running_var, bn.eps, self.activation_type)
            else:
                x = self.act(self.frontend3D(video[:, None]))  # (B, 64, T, H', W')
                # max pool over H, W only; the padding reads -inf, as flax's max_pool
                x = F.max_pool3d(x, (1, 3, 3), (1, 2, 2), (0, 1, 1))
                x = x.transpose(1, 2).reshape(b * t, x.shape[1], x.shape[3], x.shape[4])
        x = self.trunk(x).mean(dim=(2, 3))  # global average pool -> (B*T, 512)
        return x.reshape(b, t, 512), lengths
