"""The lip frontend's stem in one pass: Conv3D, BatchNorm, activation, max-pool.

``visual_stem`` launches the CUDA kernel in ``csrc/visual_stem.cu`` (see its
header for the design and what bounds it on the H100). It replaces no Pallas
kernel: the JAX package leaves this stem to XLA. For a (B, T, H, W) video
and the parameters of ``Conv3dResNet18.frontend3D`` it returns the trunk's
input, (B*T, 64, ceil(H/4), ceil(W/4)), contiguous:

    max_pool3d((1, 3, 3), (1, 2, 2), (0, 1, 1))(act(BN_eval(conv3d(video))))

with the conv (5x7x7, stride 1x2x2, padding 2x3x3) summed in f32, BatchNorm
in eval form (the running statistics) and the activation in f32, and one
rounding to the video's type before the max: rounding is monotonic, so
the max of rounded values is the rounded max. The module chain it replaces
in bf16 rounds after the conv, after BatchNorm and after the activation.

The wrapper runs ``visual_stem_plain`` for CPU tensors only; for CUDA
tensors it launches the kernel or raises (``check_inputs`` names what the
kernel refuses). ``visual_stem.launches`` counts launches.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from tailored_avsr_tpu_torch.ops.backend import check_kernel_input, use_kernel

CHANNELS = 64
KERNEL = (5, 7, 7)
# the lip frontend's activations (models/frontends.py takes them from here; "prelu"
# is the parameter-free leaky ReLU the JAX package maps it to), and the kernel's codes
ACTIVATIONS = {"swish": F.silu, "relu": F.relu, "prelu": F.leaky_relu}
_CODES = {"swish": 0, "relu": 1, "prelu": 2}
MAX_WIDTH = 288  # a block's shared memory holds the input rows and conv rows of frames this wide


def output_shape(video_shape) -> tuple:
    b, t, h, w = video_shape
    return b * t, CHANNELS, -(-h // 4), -(-w // 4)


def visual_stem_plain(video, weight, bn_weight, bn_bias, running_mean, running_var, eps: float,
                      activation: str) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch -> (B*T, 64, H/4, W/4)."""
    x = F.conv3d(video[:, None].float(), weight.float(), None, (1, 2, 2), (2, 3, 3))
    scale = bn_weight.float() * torch.rsqrt(running_var.float() + eps)
    shift = bn_bias.float() - running_mean.float() * scale
    x = ACTIVATIONS[activation](x * scale[:, None, None, None] + shift[:, None, None, None])
    x = F.max_pool3d(x.to(video.dtype).float(), (1, 3, 3), (1, 2, 2), (0, 1, 1)).to(video.dtype)
    return x.transpose(1, 2).reshape(output_shape(video.shape))


def check_inputs(video, weight, bn_weight, bn_bias, running_mean, running_var, activation: str) -> None:
    """Raise on inputs the kernel does not take: a video that is not a
    contiguous (B, T, H, W) bf16 tensor with W at most ``MAX_WIDTH``,
    parameters of another shape, type or layout, or an unknown activation."""
    if video.dim() != 4:
        raise ValueError(f"visual_stem: video must be (B, T, H, W), got {tuple(video.shape)}")
    if video.dtype != torch.bfloat16:
        raise TypeError(f"visual_stem kernel takes bfloat16, got {video.dtype}")
    b, t, h, w = video.shape
    if min(b, t, h, w) < 1 or w > MAX_WIDTH or b * t * CHANNELS >= 2 ** 31:
        raise ValueError(f"visual_stem kernel: unsupported shape {tuple(video.shape)} (W at most {MAX_WIDTH})")
    if activation not in ACTIVATIONS:
        raise ValueError(f"visual_stem: activation must be one of {sorted(ACTIVATIONS)}, got {activation!r}")
    check_kernel_input(video, "video", (b, t, h, w), torch.bfloat16)
    check_kernel_input(weight, "weight", (CHANNELS, 1) + KERNEL, torch.bfloat16)
    for name, p in (("bn_weight", bn_weight), ("bn_bias", bn_bias), ("running_mean", running_mean),
                    ("running_var", running_var)):
        check_kernel_input(p, name, (CHANNELS,), torch.bfloat16)


def _launch(video, weight, bn_weight, bn_bias, running_mean, running_var, eps: float, activation: str,
            out: torch.Tensor) -> None:
    from tailored_avsr_tpu_torch.kernels import build

    b, t, h, w = video.shape
    with torch.cuda.device(video.device):
        err = build.load().avsr_visual_stem(
            video.data_ptr(), weight.data_ptr(), bn_weight.data_ptr(), bn_bias.data_ptr(),
            running_mean.data_ptr(), running_var.data_ptr(), out.data_ptr(), b * t, t, h, w,
            float(eps), _CODES[activation], torch.cuda.current_stream(video.device).cuda_stream,
        )
    if err:
        raise RuntimeError(f"avsr_visual_stem failed: CUDA error {err}")


def visual_stem(video, weight, bn_weight, bn_bias, running_mean, running_var, eps: float,
                activation: str) -> torch.Tensor:
    """(B, T, H, W) video -> (B*T, 64, ceil(H/4), ceil(W/4)): the stem,
    BatchNorm (eval), ``activation`` and the max-pool."""
    tensors = (video, weight, bn_weight, bn_bias, running_mean, running_var)
    if not use_kernel(*tensors):
        return visual_stem_plain(*tensors, eps, activation)
    check_inputs(*tensors, activation)
    out = torch.empty(output_shape(video.shape), dtype=video.dtype, device=video.device)
    _launch(*tensors, eps, activation, out)
    visual_stem.launches += 1
    return out


visual_stem.launches = 0
