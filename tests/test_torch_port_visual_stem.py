"""The fused visual stem (``tailored_avsr_tpu_torch/ops/visual_stem.py``) on
the CPU: its plain version against the module chain it replaces (conv,
eval BatchNorm, activation, max-pool, the trunk's layout) in f32; the
kernel's tiling (``csrc/visual_stem.cu``: tap slabs, input rows a step,
the ring of rows pooled across columns) replayed in plain PyTorch; the
route ``Conv3dResNet18`` takes, with the launcher mocked on CPU tensors;
the inputs the kernel refuses; and the ``encode.visual_stem`` span."""

import math

import pytest
import torch
import torch.nn.functional as F

from tailored_avsr_tpu_torch.models.frontends import Conv3dResNet18
from tailored_avsr_tpu_torch.ops import visual_stem as vs
from tailored_avsr_tpu_torch.utils import tracing


def _frontend(activation="swish", dtype=torch.float32, seed=0):
    torch.manual_seed(seed)
    m = Conv3dResNet18(activation).eval()
    bn = m.frontend3D[1]
    with torch.no_grad():  # running statistics away from their initial 0 and 1
        bn.running_mean.normal_(0.0, 0.5)
        bn.running_var.uniform_(0.2, 3.0)
        bn.weight.normal_(1.0, 0.3)
        bn.bias.normal_(0.0, 0.3)
    return m.to(dtype)


def _stem_args(m):
    conv, bn = m.frontend3D
    return conv.weight, bn.weight, bn.bias, bn.running_mean, bn.running_var, bn.eps


def _module_chain(m, video):
    """Today's modules: conv -> eval BatchNorm -> activation -> max-pool -> the trunk's layout."""
    b, t = video.shape[:2]
    x = F.max_pool3d(m.act(m.frontend3D(video[:, None])), (1, 3, 3), (1, 2, 2), (0, 1, 1))
    return x.transpose(1, 2).reshape(b * t, x.shape[1], x.shape[3], x.shape[4])


@pytest.mark.parametrize("hw", [(88, 88), (13, 11)], ids=["88x88", "13x11"])
@pytest.mark.parametrize("t", [1, 3, 7])
@pytest.mark.parametrize("activation", ["swish", "relu", "prelu"])
def test_plain_version_equals_the_module_chain_in_f32(activation, t, hw):
    m = _frontend(activation)
    video = torch.randn(2, t, *hw, generator=torch.Generator().manual_seed(t))
    with torch.no_grad():
        want = _module_chain(m, video)
        got = vs.visual_stem_plain(video, *_stem_args(m), activation)
    assert got.shape == want.shape == vs.output_shape(video.shape) and got.is_contiguous()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def _replay(video, weight, bn_weight, bn_bias, mean, var, eps, activation):
    """The kernel's arithmetic in its own order of tiles: weights as 18 slabs
    of two (kt, ky) tap rows of 8 kx taps (kx = -1 weighted 0), a step's 13
    input rows of 5 frames with column c at c + 8, A rows read as the four
    words from word x + 2, 4 conv rows a step, each max-pooled across columns
    (2q - 1, 2q, 2q + 1) into a ring of 5 rows, then down the rows for the
    two pooled rows a step completes."""
    b, t_len, h, w = video.shape
    h2, w2 = (h + 1) // 2, (w + 1) // 2
    h4, w4 = (h2 + 1) // 2, (w2 + 1) // 2
    n_xg = -(-w2 // 48)
    iw, nq, steps = 96 * n_xg + 16, 24 * n_xg, -(-h2 // 4)
    flat = weight.float().reshape(64, 245)
    wsm = torch.zeros(64, 288)
    for k in range(288):
        q, kx = 2 * (k >> 4) + ((k >> 3) & 1), (k & 7) - 1
        if kx >= 0 and q < 35:
            wsm[:, k] = flat[:, q * 7 + kx]
    scale = bn_weight.float() / torch.sqrt(var.float() + eps)
    shift = bn_bias.float() - mean.float() * scale
    act = {"swish": F.silu, "relu": F.relu, "prelu": F.leaky_relu}[activation]
    frames = video.reshape(b * t_len, h, w).float()
    out = torch.empty(vs.output_shape(video.shape))
    cols = torch.arange(iw) - 8
    for f in range(b * t_len):
        t = f % t_len
        ring = torch.full((5, 64, nq), float("nan"))  # a read of a slot nobody wrote shows
        for step in range(steps):
            y0 = 4 * step
            buf = torch.zeros(5, 13, iw)
            for kt in range(5):
                tt = t + kt - 2
                for r in range(13):
                    iy = 2 * y0 - 3 + r
                    if 0 <= tt < t_len and 0 <= iy < h:
                        ok = (cols >= 0) & (cols < w)
                        buf[kt, r, ok] = frames[f - t + tt, iy, cols[ok]]
            for warp in range(4):
                y = y0 + warp
                if y >= h2:
                    continue
                conv = torch.empty(64, 48 * n_xg)
                for xg in range(n_xg):
                    x = 48 * xg + torch.arange(48)
                    a = torch.empty(48, 288)
                    for s in range(18):
                        for half, q in enumerate((2 * s, 2 * s + 1 if 2 * s + 1 < 35 else 2 * s)):
                            row = buf[q // 7, 2 * warp + q % 7]
                            for j in range(4):  # word x + 2 + j: elements 2(x + 2 + j) and + 1
                                a[:, 16 * s + 8 * half + 2 * j] = row[2 * (x + 2 + j)]
                                a[:, 16 * s + 8 * half + 2 * j + 1] = row[2 * (x + 2 + j) + 1]
                    conv[:, x] = (act((a @ wsm.T) * scale + shift).to(video.dtype).float()).T
                conv[:, w2:] = -math.inf  # past the conv's last column: the pool's padding
                padded = torch.cat([torch.full((64, 1), -math.inf), conv], 1)  # column -1
                ring[y % 5] = torch.stack([padded[:, 2 * q:2 * q + 3].amax(1) for q in range(nq)], 1)
            for j in range(2):
                p = 2 * step + j
                if p >= h4:
                    continue
                rows = [ring[yy % 5, :, :w4] for yy in (2 * p - 1, 2 * p, 2 * p + 1) if 0 <= yy < h2]
                out[f, :, p] = torch.stack(rows).amax(0)
    return out.to(video.dtype)


@pytest.mark.parametrize("shape", [(1, 3, 20, 17), (1, 2, 9, 100), (2, 1, 5, 8)],
                         ids=["odd", "two_column_units", "tiny"])
def test_the_kernels_tiling_replayed_equals_the_plain_version(shape):
    m = _frontend("swish", torch.bfloat16, seed=1)
    video = torch.randn(*shape, generator=torch.Generator().manual_seed(2)).to(torch.bfloat16)
    args = _stem_args(m)
    with torch.no_grad():
        want = vs.visual_stem_plain(video, *args, "swish")
        got = _replay(video, *args, "swish")
    assert not torch.isnan(got.float()).any()
    # both sum in f32 in other orders, then round once to bf16: one ulp apart at most
    torch.testing.assert_close(got.float(), want.float(), rtol=2 ** -7, atol=1e-5)


@pytest.fixture
def mocked_launcher(monkeypatch):
    """CUDA's route on CPU tensors: ``use_kernel`` says launch, and the
    launcher writes the plain version into the output."""
    def launch(video, weight, bn_weight, bn_bias, mean, var, eps, activation, out):
        out.copy_(vs.visual_stem_plain(video, weight, bn_weight, bn_bias, mean, var, eps, activation))

    monkeypatch.setattr(vs, "use_kernel", lambda *tensors: True)
    monkeypatch.setattr(vs, "_launch", launch)


def _video(dtype, t=3):
    return torch.randn(2, t, 16, 16, generator=torch.Generator().manual_seed(4)).to(dtype)


def test_a_bf16_model_in_eval_under_inference_mode_takes_the_kernel(mocked_launcher):
    m = _frontend("relu", torch.bfloat16)
    video, lengths = _video(torch.bfloat16), torch.tensor([3, 2])
    before = vs.visual_stem.launches
    with torch.inference_mode():
        out, _ = m(video, lengths)
        m(video, lengths)
    assert vs.visual_stem.launches == before + 2 and out.shape == (2, 3, 512)
    with torch.no_grad():  # the trunk sees what the modules' route would give, rounded once
        got = vs.visual_stem(video, *_stem_args(m), "relu")
        chain = _module_chain(m.float(), video.float())
    torch.testing.assert_close(got.float(), chain, rtol=2 ** -7, atol=1e-2)


@pytest.mark.parametrize("case", ["training", "float32", "grad"])
def test_training_f32_and_tracked_inputs_keep_the_modules(case, mocked_launcher):
    m = _frontend("swish", torch.float32 if case == "float32" else torch.bfloat16)
    video = _video(torch.float32 if case == "float32" else torch.bfloat16)
    if case == "training":
        m.train()
    before = vs.visual_stem.launches
    if case == "grad":
        video.requires_grad_(True)
        m(video, torch.tensor([3, 3]))[0].float().sum().backward()
        assert video.grad is not None
    else:
        with torch.inference_mode(case != "training"):
            m(video, torch.tensor([3, 3]))
    assert vs.visual_stem.launches == before


@pytest.mark.parametrize("fault", ["float32", "too_wide", "weight_layout", "activation"])
def test_the_kernel_refuses_what_it_does_not_take(fault):
    m = _frontend("swish", torch.bfloat16)
    weight, bn_w, bn_b, mean, var, _ = _stem_args(m)
    video, activation = _video(torch.bfloat16), "swish"
    if fault == "float32":
        video = video.float()
    elif fault == "too_wide":
        video = torch.zeros(1, 1, 8, vs.MAX_WIDTH + 1, dtype=torch.bfloat16)
    elif fault == "weight_layout":
        weight = weight.transpose(3, 4)
    else:
        activation = "gelu"
    with pytest.raises((TypeError, ValueError)):
        vs.check_inputs(video, weight, bn_w, bn_b, mean, var, activation)


def test_a_width_the_kernel_does_not_take_raises_on_the_kernel_route(mocked_launcher):
    m = _frontend("swish", torch.bfloat16)
    before = vs.visual_stem.launches
    with torch.inference_mode(), pytest.raises(ValueError, match="W at most"):
        m(torch.zeros(1, 1, 4, vs.MAX_WIDTH + 2, dtype=torch.bfloat16), torch.tensor([1]))
    assert vs.visual_stem.launches == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_the_stem_span_opens_once_a_frontend_call_inside_the_visual_frontend(dtype):
    m = _frontend("swish", dtype)
    video, lengths = _video(dtype), torch.tensor([3, 3])
    seen = {r["id"] for r in tracing.records()}
    tracing.enable()
    try:
        with torch.inference_mode(), tracing.call("s2t.greedy"), tracing.span("encode.visual_frontend"):
            m(video, lengths)
            m(video, lengths)
    finally:
        tracing.disable()
    records = [r for r in tracing.records() if r["id"] not in seen]
    assert len(records) == 1 and tracing.count(records, "encode.visual_stem") == 2
    spans = records[0]["spans"]
    assert [spans[p][0] for name, p, *_ in spans if name == "encode.visual_stem"] == ["encode.visual_frontend"] * 2


def test_the_stem_span_leaves_the_device_annotation_to_a_range_around_the_frontend():
    """The profiler annotates the device only for user ranges, and gives each
    kernel to the innermost: the stem's range is a host-only one, so that a
    range a reader puts around the whole frontend keeps the stem's kernels."""
    m = _frontend("swish", torch.bfloat16)
    video, lengths = _video(torch.bfloat16), torch.tensor([3, 3])
    tracing.enable(prefix="bench/")
    try:
        with torch.inference_mode(), torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            with torch.autograd.profiler.record_function("bench/visual_frontend"):
                m(video, lengths)
    finally:
        tracing.disable()
    scopes = {e.name: e.scope for e in prof.events() if e.name.startswith("bench/")}
    user, function = int(torch._C._profiler.RecordScope.USER_SCOPE), int(torch._C._profiler.RecordScope.FUNCTION)
    assert scopes == {"bench/visual_frontend": user, "bench/encode.visual_stem": function}
