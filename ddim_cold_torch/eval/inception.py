"""InceptionV3 feature extractor for FID (counterpart of
``ddim_cold_tpu/eval/inception.py``).

The architecture is torchvision's ``inception_v3`` without the auxiliary
head and the classifier: FID reads the 2048-d pool3 features. Module names
are torchvision's (``Conv2d_1a_3x3``, ``Mixed_5b.branch1x1`` …), so a
torchvision or pytorch-fid ``inception_v3`` state_dict loads with
``strict=True`` once its ``AuxLogits.*`` and ``fc.*`` keys are dropped
(:func:`load_torch_inception`), and the JAX package's Flax tree carries
over through :func:`inception_state_dict_from_flax`.

Images are NCHW here (NHWC in the JAX module). Every ``BasicConv2d`` is a
convolution without bias, BatchNorm over its running statistics (eps 1e-3,
inference only, whatever the module's train flag) and ReLU. The
convolutions are cuDNN's ``F.conv2d``: the JAX package computes them in
XLA, outside any Pallas kernel.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ddim_cold_torch.models.init import trunc_normal_

#: canonical FID input resolution
INCEPTION_SIZE = 299
#: pool3 feature width
FEATURE_DIM = 2048


class BasicConv2d(nn.Module):
    """Conv(bias=False) → BatchNorm(eps=1e-3, running stats) → ReLU."""

    def __init__(self, in_ch: int, out_ch: int, kernel, stride=1, padding=0):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, out_ch, kernel, stride, padding, bias=False)
        self.bn = nn.BatchNorm2d(out_ch, eps=1e-3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bn = self.bn
        x = F.batch_norm(self.conv(x), bn.running_mean, bn.running_var, bn.weight,
                         bn.bias, training=False, eps=bn.eps)
        return F.relu(x)


def _avg_pool_3x3_same(x: torch.Tensor) -> torch.Tensor:
    """avg_pool2d(k=3, s=1, p=1, count_include_pad=True): zero-pad, then
    divide by 9 everywhere, NOT the edge-renormalising mean."""
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=True)


def _max_pool_3x3_s2(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(x, 3, stride=2)


class InceptionA(nn.Module):
    def __init__(self, in_ch: int, pool_features: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(in_ch, 64, 1)
        self.branch5x5_1 = BasicConv2d(in_ch, 48, 1)
        self.branch5x5_2 = BasicConv2d(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = BasicConv2d(in_ch, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, padding=1)
        self.branch_pool = BasicConv2d(in_ch, pool_features, 1)

    def forward(self, x):
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        bp = self.branch_pool(_avg_pool_3x3_same(x))
        return torch.cat([self.branch1x1(x), b5, b3, bp], 1)


class InceptionB(nn.Module):
    def __init__(self, in_ch: int):
        super().__init__()
        self.branch3x3 = BasicConv2d(in_ch, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(in_ch, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, stride=2)

    def forward(self, x):
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), bd, _max_pool_3x3_s2(x)], 1)


class InceptionC(nn.Module):
    def __init__(self, in_ch: int, channels_7x7: int):
        super().__init__()
        c7 = channels_7x7
        self.branch1x1 = BasicConv2d(in_ch, 192, 1)
        self.branch7x7_1 = BasicConv2d(in_ch, c7, 1)
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(in_ch, c7, 1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(in_ch, 192, 1)

    def forward(self, x):
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = self.branch7x7dbl_1(x)
        for conv in (self.branch7x7dbl_2, self.branch7x7dbl_3, self.branch7x7dbl_4,
                     self.branch7x7dbl_5):
            bd = conv(bd)
        bp = self.branch_pool(_avg_pool_3x3_same(x))
        return torch.cat([self.branch1x1(x), b7, bd, bp], 1)


class InceptionD(nn.Module):
    def __init__(self, in_ch: int):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(in_ch, 192, 1)
        self.branch3x3_2 = BasicConv2d(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(in_ch, 192, 1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, 3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = self.branch7x7x3_1(x)
        for conv in (self.branch7x7x3_2, self.branch7x7x3_3, self.branch7x7x3_4):
            b7 = conv(b7)
        return torch.cat([b3, b7, _max_pool_3x3_s2(x)], 1)


class InceptionE(nn.Module):
    def __init__(self, in_ch: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(in_ch, 320, 1)
        self.branch3x3_1 = BasicConv2d(in_ch, 384, 1)
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(in_ch, 448, 1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(in_ch, 192, 1)

    def forward(self, x):
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], 1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], 1)
        bp = self.branch_pool(_avg_pool_3x3_same(x))
        return torch.cat([self.branch1x1(x), b3, bd, bp], 1)


class InceptionV3Features(nn.Module):
    """NCHW [−1, 1] images at 299×299 → (N, 2048) pool3 features."""

    def __init__(self):
        super().__init__()
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, 1)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3)
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280)
        self.Mixed_7c = InceptionE(2048)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = _max_pool_3x3_s2(x)
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
        x = _max_pool_3x3_s2(x)
        for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a", "Mixed_6b",
                     "Mixed_6c", "Mixed_6d", "Mixed_6e", "Mixed_7a", "Mixed_7b",
                     "Mixed_7c"):
            x = getattr(self, name)(x)
        return x.mean(dim=(2, 3))  # global average pool → (N, 2048)


@torch.no_grad()
def init_variables(seed: int = 0):
    """``(model, state_dict)``: a seeded random-init extractor, the port's
    default FID feature space. The draws follow the JAX package's
    ``init_variables`` distribution for distribution: every conv kernel
    from flax's default ``lecun_normal`` (a normal truncated at ±2σ with
    σ² = 1/fan_in) times √2, the He gain for ReLU (without it the 94-conv
    stack collapses the features); BatchNorm scale 1, bias 0, running mean
    0, variance 1. The bits come from ``torch.Generator().manual_seed(seed)``
    and differ from JAX's PRNG: to hold the port to JAX's own extractor,
    carry its variables over with :func:`inception_state_dict_from_flax`.
    Random features are a valid metric space under a fixed seed, not
    comparable with published FID numbers (those need
    :func:`load_torch_inception`)."""
    g = torch.Generator().manual_seed(seed)
    model = InceptionV3Features()
    for mod in model.modules():
        if isinstance(mod, nn.Conv2d):
            fan_in = mod.weight[0].numel()
            # truncated_normal's unit-variance correction (flax variance_scaling)
            std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
            trunc_normal_(mod.weight, g, std=std, a=-2.0 * std, b=2.0 * std)
            mod.weight.mul_(math.sqrt(2.0))
    return model, model.state_dict()


def inception_state_dict_from_flax(variables: dict) -> dict:
    """The JAX package's ``{"params", "batch_stats"}`` tree → this module's
    state_dict (the inverse of JAX's ``flax_from_torch_inception``): conv
    ``kernel`` (kh, kw, I, O) → ``weight`` (O, I, kh, kw); BatchNorm
    ``scale``/``bias`` → ``weight``/``bias``, ``mean``/``var`` →
    ``running_mean``/``running_var``, and ``num_batches_tracked`` 0. Leaves
    may be numpy or JAX arrays; the result is float32 on the CPU."""
    out = {}

    def walk(tree, path):
        for key, value in tree.items():
            if isinstance(value, dict):
                walk(value, path + [key])
                continue
            name = ".".join(path)
            v = torch.tensor(np.asarray(value), dtype=torch.float32)
            if key == "kernel":
                out[f"{name}.weight"] = v.permute(3, 2, 0, 1).contiguous()
            elif key == "scale":
                out[f"{name}.weight"] = v
            elif key == "bias":
                out[f"{name}.bias"] = v
            elif key == "mean":
                out[f"{name}.running_mean"] = v
                out[f"{name}.num_batches_tracked"] = torch.tensor(0)
            elif key == "var":
                out[f"{name}.running_var"] = v
            else:
                raise ValueError(f"unexpected leaf {name}.{key}")

    walk(variables["params"], [])
    walk(variables["batch_stats"], [])
    return out


def load_torch_inception(path: str):
    """A local torchvision / pytorch-fid ``inception_v3`` checkpoint →
    ``(model, state_dict)``; nothing is downloaded. The auxiliary head and
    the classifier (``AuxLogits.*``, ``fc.*``) are dropped, then the rest
    loads with ``strict=True``: a truncated or wrong-architecture file fails
    here, naming its keys, not inside the first FID batch."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    sd = {k: v for k, v in sd.items() if not k.startswith(("AuxLogits.", "fc."))}
    model = InceptionV3Features()
    try:
        model.load_state_dict(sd, strict=True)
    except RuntimeError as err:
        raise ValueError(f"{path}: not a full torchvision/pytorch-fid inception_v3 "
                         f"state_dict: {err}") from None
    return model, model.state_dict()
