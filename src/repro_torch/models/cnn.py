"""The paper's evaluation architectures: LeNet-5, VGG-7/11/16, DenseNet-76
(mirrors ``repro/models/cnn.py``).

They carry the paper's own experiments (Table 1, Figures 3–4) on synthetic
MNIST/CIFAR-like data.  Conv kernels are rank 4 and fc kernels rank 2, so
the default SYMOG filter quantizes both; BN scale and bias stay float.

Layouts keep the JAX package's: params are HWIO conv kernels and (in, out)
fc kernels, so a bridged JAX tree is used as is and SYMOG's Δ search sees
the same leaves; images come in NHWC.  Internally activations are NCHW
(``torch.nn.functional.conv2d``, cuDNN on the card; JAX computes the
convolutions with ``lax.conv`` outside any Pallas kernel).  Where the two
layouts would change a number, this module does what JAX does:
  * the flatten before the first fc reads NHWC order (permute, then
    reshape), so fc1's rows line up with JAX's;
  * BN in train mode uses the population variance and updates running stats
    with momentum 0.9, eps 1e-5; eval mode reads the running stats;
  * max pooling is 2x2, stride 2, VALID (floor); LeNet pads 28 → 32, then
    runs VALID convs; DenseNet concatenates on the channel axis, and its
    transitions max-pool, as JAX's do.

BatchNorm keeps its running stats in a separate ``bn_state`` tree (params
stay a pure weight tree for SYMOG and the optimizers).  The convolutions
run in full fp32 on the card (``fp32_convs``), as JAX's reference computes
them.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class CNNConfig:
    name: str
    arch: str  # 'lenet5' | 'vgg7' | 'vgg11' | 'vgg16' | 'densenet'
    in_channels: int = 3
    n_classes: int = 10
    input_hw: int = 32
    width_mult: float = 1.0  # reduced-scale knob for CPU tests
    densenet_depth: int = 76
    densenet_growth: int = 12


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------
def _normal(gen, shape, std, dtype):
    return (torch.randn(shape, generator=gen, device=gen.device) * std).to(dtype)


def _conv_init(gen, kh, kw, cin, cout, dtype=torch.float32):
    return {"kernel": _normal(gen, (kh, kw, cin, cout), math.sqrt(2.0 / (kh * kw * cin)), dtype)}


@contextlib.contextmanager
def fp32_convs():
    """cuDNN's fp32 convolutions in full fp32 while the block runs.  PyTorch
    lets cuDNN run them in TF32 by default (about 3 significant digits),
    which moves the paper's LeNet-5 SYMOG result on the card; JAX's
    reference computes them in fp32.  Forward and backward each read the
    flag when they run, so a train step holds it over both."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def _conv(p, x, padding="SAME"):
    """x (B, C, H, W), HWIO kernel, stride 1; SAME pads k // 2 (odd k)."""
    k = p["kernel"].to(x.dtype).permute(3, 2, 0, 1)  # HWIO -> OIHW
    pad = k.shape[-1] // 2 if padding == "SAME" else 0
    return F.conv2d(x, k, padding=pad)


def _fc_init(gen, cin, cout, dtype=torch.float32):
    return {"kernel": _normal(gen, (cin, cout), math.sqrt(2.0 / cin), dtype),
            "bias": torch.zeros((cout,), dtype=dtype, device=gen.device)}


def _fc(p, x):
    return x @ p["kernel"].to(x.dtype) + p["bias"].to(x.dtype)


def _bn_init(c, dtype, device):
    return ({"scale": torch.ones((c,), dtype=dtype, device=device),
             "bias": torch.zeros((c,), dtype=dtype, device=device)},
            {"mean": torch.zeros((c,), dtype=torch.float32, device=device),
             "var": torch.ones((c,), dtype=torch.float32, device=device)})


def _bn(p, state, x, train: bool, momentum=0.9, eps=1e-5):
    """x (B, C, H, W).  Train mode normalizes by the batch statistics
    (population variance) and returns the updated running stats, detached."""
    if train:
        xf = x.to(torch.float32)
        mean = torch.mean(xf, dim=(0, 2, 3))
        var = torch.var(xf, dim=(0, 2, 3), unbiased=False)
        new_state = {"mean": momentum * state["mean"] + (1 - momentum) * mean.detach(),
                     "var": momentum * state["var"] + (1 - momentum) * var.detach()}
    else:
        mean, var = state["mean"], state["var"]
        new_state = state
    y = (x - mean[:, None, None]) * torch.rsqrt(var + eps)[:, None, None]
    return y * p["scale"][:, None, None] + p["bias"][:, None, None], new_state


def _maxpool(x):
    return F.max_pool2d(x, 2)  # 2x2, stride 2, VALID


def _flatten_nhwc(h):
    return h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)


# ---------------------------------------------------------------------------
# architectures
# ---------------------------------------------------------------------------
_VGG_PLANS = {
    # (paper's VGG7 for CIFAR-10: Simonyan-style small net used by BC/TWN)
    "vgg7": [128, 128, "M", 256, 256, "M", 512, 512, "M"],
    "vgg11": [64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"],
    "vgg16": [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M"]
    + [512, 512, 512, "M"],
}
_VGG_FC = {"vgg7": [1024], "vgg11": [4096, 4096], "vgg16": [4096, 4096]}


def _w(cfg: CNNConfig, c: int) -> int:
    return max(8, int(round(c * cfg.width_mult)))


def cnn_init(seed, cfg: CNNConfig, dtype=torch.float32, device=None) -> Tuple[Dict, Dict]:
    """Random (params, bn_state) from ``seed`` (an int, or a
    ``torch.Generator`` on the target device); on the card unless ``device``
    says otherwise.  Shapes are JAX's; values differ for the same seed."""
    if isinstance(seed, torch.Generator):
        gen = seed
    else:
        gen = torch.Generator(device=resolve_device(device))
        gen.manual_seed(int(seed))
    dev = gen.device
    params: Dict[str, Any] = {}
    bn: Dict[str, Any] = {}

    if cfg.arch == "lenet5":
        params["conv1"] = _conv_init(gen, 5, 5, cfg.in_channels, 6, dtype)
        params["conv2"] = _conv_init(gen, 5, 5, 6, 16, dtype)
        hw = cfg.input_hw + 4  # classic LeNet pads 28x28 MNIST to 32x32
        flat = ((hw - 4) // 2 - 4) // 2  # two valid 5x5 convs + 2x2 pools
        params["fc1"] = _fc_init(gen, flat * flat * 16, 120, dtype)
        params["fc2"] = _fc_init(gen, 120, 84, dtype)
        params["fc3"] = _fc_init(gen, 84, cfg.n_classes, dtype)
        return params, bn

    if cfg.arch in _VGG_PLANS:
        cin, hw = cfg.in_channels, cfg.input_hw
        for i, item in enumerate(_VGG_PLANS[cfg.arch]):
            if item == "M":
                hw //= 2
                continue
            cout = _w(cfg, item)
            params[f"conv{i}"] = _conv_init(gen, 3, 3, cin, cout, dtype)
            params[f"bn{i}"], bn[f"bn{i}"] = _bn_init(cout, dtype, dev)
            cin = cout
        dims = [hw * hw * cin] + [_w(cfg, d) for d in _VGG_FC[cfg.arch]] + [cfg.n_classes]
        for j in range(len(dims) - 1):
            params[f"fc{j}"] = _fc_init(gen, dims[j], dims[j + 1], dtype)
        return params, bn

    if cfg.arch == "densenet":
        # DenseNet-BC: depth 76 -> 12 bottleneck pairs per block, 3 blocks
        n = (cfg.densenet_depth - 4) // 6
        g = max(4, int(round(cfg.densenet_growth * cfg.width_mult)))
        c = 2 * g
        params["conv_in"] = _conv_init(gen, 3, 3, cfg.in_channels, c, dtype)
        for b in range(3):
            for i in range(n):
                pre = f"block{b}/layer{i}"
                params[f"{pre}/bn1"], bn[f"{pre}/bn1"] = _bn_init(c, dtype, dev)
                params[f"{pre}/conv1"] = _conv_init(gen, 1, 1, c, 4 * g, dtype)
                params[f"{pre}/bn2"], bn[f"{pre}/bn2"] = _bn_init(4 * g, dtype, dev)
                params[f"{pre}/conv2"] = _conv_init(gen, 3, 3, 4 * g, g, dtype)
                c += g
            if b < 2:
                params[f"trans{b}/bn"], bn[f"trans{b}/bn"] = _bn_init(c, dtype, dev)
                params[f"trans{b}/conv"] = _conv_init(gen, 1, 1, c, c // 2, dtype)
                c = c // 2
        params["bn_out"], bn["bn_out"] = _bn_init(c, dtype, dev)
        params["fc"] = _fc_init(gen, c, cfg.n_classes, dtype)
        return params, bn

    raise ValueError(f"unknown cnn arch {cfg.arch}")


def cnn_apply(params, bn_state, x, cfg: CNNConfig, *, train: bool) -> Tuple[torch.Tensor, Dict]:
    """x (B, H, W, C) NHWC images -> (logits (B, n_classes), new bn_state);
    the convolutions in full fp32 (``fp32_convs``)."""
    with fp32_convs():
        return _cnn_apply(params, bn_state, x, cfg, train)


def _cnn_apply(params, bn_state, x, cfg: CNNConfig, train: bool) -> Tuple[torch.Tensor, Dict]:
    new_bn = dict(bn_state)

    def bnorm(name, h):
        y, s = _bn(params[name], bn_state[name], h, train)
        new_bn[name] = s
        return y

    x = x.permute(0, 3, 1, 2)  # NHWC -> NCHW
    if cfg.arch == "lenet5":
        x = F.pad(x, (2, 2, 2, 2))  # 28→32 (classic)
        h = _maxpool(torch.relu(_conv(params["conv1"], x, padding="VALID")))
        h = _maxpool(torch.relu(_conv(params["conv2"], h, padding="VALID")))
        h = torch.relu(_fc(params["fc1"], _flatten_nhwc(h)))
        h = torch.relu(_fc(params["fc2"], h))
        return _fc(params["fc3"], h), new_bn

    if cfg.arch in _VGG_PLANS:
        h = x
        for i, item in enumerate(_VGG_PLANS[cfg.arch]):
            if item == "M":
                h = _maxpool(h)
                continue
            h = torch.relu(bnorm(f"bn{i}", _conv(params[f"conv{i}"], h)))
        h = _flatten_nhwc(h)
        n_fc = len(_VGG_FC[cfg.arch]) + 1
        for j in range(n_fc):
            h = _fc(params[f"fc{j}"], h)
            if j < n_fc - 1:
                h = torch.relu(h)
        return h, new_bn

    if cfg.arch == "densenet":
        n = (cfg.densenet_depth - 4) // 6
        h = _conv(params["conv_in"], x)
        for b in range(3):
            for i in range(n):
                pre = f"block{b}/layer{i}"
                y = torch.relu(bnorm(f"{pre}/bn1", h))
                y = _conv(params[f"{pre}/conv1"], y)
                y = torch.relu(bnorm(f"{pre}/bn2", y))
                y = _conv(params[f"{pre}/conv2"], y)
                h = torch.cat([h, y], dim=1)
            if b < 2:
                h = torch.relu(bnorm(f"trans{b}/bn", h))
                h = _maxpool(_conv(params[f"trans{b}/conv"], h))  # max, as JAX's
        h = torch.relu(bnorm("bn_out", h))
        return _fc(params["fc"], torch.mean(h, dim=(2, 3))), new_bn

    raise ValueError(cfg.arch)


PAPER_CNNS = {
    "lenet5": CNNConfig("lenet5", "lenet5", in_channels=1, n_classes=10, input_hw=28),
    "vgg7": CNNConfig("vgg7", "vgg7", n_classes=10),
    "vgg11": CNNConfig("vgg11", "vgg11", n_classes=100),
    "vgg16": CNNConfig("vgg16", "vgg16", n_classes=100),
    "densenet": CNNConfig("densenet", "densenet", n_classes=10),
}


def reduced_cnn(name: str, width_mult: float = 0.25, densenet_depth: int = 22) -> CNNConfig:
    base = PAPER_CNNS[name]
    return dataclasses.replace(
        base, width_mult=width_mult, name=f"{name}-reduced",
        densenet_depth=(densenet_depth if name == "densenet" else base.densenet_depth),
    )
