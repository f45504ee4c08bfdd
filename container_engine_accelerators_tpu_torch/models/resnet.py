"""ResNet of the PyTorch port — counterpart of
``container_engine_accelerators_tpu/models/resnet.py``.

Depths 18/34 use basic blocks, 50/101/152 bottlenecks, with the flax
model's channel plan.  Parameters are f32 and cast to the compute dtype
(bf16 by default) where they are used; activations are NCHW tensors in
``channels_last`` memory (an NHWC batch permuted to NCHW already is), so
the convolutions, batch norms and pools are cuDNN calls in NHWC.  No
function here reaches a Pallas kernel in the JAX package, so these
library calls are the faithful counterpart of what XLA computed.

Three details of flax that PyTorch's own layers do otherwise:

- ``padding="SAME"`` pads ``total = max((ceil(n/s) - 1)*s + k - n, 0)``
  as ``(total // 2, total - total // 2)``: a stride-2 window on an even
  size puts its odd pixel after, where ``padding=k // 2`` pads both
  sides and shifts every window by one.  :func:`same_padding` computes
  it; symmetric pads go to the op itself, asymmetric ones through
  ``F.pad`` (with -inf for max pooling).
- BatchNorm's running statistics take the *biased* batch variance with
  momentum 0.9 on the old value (:class:`BatchNorm`); torch's take the
  unbiased one, with ``momentum`` on the new value.
- The last BatchNorm of every block starts with its scale at zero.

On a mesh (``models/train.py::make_sharded_train_step``) the weights are
DTensors laid out by the JAX rule (``FLAX_AXES`` maps each port axis to
its flax axis) and the activations are DTensors split by batch rows,
every channel on every model rank.  DTensor has no convolution strategy
for a sharded weight, so a convolution and the head run on this rank's
rows with this rank's weight shard and combine over the model axis as
Megatron does (``parallel/mesh.py::model_parallel``): a weight split on
its output channels convolves 1/M of them and gathers the slices; one
split on its input channels convolves its 1/M of x's channels and sums
the partial outputs.  So ``--model-par M`` splits each convolution's
compute M ways, as GSPMD does in the JAX step; the activation leaves
whole, so BatchNorm, the pools and the residual adds are untouched.  A
weight the rule leaves replicated (or splits on H or W, which it never
does for ResNet or Inception) is gathered whole.  The pools run on the
rows too.  BatchNorm takes its statistics over the GLOBAL batch, as
GSPMD does: DTensor means over the batch-split rows, flax's one-pass
variance ``mean(x^2) - mean(x)^2``.
"""

import functools
import math
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor

from container_engine_accelerators_tpu_torch.parallel.mesh import (
    batch_local,
    full,
    gather_weight,
    model_parallel,
    model_shard_dim,
    replicate,
)

STAGE_SIZES = {
    18: [2, 2, 2, 2],
    34: [3, 4, 6, 3],
    50: [3, 4, 6, 3],
    101: [3, 4, 23, 3],
    152: [3, 8, 36, 3],
}

# Stddev of a unit normal truncated to [-2, 2]: flax's truncated-normal
# initializers divide by it so the variance is the requested one.
_TRUNC_STD = 0.87962566103423978
_TRUNC_CDF = math.erf(2 / math.sqrt(2))  # P(|z| <= 2), in erf's units


def same_padding(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """flax/XLA ``padding="SAME"`` along one axis: (before, after)."""
    total = max((-(-size // stride) - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def pad_same(x: torch.Tensor, kernel: Tuple[int, int],
             stride: Tuple[int, int], value: float = 0.0):
    """(x, padding) for a SAME window op over x's H and W: symmetric pads
    are returned for the op to apply itself; asymmetric ones are applied
    here with ``value`` and the op gets none."""
    top, bottom = same_padding(x.shape[2], kernel[0], stride[0])
    left, right = same_padding(x.shape[3], kernel[1], stride[1])
    if top == bottom and left == right:
        return x, (top, left)
    return F.pad(x, (left, right, top, bottom), value=value), (0, 0)


def max_pool_same(x: torch.Tensor, window: int, stride: int) -> torch.Tensor:
    """``nn.max_pool(padding="SAME")``: padded cells are -inf."""
    if isinstance(x, DTensor):
        return batch_local(functools.partial(max_pool_same, window=window,
                                             stride=stride), x)
    k, s = (window, window), (stride, stride)
    x, pad = pad_same(x, k, s, value=-math.inf)
    return F.max_pool2d(x, k, s, padding=pad)


def avg_pool_same(x: torch.Tensor, window: int, stride: int) -> torch.Tensor:
    """``nn.avg_pool(padding="SAME")``: padded zeros count in the mean."""
    if isinstance(x, DTensor):
        return batch_local(functools.partial(avg_pool_same, window=window,
                                             stride=stride), x)
    k, s = (window, window), (stride, stride)
    x, pad = pad_same(x, k, s)
    return F.avg_pool2d(x, k, s, padding=pad, count_include_pad=True)


def conv_same(x: torch.Tensor, w: torch.Tensor, kernel: Tuple[int, int],
              strides: Tuple[int, int]) -> torch.Tensor:
    """flax's ``padding="SAME"`` convolution of ``x`` with the OIHW ``w``
    cast to x's dtype: what :class:`Conv` computes, and on a mesh what
    each model rank computes with its weight shard (an output-channel
    shard gives those output channels, an input-channel shard, on those
    channels of x, a partial sum of the whole output)."""
    w = w.to(x.dtype)
    if x.device.type == "cpu" and tuple(kernel) == (1, 1) \
            and tuple(strides) != (1, 1):
        # PyTorch's CPU build (oneDNN, torch 2.13) corrupts the heap in
        # the channels_last backward of a strided 1x1 convolution with
        # few input channels.  Every stride-th pixel convolved at
        # stride 1 is the same sums (SAME pads a 1x1 window nothing).
        x, strides = x[:, :, ::strides[0], ::strides[1]], (1, 1)
    x, pad = pad_same(x, kernel, strides)
    return F.conv2d(x, w, stride=strides, padding=pad)


def conv_channel_slice(x: torch.Tensor, w: torch.Tensor,
                       kernel: Tuple[int, int],
                       strides: Tuple[int, int]) -> torch.Tensor:
    """A model rank's product under an input-channel split: ``x`` is its
    slice of the channels (a strided view of the ``channels_last`` rows)
    and ``w`` its ``[out, in / M, kh, kw]`` shard; the result is its
    partial sum of the whole output.  A 1x1 window at stride 1 runs as
    one GEMM over the NHWC rows, which reads the slice in place (a
    convolution would first copy it: as much traffic as the product, in
    bf16); any other window is :func:`conv_same`."""
    if tuple(kernel) != (1, 1) or tuple(strides) != (1, 1):
        return conv_same(x, w, kernel, strides)
    n, c, h, w_ = x.shape
    rows = x.permute(0, 2, 3, 1).reshape(n * h * w_, c)
    y = F.linear(rows, w.to(x.dtype).reshape(w.shape[0], c))
    return y.view(n, h, w_, -1).permute(0, 3, 1, 2)


class Conv(nn.Module):
    """``nn.Conv(use_bias=False, padding="SAME")``: an f32 OIHW kernel in
    ``channels_last`` memory, cast to the input's dtype at use.

    On a mesh each rank convolves its batch rows with its shard of the
    weight (:func:`conv_same`) and the model axis combines them
    (``parallel/mesh.py::model_parallel``): an output-channel shard (port
    dim 0) gathers the output channels, an input-channel shard (dim 1)
    splits x's channels and sums the partial outputs
    (:func:`conv_channel_slice`).  Each model rank computes 1/M of the
    convolution, as GSPMD's split in the JAX step; in bf16 the partial
    sums of an input-channel split are rounded and summed in bf16.  A
    weight not split on its channels alone is gathered whole."""

    FLAX_AXES = {"weight": (3, 2, 0, 1)}  # OIHW holds flax's HWIO

    def __init__(self, in_channels: int, features: int,
                 kernel: Tuple[int, int], strides: Tuple[int, int] = (1, 1),
                 device=None):
        super().__init__()
        self.kernel, self.strides = tuple(kernel), tuple(strides)
        self.weight = nn.Parameter(torch.empty(
            features, in_channels, *kernel, device=device,
            memory_format=torch.channels_last))

    def forward(self, x):
        w = self.weight
        if not isinstance(w, DTensor):
            return self._conv(x, w)
        dim = model_shard_dim(w)
        if dim in (0, 1):
            local = self._conv if dim == 0 else functools.partial(
                conv_channel_slice, kernel=self.kernel, strides=self.strides)
            return batch_local(
                lambda rows: model_parallel(local, rows, w, dim), x)
        return batch_local(lambda rows: self._conv(rows, gather_weight(w)),
                           x)

    def _conv(self, x, w):
        return conv_same(x, w, self.kernel, self.strides)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` over the channel axis: f32 scale and bias,
    statistics in f32, output in the input's dtype.

    In train mode it normalises with the batch's statistics and updates
    ``running_mean`` / ``running_var`` as flax does:
    ``momentum * old + (1 - momentum) * batch``, with the biased batch
    variance.  ``F.batch_norm`` (cuDNN) computes the statistics in its one
    pass; given momentum 1 it leaves the batch mean and the *unbiased*
    variance in two scratch buffers, which are then scaled by
    ``(n - 1) / n`` into the running variance.  In eval mode it
    normalises with the running statistics."""

    def __init__(self, channels: int, eps: float, momentum: float = 0.9,
                 zero_scale: bool = False, device=None):
        super().__init__()
        self.eps, self.momentum, self.zero_scale = eps, momentum, zero_scale
        self.weight = nn.Parameter(torch.empty(channels, device=device))
        self.bias = nn.Parameter(torch.empty(channels, device=device))
        self.register_buffer("running_mean",
                             torch.zeros(channels, device=device))
        self.register_buffer("running_var",
                             torch.ones(channels, device=device))
        # Finite before every call: momentum 1 multiplies the old values
        # by zero, and 0 * NaN would stay NaN.
        self.register_buffer("_batch_mean", torch.zeros(channels,
                                                        device=device),
                             persistent=False)
        self.register_buffer("_batch_var", torch.zeros(channels,
                                                       device=device),
                             persistent=False)

    def forward(self, x):
        if isinstance(x, DTensor):
            return self._global_batch_norm(x)
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        y = F.batch_norm(x, self._batch_mean, self._batch_var, self.weight,
                         self.bias, True, 1.0, self.eps)
        n = x.numel() // x.shape[1]
        keep = 1.0 - self.momentum
        with torch.no_grad():
            self.running_mean.mul_(self.momentum).add_(self._batch_mean,
                                                       alpha=keep)
            self.running_var.mul_(self.momentum).add_(
                self._batch_var, alpha=keep * (n - 1) / n)
        return y

    def _global_batch_norm(self, x: DTensor) -> DTensor:
        """BatchNorm of a batch split over ranks, with flax's arithmetic:
        statistics over the global batch (DTensor's means over the split
        rows sum across ranks), the one-pass biased variance, then
        ``(x - mean) * (scale * rsqrt(var + eps)) + bias``."""
        # Statistics in f32 at least (f64 stays f64), as flax's.
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        if self.training:
            mean = xf.mean((0, 2, 3))
            var = ((xf * xf).mean((0, 2, 3)) - mean * mean).clamp_min(0.0)
            keep = 1.0 - self.momentum
            with torch.no_grad():
                self.running_mean.mul_(self.momentum).add_(
                    full(mean.detach()), alpha=keep)
                self.running_var.mul_(self.momentum).add_(
                    full(var.detach()), alpha=keep)
        else:
            mean, var = (replicate(t, x.device_mesh)
                         for t in (self.running_mean, self.running_var))
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean[:, None, None]) * mul[:, None, None]
        return (y + self.bias[:, None, None]).to(x.dtype)


class Dense(nn.Module):
    """flax ``nn.Dense(dtype=float32)``: f32 ``[out, in]`` weight and bias,
    the input cast to the weight's dtype (f32), f32 output.

    On a mesh the weight is used as :class:`Conv`'s: each rank multiplies
    its rows by its shard and the model axis combines the products (the
    head's 2048 x 1000 kernel is split on its input features: *split*,
    then *reduce*); the bias, gathered whole, is added once after."""

    FLAX_AXES = {"weight": (1, 0)}  # [out, in] holds flax's [in, out]

    def __init__(self, in_features: int, features: int, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(features, in_features,
                                               device=device))
        self.bias = nn.Parameter(torch.empty(features, device=device))

    def forward(self, x):
        w = self.weight
        dim = model_shard_dim(w) if isinstance(w, DTensor) else None
        if dim is None:
            return F.linear(x.to(w.dtype), w, self.bias)
        b = self.bias
        return batch_local(lambda rows: model_parallel(
            self._linear, rows, w, dim) + (
                gather_weight(b) if isinstance(b, DTensor) else b), x)

    @staticmethod
    def _linear(x, w):
        return F.linear(x.to(w.dtype), w)


class ResNetBlock(nn.Module):
    """Basic residual block (depths 18/34)."""

    def __init__(self, in_channels: int, filters: int,
                 strides: Tuple[int, int] = (1, 1), eps: float = 1e-5,
                 device=None):
        super().__init__()
        self.out_channels = filters
        self.conv0 = Conv(in_channels, filters, (3, 3), strides, device)
        self.bn0 = BatchNorm(filters, eps, device=device)
        self.conv1 = Conv(filters, filters, (3, 3), device=device)
        self.bn1 = BatchNorm(filters, eps, zero_scale=True, device=device)
        self.conv_proj = self.norm_proj = None
        # flax projects when the shapes differ: channels, or the stride.
        if in_channels != filters or tuple(strides) != (1, 1):
            self.conv_proj = Conv(in_channels, filters, (1, 1), strides,
                                  device)
            self.norm_proj = BatchNorm(filters, eps, device=device)

    def forward(self, x):
        y = F.relu(self.bn0(self.conv0(x)))
        y = self.bn1(self.conv1(y))
        residual = x
        if self.conv_proj is not None:
            residual = self.norm_proj(self.conv_proj(x))
        return F.relu(residual + y)


class BottleneckResNetBlock(nn.Module):
    """Bottleneck residual block (depths 50/101/152); the stride sits on
    the 3x3 convolution."""

    def __init__(self, in_channels: int, filters: int,
                 strides: Tuple[int, int] = (1, 1), eps: float = 1e-5,
                 device=None):
        super().__init__()
        out = filters * 4
        self.out_channels = out
        self.conv0 = Conv(in_channels, filters, (1, 1), device=device)
        self.bn0 = BatchNorm(filters, eps, device=device)
        self.conv1 = Conv(filters, filters, (3, 3), strides, device)
        self.bn1 = BatchNorm(filters, eps, device=device)
        self.conv2 = Conv(filters, out, (1, 1), device=device)
        self.bn2 = BatchNorm(out, eps, zero_scale=True, device=device)
        self.conv_proj = self.norm_proj = None
        if in_channels != out or tuple(strides) != (1, 1):
            self.conv_proj = Conv(in_channels, out, (1, 1), strides, device)
            self.norm_proj = BatchNorm(out, eps, device=device)

    def forward(self, x):
        y = F.relu(self.bn0(self.conv0(x)))
        y = F.relu(self.bn1(self.conv1(y)))
        y = self.bn2(self.conv2(y))
        residual = x
        if self.conv_proj is not None:
            residual = self.norm_proj(self.conv_proj(x))
        return F.relu(residual + y)


class ResNet(nn.Module):
    """The flax ``ResNet``: stem (7x7/s2 conv and a 3x3/s2 max pool, or a
    3x3/s1 conv with ``small_inputs``), the stages, a global mean over H
    and W and an f32 head.  Takes ``[N, 3, H, W]`` images of any float
    dtype and returns f32 logits; train or eval mode is the module's."""

    def __init__(self, stage_sizes: Sequence[int], block_cls,
                 num_classes: int = 1000, num_filters: int = 64,
                 dtype: torch.dtype = torch.bfloat16,
                 small_inputs: bool = False, device=None):
        super().__init__()
        self.dtype, self.small_inputs = dtype, small_inputs
        stem = ((3, 3), (1, 1)) if small_inputs else ((7, 7), (2, 2))
        self.conv_init = Conv(3, num_filters, *stem, device=device)
        self.bn_init = BatchNorm(num_filters, 1e-5, device=device)
        blocks, channels = [], num_filters
        for i, block_size in enumerate(stage_sizes):
            for j in range(block_size):
                strides = (2, 2) if i > 0 and j == 0 else (1, 1)
                block = block_cls(channels, num_filters * 2 ** i, strides,
                                  device=device)
                blocks.append(block)
                channels = block.out_channels
        self.blocks = nn.ModuleList(blocks)
        self.head = Dense(channels, num_classes, device=device)

    def forward(self, x):
        x = x.to(self.dtype, memory_format=torch.channels_last)
        x = F.relu(self.bn_init(self.conv_init(x)))
        if not self.small_inputs:
            x = max_pool_same(x, 3, 2)
        for block in self.blocks:
            x = block(x)
        return self.head(x.mean((2, 3)))


def resnet(depth: int = 50, **kwargs) -> ResNet:
    """A ResNet of any depth the JAX package builds (18/34/50/101/152)."""
    if depth not in STAGE_SIZES:
        raise ValueError(f"unsupported ResNet depth {depth}; "
                         f"choose from {sorted(STAGE_SIZES)}")
    block_cls = ResNetBlock if depth < 50 else BottleneckResNetBlock
    return ResNet(STAGE_SIZES[depth], block_cls, **kwargs)


def _truncated_normal(shape, generator: torch.Generator) -> torch.Tensor:
    """A unit normal truncated to [-2, 2], by its inverse CDF: one uniform
    draw an element, so the values depend on the generator alone (torch's
    ``trunc_normal_`` resamples, and costs several draws an element)."""
    t = torch.empty(shape).uniform_(-_TRUNC_CDF, _TRUNC_CDF,
                                    generator=generator)
    return t.erfinv_().mul_(math.sqrt(2.0)).clamp_(-2.0, 2.0)


def init_params(model: nn.Module, generator: torch.Generator) -> dict:
    """A full state dict of initial values for an image model's shapes
    (``ResNet`` or ``InceptionV3``), drawn on the CPU from ``generator``
    in parameter order, with flax's initializers: convolution and head
    kernels lecun-normal (truncated normal at two standard deviations,
    variance 1/fan_in), head bias 0, BatchNorm scale 1 (0 where flax
    zero-initialises it) and bias 0, running mean 0 and variance 1.
    Load it with ``model.load_state_dict``."""
    out = {}
    for prefix, module in model.named_modules():
        name = f"{prefix}." if prefix else ""
        if isinstance(module, (Conv, Dense)):
            w = module.weight
            fan_in = w[0].numel()
            out[f"{name}weight"] = _truncated_normal(w.shape, generator).mul_(
                math.sqrt(1.0 / fan_in) / _TRUNC_STD)
            if isinstance(module, Dense):
                out[f"{name}bias"] = torch.zeros(module.bias.shape)
        elif isinstance(module, BatchNorm):
            c = module.weight.shape[0]
            out[f"{name}weight"] = (torch.zeros(c) if module.zero_scale
                                    else torch.ones(c))
            out[f"{name}bias"] = torch.zeros(c)
            out[f"{name}running_mean"] = torch.zeros(c)
            out[f"{name}running_var"] = torch.ones(c)
    return out


def forward_flops(model: nn.Module, image_size: int) -> int:
    """Floating-point operations of one image's forward pass, counted
    from the shapes of the model's convolutions and head: 2 per
    multiply-add, ``2 * (in_channels * kh * kw)`` an output element of a
    convolution and ``2 * in * out`` for the head (BatchNorm, pooling and
    additions are not counted).  Runs one batch-1 eval forward on the
    model's device to read the shapes."""
    total = 0

    def count(module, args, output):
        nonlocal total
        if isinstance(module, Conv):
            total += 2 * output[0].numel() * module.weight[0].numel()
        else:
            total += 2 * module.weight.numel()

    hooks = [m.register_forward_hook(count) for m in model.modules()
             if isinstance(m, (Conv, Dense))]
    was_training = model.training
    device = next(model.parameters()).device
    try:
        model.eval()
        with torch.inference_mode():
            model(torch.zeros(1, 3, image_size, image_size, device=device))
    finally:
        model.train(was_training)
        for h in hooks:
            h.remove()
    return total
