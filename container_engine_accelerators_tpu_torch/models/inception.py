"""Inception-v3 of the PyTorch port — counterpart of
``container_engine_accelerators_tpu/models/inception.py``.

The standard channel plan (stem -> InceptionA x3 -> InceptionB ->
InceptionC x4 -> InceptionD -> InceptionE x2 -> global mean -> head), no
aux head, built from the ResNet port's pieces (``models/resnet.py``):
f32 parameters cast at use, ``channels_last`` activations, flax's SAME
padding for every convolution and pool (the (1, 7) and (7, 1) kernels
included; SAME average pools count the padded zeros), BatchNorm with
epsilon 1e-3 and flax's running statistics.

Each block registers its ``ConvBNAct`` children in the order the flax
block calls them, which is the order flax numbers them
(``ConvBNAct_0``, ``ConvBNAct_1``, ...): ``BRANCHES`` names them, and
``models/convert.py`` maps them by it.

On a mesh (``models/train.py::make_sharded_train_step``) the
convolutions and the head split their work over the model axis as
ResNet's do (``models/resnet.py::Conv``), and every activation between
them is the batch-split DTensor of this rank's rows with every channel:
the block-level concatenations (:func:`cat_channels`) and the SAME pools
run on those rows, with no collective, and compute the single-device
values.
"""

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor

from container_engine_accelerators_tpu_torch.models.resnet import (
    BatchNorm,
    Conv,
    Dense,
    avg_pool_same,
    max_pool_same,
)
from container_engine_accelerators_tpu_torch.parallel.mesh import batch_local

EPS = 1e-3


def cat_channels(xs) -> torch.Tensor:
    """``torch.cat(xs, dim=1)``; on a mesh, of this rank's rows of each
    batch-split DTensor (every channel on every rank, so no collective)."""
    if isinstance(xs[0], DTensor):
        return batch_local(lambda *rows: torch.cat(rows, dim=1), *xs)
    return torch.cat(xs, dim=1)


class ConvBNAct(nn.Module):
    """Conv + BatchNorm + ReLU, the Inception primitive."""

    def __init__(self, in_channels: int, features: int,
                 kernel: Tuple[int, int], strides: Tuple[int, int] = (1, 1),
                 device=None):
        super().__init__()
        self.out_channels = features
        self.conv = Conv(in_channels, features, kernel, strides, device)
        self.bn = BatchNorm(features, EPS, device=device)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


class _Block(nn.Module):
    BRANCHES: Tuple[str, ...] = ()

    def _add(self, specs, device):
        """Register ``name: (in, out, kernel[, strides])`` in BRANCHES
        order."""
        assert tuple(specs) == self.BRANCHES
        for name, (cin, cout, kernel, *strides) in specs.items():
            self.add_module(name, ConvBNAct(cin, cout, kernel,
                                            *(strides or [(1, 1)]),
                                            device=device))


class InceptionA(_Block):
    BRANCHES = ("b1", "b5_1", "b5_2", "b3_1", "b3_2", "b3_3", "bp")

    def __init__(self, in_channels: int, pool_features: int, device=None):
        super().__init__()
        c = in_channels
        self._add({"b1": (c, 64, (1, 1)), "b5_1": (c, 48, (1, 1)),
                   "b5_2": (48, 64, (5, 5)), "b3_1": (c, 64, (1, 1)),
                   "b3_2": (64, 96, (3, 3)), "b3_3": (96, 96, (3, 3)),
                   "bp": (c, pool_features, (1, 1))}, device)
        self.out_channels = 64 + 64 + 96 + pool_features

    def forward(self, x):
        b1 = self.b1(x)
        b5 = self.b5_2(self.b5_1(x))
        b3 = self.b3_3(self.b3_2(self.b3_1(x)))
        bp = self.bp(avg_pool_same(x, 3, 1))
        return cat_channels([b1, b5, b3, bp])


class InceptionB(_Block):
    """Grid reduction 35x35 -> 17x17."""

    BRANCHES = ("b3", "bd_1", "bd_2", "bd_3")

    def __init__(self, in_channels: int, device=None):
        super().__init__()
        c = in_channels
        self._add({"b3": (c, 384, (3, 3), (2, 2)), "bd_1": (c, 64, (1, 1)),
                   "bd_2": (64, 96, (3, 3)),
                   "bd_3": (96, 96, (3, 3), (2, 2))}, device)
        self.out_channels = 384 + 96 + c

    def forward(self, x):
        b3 = self.b3(x)
        bd = self.bd_3(self.bd_2(self.bd_1(x)))
        return cat_channels([b3, bd, max_pool_same(x, 3, 2)])


class InceptionC(_Block):
    """Factorized 7x7 block."""

    BRANCHES = ("b1", "b7_1", "b7_2", "b7_3", "bd_1", "bd_2", "bd_3",
                "bd_4", "bd_5", "bp")

    def __init__(self, in_channels: int, channels_7x7: int, device=None):
        super().__init__()
        c, c7 = in_channels, channels_7x7
        self._add({"b1": (c, 192, (1, 1)), "b7_1": (c, c7, (1, 1)),
                   "b7_2": (c7, c7, (1, 7)), "b7_3": (c7, 192, (7, 1)),
                   "bd_1": (c, c7, (1, 1)), "bd_2": (c7, c7, (7, 1)),
                   "bd_3": (c7, c7, (1, 7)), "bd_4": (c7, c7, (7, 1)),
                   "bd_5": (c7, 192, (1, 7)), "bp": (c, 192, (1, 1))},
                  device)
        self.out_channels = 4 * 192

    def forward(self, x):
        b1 = self.b1(x)
        b7 = self.b7_3(self.b7_2(self.b7_1(x)))
        bd = self.bd_5(self.bd_4(self.bd_3(self.bd_2(self.bd_1(x)))))
        bp = self.bp(avg_pool_same(x, 3, 1))
        return cat_channels([b1, b7, bd, bp])


class InceptionD(_Block):
    """Grid reduction 17x17 -> 8x8."""

    BRANCHES = ("b3_1", "b3_2", "b7_1", "b7_2", "b7_3", "b7_4")

    def __init__(self, in_channels: int, device=None):
        super().__init__()
        c = in_channels
        self._add({"b3_1": (c, 192, (1, 1)),
                   "b3_2": (192, 320, (3, 3), (2, 2)),
                   "b7_1": (c, 192, (1, 1)), "b7_2": (192, 192, (1, 7)),
                   "b7_3": (192, 192, (7, 1)),
                   "b7_4": (192, 192, (3, 3), (2, 2))}, device)
        self.out_channels = 320 + 192 + c

    def forward(self, x):
        b3 = self.b3_2(self.b3_1(x))
        b7 = self.b7_4(self.b7_3(self.b7_2(self.b7_1(x))))
        return cat_channels([b3, b7, max_pool_same(x, 3, 2)])


class InceptionE(_Block):
    """Expanded-filter-bank output block."""

    BRANCHES = ("b1", "b3", "b3_a", "b3_b", "bd_1", "bd_2", "bd_a", "bd_b",
                "bp")

    def __init__(self, in_channels: int, device=None):
        super().__init__()
        c = in_channels
        self._add({"b1": (c, 320, (1, 1)), "b3": (c, 384, (1, 1)),
                   "b3_a": (384, 384, (1, 3)), "b3_b": (384, 384, (3, 1)),
                   "bd_1": (c, 448, (1, 1)), "bd_2": (448, 384, (3, 3)),
                   "bd_a": (384, 384, (1, 3)), "bd_b": (384, 384, (3, 1)),
                   "bp": (c, 192, (1, 1))}, device)
        self.out_channels = 320 + 768 + 768 + 192

    def forward(self, x):
        b1 = self.b1(x)
        b3 = self.b3(x)
        b3 = cat_channels([self.b3_a(b3), self.b3_b(b3)])
        bd = self.bd_2(self.bd_1(x))
        bd = cat_channels([self.bd_a(bd), self.bd_b(bd)])
        bp = self.bp(avg_pool_same(x, 3, 1))
        return cat_channels([b1, b3, bd, bp])


class InceptionV3(nn.Module):
    """Inception-v3 with the flax model's plan; ``a_blocks`` /
    ``c_blocks`` / ``e_blocks`` set the repeats as there (the tests use
    1/1/1).  Takes ``[N, 3, H, W]`` images and returns f32 logits."""

    def __init__(self, num_classes: int = 1000,
                 dtype: torch.dtype = torch.bfloat16,
                 a_blocks: Sequence[int] = (32, 64, 64),
                 c_blocks: Sequence[int] = (128, 160, 160, 192),
                 e_blocks: int = 2, device=None):
        super().__init__()
        self.dtype = dtype
        stem, c = [], 3
        for features, kernel, strides in ((32, (3, 3), (2, 2)),
                                          (32, (3, 3), (1, 1)),
                                          (64, (3, 3), (1, 1)),
                                          (80, (1, 1), (1, 1)),
                                          (192, (3, 3), (1, 1))):
            stem.append(ConvBNAct(c, features, kernel, strides, device))
            c = features
        self.stem = nn.ModuleList(stem)

        def stage(make, args):
            nonlocal c
            out = []
            for a in args:
                out.append(make(c, *a, device=device))
                c = out[-1].out_channels
            return nn.ModuleList(out)

        self.a = stage(InceptionA, [(p,) for p in a_blocks])
        self.b = stage(InceptionB, [()])
        self.c = stage(InceptionC, [(c7,) for c7 in c_blocks])
        self.d = stage(InceptionD, [()])
        self.e = stage(InceptionE, [()] * e_blocks)
        self.head = Dense(c, num_classes, device=device)

    def forward(self, x):
        x = x.to(self.dtype, memory_format=torch.channels_last)
        # Stem: 299x299x3 -> 35x35x192 (SAME throughout, as flax).
        x = self.stem[2](self.stem[1](self.stem[0](x)))
        x = max_pool_same(x, 3, 2)
        x = self.stem[4](self.stem[3](x))
        x = max_pool_same(x, 3, 2)
        for block in (*self.a, *self.b, *self.c, *self.d, *self.e):
            x = block(x)
        return self.head(x.mean((2, 3)))


def inception_v3(**kwargs) -> InceptionV3:
    """Build Inception-v3 (the demo's second model family)."""
    return InceptionV3(**kwargs)
