"""A cell's weights, drawn on the device from the seed.

An architecture (``arch/<architecture>.py``) declares its leaves as
:class:`Kind` s, in a fixed order; this module knows only the laws.
The laws are flax's initializers', which the port's ``init_params`` also
follows: ``trunc_normal`` a normal truncated to two standard deviations
with variance 1/fan_in, ``embed`` a normal of variance 1/(the last
axis), ``ones`` ones.  Each kind is drawn for every layer that holds it
at once, ``[layers, *shape]``, in one call on the card from a generator
seeded by the seed and the kind's salt (its place in the order, plus
one), so the same seed gives the same weights to the program and, after
the window, to the reference, and a kind can be drawn again alone.
"""

import math
from typing import NamedTuple, Optional

import torch

# Standard deviation of a unit normal truncated to [-2, 2].
TRUNC_STD = 0.87962566103423978


class Kind(NamedTuple):
    """One kind of leaf: ``name`` is the leaf's name, with ``{}`` where a
    layer's index goes; ``shape`` one leaf's shape; ``law`` ``ones``,
    ``embed`` or ``trunc_normal`` (which takes ``fan_in``); ``layers``
    the layers that hold it, or None for a global leaf."""

    name: str
    shape: tuple
    law: str
    fan_in: Optional[int] = None
    layers: Optional[tuple] = None


def _generator(seed: int, salt: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(
        (int(seed) * 1_000_003 + salt) % (2 ** 63))


def draw_kind(kind: Kind, salt: int, seed: int, device,
              dtype=torch.float32) -> torch.Tensor:
    """Every leaf of ``kind`` at once, ``[len(layers), *shape]`` (a global
    kind: its one leaf), drawn in f32 and cast to ``dtype``."""
    shape = kind.shape
    if kind.layers is not None:
        shape = (len(kind.layers),) + tuple(shape)
    if kind.law == "ones":
        return torch.ones(shape, dtype=dtype, device=device)
    g = _generator(seed, salt, device)
    w = torch.empty(shape, dtype=torch.float32, device=device)
    if kind.law == "embed":
        w.normal_(0.0, 1.0, generator=g).div_(math.sqrt(shape[-1]))
    elif kind.law == "trunc_normal":
        # Inverse-CDF truncated normal: uniform over the normal's CDF
        # between -2 and 2, mapped back through its inverse.
        lo, hi = (1 + math.erf(-2 / math.sqrt(2))) / 2, \
            (1 + math.erf(2 / math.sqrt(2))) / 2
        w.uniform_(2 * lo - 1, 2 * hi - 1, generator=g)
        w.erfinv_().mul_(math.sqrt(2.0)).clamp_(-2.0, 2.0)
        w.mul_(math.sqrt(1.0 / kind.fan_in) / TRUNC_STD)
    else:
        raise ValueError(f"kind {kind.name!r}: unknown law {kind.law!r}")
    return w.to(dtype)


def stacks(kinds, seed: int, device, dtype=torch.float32):
    """(kind, its stacked draw) for each of ``kinds`` in turn, each drawn
    with its salt, so at most one kind's stack is alive at a time."""
    for salt, kind in enumerate(kinds, 1):
        yield kind, draw_kind(kind, salt, seed, device, dtype)


def leaves(kind: Kind, stacked: torch.Tensor):
    """(name, leaf) of a kind drawn by :func:`draw_kind`."""
    if kind.layers is None:
        return [(kind.name, stacked)]
    return list(zip((kind.name.format(i) for i in kind.layers),
                    stacked.unbind(0)))


def draw(kinds, seed: int, device, dtype=torch.float32) -> dict:
    """Every leaf, name -> a tensor of its own in ``dtype``."""
    out = {}
    for kind, stacked in stacks(kinds, seed, device, dtype):
        out.update((n, t.clone()) for n, t in leaves(kind, stacked))
        del stacked
    return out


@torch.no_grad()
def load_into(params: dict, kinds, seed: int, device, dtype) -> None:
    """Copy the drawn weights into a model's parameters (``name ->
    tensor``, as ``named_parameters``), one kind at a time: the draw is
    in ``dtype``, the type the weights are served or trained in, and
    each copy casts to the parameter's own type."""
    for kind, stacked in stacks(kinds, seed, device, dtype):
        for name, leaf in leaves(kind, stacked):
            params[name].copy_(leaf)
        del stacked
