"""The card's peaks and the utilization guard of the port's measurement
tools — counterpart of ``bench.py``'s chip helpers (``chip_generation``,
``_chip_peak_flops``, ``_chip_hbm_bw``, ``HBM_BW``,
``BenchMeasurementError``, ``_validate_utilization``).

The card is read from ``torch.cuda.get_device_name``, where the JAX
helpers read a TPU's ``device_kind``.  The figures are NVIDIA's H100
Tensor Core GPU data sheet: dense bf16 tensor-core FLOP/s (the sheet
prints the 2:4-sparse rate, twice the dense one), f32 CUDA-core FLOP/s
and HBM bytes/s.  A name that matches no pattern gets the SXM figures
with the source ``"default"``, so a guess is never reported as a fact.

Imported without torch (the node layer may import ``utils``): torch is
imported only when a device name is read.
"""

# Dense peaks and HBM bandwidth by card, NVIDIA H100 data sheet.
PEAK_BF16_FLOPS = {"h100-sxm": 989e12, "h100-pcie": 756e12,
                   "h100-nvl": 835e12}
PEAK_F32_FLOPS = {"h100-sxm": 67e12, "h100-pcie": 51e12, "h100-nvl": 60e12}
HBM_BW = {"h100-sxm": 3.35e12, "h100-pcie": 2.0e12, "h100-nvl": 3.9e12}
_PEAKS = {"bfloat16": PEAK_BF16_FLOPS, "float32": PEAK_F32_FLOPS}

# Ordered patterns against the normalized name ("NVIDIA H100 80GB HBM3"
# -> "nvidiah10080gbhbm3"): the PCIe and NVL forms first, so the bare
# "h100" (the SXM part's name) never shadows them.
_NAME_PATTERNS = (
    ("h100pcie", "h100-pcie"),
    ("h100nvl", "h100-nvl"),
    ("h100", "h100-sxm"),
)
DEFAULT_CHIP = "h100-sxm"


def device_name(device=None) -> str:
    """The card's name for a CUDA device (index, string or
    ``torch.device``; None is the current one), "" for any other."""
    import torch

    if device is not None and not isinstance(device, int):
        device = torch.device(device)
        if device.type != "cuda":
            return ""
    if not torch.cuda.is_available():
        return ""
    return torch.cuda.get_device_name(device)


def chip_generation(device=None, name=None):
    """(card key, source) for ``device`` (or a given ``name``): source is
    ``"device_name"`` when the name matched a pattern and ``"default"``
    when it did not (a CPU device included) — a guess, surfaced so an
    unknown card never carries confident-but-wrong numbers."""
    if name is None:
        name = device_name(device)
    norm = name.lower().replace(" ", "").replace("-", "").replace("_", "")
    for pattern, chip in _NAME_PATTERNS:
        if pattern in norm:
            return chip, "device_name"
    return DEFAULT_CHIP, "default"


def _chip_peak_flops(device=None, dtype="bfloat16", name=None):
    """(dense peak FLOP/s for ``dtype``, source) of the card."""
    chip, source = chip_generation(device, name)
    return _PEAKS[str(dtype).replace("torch.", "")][chip], source


def _chip_hbm_bw(device=None, name=None):
    """(HBM bytes/s, source) of the card."""
    chip, source = chip_generation(device, name)
    return HBM_BW[chip], source


class BenchMeasurementError(RuntimeError):
    """The measurement is physically impossible — do not report it."""


def _validate_utilization(value: float, name: str, ceiling: str,
                          on_accel: bool) -> float:
    """Refuse to report a utilization above 1.0 (MFU, a share of the HBM
    bandwidth, a floor over a step) on the card: a rate past the card's
    ceiling means the timed region did not run what it claims (an
    unsynchronized clock, a cached result).  CPU runs are smoke runs and
    pass through."""
    if on_accel and value > 1.0:
        raise BenchMeasurementError(
            f"measured {name} {value:.2f} exceeds {ceiling} — the timed "
            f"work was not synchronized or not executed; rerun")
    return value


def _validate_mfu(mfu: float, on_accel: bool) -> float:
    return _validate_utilization(mfu, "MFU", "the card's peak", on_accel)
