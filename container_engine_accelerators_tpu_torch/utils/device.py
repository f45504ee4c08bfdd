"""Device selection: the port's entry points run on the card by default."""

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means ``"cuda"``.  A CUDA device without CUDA raises: a
    run that asked for the card never drops to the CPU silently.  Pass
    ``device="cpu"`` to run on the CPU (the tests do)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but CUDA is not available; pass "
            f"device='cpu' (--device cpu) to run on the CPU")
    return dev
