"""Device kernels told apart by the names the trace gives them on the
card: the port's own (``ops/csrc``)."""

FLASH_KINDS = {"fwd": "fa_fwd", "dq": "fa_bwd_dq", "dkv": "fa_bwd_dkv"}


def flash_attention(kind):
    """A matcher of one flash-attention kernel kind, or (``None``) of
    every kernel the flash-attention ops launch (the delta pre-pass
    included)."""
    if kind is None:
        return lambda name: "fa_fwd" in name or "fa_bwd" in name
    mark = FLASH_KINDS[kind]
    return lambda name: mark in name


def is_flash_decode(name: str) -> bool:
    return "flash_decode_kernel" in name
