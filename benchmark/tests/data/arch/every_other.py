"""A test architecture whose kinds are held by some of the layers only,
as a hybrid's are: ``up`` in the even blocks, ``ln.scale`` in the odd
ones.  Sizes and leaves alone; it builds no model."""

from harness.weights import Kind


def sizes(cfg: dict) -> dict:
    return {"D": cfg["hidden_size"], "F": cfg["intermediate_size"],
            "V": cfg["vocab_size"], "L": cfg["num_hidden_layers"]}


def kinds(cfg: dict) -> list:
    s = sizes(cfg)
    d, f = s["D"], s["F"]
    every = tuple(range(s["L"]))
    return [
        Kind("embed", (s["V"], d), "embed"),
        Kind("blocks.{}.gate", (d, f), "trunc_normal", d, every),
        Kind("blocks.{}.up", (d, f), "trunc_normal", d, every[::2]),
        Kind("blocks.{}.ln.scale", (d,), "ones", None, every[1::2]),
    ]
