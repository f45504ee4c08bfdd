"""Entry point of the PyTorch port — counterpart of ``__graft_entry__.py``'s
``entry()``: a forward step of the flagship model, for compile and
launch checks on one card.

``dryrun_multichip`` (the sharded train steps) comes with the multi-GPU
slice of the port.
"""

import os

import torch


def entry(device=None):
    """Return ``(fn, example_args)``: ``fn(model, images)`` is the bf16
    ResNet-50 eval forward (f32 logits) and ``example_args`` the model,
    weights from seed 0, with a batch of ones, ``GRAFT_BATCH`` images
    (default 8) of ``GRAFT_IMAGE_SIZE`` pixels (default 224) as
    ``channels_last`` NCHW, on ``device`` (the card unless
    ``device="cpu"``)."""
    from container_engine_accelerators_tpu_torch.models.resnet import (
        init_params,
        resnet,
    )
    from container_engine_accelerators_tpu_torch.utils.device import (
        resolve_device,
    )

    dev = resolve_device(device)
    batch = int(os.environ.get("GRAFT_BATCH", "8"))
    image_size = int(os.environ.get("GRAFT_IMAGE_SIZE", "224"))
    model = resnet(depth=50, device=dev)
    model.load_state_dict(init_params(model, torch.Generator().manual_seed(0)))
    model.eval()
    x = torch.ones(batch, 3, image_size, image_size, device=dev).to(
        memory_format=torch.channels_last)

    def forward(model, x):
        with torch.inference_mode():
            return model(x)

    return forward, (model, x)


if __name__ == "__main__":
    fn, args = entry()
    out = fn(*args)
    torch.cuda.synchronize()
    print(f"entry OK: logits {tuple(out.shape)} {out.dtype}")
