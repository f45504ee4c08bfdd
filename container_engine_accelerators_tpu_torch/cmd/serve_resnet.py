"""ResNet inference server — PyTorch counterpart of ``cmd/serve_resnet.py``,
with the same HTTP contract (stdlib HTTP only)::

    POST /predict   {"batch": N} or {"inputs": [[...HWC floats...], ...]}
                    -> {"predictions": [class_id, ...], "latency_ms": t}
    GET  /healthz   -> {"status": "ok"}

An error gets a 400 with ``{"error": ...}``.  ``{"batch": N}`` builds its
images from ``np.random.default_rng(0)`` with shape (N, H, W, 3), as the
JAX server does, so the same weights give the same predictions.

It serves in eval mode under ``torch.inference_mode`` on ``--device``
(the card by default), bf16 compute with ``channels_last`` activations,
after warming batches 1 and 8.  With ``--model-dir`` it loads the
trainer's ``params.pt`` (``cmd/train_resnet.py``) and leaves the
BatchNorm running statistics at their initial values, mean 0 and
variance 1, because the JAX server restores ``params`` alone; without
it, it serves random weights from seed 0 (load for the autoscaling
demo).

Run: ``python -m container_engine_accelerators_tpu_torch.cmd.serve_resnet
[--port 9000] [--model-dir D]``.
"""

import argparse
import json
import logging
import os
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

log = logging.getLogger("serve-resnet")

PARAMS_FILE = "params.pt"  # what cmd/train_resnet.py --model-dir writes


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="PyTorch ResNet server")
    p.add_argument("--device", default="cuda",
                   help="torch device to serve on (cuda, cuda:N or cpu)")
    p.add_argument("--port", type=int, default=9000)
    p.add_argument("--resnet-depth", type=int, default=50)
    p.add_argument("--num-classes", type=int, default=1000)
    p.add_argument("--image-size", type=int, default=224)
    p.add_argument("--model-dir", default=None,
                   help=f"directory holding {PARAMS_FILE} from training")
    return p.parse_args(argv)


def load_model(args):
    """The served model (bf16 compute) in eval mode on ``args.device``:
    random weights from seed 0, then the parameters of ``--model-dir``'s
    params file where there is one (the BatchNorm statistics stay at their
    initial values)."""
    from container_engine_accelerators_tpu_torch.models.resnet import (
        init_params,
        resnet,
    )
    from container_engine_accelerators_tpu_torch.utils.device import (
        resolve_device,
    )

    device = resolve_device(args.device)
    model = resnet(args.resnet_depth, num_classes=args.num_classes,
                   device=device)
    model.load_state_dict(init_params(model, torch.Generator().manual_seed(0)))
    path = (os.path.join(args.model_dir, PARAMS_FILE)
            if args.model_dir else None)
    if path and os.path.exists(path):
        params = torch.load(path, map_location="cpu", weights_only=True)
        want = {name for name, _ in model.named_parameters()}
        if set(params) != want:
            raise ValueError(
                f"{path} does not hold this model's parameters: missing "
                f"{sorted(want - set(params))[:5]}, unexpected "
                f"{sorted(set(params) - want)[:5]}")
        model.load_state_dict(params, strict=False)
        log.info("loaded params from %s", path)
    else:
        log.info("serving randomly-initialized params (demo mode)")
    return model.eval()


def build_forward(args):
    """``forward(x)``: NHWC f32 images (numpy) -> predicted classes
    (numpy int64), through :func:`load_model`'s model, warmed at batches
    1 and 8.  ``forward.model`` is the model."""
    model = load_model(args)
    device = next(model.parameters()).device

    def forward(x):
        with torch.inference_mode():
            images = torch.from_numpy(np.ascontiguousarray(x, np.float32))
            # NHWC permuted to NCHW is channels_last: no copy.
            logits = model(images.to(device).permute(0, 3, 1, 2))
            return logits.argmax(-1).cpu().numpy()

    for b in (1, 8):
        forward(np.zeros((b, args.image_size, args.image_size, 3),
                         np.float32))
    forward.model = model
    return forward


def request_images(req: dict, args) -> np.ndarray:
    """The NHWC f32 batch a request asks for: its ``inputs``, or
    ``batch`` images from ``np.random.default_rng(0)``."""
    if "inputs" in req:
        return np.asarray(req["inputs"], dtype=np.float32)
    batch = int(req.get("batch", 1))
    return np.random.default_rng(0).standard_normal(
        (batch, args.image_size, args.image_size, 3)).astype(np.float32)


def make_handler(forward, args):
    class Handler(BaseHTTPRequestHandler):
        def _reply(self, code, obj):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._reply(200, {"status": "ok"})
            else:
                self._reply(404, {"error": "not found"})

        def do_POST(self):
            if self.path != "/predict":
                self._reply(404, {"error": "not found"})
                return
            try:
                n = int(self.headers.get("Content-Length", "0"))
                x = request_images(json.loads(self.rfile.read(n) or b"{}"),
                                   args)
                t0 = time.perf_counter()
                preds = forward(x)
                dt = (time.perf_counter() - t0) * 1e3
                self._reply(200, {"predictions": preds.tolist(),
                                  "latency_ms": round(dt, 3)})
            except Exception as e:  # demo server: report, don't die
                log.exception("request failed")
                self._reply(400, {"error": str(e)})

        def log_message(self, fmt, *a):
            log.debug(fmt, *a)

    return Handler


def main(argv=None):
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    args = parse_args(argv)
    forward = build_forward(args)
    srv = ThreadingHTTPServer(("0.0.0.0", args.port),
                              make_handler(forward, args))
    log.info("serving ResNet-%d on :%d", args.resnet_depth,
             srv.server_address[1])
    srv.serve_forever()


if __name__ == "__main__":
    main()
