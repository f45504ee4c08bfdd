"""The PyTorch port's ResNet server (``cmd/serve_resnet.py``) on the CPU
at a small size (ResNet-18 at 32x32, 10 classes): the HTTP contract of
the JAX server, its predictions equal to the JAX server's ``forward`` on
the same weights with the BatchNorm statistics at their initial values
(both sides in f32, where the argmax of logits that agree to ~1e-6 is
the same), and ``--model-dir`` serving the trainer's params."""

import functools
import importlib.util
import json
import os
import re
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

import container_engine_accelerators_tpu.models as jmodels
from container_engine_accelerators_tpu_torch.cmd import (
    serve_resnet,
    train_resnet,
)
from container_engine_accelerators_tpu_torch.models import resnet as presnet
from container_engine_accelerators_tpu_torch.models.convert import (
    resnet_to_flax,
)
from torch_image_helpers import (  # noqa: F401 (autouse fixture)
    FEW_THREADS_ENV,
    few_torch_threads,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["--device", "cpu", "--resnet-depth", "18", "--image-size", "32",
        "--num-classes", "10"]


def _jax_server():
    spec = importlib.util.spec_from_file_location(
        "jax_serve_resnet", os.path.join(REPO, "cmd", "serve_resnet.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture
def server():
    """Start one port server for ``argv``; yields a factory returning
    (port, forward)."""
    started = []

    def start(argv):
        args = serve_resnet.parse_args(argv + ["--port", "0"])
        forward = serve_resnet.build_forward(args)
        srv = ThreadingHTTPServer(("127.0.0.1", 0),
                                  serve_resnet.make_handler(forward, args))
        thread = threading.Thread(target=srv.serve_forever, daemon=True)
        thread.start()
        started.append((srv, thread))
        return srv.server_address[1], forward

    yield start
    for srv, thread in started:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=10)


def _call(port, path, body=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=None if body is None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_http_round_trip(server):
    port, forward = server(TINY)
    assert _call(port, "/healthz") == (200, {"status": "ok"})
    code, out = _call(port, "/predict", {"batch": 3})
    assert code == 200 and len(out["predictions"]) == 3
    assert all(0 <= p < 10 for p in out["predictions"])
    assert out["latency_ms"] > 0
    # The same images sent as HWC floats: the same predictions.
    x = np.random.default_rng(0).standard_normal((3, 32, 32, 3)).astype(
        np.float32)
    code, sent = _call(port, "/predict", {"inputs": x.tolist()})
    assert code == 200 and sent["predictions"] == out["predictions"]
    assert forward(x).tolist() == out["predictions"]
    assert _call(port, "/predict", {})[1]["predictions"] == \
        out["predictions"][:1]
    code, err = _call(port, "/predict", {"inputs": [[1.0, 2.0]]})
    assert code == 400 and "error" in err
    assert _call(port, "/nope")[0] == 404
    assert _call(port, "/nope", {})[0] == 404


def test_defaults_match_the_jax_server():
    want = vars(_jax_server().parse_args([]))
    got = vars(serve_resnet.parse_args([]))
    assert got.pop("device") == "cuda"
    assert got == want


def test_predictions_equal_the_jax_servers(tmp_path, monkeypatch):
    """The port's weights from seed 0, written as the JAX server's
    params.msgpack and as the port's params.pt: both servers restore the
    params alone, so both serve the initial BatchNorm statistics."""
    model = presnet.resnet(18, num_classes=10)
    model.load_state_dict(presnet.init_params(
        model, torch.Generator().manual_seed(3)))
    # Drawn BatchNorm scales (flax zero-initialises the last of each
    # block), so every block contributes and the images' classes differ.
    gen = torch.Generator().manual_seed(4)
    for name, p in model.named_parameters():
        if name.endswith("weight") and p.ndim == 1:
            p.data.uniform_(0.8, 1.2, generator=gen)
    (tmp_path / "jax").mkdir()
    params, _ = resnet_to_flax(model)
    (tmp_path / "jax" / "params.msgpack").write_bytes(
        serialization.to_bytes(params))
    os.makedirs(tmp_path / "port")
    torch.save(train_resnet.params_state(model),
               tmp_path / "port" / serve_resnet.PARAMS_FILE)

    # Both servers in f32 (each builds its model by this name at call
    # time), where the argmax of logits that agree to ~1e-6 is the same.
    monkeypatch.setattr(jmodels, "resnet",
                        functools.partial(jmodels.resnet, dtype=jnp.float32))
    monkeypatch.setattr(presnet, "resnet",
                        functools.partial(presnet.resnet, dtype=torch.float32))
    jax_server = _jax_server()
    jargs = jax_server.parse_args(["--resnet-depth", "18", "--image-size",
                                   "32", "--num-classes", "10",
                                   "--model-dir", str(tmp_path / "jax")])
    jax_forward = jax_server.build_forward(jargs)
    args = serve_resnet.parse_args(TINY + ["--model-dir",
                                           str(tmp_path / "port")])
    forward = serve_resnet.build_forward(args)
    assert forward.model.dtype == torch.float32
    x = serve_resnet.request_images({"batch": 8}, args)
    want = np.asarray(jax_forward(jnp.asarray(x)))
    assert forward(x).tolist() == want.tolist()
    assert len(set(want.tolist())) > 1  # not one class for every image
    stats = {k: v for k, v in forward.model.state_dict().items()
             if "running" in k}
    assert all(not v.any() for k, v in stats.items() if k.endswith("mean"))
    assert all((v == 1).all() for k, v in stats.items() if k.endswith("var"))


def test_model_dir_serves_the_trainers_params(tmp_path, caplog):
    out = tmp_path / "model"
    train_resnet.main(["--device", "cpu", "--resnet-depth", "18",
                       "--image-size", "32", "--num-classes", "10",
                       "--train-batch-size", "4", "--train-steps", "3",
                       "--model-dir", str(out)])
    saved = torch.load(out / serve_resnet.PARAMS_FILE, weights_only=True)
    with caplog.at_level("INFO"):
        model = serve_resnet.load_model(serve_resnet.parse_args(
            TINY + ["--model-dir", str(out)]))
    assert "loaded params from" in caplog.text
    assert not model.training
    for name, p in model.named_parameters():
        assert torch.equal(p.detach(), saved[name]), name
    assert not model.bn_init.running_mean.any()
    assert (model.bn_init.running_var == 1).all()


def test_model_dir_of_another_model_raises(tmp_path):
    torch.save({"conv_init.weight": torch.zeros(1)},
               tmp_path / serve_resnet.PARAMS_FILE)
    with pytest.raises(ValueError, match="does not hold this model"):
        serve_resnet.load_model(serve_resnet.parse_args(
            TINY + ["--model-dir", str(tmp_path)]))


def test_module_entry_point_serves():
    proc = subprocess.Popen(
        [sys.executable, "-m",
         "container_engine_accelerators_tpu_torch.cmd.serve_resnet"] + TINY
        + ["--port", "0"], cwd=REPO, stderr=subprocess.PIPE, text=True,
        env={**os.environ, **FEW_THREADS_ENV})
    try:
        deadline = time.monotonic() + 120
        port = None
        for line in proc.stderr:
            m = re.search(r"serving ResNet-18 on :(\d+)", line)
            if m:
                port = int(m.group(1))
                break
            assert time.monotonic() < deadline, "the server never started"
        assert port, "the server never started"
        code, out = _call(port, "/predict", {"batch": 2})
        assert code == 200 and len(out["predictions"]) == 2
    finally:
        proc.terminate()
        proc.wait(timeout=30)
        proc.stderr.close()
