"""The PyTorch port's LM server (container_engine_accelerators_tpu_torch/
cmd/serve_lm.py) on the CPU: HTTP round trips through the real handler,
the flag gates of this slice, and the device rule."""

import importlib.util
import json
import os
import re
import select
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import pytest
import torch

from container_engine_accelerators_tpu_torch.cmd import serve_lm
from container_engine_accelerators_tpu_torch.utils.device import resolve_device

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["--device", "cpu", "--vocab-size", "64", "--num-layers", "1",
        "--num-heads", "2", "--head-dim", "8", "--mlp-dim", "32",
        "--max-prompt-len", "8", "--max-new-tokens", "4", "--port", "0"]


@pytest.fixture(scope="module", params=[False, True], ids=["einsum", "flash"])
def server(request):
    args = serve_lm.parse_args(TINY + (["--flash-decode"] if request.param
                                       else []))
    serve_lm.validate_args(args)
    return args, serve_lm.build_generate(args)


def _serve(args, run):
    srv = ThreadingHTTPServer(("127.0.0.1", 0), serve_lm.make_handler(run, args))
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    return srv, t


def _stop(srv, t):
    srv.shutdown()
    srv.server_close()
    t.join(timeout=10)
    assert not t.is_alive()


def _post(port, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/generate", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.load(r)


def test_http_roundtrip(server):
    args, run = server
    srv, t = _serve(args, run)
    port = srv.server_address[1]
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                                    timeout=10) as r:
            assert json.load(r)["status"] == "ok"
        body = _post(port, {"prompt_ids": [[1, 2, 3], [5]],
                            "max_new_tokens": 4})
        assert len(body["tokens"]) == 2
        assert body["tokens"][0][:3] == [1, 2, 3]  # prompt echoed
        assert len(body["tokens"][0]) == 7  # 3 prompt + 4 generated
        assert len(body["tokens"][1]) == 5
        assert all(0 <= x < 64 for row in body["tokens"] for x in row)
        assert body["latency_ms"] > 0
        capped = _post(port, {"prompt_ids": [[1, 2, 3]], "max_new_tokens": 2})
        assert capped["tokens"][0] == body["tokens"][0][:5]
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(f"http://127.0.0.1:{port}/nope", timeout=10)
        assert e.value.code == 404
    finally:
        _stop(srv, t)


def test_prefix_ids_concatenate(server):
    """Without the prefix cache, prefix_ids is plain concatenation."""
    args, run = server
    srv, t = _serve(args, run)
    try:
        port = srv.server_address[1]
        joined = _post(port, {"prompt_ids": [[7, 8, 9, 10]]})
        split = _post(port, {"prompt_ids": [[9, 10]], "prefix_ids": [7, 8]})
        assert split["tokens"] == joined["tokens"]
    finally:
        _stop(srv, t)


def test_sampling_reproducible_from_seed(server):
    args, run = server
    prompt = torch.tensor([[3, 1, 4, 1]], dtype=torch.long)
    a = run(prompt, 4, 0.9, 123, True)
    b = run(prompt, 4, 0.9, 123, True)
    assert torch.equal(a, b)
    greedy = run(prompt, 4, 0.0, 0, False)
    assert torch.equal(greedy, run(prompt, 4, 0.0, 99, False))


def test_defaults_match_the_jax_server():
    spec = importlib.util.spec_from_file_location(
        "jax_serve_lm_defaults", os.path.join(REPO, "cmd", "serve_lm.py"))
    jax_serve = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_serve)
    want = vars(jax_serve.parse_args([]))
    got = vars(serve_lm.parse_args([]))
    assert got.pop("device") == "cuda"
    assert got == want


@pytest.mark.parametrize("flags", [
    ["--slots", "2"], ["--speculative", "3"], ["--prefix-cache", "2"],
    ["--tp", "2"], ["--num-experts", "4"], ["--weights", "int8"],
    ["--checkpoint-dir", "/nonexistent"], ["--prefill-chunk", "16"]])
def test_unported_flags_exit(flags):
    with pytest.raises(SystemExit, match="later serving slice"):
        serve_lm.validate_args(serve_lm.parse_args(TINY + flags))


def test_bf16_weights_serve():
    args = serve_lm.parse_args(TINY + ["--weights", "bf16"])
    serve_lm.validate_args(args)
    run = serve_lm.build_generate(args)
    assert run.model.embed.dtype == torch.bfloat16
    out = run(torch.tensor([[1, 2, 0, 0]]), 2, 0.0, 0, False)
    assert out.shape == (1, 8)


def test_resolve_device(monkeypatch):
    assert resolve_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for dev in (None, "cuda", "cuda:1"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            resolve_device(dev)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve_lm.build_generate(serve_lm.parse_args(TINY[2:]))


def test_module_entry_point_serves():
    """``python -m container_engine_accelerators_tpu_torch.cmd.serve_lm``
    on an ephemeral port (read back from its log line)."""
    proc = subprocess.Popen(
        [sys.executable, "-m",
         "container_engine_accelerators_tpu_torch.cmd.serve_lm"] + TINY,
        cwd=REPO, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
    try:
        deadline = time.monotonic() + 60
        log, m = b"", None
        while m is None:
            left = deadline - time.monotonic()
            assert left > 0, "server never reported its port"
            ready, _, _ = select.select([proc.stderr], [], [], left)
            chunk = os.read(proc.stderr.fileno(), 4096) if ready else b""
            assert chunk or proc.poll() is None, f"server exited: {log!r}"
            log += chunk
            m = re.search(rb"serving LM on :(\d+)", log)
        body = _post(int(m.group(1)), {"prompt_ids": [[1, 2]]})
        assert len(body["tokens"][0]) == 6
    finally:
        proc.terminate()
        proc.wait(timeout=30)
        proc.stderr.close()
