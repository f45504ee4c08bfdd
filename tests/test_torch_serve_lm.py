"""The PyTorch port's LM server (container_engine_accelerators_tpu_torch/
cmd/serve_lm.py) on the CPU: HTTP round trips through the real handler,
per request and through the continuous-batching engine (``--slots``), the
weights of a trainer's checkpoint (``--checkpoint-dir``) against the JAX
model's tokens, the flag gates, and the device rule."""

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

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from container_engine_accelerators_tpu.models import generate as jgen
from container_engine_accelerators_tpu.models import transformer as jtr
from container_engine_accelerators_tpu_torch.cmd import serve_lm, train_lm
from container_engine_accelerators_tpu_torch.models.checkpoint import (
    STATE_FILE,
)
from container_engine_accelerators_tpu_torch.models.convert import (
    to_flax_params,
)
from container_engine_accelerators_tpu_torch.models.generate import generate
from container_engine_accelerators_tpu_torch.models.transformer import (
    TransformerLM,
    init_params,
)
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


def _serve(args, run, engine_loop=None):
    srv = ThreadingHTTPServer(("127.0.0.1", 0),
                              serve_lm.make_handler(run, args, engine_loop))
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
    ["--tp", "2", "--prefix-cache", "2"],
    ["--slots", "2", "--tp", "2", "--weights", "int8"]])
def test_unported_flags_exit(flags):
    """Once rejected as a later slice's, now taken, as the JAX server
    takes them (served across ranks: test_torch_dist_serve_features.py);
    what still exits with --tp is what JAX refuses."""
    serve_lm.validate_args(serve_lm.parse_args(TINY + flags))
    for refused in (["--flash-decode"], ["--speculative", "2"]):
        with pytest.raises(SystemExit, match="mutually exclusive"):
            serve_lm.validate_args(serve_lm.parse_args(TINY + flags
                                                       + refused))


@pytest.mark.parametrize("flags", [
    ["--slots", "2", "--prefix-cache", "2"], ["--speculative", "3"],
    ["--prefix-cache", "2"], ["--weights", "int8"],
    ["--slots", "2", "--speculative", "3"], ["--prefill-chunk", "16"],
    ["--slots", "2", "--prefill-chunk", "4"],
    ["--speculative", "2", "--prefix-cache", "2", "--slots", "2",
     "--weights", "int8"]])
def test_ported_flags_are_taken(flags):
    """Once rejected as a later slice's, now taken, alone and with
    --slots, as the JAX server takes them."""
    serve_lm.validate_args(serve_lm.parse_args(TINY + flags))


@pytest.mark.parametrize("flags,combo", [
    (["--tp", "2", "--prefix-cache", "2"], "--prefix-cache with --tp > 1")])
def test_slots_with_later_features_name_the_combination(flags, combo):
    """``--slots`` with the prefix cache under ``--tp``, once refused by
    naming the combination, is taken; the flash-decode kernel with
    ``--tp`` still names its combination, as in the JAX server."""
    serve_lm.validate_args(serve_lm.parse_args(TINY + ["--slots", "2"]
                                               + flags))
    with pytest.raises(SystemExit, match=re.escape(
            "--flash-decode and --tp > 1")):
        serve_lm.validate_args(serve_lm.parse_args(
            TINY + ["--slots", "2", "--flash-decode"] + flags))


@pytest.mark.parametrize("flags", [
    ["--prefill-chunk", "4", "--speculative", "2"],
    ["--prefill-chunk", "4", "--prefix-cache", "2"]])
def test_prefill_chunk_refuses_the_paths_it_does_not_bound(flags):
    """The JAX server's rule: the speculative and prefix-cache paths
    prefill single-shot, so the memory bound would silently drop."""
    with pytest.raises(SystemExit, match="--prefill-chunk wires"):
        serve_lm.validate_args(serve_lm.parse_args(TINY + flags))


def test_slots_and_checkpoint_dir_are_ported(tmp_path):
    """Once rejected as a later slice's, now taken."""
    args = serve_lm.parse_args(TINY + ["--slots", "2", "--checkpoint-dir",
                                       str(tmp_path)])
    serve_lm.validate_args(args)
    with pytest.raises(SystemExit, match="--slots must be >= 0"):
        serve_lm.validate_args(serve_lm.parse_args(TINY + ["--slots", "-1"]))


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


# The server's shapes, trained for a few steps.
TRAIN = ["--device", "cpu", "--vocab-size", "64", "--num-layers", "1",
         "--num-heads", "2", "--head-dim", "8", "--mlp-dim", "32",
         "--seq-len", "16", "--train-batch-size", "2",
         "--learning-rate", "3e-2"]
JAX_CFG = dict(vocab_size=64, num_layers=1, num_heads=2, head_dim=8,
               mlp_dim=32)


def _decode_model(args, params, dtype=torch.bfloat16):
    model = TransformerLM(**JAX_CFG, dtype=dtype, decode=True,
                          use_flash_decode=args.flash_decode, device="cpu")
    model.load_state_dict(params)
    return model


def _greedy(model, prompts, args):
    """The port's generate() on bucket-padded prompts -> token rows."""
    rows = []
    for ids in prompts:
        bucket = serve_lm.bucket_len(len(ids), args.max_prompt_len)
        prompt = torch.tensor([ids + [0] * (bucket - len(ids))])
        with torch.inference_mode():
            out = generate(model, prompt, args.max_new_tokens,
                           prompt_len=len(ids))
        rows.append(out[0, :len(ids) + args.max_new_tokens].tolist())
    return rows


def _jax_greedy(flax_params, prompts, args):
    """JAX generate() (f32) on bucket-padded prompts -> token rows."""
    model = jtr.transformer_lm(**JAX_CFG, decode=True, dtype=jnp.float32)
    rows = []
    for ids in prompts:
        bucket = serve_lm.bucket_len(len(ids), args.max_prompt_len)
        prompt = jnp.asarray([ids + [0] * (bucket - len(ids))], jnp.int32)
        out = np.asarray(jgen.generate(model, flax_params, prompt,
                                       args.max_new_tokens,
                                       prompt_len=len(ids)))
        rows.append(out[0, :len(ids) + args.max_new_tokens].tolist())
    return rows


@pytest.mark.parametrize("flash", [False, True], ids=["einsum", "flash"])
def test_checkpoint_dir_serves_the_trained_weights(tmp_path, caplog, flash):
    """The trainer saves, the server loads the newest step: its weights
    are the checkpoint's, its greedy tokens over HTTP are generate()'s on
    the saved weights, and in f32 those weights give the JAX model's
    greedy tokens."""
    ckpt = str(tmp_path / "ckpt")
    train_lm.main(TRAIN + ["--train-steps", "4", "--checkpoint-interval",
                           "3", "--checkpoint-dir", ckpt])
    args = serve_lm.parse_args(TINY + ["--checkpoint-dir", ckpt]
                               + (["--flash-decode"] if flash else []))
    serve_lm.validate_args(args)
    with caplog.at_level("INFO"):
        run = serve_lm.build_generate(args)
    assert f"loaded step-4 params from {ckpt}" in caplog.text
    saved = torch.load(os.path.join(ckpt, "4", STATE_FILE),
                       weights_only=True)["model"]
    assert saved.keys() == run.params.keys()
    assert all(torch.equal(saved[k], run.params[k]) for k in saved)
    random = init_params(run.model, torch.Generator().manual_seed(0))
    assert not torch.equal(random["embed"], saved["embed"])
    prompts = [[1, 2, 3], [9, 8, 7, 6, 5], [40]]
    srv, t = _serve(args, run)
    try:
        got = _post(srv.server_address[1], {"prompt_ids": prompts})["tokens"]
    finally:
        _stop(srv, t)
    assert got == _greedy(_decode_model(args, saved), prompts, args)
    f32 = _decode_model(args, saved, torch.float32)
    assert _greedy(f32, prompts, args) == _jax_greedy(to_flax_params(saved),
                                                      prompts, args)


def test_checkpoint_dir_without_a_checkpoint_serves_random_params(tmp_path,
                                                                  caplog):
    args = serve_lm.parse_args(TINY + ["--checkpoint-dir", str(tmp_path)])
    with caplog.at_level("INFO"):
        run = serve_lm.build_generate(args)
    assert "no checkpoint found; serving random params" in caplog.text
    want = init_params(run.model, torch.Generator().manual_seed(0))
    assert all(torch.equal(want[k], run.params[k]) for k in want)


@pytest.mark.parametrize("flash", [False, True], ids=["einsum", "flash"])
def test_slots_answer_concurrent_requests_with_per_request_tokens(flash):
    """``--slots``: concurrent HTTP requests (several rows each, greedy
    and seeded sampled) through the engine give the per-request path's
    tokens, on one model, in one server process.  (The server computes
    in bf16, where a near-tie could flip between the fleet's products
    and batch 1's; at this size none does.  The f32 identity is
    ``tests/test_torch_batching.py``'s.)"""
    args = serve_lm.parse_args(TINY + ["--slots", "3"]
                               + (["--flash-decode"] if flash else []))
    serve_lm.validate_args(args)
    run = serve_lm.build_generate(args)
    engine_loop = serve_lm.start_engine(run, args)
    assert engine_loop.engine.max_len == 8 + 4
    slots_srv, slots_t = _serve(args, run, engine_loop)
    solo_srv, solo_t = _serve(args, run)
    bodies = [{"prompt_ids": [[1, 2, 3], [5]], "max_new_tokens": 4},
              {"prompt_ids": [[7, 8, 9, 10, 11, 12, 13]]},
              {"prompt_ids": [[3, 1, 4], [1, 5]], "temperature": 0.9,
               "seed": 77},
              {"prompt_ids": [[2, 7]], "max_new_tokens": 2},
              {"prompt_ids": [[6, 6, 6, 6]], "prefix_ids": [4, 4]}]
    got = {}
    try:
        def ask(i):
            got[i] = _post(slots_srv.server_address[1], bodies[i])

        threads = [threading.Thread(target=ask, args=(i,))
                   for i in range(len(bodies))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
            assert not th.is_alive()
        for i, body in enumerate(bodies):
            want = _post(solo_srv.server_address[1], body)["tokens"]
            assert got[i]["tokens"] == want, i
        assert engine_loop.engine.steps > 0
    finally:
        _stop(slots_srv, slots_t)
        _stop(solo_srv, solo_t)
        engine_loop.close()
    assert not engine_loop._thread.is_alive()


def test_module_entry_point_serves_with_slots():
    """``python -m ... serve_lm --slots 2``: main() wires the engine."""
    proc = subprocess.Popen(
        [sys.executable, "-m",
         "container_engine_accelerators_tpu_torch.cmd.serve_lm"] + TINY
        + ["--slots", "2"],
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
        assert b"continuous batching: 2 decode slots" in log
        body = _post(int(m.group(1)), {"prompt_ids": [[1, 2], [3]]})
        assert [len(r) for r in body["tokens"]] == [6, 5]
    finally:
        proc.terminate()
        proc.wait(timeout=30)
        proc.stderr.close()


# ---- the single-GPU serving features over HTTP ----------------------------

FEATURE_BODIES = [
    {"prompt_ids": [[1, 2, 3], [5]], "max_new_tokens": 4},
    {"prompt_ids": [[7, 8, 9, 10, 11, 12, 13]]},
    {"prompt_ids": [[3, 1, 4], [1, 5]], "temperature": 0.9, "seed": 77},
    {"prompt_ids": [[6, 6, 6, 6], [2]], "prefix_ids": [4, 4, 9]},
    {"prompt_ids": [[6, 1]], "prefix_ids": [4, 4, 9], "temperature": 0.7,
     "seed": 5},
    {"prompt_ids": [[2, 7]], "prefix_ids": list(range(1, 9))},  # too long
]


def _tokens_both_ways(flags, bodies=FEATURE_BODIES):
    """(per-request tokens, --slots 3 tokens, run) for ``bodies`` sent to
    two servers of ``flags`` in one process, on one model."""
    args = serve_lm.parse_args(TINY + flags + ["--slots", "3"])
    serve_lm.validate_args(args)
    run = serve_lm.build_generate(args)
    engine_loop = serve_lm.start_engine(run, args)
    solo_srv, solo_t = _serve(args, run)
    slots_srv, slots_t = _serve(args, run, engine_loop)
    try:
        solo = [_post(solo_srv.server_address[1], b)["tokens"] for b in bodies]
        got = {}

        def ask(i):
            got[i] = _post(slots_srv.server_address[1], bodies[i])["tokens"]

        threads = [threading.Thread(target=ask, args=(i,))
                   for i in range(len(bodies))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
            assert not th.is_alive()
    finally:
        _stop(solo_srv, solo_t)
        _stop(slots_srv, slots_t)
        engine_loop.close()
    return solo, [got[i] for i in range(len(bodies))], run


def _plain_tokens(bodies=FEATURE_BODIES, flags=()):
    """The tokens of a server without the features (same random
    weights), prefix_ids concatenated."""
    args = serve_lm.parse_args(TINY + list(flags))
    run = serve_lm.build_generate(args)
    srv, t = _serve(args, run)
    try:
        return [_post(srv.server_address[1], b)["tokens"] for b in bodies]
    finally:
        _stop(srv, t)


@pytest.mark.parametrize("flags", [
    ["--weights", "int8"], ["--prefill-chunk", "2"], ["--prefix-cache", "2"],
    ["--speculative", "2"], ["--speculative", "3", "--prefix-cache", "2"],
    ["--weights", "int8", "--speculative", "2", "--prefix-cache", "2"]],
    ids=["int8", "chunk", "prefix", "spec", "spec-prefix", "int8-spec-prefix"])
@pytest.mark.parametrize("flash", [False, True], ids=["einsum", "flash"])
def test_feature_slots_give_the_per_request_tokens(flags, flash):
    """Each feature, per request and through ``--slots`` (greedy rows,
    seeded sampled rows, rows after a prefix, a prefix too long for the
    cache): the engine gives the per-request path's tokens.  (bf16, as
    the server computes; at this size no near-tie flips.)"""
    flags = flags + (["--flash-decode"] if flash else [])
    solo, slots, run = _tokens_both_ways(flags)
    assert slots == solo
    for body, rows in zip(FEATURE_BODIES, solo):
        prompts = body["prompt_ids"]
        assert len(rows) == len(prompts)
        pfx = body.get("prefix_ids", [])
        for p, row in zip(prompts, rows):
            ctx = (pfx + p)[:8]
            assert row[:len(ctx)] == ctx and len(row) == len(ctx) + 4
    if "--prefix-cache" in flags:
        assert run.prefix_cache.stats()["hits"] > 0


@pytest.mark.parametrize("flags", [["--prefill-chunk", "2"],
                                   ["--prefix-cache", "2"]],
                         ids=["chunk", "prefix"])
def test_feature_gives_the_plain_servers_greedy_tokens(flags):
    """Chunked prefill and the prefix cache change no greedy token: the
    plain server's (prefix_ids concatenated)."""
    greedy = [b for b in FEATURE_BODIES if not b.get("temperature")]
    solo, _, _ = _tokens_both_ways(flags + ["--flash-decode"], greedy)
    assert solo == _plain_tokens(greedy, ["--flash-decode"])


def test_int8_server_equals_a_bf16_model_on_the_dequantized_weights():
    """``--weights int8``: the model holds int8 kernels and f32 scales,
    and its greedy tokens are those of a bf16 model loaded with the
    dequantized weights (the same arithmetic)."""
    from container_engine_accelerators_tpu_torch.models.quant import (
        dequantize_params,
        serving_params,
    )

    args = serve_lm.parse_args(TINY + ["--weights", "int8", "--flash-decode"])
    run = serve_lm.build_generate(args)
    assert run.model.blocks[0].attn.q.kernel_q.dtype == torch.int8
    dense = _decode_model(args, dequantize_params(
        serving_params(run.params, "int8")))
    prompts = [[1, 2, 3], [9, 8, 7, 6, 5], [40]]
    srv, t = _serve(args, run)
    try:
        got = _post(srv.server_address[1], {"prompt_ids": prompts})["tokens"]
    finally:
        _stop(srv, t)
    assert got == _greedy(dense, prompts, args)


def test_spec_server_counts_rounds_and_logs_its_draft(caplog):
    args = serve_lm.parse_args(TINY + ["--speculative", "3",
                                       "--num-layers", "4"])
    with caplog.at_level("INFO"):
        run = serve_lm.build_generate(args)
    assert "draft: randomly-initialized 1-layer model" in caplog.text
    assert run.draft.num_layers == 1  # max(1, 4 // 4)
    rounds = run.spec_rounds  # the warm-up's
    assert rounds > 0 and run.spec_drafted == 3 * rounds
    run(torch.tensor([[1, 2, 3, 0]]), 3, 0.0, 0, False)
    assert run.spec_rounds > rounds
    assert 0 <= run.spec_accepted <= run.spec_drafted


@pytest.mark.parametrize("saved", [True, False], ids=["saved", "empty"])
def test_draft_checkpoint_dir_loads_the_saved_draft(tmp_path, caplog, saved):
    """``--draft-checkpoint-dir``: the draft serves the trainer's newest
    step.  The target's own checkpoint as its draft (a self-draft)
    accepts every proposal and gives the plain greedy tokens; an empty
    directory leaves the draft random, and says so."""
    ckpt = str(tmp_path / "ckpt")
    if saved:
        train_lm.main(TRAIN + ["--train-steps", "2", "--checkpoint-dir",
                               ckpt])
    args = serve_lm.parse_args(TINY + [
        "--checkpoint-dir", ckpt, "--speculative", "3", "--draft-layers", "1",
        "--draft-checkpoint-dir", ckpt, "--flash-decode"])
    with caplog.at_level("INFO"):
        run = serve_lm.build_generate(args)
    if not saved:
        assert f"draft: NO checkpoint found; random params from {ckpt}" \
            in caplog.text
        return
    assert f"draft: step-2 params from {ckpt}" in caplog.text
    assert all(torch.equal(run.draft.state_dict()[k],
                           run.model.state_dict()[k])
               for k in run.model.state_dict())
    prompts = [[1, 2, 3], [9, 8, 7, 6, 5]]
    srv, t = _serve(args, run)
    try:
        got = _post(srv.server_address[1], {"prompt_ids": prompts})["tokens"]
    finally:
        _stop(srv, t)
    assert run.spec_accepted == run.spec_drafted > 0
    assert got == _greedy(_decode_model(args, run.params), prompts, args)


def test_prefix_cache_server_reuses_its_blocks():
    args = serve_lm.parse_args(TINY + ["--prefix-cache", "2"])
    run = serve_lm.build_generate(args)
    srv, t = _serve(args, run)
    try:
        for sfx in ([1], [2, 3], [4]):
            _post(srv.server_address[1], {"prompt_ids": [sfx],
                                          "prefix_ids": [5, 6, 7]})
        # As long as --max-prompt-len: concatenated, not cached.
        _post(srv.server_address[1], {"prompt_ids": [[1]],
                                      "prefix_ids": list(range(8))})
    finally:
        _stop(srv, t)
    assert run.prefix_cache.stats() == {"entries": 1, "hits": 2, "misses": 1,
                                        "evictions": 0}


def test_module_entry_point_serves_speculative_slots():
    """``python -m ... serve_lm --slots 2 --speculative 2 --prefix-cache
    2``: main() wires the speculative engine."""
    proc = subprocess.Popen(
        [sys.executable, "-m",
         "container_engine_accelerators_tpu_torch.cmd.serve_lm"] + TINY
        + ["--slots", "2", "--speculative", "2", "--prefix-cache", "2"],
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
        assert b"continuous batching: 2 decode slots (speculative, k=2)" in log
        body = _post(int(m.group(1)), {"prompt_ids": [[1, 2], [3]],
                                       "prefix_ids": [4, 5]})
        assert [len(r) for r in body["tokens"]] == [8, 7]
    finally:
        proc.terminate()
        proc.wait(timeout=30)
        proc.stderr.close()
