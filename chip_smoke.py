#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

Drives the port's serving path as a user would — ``cmd/serve_lm.py``'s
``build_generate`` and ``make_handler`` behind a real HTTP server, at the
server's default model width (12 layers, 8 heads x 64, mlp 2048, vocab
32000, random weights from a seed) with ``--flash-decode`` — and holds
the hand-written CUDA flash-decode kernel against its plain PyTorch
version.  Phases, one JSON line each:

1. the card (``nvidia-smi`` name and power limit, printed verbatim too);
2. the kernel build from ``ops/csrc/`` (``torch.utils.cpp_extension``:
   nvcc for sm_90a, and the op's TORCH_LIBRARY binding);
3. kernel vs plain version on the card, f32 at 2e-5 and bf16 at 3e-2
   (atol and rtol) and, in bf16, a max abs error of at most 1e-2 of the
   case's largest output: at
   every (cache, length) the server phase sends it (batch 1, 8 heads x
   64) with lengths 1 and full added, and at GQA groups 1-16, head dims
   40-256, batch 2-64, random lengths; a NaN tail past the length that
   must never be read; and designed inputs on which rounding p to bf16
   moves the output ~18%, where the kernel must match the plain version
   to one bf16 step and the same math with p in f32 must not;
4. the full-width model with the kernel on and off: first decode step's
   logits (bf16 within 5e-2 of the largest logit, f32 within 1e-4) and,
   in f32, identical greedy tokens;
5. the server: launch counts reset, four requests (5-token and
   700-token greedy prompts, a 3-prompt batch, a seeded sampled request
   sent twice), launch counts read — every decode step of every request
   must have launched the kernel;
6. kernel time (CUDA graphs of launches over enough distinct inputs to
   miss the 50 MB L2, timed with CUDA events) at the serving shape and at
   a 4096-token cache, beside the plain version, the
   ``scaled_dot_product_attention`` yardstick and the HBM bound, and the
   wall time per call of eager calls back to back (the host's share);
7. one greedy request through the server's ``run`` traced with
   ``torch.profiler``: device time against wall time (the busy share);
8. the ``{"kernels": [...]}`` summary line.

The last line is ``{"ok": true, "device": {...}}``.  Any failure raises
and the exit code is non-zero; without CUDA the script exits 2 before
printing any result.  Run from the repository root:

    python3 chip_smoke.py
"""

import json
import math
import statistics
import subprocess
import sys
import threading
import time
import urllib.request

# Prompt lengths of the server phase's requests, one generate each
# (batch 1); build_generate's warm-up adds a 1-token prompt.
PROMPT_LENS = {"greedy_5": [5], "greedy_700": [700], "batch_3": [3, 17, 64],
               "sampled": [12]}
SERVE_FLAGS = ["--flash-decode", "--max-prompt-len", "1024"]
TOL = {"float32": 2e-5, "bfloat16": 3e-2}  # atol and rtol, as the JAX tests
# In bf16 also: max abs error <= this times the case's largest |output|.
# Outputs are ~0.05 over long caches, where 3e-2 alone would let most of
# their digits go.  One bf16 step of the largest output is at most 2**-7
# (0.0078) of it; the rest is room for p rounded against another running
# max.
BF16_ERR_TO_MAX = 1e-2
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}  # dense, same source
KERNEL_SRC = "container_engine_accelerators_tpu_torch/ops/csrc/flash_decode.cu"
TPU_KERNEL = "container_engine_accelerators_tpu/ops/flash_decode.py:62"
L2_BYTES = 50 * 2 ** 20


def _phase(phase, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def _name(dtype):
    return str(dtype).replace("torch.", "")


def _agrees(got, want, dtype):
    """(max |got - want|, that over max |want|), or AssertionError past
    the stated tolerance."""
    import torch

    err = (got.float() - want.float()).abs().max().item()
    to_max = err / max(want.float().abs().max().item(), 1e-30)
    tol = TOL[_name(dtype)]
    ok = torch.allclose(got.float(), want.float(), atol=tol, rtol=tol)
    if dtype == torch.bfloat16:
        ok = ok and to_max <= BF16_ERR_TO_MAX
    if not ok:
        raise AssertionError(f"kernel != plain ({_name(dtype)}): "
                             f"max_abs_err={err}, {to_max} of max |output|")
    return err, to_max


def serving_shapes(n_new, max_prompt_len):
    """(cache length, lengths) of the flash-decode calls of the server
    phase, all at batch 1: each prompt's cache is its bucket + n_new, the
    prefill of a 1-token bucket attends 1 key, and the decode steps see
    prompt_len + 1 ... prompt_len + n_new - 1.  Lengths 1 and the full
    cache are added as edges."""
    from container_engine_accelerators_tpu_torch.models.batching import (
        bucket_len,
    )

    shapes = {}
    for plen in [1] + [n for lens in PROMPT_LENS.values() for n in lens]:
        cache_len = bucket_len(plen, max_prompt_len) + n_new
        shapes.setdefault(cache_len, {1, cache_len}).update(
            {plen + 1, plen + n_new - 1})
    return sorted((c, sorted(ls)) for c, ls in shapes.items())


def p_cast_inputs(dev, cache_len=1056, heads=8, head_dim=64):
    """tests/flash_decode_inputs.py's designed inputs, in bf16 on the
    card: scores exact in any summation order, each 32-key tile's max
    equal to the row's (so p is the same f32 number in the kernel and the
    plain version), and slot pairs whose output is (1 - p) / (1 + p) with
    p = 0.99004, which bf16 rounds to 0.98828: 0.00589 with the cast,
    0.00500 without."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(7)
    scale = head_dim ** -0.5
    q = torch.zeros(1, heads, head_dim, device=dev)
    q[..., 0] = 1.0
    k, v = (torch.randn(1, cache_len, heads, head_dim, device=dev,
                        generator=gen) for _ in range(2))
    slot = torch.arange(cache_len, device=dev) % 32
    col = torch.full((cache_len,), -64 / scale, device=dev)
    col[slot == 1] = -41 / 4096 / scale
    col[slot == 0] = 0.0
    k[..., 0] = col[None, :, None]
    v[:, slot == 0] = 1.0
    v[:, slot == 1] = -1.0
    return tuple(t.to(torch.bfloat16) for t in (q, k, v))


def check_kernel(fd, dev):
    """Phase 3: the kernel against the plain version on the card."""
    import torch

    from container_engine_accelerators_tpu_torch.cmd import serve_lm

    args = serve_lm.parse_args(SERVE_FLAGS)
    gen = torch.Generator(device=dev).manual_seed(0)
    # (batch, cache length, KV heads, heads, head dim, lengths or None for
    # 1 / mid / full / random).  First the server's own calls (batch 1,
    # its heads), then GQA groups 1-16, head dims 40-256 (40: the
    # scalar-load path), and cache cuts of one chunk (batch 64) and of
    # many chunks (batch 3).
    serving = serving_shapes(args.max_new_tokens, args.max_prompt_len)
    cases = [(1, c, args.kv_heads or args.num_heads, args.num_heads,
              args.head_dim, [n]) for c, lens in serving for n in lens]
    cases += [(3, 1056, kvh, 8, hd, None) for kvh in (8, 4, 2, 1)
              for hd in (64, 128)]
    cases += [(3, 1056, 1, 16, 64, None), (3, 1056, 2, 8, 256, None),
              (3, 1056, 2, 6, 40, None), (2, 32, 8, 8, 64, None),
              (64, 256, 8, 8, 64, None)]
    worst, worst_to_max, control_to_max = {}, 0.0, 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for b, cache_len, kvh, h, hd, lens in cases:
            if lens is None:
                lengths = torch.randint(1, cache_len + 1, (b,), device=dev,
                                        generator=gen, dtype=torch.int32)
                lengths[:2] = torch.tensor([1, cache_len])
                lengths[2:3] = cache_len // 2 + 5
            else:
                lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
            q, k, v = (torch.randn(shape, device=dev, generator=gen).to(dtype)
                       for shape in ((b, h, hd), (b, cache_len, kvh, hd),
                                     (b, cache_len, kvh, hd)))
            got = fd.flash_decode(q, k, v, lengths)
            torch.cuda.synchronize()
            want = fd.flash_decode_reference(q, k, v, lengths)
            try:
                err, to_max = _agrees(got, want, dtype)
            except AssertionError as e:
                raise AssertionError(f"{e} at b={b} L={cache_len} kvh={kvh} "
                                     f"h={h} hd={hd}") from None
            worst[_name(dtype)] = max(worst.get(_name(dtype), 0.0), err)
            if dtype == torch.bfloat16:
                worst_to_max = max(worst_to_max, to_max)
                # The plain version with p kept in f32: how far random
                # inputs can see the p cast.
                control = fd.flash_decode_reference(
                    q.float(), k.float(), v.float(), lengths).to(dtype).float()
                control_to_max = max(control_to_max, (
                    (got.float() - control).abs().max()
                    / want.float().abs().max()).item())
        # NaN tail right after a length that is not tile-aligned: the
        # kernel must never read it.
        cache_len = 1056
        q, k, v = (torch.randn(shape, device=dev, generator=gen).to(dtype)
                   for shape in ((1, 8, 64), (1, cache_len, 2, 64),
                                 (1, cache_len, 2, 64)))
        live = torch.tensor([517], dtype=torch.int32, device=dev)
        tail = torch.arange(cache_len, device=dev)[None, :, None, None] >= 517
        got = fd.flash_decode(q, k.masked_fill(tail, float("nan")),
                              v.masked_fill(tail, float("nan")), live)
        torch.cuda.synchronize()
        if not torch.isfinite(got).all():
            raise AssertionError(f"NaN tail reached the output ({dtype})")
        _agrees(got, fd.flash_decode_reference(q, k, v, live), dtype)
    # The p cast, at the server's longest decode shape.
    q, k, v = p_cast_inputs(dev)
    live = torch.tensor([731], dtype=torch.int32, device=dev)
    got = fd.flash_decode(q, k, v, live).float()
    torch.cuda.synchronize()
    want = fd.flash_decode_reference(q, k, v, live).float()
    p_in_f32 = fd.flash_decode_reference(q.float(), k.float(), v.float(),
                                         live).to(torch.bfloat16).float()
    rel = {name: ((x - got).abs() / got.abs()).max().item()
           for name, x in (("plain", want), ("p_in_f32", p_in_f32))}
    if not (rel["plain"] <= 2 ** -7 < rel["p_in_f32"]):
        raise AssertionError(f"p-cast check: max relative difference of the "
                             f"kernel to {rel} (bound 2**-7: one bf16 step)")
    _phase("kernel_check", cases=2 * len(cases) + 3,
           serving_shapes=[[c, lens] for c, lens in serving],
           max_abs_err=worst, tolerance=TOL,
           bf16_err_to_max={"kernel": worst_to_max,
                            "p_in_f32_control": control_to_max,
                            "bound": BF16_ERR_TO_MAX},
           p_cast_case={"kernel_output": got.max().item(),
                        "max_rel_diff": rel, "bound": 2 ** -7})
    return worst


def check_model(dev):
    """Phase 4: the full-width model with the kernel on and off."""
    import torch

    from container_engine_accelerators_tpu_torch.models.generate import (
        generate,
        prefill,
    )
    from container_engine_accelerators_tpu_torch.models.transformer import (
        TransformerLM,
        init_params,
    )

    params = init_params(TransformerLM(decode=True, device="meta"),
                         torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    prompt = torch.randint(0, 32000, (1, 64), generator=gen).to(dev)
    plen = 40  # bucket 64: the pad slots are overwritten by decode
    out = {}
    for dtype, tol in ((torch.bfloat16, 5e-2), (torch.float32, 1e-4)):
        model = TransformerLM(decode=True, dtype=dtype, device=dev)
        model.load_state_dict(params)
        with torch.inference_mode():
            cache, last = prefill(model, prompt, plen, 64 + 32)
            tok = last.argmax(-1)[:, None]
            pos = torch.tensor([plen], dtype=torch.int32, device=dev)
            step = {}
            for flash in (True, False):
                model.use_flash_decode = flash
                c = {name: t.clone() for name, t in cache.items()}
                step[flash] = model(tok, positions=pos, cache=c)[:, 0]
            diff = (step[True] - step[False]).abs().max().item()
            scale = step[False].abs().max().item()
            if dtype == torch.bfloat16:
                ok = diff <= tol * scale
            else:
                ok = torch.allclose(step[True], step[False], atol=tol, rtol=tol)
            if not ok or not torch.isfinite(step[True]).all():
                raise AssertionError(f"decode step logits, kernel vs einsum "
                                     f"({dtype}): max diff {diff}")
            entry = {"step_logits_max_diff": diff, "max_abs_logit": scale}
            if dtype == torch.float32:
                toks = {}
                for flash in (True, False):
                    model.use_flash_decode = flash
                    toks[flash] = generate(model, prompt, 32,
                                           prompt_len=plen)[0, :plen + 32]
                if not torch.equal(toks[True], toks[False]):
                    raise AssertionError("f32 greedy tokens differ, kernel "
                                         "vs einsum")
                entry["greedy_tokens_identical"] = 32
        out[_name(dtype)] = entry
        del model, cache
    _phase("model", config="12L 8x64 mlp2048 vocab32000 MHA", **out)


def _post(port, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/generate", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=300) as r:
        status, resp = r.status, json.load(r)
    return status, resp, (time.perf_counter() - t0) * 1e3


def serve(fd):
    """Phase 5: the main path — the server as main() wires it."""
    from http.server import ThreadingHTTPServer

    import numpy as np

    from container_engine_accelerators_tpu_torch.cmd import serve_lm

    args = serve_lm.parse_args(SERVE_FLAGS + ["--port", "0"])
    serve_lm.validate_args(args)
    for name in fd.LAUNCHES:
        fd.LAUNCHES[name] = 0
    run = serve_lm.build_generate(args)
    srv = ThreadingHTTPServer(("127.0.0.1", 0), serve_lm.make_handler(run, args))
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    rng = np.random.default_rng(0)

    def ids(n):
        return rng.integers(0, args.vocab_size, n).tolist()

    sampling = {"greedy_5": {"temperature": 0}, "greedy_700": {"temperature": 0},
                "batch_3": {}, "sampled": {"temperature": 0.8, "seed": 1234}}
    requests = [(name, {"prompt_ids": [ids(n) for n in lens], **sampling[name]})
                for name, lens in PROMPT_LENS.items()]
    n_new = args.max_new_tokens
    results = []
    # Prompt bucket of every generate: build_generate's warm-up first.
    buckets = [serve_lm.bucket_len(1, args.max_prompt_len)]
    try:
        for name, body in requests:
            status, resp, wall_ms = _post(srv.server_address[1], body)
            toks = resp.get("tokens")
            if status != 200 or toks is None or len(toks) != len(body["prompt_ids"]):
                raise AssertionError(f"{name}: bad response {status} {resp}")
            for p, t in zip(body["prompt_ids"], toks):
                if len(t) != len(p) + n_new or t[:len(p)] != p:
                    raise AssertionError(f"{name}: bad token row length or echo")
                if not all(0 <= x < args.vocab_size for x in t):
                    raise AssertionError(f"{name}: token outside the vocab")
            buckets += [serve_lm.bucket_len(len(p), args.max_prompt_len)
                        for p in body["prompt_ids"]]
            new = n_new * len(toks)
            results.append({"request": name,
                            "prompt_lens": [len(p) for p in body["prompt_ids"]],
                            "latency_ms": resp["latency_ms"],
                            "client_ms": round(wall_ms, 2),
                            "new_tokens": new,
                            "tokens_per_s": round(new / (resp["latency_ms"] / 1e3), 1)})
            if name == "sampled":
                # Same seed, same tokens: the per-request generator.
                _, again, _ = _post(srv.server_address[1], body)
                buckets.append(buckets[-1])
                if again["tokens"] != toks:
                    raise AssertionError("sampled request not reproducible "
                                         "from its seed")
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=30)
    launches = dict(fd.LAUNCHES)
    # Every decode step of every layer, plus the prefill of a 1-token
    # bucket, which is a single-token step too (as in the JAX model).
    steps = sum(n_new - 1 + (b == 1) for b in buckets)
    want = args.num_layers * steps
    if launches["flash_decode"] != want:
        raise AssertionError(f"flash_decode launched {launches['flash_decode']} "
                             f"times on the main path, expected {want}")
    _phase("serve", flags="--flash-decode --max-prompt-len 1024",
           requests=results, launches=launches,
           expected_launches=f"{args.num_layers} layers x {steps} single-token "
                             f"steps over {len(buckets)} generates")
    return launches["flash_decode"], run


def profile_request(run):
    """Phase 7: where one greedy request's time goes — device activity
    (kernels, copies) traced by torch.profiler against the request's
    wall time under the same tracing."""
    from collections import defaultdict

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    prompt = torch.randint(0, 32000, (1, 8), generator=torch.Generator().manual_seed(3))
    run(prompt, 5, 0.0, 0, False)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(prompt, 5, 0.0, 0, False)  # returns on the host: synchronized
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = defaultdict(float)
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] += e.time_range.elapsed_us() / 1e3
    if not by_name:
        raise AssertionError("the profiler recorded no device activity")
    device_ms = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    _phase("profile", request="greedy, 5-token prompt (bucket 8), 32 new",
           wall_ms=wall_ms, device_ms=device_ms,
           device_busy_share=device_ms / wall_ms,
           flash_decode_ms=sum(v for k, v in by_name.items()
                               if "flash_decode" in k),
           top=[[k[:70], v] for k, v in top])


def _graph_ms(fn, inputs, reps=7):
    """Per-call device time of ``fn`` over ``inputs``: one CUDA graph of
    one call per input, replayed and timed with CUDA events."""
    import torch

    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for args in inputs[:2]:
            fn(*args)  # warm-up outside capture
    torch.cuda.current_stream().wait_stream(stream)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for args in inputs:
            fn(*args)
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / len(inputs))
    return statistics.median(times)


def time_kernel(fd, dev, cache_len, length, heads=8, kv_heads=8, head_dim=64):
    """Phase 6 at one shape (batch 1, bf16, the serving dtype)."""
    import torch
    import torch.nn.functional as F

    dtype = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(2)
    per_input = 2 * cache_len * kv_heads * head_dim * 2
    n_inputs = max(4, math.ceil(2.5 * L2_BYTES / per_input))
    lengths = torch.tensor([length], dtype=torch.int32, device=dev)
    inputs = [tuple(torch.randn(shape, device=dev, generator=gen).to(dtype)
                    for shape in ((1, heads, head_dim),
                                  (1, cache_len, kv_heads, head_dim),
                                  (1, cache_len, kv_heads, head_dim)))
              + (lengths,) for _ in range(n_inputs)]
    q, k, v, _ = inputs[0]
    err, _ = _agrees(fd.flash_decode(q, k, v, lengths),
                     fd.flash_decode_reference(q, k, v, lengths), dtype)
    mask = (torch.arange(cache_len, device=dev) < length)[None, None, None, :]

    def sdpa(q, k, v, lengths):
        return F.scaled_dot_product_attention(
            q[:, :, None], k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=mask, enable_gqa=heads != kv_heads)

    ms = _graph_ms(fd.flash_decode, inputs)
    plain_ms = _graph_ms(fd.flash_decode_reference, inputs)
    library_ms = _graph_ms(sdpa, inputs)
    # Eager calls back to back, as the decode loop makes them: wall time
    # per call, the host's cost of one call where it exceeds the kernel's.
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for args in inputs:
        fd.flash_decode(*args)
    torch.cuda.synchronize()
    eager_ms = (time.perf_counter() - t0) * 1e3 / n_inputs
    # Least time for the same work: each input byte read once (only the
    # `length` visible K/V rows are needed), the output written once.
    nbytes = (2 * heads * head_dim * 2 + 4
              + 2 * length * kv_heads * head_dim * 2)
    flops = 4 * heads * head_dim * length
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / PEAK_FLOPS["bfloat16"] * 1e3
    row = {"shape": f"B=1 H={heads} KVH={kv_heads} D={head_dim} L={cache_len} "
                    f"length={length} bf16",
           "distinct_inputs": n_inputs, "max_abs_err": err, "ms": ms,
           "plain_ms": plain_ms, "library_ms": library_ms, "eager_ms": eager_ms,
           "bound_ms": max(bytes_ms, ops_ms),
           "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
           "bytes": nbytes, "flops": flops}
    _phase("kernel_time", **row)
    return row


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 2
    from container_engine_accelerators_tpu_torch.ops import flash_decode as fd

    # f32 matmuls in full f32 (PyTorch's default, stated for the f32 checks).
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    _phase("device", nvidia_smi=smi, card=torch.cuda.get_device_name(0),
           torch=torch.__version__, cuda=torch.version.cuda)

    t0 = time.perf_counter()
    fd.build()
    _phase("build", seconds=round(time.perf_counter() - t0, 3),
           route="torch.utils.cpp_extension.load: nvcc sm_90a for the "
                 "kernel, the host compiler for the TORCH_LIBRARY binding")

    check_kernel(fd, dev)
    check_model(dev)
    launches, run = serve(fd)
    serving = time_kernel(fd, dev, cache_len=1056, length=731)
    time_kernel(fd, dev, cache_len=4096, length=4096)
    # Last: once traced, the process timed its kernels slower.
    profile_request(run)

    print(json.dumps({"kernels": [{
        "name": "flash_decode", "route": "cuda", "source": KERNEL_SRC,
        "replaces": TPU_KERNEL, "launches": launches,
        "max_abs_err": serving["max_abs_err"], "ms": serving["ms"],
        "plain_ms": serving["plain_ms"], "bound_ms": serving["bound_ms"],
        "bound_by": serving["bound_by"],
        "library_ms": serving["library_ms"]}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
