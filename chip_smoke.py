#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

Drives the port's paths as a user would: the LM paths at the default
model width (12 layers, 8 heads x 64, mlp 2048, vocab 32000, random
weights from a seed), serving — ``cmd/serve_lm.py``'s ``build_generate`` and
``make_handler`` behind a real HTTP server with ``--flash-decode``, then
with each single-GPU feature (int8 weights, chunked prefill, the prefix
cache, speculative decoding) per request and with ``--slots`` — and
training — ``cmd/train_lm.py``'s ``main`` at its defaults (seq 2048,
batch 8, bf16) — both again with ``--num-experts 8`` (the Switch MoE-LM),
and the image paths, ``cmd/train_resnet.py`` and ``cmd/serve_resnet.py``
at their defaults (ResNet-50, 224x224, batch 128, bf16 with cuDNN) and
Inception-v3, the multi-GPU layer at a world of one card (an NCCL group,
the trainers and the LM server on the (1, 1) mesh of DTensor weights,
the NCCL collectives sweep, the sharded ResNet and Inception-v3 steps and
the model-parallel convolution's per-rank shards), sequence parallelism
(ring, ring-zigzag and Ulysses through ``cmd/train_lm.py
--seq-parallel``, the ring's blocks on the flash kernels), pipeline and
expert parallelism, the MoE-LM and
the int8 / prefix-cache / MoE server on the mesh, the JAX dry run's nine
regimes, and the node layer (NVML, the ``nvidia.com/gpu`` device
plugin daemon, its Xid health checker and metrics server, its fault
sites, MIG, the maintenance watcher, MPS, the NRI device injector, the
node labeler and the topology-aware scheduler) on the card, and the DCN
transfer plane (two ranks' shards of the trainer's parameters through
their own PyXferds and through the native daemons, and ``dcn_bench``);
and holds every hand-written CUDA kernel against its plain PyTorch
version.  Phases, one JSON line each:

1. the card (``nvidia-smi`` name and power limit, printed verbatim too);
2. the build of every kernel from ``ops/csrc/`` in one
   ``torch.utils.cpp_extension.load`` (nvcc for sm_90a, and the ops'
   TORCH_LIBRARY bindings), with its seconds and the tensor-core source;
3. flash decode vs its plain version on the card, f32 at 2e-5 and bf16 at 3e-2
   (atol and rtol) and, in bf16, a max abs error of at most 1e-2 of the
   case's largest output: at
   every (cache, length) the server phase sends it (batch 1, 8 heads x
   64) with lengths 1 and full added, and at GQA groups 1-16, head dims
   40-256, batch 2-64, random lengths; a NaN tail past the length that
   must never reach the output; and designed inputs on which rounding p
   to bf16 moves the output ~18%, where the kernel must match the plain
   version to one bf16 step and the same math with p in f32 must not;
   then (``kernel_launch``) lengths 0 (NaN, as the plain version) and past
   the cache, length 1 at the widest split (CTAs of a cluster with no
   key), a CUDA graph of one call replayed twice to the eager call's
   bits, and one call = one kernel in a ``torch.profiler`` trace;
4. the full-width model with the kernel on and off: first decode step's
   logits (bf16 within 5e-2 of the largest logit, f32 within 1e-4) and,
   in f32, identical greedy tokens;
5. the server: launch counts reset, four requests (5-token and
   700-token greedy prompts, a 3-prompt batch, a seeded sampled request
   sent twice), launch counts read — every decode step of every request
   must have launched the kernel;
6. ``fa_kernel_check``: the flash-attention forward (o, lse) and
   backward (dq, dk, dv) kernels vs their plain versions, causal and
   not, head dims 64/128/256, T 128/256/2048, B*H 1-64 and the training
   shape, f32 at 2e-5 / 2e-4 and bf16 at 2e-2 / 1e-1 plus a max abs
   error of at most 1e-2 of the case's largest output; beside it, how
   far the plain math with p (and dS) kept in f32 lands from the kernel;
   and designed cases where the casts move the output far more than
   bf16 rounds it: the forward's p cast (decode inputs, every query row
   the decode query), dK/dV's P and dS casts (``bwd_cast_inputs``) and
   dQ's dS cast (``dq_cast_inputs``), where the kernel must match the
   plain version to one bf16 step and the same math in f32 must not;
7. ``train_parity``: the full-width model, batch 2 at T 2048, kernels on
   vs dense attention — f32 loss within 1e-5 relative and every gradient
   within 1e-4 of its leaf's largest |g|, bf16 loss within 2e-2;
8. ``train``: the trainer's ``main`` at its defaults for a few steps
   with the launch counts reset around it — the forward kernel must run
   2 x layers x steps times (remat recomputes it), each backward kernel
   layers x steps — finite losses, the first equal to dense attention's
   within bf16 tolerance, and the steady-state step time and tokens/s;
9. kernel times (CUDA graphs of launches over enough distinct inputs to
   miss the 50 MB L2, timed with CUDA events): flash decode at the
   serving shape, at a 4096-token cache, at one KV head of 8 query heads
   (batch 1, 4096 keys), at a ragged GQA batch (B=8, KVH=2, lengths
   from a seed over 1..4096) and at the ``--slots`` fleet's shape (B=8,
   the server's heads, a 1056-slot lane, phase 11's prompt lengths + 16),
   beside the plain version, the
   ``scaled_dot_product_attention`` yardstick and the HBM bound, and the
   wall time per call of eager calls
   back to back (the host's share); the launch floor (a one-element add in
   the same harness); the three flash-attention kernels at the training shape
   beside their plain versions, SDPA's forward and backward kernels and
   their FLOP bounds, with the achieved TFLOP/s and the share of the
   bound; and the port's whole bf16 backward (dQ op, then dK/dV op)
   beside SDPA's backward kernel, both in CUDA graphs;
10. one greedy request through the server's ``run`` and one train step,
    each traced with ``torch.profiler``: device time against wall time
    (the busy share), device time by kernel (and flash decode's per
    call), and in the train step one
    delta pre-pass launch per layer (delta is computed once per
    backward);
11. ``serve_slots``: the server with ``--slots 8`` (the continuous-
    batching engine), launch counts reset: 8 concurrent greedy requests
    with prompt lengths from a seed over 5..700 and a seeded sampled
    request sent twice, launch counts read — every fleet step must have
    launched flash decode once per layer (a ragged batch: one length per
    lane); the sampled request must give the same tokens both times; the
    same requests one by one through the per-request path beside them
    (latency, the batch's wall time, aggregate decode tokens/s, and at
    bf16 the share of tokens that agree); an f32 engine at full width
    whose greedy and sampled tokens must equal per-request ``generate``'s;
    and fleet steps of eight live lanes, ten timed on the host clock and
    one traced (busy share, device time by kernel);
12. ``train_resume``: the trainer at its defaults with
    ``--checkpoint-dir``, 4 steps at an interval of 2, then a restart to
    step 6, its losses beside phase 8's unbroken 6 steps (exact, or
    within phase 8's bf16 tolerance, and which), the step times with and
    without a save; then the server with ``--checkpoint-dir`` there, whose
    weights must be the saved ones and whose greedy tokens must equal
    ``generate``'s on them;
13. ``profile_dir``: the trainer with ``--train-steps 21 --profile-dir``,
    then ``cmd/trace_summary.py`` on its trace — 11 traced steps, the
    forward kernel launched 2 x layers and each backward kernel layers
    times a step, the device time a step within 10% of phase 10's traced
    step, and the busy share;
14. ``serve_int8``: the server with ``--weights int8``, per request (4
    greedy prompts, beside the bf16 server on the original weights) and
    with ``--slots 8`` (8 concurrent prompts), launch counts reset and
    read around the two: decode latency, tokens/s and ``param_bytes``
    int8 against bf16; greedy tokens identical to a bf16 model on the
    dequantized weights (per request, and an engine fed the same
    submits), and the share agreeing with the bf16 server;
15. ``serve_chunked``: ``--prefill-chunk 256`` on prompts of 896..1024
    tokens, per request and with ``--slots 8``: TTFT and the prefill's
    peak memory, chunked against single-shot; request latency against the
    unchunked server; in f32, chunked logits within 1e-4 of single-shot's
    and identical greedy tokens;
16. ``serve_prefix``: ``--prefix-cache 4``, 8 requests behind one
    512-token ``prefix_ids`` with suffixes of 16..200 tokens, per request
    and with ``--slots 8``: hit/miss stats, the first (missing) request's
    latency against the later ones, a hit's TTFT against a cacheless
    prefill, the block unchanged after the requests; in f32, the tokens of
    the concatenated prompt, per request and through an engine;
17. ``serve_spec``: ``--speculative 4`` with a random 3-layer draft
    (acceptance ~0), then with the target's own weights saved by
    ``TrainCheckpointer`` as a 12-layer draft (``--draft-checkpoint-dir``,
    acceptance ~1), each per request and with ``--slots 8``: acceptance,
    tokens per round, latency against plain decode, a seeded sampled
    request that must repeat its tokens, and in f32 greedy tokens
    identical to ``generate``'s; flash decode must have run draft layers x
    (k + 1) times a round;
18. ``moe_parity``: the Switch MoE FFN (``ops/moe.py``) at the train
    shape (N 16,384, D 512, H 2,048, E 8, C 2,560; inputs and weights
    from a seed) on the card against the CPU — in f64 identical expert
    index and kept set, the output, aux loss and every gradient within
    1e-9 of the leaf's largest; in f32 with TF32 off the share of tokens
    routed differently (at most 1e-3) and the output error on the tokens
    routed alike; then the full-width MoE-LM (``--num-experts 8``), batch
    2 x 2048, flash kernels against dense attention: the f32 loss (aux
    term included) within 1e-4 relative, and the routes that differ;
19. ``train_moe``: the trainer's ``main`` at its defaults plus
    ``--num-experts 8`` for 6 steps, launch counts reset around it (the
    forward kernel 2 x layers x steps, each backward kernel layers x
    steps): finite losses, the aux loss and the share of tokens dropped
    per step, the steady step ms, tokens/s and peak memory; one step
    traced, device ms by kind (expert GEMMs, routing scatter/gather,
    attention, LM head and loss) and the busy share; then 4 steps with
    ``--checkpoint-dir`` at interval 2 and a restart to step 6, beside
    the unbroken losses (exact, or within 2e-2 relative, and which);
20. ``serve_moe``: the server with ``--num-experts 8`` (and phase 5's
    flags), per request (phase 5's four requests) and with ``--slots 8``
    (``serve_slots``' prompts), launch counts reset: flash decode exactly
    layers x decode steps; latency and decode tokens/s beside the dense
    server's on the same requests; in f32, per-request greedy tokens
    identical to ``generate``'s and the engine's to per-request
    ``generate``'s; ``--weights int8`` (``param_bytes``, tokens identical
    to a bf16 model on the dequantized weights); ``--speculative 4`` with
    its MoE draft (f32 tokens identical to ``generate``'s); and
    ``--checkpoint-dir`` on phase 19's checkpoint (the saved weights);
21. ``resnet_parity``: ResNet-50 at full width, 224x224, batch 8 (seed-0
    weights, every BatchNorm value drawn from the seed) on the card
    against the same model on the CPU: eval logits in f32 with TF32 off
    (1e-4 of the largest); one train step in f64 (loss 1e-9 relative,
    every gradient and running statistic 1e-6 of its leaf's largest) and
    in f32 (loss 1e-4, running statistics 1e-4, and the card's gradients
    no more than 2x as far from the f64 ones as the CPU's: this step's
    f32 gradients are ill-conditioned), no parameter moved by step 0 (lr
    0); bf16 eval logits against f32's: top-1 agreement and the largest
    difference;
22. ``train_resnet``: ``cmd/train_resnet.py``'s ``main`` at its defaults
    (ResNet-50, batch 128, 224x224, bf16, channels_last) for 30 steps
    with ``--profile-dir`` (steps 10-20 traced, read by
    ``cmd/trace_summary.py``) and ``--model-dir``: finite losses, step ms
    and images/s outside the traced window, peak memory, the busy share
    and the top kernels, FLOPs an image counted from the model's shapes
    and the share of the card's bf16 peak; then ``--model inception-v3``
    at 299x299 for 6 steps;
23. ``train_resnet_resume``: 12 steps unbroken against a run with
    ``--checkpoint-dir`` SIGTERMed in step 5 (exit 80, a checkpoint at 6)
    and restarted, with cuDNN's default algorithms and with
    ``torch.backends.cudnn.deterministic`` — exact or within 2e-2
    relative, and which, and the step ms of each;
24. ``serve_resnet``: ``cmd/serve_resnet.py`` behind a real HTTP server,
    20 requests each of ``{"batch": 1}`` and ``{"batch": 8}`` (latency),
    predictions equal to a direct eval forward and to an ``inputs``
    request of the same array, then ``--model-dir`` from phase 22 (the
    saved params, the initial running statistics); phases 21-24 launch
    none of the port's kernels (every counter checked unchanged);
25. ``nccl``: a world-size-1 NCCL group on the card
    (``parallel/dcn.py::initialize``): NCCL's version, one
    ``all_reduce``, ``all_gather_into_tensor`` and
    ``reduce_scatter_tensor`` of 4 MiB, each checked, and their ms;
25a. ``collectives``: ``collectives/bench.py``'s ``main`` (the NCCL
    sweep, nccl-tests' loop) at world 1 on that group for all_reduce,
    all_gather, reduce_scatter and the ring shift, 1M-64M: exit 0, the
    verdict file's keys (the JAX rig's) and values, every ``size_bytes``
    the per-rank accounting, time_us and algbw (busbw is 0 at n = 1 by
    nccl-tests' factors); then one ``--percentiles`` run (all_reduce,
    1M-4M): p50 and p99 a size, one ``bench.iter`` span a round, and
    the ``bench.all_reduce`` histogram's count; every run with
    ``DCN_UDS_DIR`` at a port ``PyXferd``, whose ``stats`` for
    ``bench-<op>`` must count the sweep's bytes
    (``DcnBenchAccounting``), as must its total;
26. ``mesh_train``: ``cmd/train_lm.py`` at its defaults on the (1, 1)
    mesh with DTensor weights, 6 steps each: its loop through
    ``make_lm_train_step(create_mesh(1, 1), ..., "megatron")``, then
    ``main`` with ``--param-sharding fsdp``; launch counts reset around
    each (the flash kernels as in phase 8): losses bit-equal to phase
    8's, step ms, tokens/s and peak memory beside phase 8's;
27. ``mesh_resume``: 4 steps on the (1, 1) mesh under fsdp with
    ``--checkpoint-dir``, then the plain single-GPU trainer resumed from
    that checkpoint to step 6: losses bit-equal to phase 8's;
28. ``mesh_resnet``: ``models/train.py::make_sharded_train_step`` on the
    (1, 1) mesh against ``train_step``, ResNet-50 at 224x224 from the
    seed-0 weights: f32 with TF32 off at batch 32, 4 steps at lr 0.01
    (losses within 1e-5 relative, running statistics 1e-4), bf16 at
    batch 128 on the default schedule (losses 1e-4, statistics 2e-3)
    with both step times; each loss bound at least 10x below how far
    the updates moved the loss;
28a. ``mesh_conv_shards``: for every distinct convolution shape of
    ResNet-50 at batch 128 (224x224, channels_last) and for its 2048 ->
    1000 head, at M = 2 and 4, each model rank's local product
    (``models/resnet.py::conv_same``, ``conv_channel_slice`` /
    ``Dense._linear``, what ``Conv`` and ``Dense`` run on a mesh) in one
    process, combined as the
    collective would (output-channel shards concatenated, input-channel
    partial sums added in the dtype) against the whole product, in bf16
    (1e-2 of the largest |y|) and in f32 with TF32 off (1e-5; the head in
    f32 only, as both models compute it); rank 0's shard's ms beside the
    whole product's (CUDA events), per shape and summed over the model's
    convolutions;
28b. ``mesh_inception``: phase 28 for Inception-v3 at its published
    widths (299x299, 1000 classes): f32 at batch 32, its losses held
    before the first update (its f32 train-mode gradients are
    ill-conditioned in both steps), four steps in f64 at batch 8 (losses
    within 1e-9, statistics 1e-6: resnet_parity's f64 bounds), bf16 at
    128 (losses and statistics within 2e-2, the other bf16 phases'
    bound: its step ms);
29. ``mesh_serve``: ``cmd/serve_lm.py``'s ``build_generate(args,
    create_mesh(1, 1))`` and ``start_engine`` at phase 5's
    flags on the (1, 1) mesh against the plain server: one 64-token
    prompt's 16-token greedy request (latency, twice) and
    ``serve_slots``' 8 prompts through ``--slots 8`` (batch wall time,
    once), identical greedy tokens and flash decode launches; then the
    f32 greedy tokens (8, after a 300-token prompt) of a TP-sharded
    decode model equal to the plain model's;
30. ``seq_ring_blocks``: ring attention's blocks on the flash kernels
    (``parallel/seq.py::ring_forward_step`` / ``ring_backward_step``),
    every virtual rank composed in one process at B=2, T=2048, H=8,
    D=64, causal, bf16 and f32: contiguous at n = 2 and 4, zigzag at
    n = 2, 4 and 8 (a zigzag half of 128 rows); o, dq, dk and dv against
    ``flash_attention`` over the whole sequence on the card (phase 6's
    tolerances), the gap to the plain per-block ring in f32 (held at f32
    tolerance in f32), every kernel launched once a non-skipped block
    (``count_ring_blocks``), and in bf16 the busiest virtual rank's and
    the critical path's ms, contiguous over zigzag beside
    ``ring_skip_stats``' predicted ratio;
31. ``seq_train``: the trainer's ``main`` at its defaults with
    ``--seq-parallel ring``, ``ring-zigzag`` and ``ulysses`` for 6 steps
    each on phase 25's one-rank NCCL group, launch counts reset around
    each (ring: phase 8's counts times a rank's blocks, 1 contiguous, 3
    zigzag; Ulysses none): losses within 2e-2 relative of phase 8's,
    step ms, tokens/s and peak memory beside phase 8's;
32. ``seq_resume``: ``--seq-parallel ring-zigzag`` with
    ``--checkpoint-dir``, 4 steps at an interval of 2 and a restart to
    step 6: losses bit-equal to phase 31's unbroken run;
32a. ``pipeline``: the trainer's default blocks (12 layers, 8 x 64
    heads, mlp 2048, flash attention) as the layer of
    ``parallel/pipeline.py``'s GPipe schedule at one stage and 4
    microbatches of a [8, 2048, 512] bf16 batch: output and every
    gradient bit-equal to the blocks applied in order, flash launches
    12 x 4 each kernel;
32b. ``expert_parallel``: ``MoEFFN`` at full width (E 8, D 512, F 2048)
    expert-sharded on the (1, 1) mesh against the unsharded layer on
    16,384 tokens: output, aux, drop share and gradients bit-equal;
32c. ``mesh_train_moe``: the trainer at its defaults plus
    ``--num-experts 8`` on the (1, 1) mesh under megatron and fsdp:
    losses and drop shares bit-equal to phase 19's, flash launches
    exact, step ms;
32d. ``mesh_serve_features``: the server with the MoE-LM, int8 weights
    and the prefix cache on the (1, 1) mesh against the plain server,
    per request and with ``--slots 8``: identical greedy tokens, one
    prefix miss and the rest hits on every server;
32e. ``dryrun``: ``entry.dryrun_multichip(1)``: the nine regimes of the
    JAX dry run on the card;
33. ``nvml``: ``gpulib/nvml.py``'s ``NvmlLib`` against the card: the
    device count equals torch's and nvidia-smi's; each device's name,
    UUID, PCI bus id and total memory equal nvidia-smi's (and torch's,
    where the machine does not redact them), its ``/dev/nvidia<minor>``
    exists; the ``sizeof`` and ``offsetof`` of every ctypes struct equal a
    C program's built with g++ on the toolkit's ``nvml.h``; MIG mode; Xid
    registration on every device; the microseconds of a memory and a duty
    cycle read;
34. ``nvml_load``: a child holds 8 GiB and runs bf16 matmuls: duty cycle
    at least 80 and memory up by at least 8 GiB while it runs, duty cycle
    at most 10 and memory back a few seconds after, each reading beside
    nvidia-smi's at the same moment;
35. ``device_plugin``: ``cmd/gpu_device_plugin.py`` as a subprocess on the
    real ``/dev`` and NVML with a kubelet stub and a PodResources stub
    that gives the first GPU to one container: it registers
    ``nvidia.com/gpu``, ListAndWatch lists exactly NVML's GPUs as
    ``nvidia<minor>``, all Healthy, Allocate returns the GPU's node, the
    control nodes and the driver mount, an unknown ID is refused, and
    ``/metrics`` serves the node and container gauges; the seconds to
    register and the milliseconds to the first ListAndWatch and per
    Allocate;
36. ``xid``: Xid registration, then the daemon's health state machine
    through its fault file (this machine delivers no Xid: see
    ``XID_INJECTION``): the GPU goes Unhealthy on ListAndWatch, Allocate
    refuses it, and it is Healthy again after the 10 s recovery window;
37. ``node_faults``: the daemon armed with ``NODE_FAULT_SPEC`` registers
    on its second attempt (seconds beside phase 35's unarmed start), its
    checker rides the dropped event wait and the fault file still turns
    the GPU Unhealthy, ``/metrics`` counts each ``fault.fired.<site>``;
    ``MetricServer.rebind`` moves the listener and the gauges read the
    same; the Xid watch list (a hot-added GPU needs a second card);
38. ``mig``: MIG mode from NVML and nvidia-smi, ``nvidia-smi mig -lgip``
    and ``/proc/driver/nvidia``; the daemon with ``GPUPartitionSize`` on
    this MIG-off card refuses, naming the GPU and the path, and
    advertises nothing; ``cmd/partition_gpu.py`` behind ``MIG_SHIM``
    (read-only queries pass, every other command is recorded and
    refused) reads the card's state and issues exactly ``-i 0 -mig 1``,
    exits 1 and writes no state; the card's MIG mode is never changed;
39. ``maintenance``: ``cmd/maintenance_watcher.py --once`` against local
    metadata and API server stubs, armed with one ``k8s.patch`` conflict:
    the node tainted beside its foreign taint, every GPU Unhealthy on the
    daemon's ListAndWatch (``XID_CONFIG`` names the maintenance code),
    the milliseconds from the fault-file line to Unhealthy; ``NONE``
    removes the taint;
40. ``mps``: the daemon under ``mps`` advertises nothing while no MPS
    daemon answers; with NVIDIA's MPS control daemon on a private pipe
    directory it advertises ``nvidia<minor>/vgpu0..1`` and Allocate
    gives the node, the pipe mount, 50% of the threads and half of
    NVML's memory; a child run with those envs (``MPS_CLIENTS``); once
    the MPS daemon quits, Allocate is refused; no MPS process is left;
41. ``node_nri``: the NRI device injector (``nri/plugin.py``) against an
    in-process fake runtime on a real unix socket: it registers and
    subscribes to CreateContainer only; a container annotated with what
    the device plugin Allocates for the first GPU (its node,
    ``CONTROL_DEVICES`` and the ``OPTIONAL_DEVICES`` present) gets
    exactly those paths, type ``c`` at ``os.stat``'s major and minor; a
    path that does not exist fails the container; the runtime closes its
    trunk once and the plugin registers again (``nri.reconnect`` 1); the
    registration ms and the median CreateContainer round trip in µs;
42. ``node_scheduler``: ``cmd/label_nodes.py --once`` for each node of a
    16-node fleet (2 clusters x 2 racks x 4 hosts, 8 GPUs a node but the
    one named for this machine, which carries NVML's count), against
    metadata and API servers in process over HTTP: the PATCHed labels are
    ``compute_labels``'; then ``cmd/topology_scheduler.py --once
    --settle-seconds 0`` with two gated jobs (4 pods x 8 GPUs, then 2 x
    1): every gate removed, every pod pinned by nodeAffinity, and the
    first job on the set a plain ``itertools.combinations`` search over
    the same sorted nodes finds closest (C(16, 4) = 1820 sets); the
    pass's ms;
42a. ``node_obs``: the daemon with ``TPU_TRACE_FILE`` and
    ``TPU_FLIGHT_FILE`` (``obs/``): 100 Allocates give
    ``agent_latency{op="plugin.allocate"}`` a count of at least 100 and
    its worst bucket's ``agent_exemplar`` trace is found in ``/spans``; a
    fault-file line and its clear take a GPU to Unhealthy and back,
    leaving ``health.fault_file`` and ``health.recover`` spans and a
    ``health.recovery`` observation; ``/spans`` pages twice by cursor with
    none dropped and ``/profile`` shows samples and subsystem shares;
    ``kill -USR1`` leaves one flight blob with spans, counters and
    histograms; the port's ``agent_trace`` (summary, and the fault's
    trace as a tree), ``agent_top --once --port`` and ``agent_prof
    --port`` exit 0 on it.  Numbers: the Allocate median and p99 in µs
    from the client and from the buckets, µs a span in this process (ring
    only, then with the JSONL sink; median of 10,000), ms and bytes of a
    ``/metrics`` scrape and of a full ``/spans`` page, the daemon's
    ``prof.overhead_ratio``, the flight blob's bytes;
42b. ``dcn_xfer``: the cross-node leg of a collective on a GPU node.
    Two ranks (spawned processes, gloo through
    ``parallel/dcn.py::initialize(device="cpu")``), each with half of
    the f32 parameters of ``cmd/train_lm.py``'s default model (seed 0)
    on ``cuda:0`` and its own port ``PyXferd`` on loopback: the shard
    to the host, ``exchange_shard`` with ``barrier=dist.barrier``, the
    peer's bytes back to the card by ``torch.frombuffer(...).to``, the
    sum on the card — bit-equal to gloo's ``all_reduce`` of the host
    copies — in the serial lane, the socket pipeline (``TPU_DCN_SHM=0``,
    ``TPU_DCN_SHM_DIRECT=0``) and the default lane, then serially
    between two native daemons (``native/dcnxferd``, built here at first
    use; no ``wait`` op, so the poll path); the ms and GB/s of the
    device-to-host copy (pageable and pinned), each lane's whole
    ``exchange_shard`` and its ``dcn.exchange.*`` spans, and the
    host-to-device copy; the ``dcn.lane.{shm_direct,shm,socket}`` byte
    counters and ``dcn.exposed_ratio`` of each lane; then the port's
    ``cmd/dcn_bench.py --producer --ring-socket --tuned`` (64K-64M, 5
    iterations, every transfer byte-exact): each mode's best GB/s and
    exposed ratio at 64M, and the memcpy ceiling; phases 33-42b launch
    none of the port's kernels;
43. the ``{"kernels": [...]}`` summary line (flash decode's launches: the
    ``serve`` and ``serve_slots`` phases' and phases 14-17', 20's and
    29's; flash attention's: the ``train``, ``train_moe``,
    ``mesh_train``, ``seq_train``, ``seq_resume``, ``pipeline``,
    ``mesh_train_moe`` and ``dryrun`` phases').

Each phase's seconds follow it on a ``timing`` line.  The last line is
``{"ok": true, "device": {...}}``.  Any failure raises
and the exit code is non-zero; without CUDA the script exits 2 before
printing any result.  Run from the repository root:

    python3 chip_smoke.py
"""

import ast
import json
import math
import os
import signal
import statistics
import subprocess
import sys
import tempfile
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
FA_CSRC = "container_engine_accelerators_tpu_torch/ops/csrc"
FA_TPU = "container_engine_accelerators_tpu/ops/flash_attention.py"
# Flash-attention kernels: counter name -> (TPU kernel line, matrix
# products per (query, key) pair of D multiply-adds each, the source of
# the kernel a bf16 call at the training shape runs).
FA_KERNELS = {
    "flash_attention_fwd": (f"{FA_TPU}:67", 2,
                            f"{FA_CSRC}/flash_attention_sm90.cu"),
    "flash_attention_bwd_dq": (f"{FA_TPU}:160", 3,
                               f"{FA_CSRC}/flash_attention_sm90.cu"),
    "flash_attention_bwd_dkv": (f"{FA_TPU}:220", 4,
                                f"{FA_CSRC}/flash_attention_sm90.cu")}
# (atol = rtol) forward, backward: the JAX kernels' tests' tolerances.
FA_TOL = {"float32": (2e-5, 2e-4), "bfloat16": (2e-2, 1e-1)}
TRAIN_STEPS = 6
TRAIN_SHAPE = (8, 2048, 8, 64)  # the trainer's defaults: B, T, H, D
SLOTS = 8
SLOTS_SEED = 6  # prompt lengths and tokens of the serve_slots phase
# The profile_dir phase: the trainer's traced window is steps 10-20.
PROFILE_STEPS = 21
TRACED_STEPS = 11
HERE = os.path.dirname(os.path.abspath(__file__))


def _phase(phase, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def _name(dtype):
    return str(dtype).replace("torch.", "")


def _agrees(got, want, dtype, tol=None):
    """(max |got - want|, that over max |want|), or AssertionError past
    atol = rtol = ``tol`` (default: flash decode's for ``dtype``) and, in
    bf16, past BF16_ERR_TO_MAX of max |want|."""
    import torch

    err = (got.float() - want.float()).abs().max().item()
    to_max = err / max(want.float().abs().max().item(), 1e-30)
    tol = TOL[_name(dtype)] if tol is None else tol
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


def bwd_cast_inputs(dev, t=2048, heads=8, head_dim=64):
    """tests/flash_decode_inputs.py's designed backward inputs (q, k, v,
    o, do in bf16, lse f32, on the card; batch 1, non-causal, scale 1/8):
    query rows of kinds i % 4, P = 1 on kinds 0-1 and exp(-41/4096) =
    0.99004 (bf16: 0.98828) on kinds 2-3, dO = +1 / -1 on them, so every
    element of dV is (T/2)(1 - P): 0.01172 T/2 with P cast to bf16,
    0.00996 T/2 without; V = 0 and O chosen so that dS on kind-1 rows is
    0.12366 (bf16: 0.12354), and dK's first column is (T/4)(dS - 1/8):
    -0.0014648 T/4 with dS cast, -0.0013428 T/4 without.  Every product
    and sum is exact in f32 in any order.  Also returns the same inputs in
    f32, for the control."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(8)
    scale = head_dim ** -0.5
    shape = (1, t, heads, head_dim)
    kind = (torch.arange(t, device=dev) % 4)[None, :, None]
    a_rows = kind < 2
    q = torch.zeros(shape, device=dev)
    q[..., 0] = a_rows.float()
    q[..., 1] = (~a_rows).float()
    k = torch.round(torch.randn(shape, device=dev, generator=gen) * 32) / 32
    k[..., 0] = 0.0
    k[..., 1] = -41 / 4096 / scale
    v = torch.zeros(shape, device=dev)
    o = torch.zeros(shape, device=dev)
    o[..., 0] = torch.where(kind == 0, 1.0, torch.where(kind == 1, -253 / 256,
                                                        0.0))
    o[..., 1] = torch.where(kind == 1, -2.0 ** -10, 0.0)
    do = torch.where(a_rows, 1.0, -1.0)[..., None].expand(shape).contiguous()
    lse = torch.zeros(heads, t, device=dev)
    f32 = (q, k, v, o, lse, do)
    return tuple(x if x is lse else x.bfloat16() for x in f32), f32


def dq_cast_inputs(dev, t=2048, heads=8, head_dim=64):
    """tests/flash_decode_inputs.py's designed dQ inputs (q, k, v, o, do
    in bf16, lse f32, on the card; batch 1, non-causal, scale 1/8): every
    query row q = e0, keys of two kinds by parity with scores 0 and
    -41/4096 (lse = 0: P = 1 and 0.99004), V = 0 and delta = -1, so dS is
    1/8 and 0.123755 (bf16: 0.123535), and with K's second column +1 / -1
    dQ[..., 1] is (T/2)(1/8 - dS_odd): 0.0014648 T/2 with dS cast to bf16,
    0.0012450 T/2 without.  Also returns the same inputs in f32."""
    import torch

    scale = head_dim ** -0.5
    shape = (1, t, heads, head_dim)
    odd = (torch.arange(t, device=dev) % 2 == 1)[None, :, None]
    q = torch.zeros(shape, device=dev)
    q[..., 0] = 1.0
    k = torch.zeros(shape, device=dev)
    k[..., 0] = torch.where(odd, -41 / 4096 / scale, 0.0)
    k[..., 1] = torch.where(odd, -1.0, 1.0)
    v = torch.zeros(shape, device=dev)
    o = torch.zeros(shape, device=dev)
    o[..., 0] = -1.0
    do = torch.ones(shape, device=dev)
    lse = torch.zeros(heads, t, device=dev)
    f32 = (q, k, v, o, lse, do)
    return tuple(x if x is lse else x.bfloat16() for x in f32), f32


def check_kernel(fd, dev):
    """Phase 3: the kernel against the plain version on the card."""
    import torch

    from container_engine_accelerators_tpu_torch.cmd import serve_lm

    args = serve_lm.parse_args(SERVE_FLAGS)
    gen = torch.Generator(device=dev).manual_seed(0)
    # (batch, cache length, KV heads, heads, head dim, lengths or None for
    # 1 / mid / full / random).  First the server's own calls (batch 1,
    # its heads), then GQA groups 1-16, head dims 40-256 (40: 80-byte rows
    # through TMA in bf16), rows that are not whole 16-byte chunks (bf16
    # D 20 and 255, f32 D 6 and 255: plain loads), few keys a CTA (batch
    # 2 at a 32-slot cache), many row blocks (batch 64: 2 CTAs each), and
    # batch 16 at G 8 and 12, where the plan keeps 8- (f32: 16-) row CTAs;
    # at batch 3 and one or two KV heads it takes one row a CTA.
    serving = serving_shapes(args.max_new_tokens, args.max_prompt_len)
    cases = [(1, c, args.kv_heads or args.num_heads, args.num_heads,
              args.head_dim, [n]) for c, lens in serving for n in lens]
    cases += [(3, 1056, kvh, 8, hd, None) for kvh in (8, 4, 2, 1)
              for hd in (64, 128)]
    cases += [(3, 1056, 1, 16, 64, None), (3, 1056, 2, 8, 256, None),
              (3, 1056, 2, 6, 40, None), (2, 32, 8, 8, 64, None),
              (64, 256, 8, 8, 64, None), (3, 1056, 2, 8, 20, None),
              (3, 300, 1, 6, 6, None), (3, 130, 1, 2, 255, None),
              (16, 256, 2, 16, 64, None), (16, 256, 1, 12, 40, None)]
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
        # NaN tail right after a length that is not tile-aligned: TMA
        # boxes bring some of it into shared memory, and none of it may
        # reach the output.
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


def check_kernel_launch(fd, dev):
    """Phase 3b: what the one-launch design promises.  Length 0 gives NaN
    (0/0, as the plain version) and a length past the cache counts as the
    cache; at the server's shape with length 1 the widest split leaves 7
    of 8 CTAs of every cluster without a key; a cache off a 16-byte
    boundary (no TMA map) agrees with the plain version; a CUDA graph of
    one call replays twice to the eager call's bits; and one call is one
    kernel on the device."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator(device=dev).manual_seed(13)
    checked = []
    for dtype in (torch.float32, torch.bfloat16):
        for b, cache_len, lens in ((4, 1056, [0, 1056 + 9, 1, 17]),
                                   (1, 1056, [1]), (1, 4096, [4096])):
            q, k, v = (torch.randn(shape, device=dev, generator=gen).to(dtype)
                       for shape in ((b, 8, 64), (b, cache_len, 8, 64),
                                     (b, cache_len, 8, 64)))
            lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
            want = fd.flash_decode_reference(q, k, v, lengths)
            live = lengths > 0
            got = fd.flash_decode(q, k, v, lengths)
            torch.cuda.synchronize()
            if not (torch.isnan(got[~live]).all()
                    and torch.isnan(want[~live]).all()):
                raise AssertionError(f"length 0 did not give NaN "
                                     f"({_name(dtype)})")
            _agrees(got[live], want[live], dtype)
            checked.append({"dtype": _name(dtype), "B": b, "L": cache_len,
                            "lengths": lens, "rows_splits": fd.plan(q, k, v)})
    if checked[1]["rows_splits"] != (1, 8):  # one-row CTAs, widest cluster
        raise AssertionError(f"serving shape at length 1: {checked[1]} "
                             f"is not the widest split")
    # A cache one element into its storage: off 16 bytes, no TMA map.
    q = torch.randn((2, 8, 64), device=dev, generator=gen).bfloat16()
    k, v = (torch.randn(2 * 1056 * 8 * 64 + 1, device=dev, generator=gen)
            .bfloat16()[1:].view(2, 1056, 8, 64) for _ in range(2))
    lengths = torch.tensor([731, 1056], dtype=torch.int32, device=dev)
    got = fd.flash_decode(q, k, v, lengths)
    torch.cuda.synchronize()
    _agrees(got, fd.flash_decode_reference(q, k, v, lengths), torch.bfloat16)
    # Graph replays at the server's shape.
    q, k, v = (torch.randn(shape, device=dev, generator=gen).bfloat16()
               for shape in ((1, 8, 64), (1, 1056, 8, 64), (1, 1056, 8, 64)))
    lengths = torch.tensor([731], dtype=torch.int32, device=dev)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        eager = fd.flash_decode(q, k, v, lengths)
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fd.flash_decode(q, k, v, lengths)
    outs = []
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        outs.append(out.clone())
    if not (torch.equal(outs[0], outs[1]) and torch.equal(outs[0], eager)):
        raise AssertionError("graph replays of flash_decode differ from each "
                             "other or the eager call")
    del graph
    # One call, one kernel.
    fd.flash_decode(q, k, v, lengths)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fd.flash_decode(q, k, v, lengths)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    if len(names) != 1 or "flash_decode_kernel" not in names[0]:
        raise AssertionError(f"one flash_decode call ran {names} on the "
                             f"device, expected one flash_decode_kernel")
    _phase("kernel_launch", edge_cases=checked, unaligned_cache="agrees",
           graph_replay="2 replays identical to the eager call",
           device_kernels_per_call=len(names), kernel=names[0][:90])


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


def serve_requests(vocab):
    """Phase 5's requests, (name, body) in order: PROMPT_LENS' prompts
    drawn from seed 0, greedy but for the seeded sampled one."""
    import numpy as np

    rng = np.random.default_rng(0)

    def ids(n):
        return rng.integers(0, vocab, n).tolist()

    sampling = {"greedy_5": {"temperature": 0}, "greedy_700": {"temperature": 0},
                "batch_3": {}, "sampled": {"temperature": 0.8, "seed": 1234}}
    return [(name, {"prompt_ids": [ids(n) for n in lens], **sampling[name]})
            for name, lens in PROMPT_LENS.items()]


def serve(fd):
    """Phase 5: the main path — the server as main() wires it."""
    from http.server import ThreadingHTTPServer

    from container_engine_accelerators_tpu_torch.cmd import serve_lm

    args = serve_lm.parse_args(SERVE_FLAGS + ["--port", "0"])
    serve_lm.validate_args(args)
    for name in fd.LAUNCHES:
        fd.LAUNCHES[name] = 0
    run = serve_lm.build_generate(args)
    srv = ThreadingHTTPServer(("127.0.0.1", 0), serve_lm.make_handler(run, args))
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    requests = serve_requests(args.vocab_size)
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


def _traced(fn):
    """(device ms, wall ms, device ms by kernel name, launches by kernel
    name) of ``fn()`` — which must end synchronized — traced by
    torch.profiler (device activity only: kernels, copies)."""
    from collections import Counter, defaultdict

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name, count = defaultdict(float), Counter()
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] += e.time_range.elapsed_us() / 1e3
            count[e.name] += 1
    if not by_name:
        raise AssertionError("the profiler recorded no device activity")
    return sum(by_name.values()), wall_ms, by_name, count


def profile_request(run):
    """Phase 10 for serving: where one greedy request's time goes —
    device activity against the request's wall time under the same
    tracing."""
    import torch

    prompt = torch.randint(0, 32000, (1, 8), generator=torch.Generator().manual_seed(3))
    run(prompt, 5, 0.0, 0, False)
    device_ms, wall_ms, by_name, count = _traced(
        lambda: run(prompt, 5, 0.0, 0, False))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    fd_ms = sum(v for k, v in by_name.items() if "flash_decode" in k)
    fd_calls = sum(v for k, v in count.items() if "flash_decode" in k)
    _phase("profile", request="greedy, 5-token prompt (bucket 8), 32 new",
           wall_ms=wall_ms, device_ms=device_ms,
           device_busy_share=device_ms / wall_ms,
           flash_decode_ms=fd_ms, flash_decode_launches=fd_calls,
           flash_decode_ms_per_call=fd_ms / max(fd_calls, 1),
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


def time_kernel(fd, dev, cache_len, lengths, heads=8, kv_heads=8,
                head_dim=64):
    """Phase 9 for flash decode at one shape (bf16, the serving dtype; one
    sequence per entry of ``lengths``), beside the plain version, SDPA and
    the bound."""
    import torch
    import torch.nn.functional as F

    dtype = torch.bfloat16
    batch = len(lengths)
    gen = torch.Generator(device=dev).manual_seed(2)
    per_input = 2 * batch * cache_len * kv_heads * head_dim * 2
    n_inputs = max(4, math.ceil(2.5 * L2_BYTES / per_input))
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    inputs = [tuple(torch.randn(shape, device=dev, generator=gen).to(dtype)
                    for shape in ((batch, heads, head_dim),
                                  (batch, cache_len, kv_heads, head_dim),
                                  (batch, cache_len, kv_heads, head_dim)))
              + (lens,) for _ in range(n_inputs)]
    q, k, v, _ = inputs[0]
    want = fd.flash_decode_reference(q, k, v, lens)
    err, _ = _agrees(fd.flash_decode(q, k, v, lens), want, dtype)
    mask = (torch.arange(cache_len, device=dev)[None, :]
            < lens[:, None])[:, None, None, :]

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
    # visible K/V rows are needed), the output written once.
    visible = sum(lengths)
    nbytes = (2 * batch * heads * head_dim * 2 + 4 * batch
              + 2 * visible * kv_heads * head_dim * 2)
    flops = 4 * heads * head_dim * visible
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / PEAK_FLOPS["bfloat16"] * 1e3
    spread = (f"length={lengths[0]}" if batch == 1 else
              f"lengths {min(lengths)}..{max(lengths)} (sum {visible})")
    row = {"shape": f"B={batch} H={heads} KVH={kv_heads} D={head_dim} "
                    f"L={cache_len} {spread} bf16",
           "rows_splits": fd.plan(q, k, v), "distinct_inputs": n_inputs,
           "max_abs_err": err, "ms": ms,
           "plain_ms": plain_ms, "library_ms": library_ms,
           "eager_ms": eager_ms, "bound_ms": max(bytes_ms, ops_ms),
           "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
           "share_of_bound": max(bytes_ms, ops_ms) / ms,
           "bytes": nbytes, "flops": flops}
    _phase("kernel_time", **row)
    return row


def launch_floor(dev):
    """Phase 9: the device time of the smallest kernel in the same graph
    harness (an in-place add to one element): the part of a decode call's
    time that no kernel design can remove."""
    import torch

    inputs = [(torch.zeros(1, device=dev),) for _ in range(64)]
    ms = _graph_ms(lambda x: x.add_(1), inputs)
    _phase("launch_floor", what="x.add_(1) on one f32 element, one CUDA "
           "graph of 64 calls", ms=ms)
    return ms


def _fa_case(fa, q, k, v, do, causal):
    """Every flash-attention kernel once at (q, k, v, do) against its
    plain version: {output: (max abs err, err over max |output|)}, and
    the same for the plain math with p and dS kept in f32 (the control
    a cast the kernel forgot would look like), in bf16."""
    import torch

    dtype = q.dtype
    scale = q.shape[-1] ** -0.5
    fwd_tol, bwd_tol = FA_TOL[_name(dtype)]
    o, lse = fa.flash_forward(q, k, v, causal, scale)
    grads = fa.flash_backward(q, k, v, o, lse, do, causal, scale)
    torch.cuda.synchronize()
    want_o, want_lse = fa.flash_attention_reference(q, k, v, causal)
    want = fa.flash_attention_bwd_reference(q, k, v, o, lse, do, causal)
    errs = {"o": _agrees(o, want_o, dtype, fwd_tol),
            "lse": _agrees(lse, want_lse, torch.float32, 2e-5)}
    for name, got, ref in zip(("dq", "dk", "dv"), grads, want):
        errs[name] = _agrees(got, ref, dtype, bwd_tol)
    control = {}
    if dtype == torch.bfloat16:
        f32 = [x.float() for x in (q, k, v, o, lse, do)]
        ctrl_o, _ = fa.flash_attention_reference(*f32[:3], causal)
        ctrl = fa.flash_attention_bwd_reference(*f32, causal)
        for name, got, c, ref in zip(("o", "dq", "dk", "dv"), (o,) + grads,
                                     (ctrl_o,) + ctrl, (want_o,) + want):
            diff = (got.float() - c.to(dtype).float()).abs().max().item()
            control[name] = diff / ref.float().abs().max().item()
    return errs, control


def check_fa_kernels(fa, dev):
    """Phase 6: every flash-attention kernel against its plain version."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(11)
    shapes = [(1, 128, 1), (4, 128, 16), (2, 256, 3), (8, 256, 8),
              (1, 2048, 1), (2, 2048, 4)]  # (B, T, H): B*H 1 to 64
    cases = [(b, t, h, d, causal, dtype)
             for dtype in (torch.float32, torch.bfloat16)
             for causal in (False, True) for d in (64, 128, 256)
             for b, t, h in shapes]
    b, t, h, d = TRAIN_SHAPE
    cases += [(b, t, h, d, True, dtype)
              for dtype in (torch.float32, torch.bfloat16)]
    worst, worst_to_max = {}, {}
    control = {}
    for b, t, h, d, causal, dtype in cases:
        q, k, v, do = (torch.randn(b, t, h, d, device=dev, generator=gen)
                       .to(dtype) for _ in range(4))
        try:
            errs, ctrl = _fa_case(fa, q, k, v, do, causal)
        except AssertionError as e:
            raise AssertionError(f"flash attention kernel != plain at B={b} "
                                 f"T={t} H={h} D={d} causal={causal} "
                                 f"{_name(dtype)}: {e}") from None
        key = _name(dtype)
        for name, (err, to_max) in errs.items():
            worst.setdefault(key, {})[name] = max(
                worst.get(key, {}).get(name, 0.0), err)
            if dtype == torch.bfloat16:
                worst_to_max[name] = max(worst_to_max.get(name, 0.0), to_max)
        for name, to_max in ctrl.items():
            control[name] = max(control.get(name, 0.0), to_max)
    # The forward's p cast, on the designed inputs with every query row
    # the decode query (non-causal, T = 2048).
    q, k, v = p_cast_inputs(dev, cache_len=2048)
    q = q[:, None].expand(1, 2048, *q.shape[1:]).contiguous()
    got = fa.flash_forward(q, k, v, False, 0.125)[0].float()
    torch.cuda.synchronize()
    want = fa.flash_attention_reference(q, k, v)[0].float()
    p_in_f32 = fa.flash_attention_reference(
        q.float(), k.float(), v.float())[0].to(torch.bfloat16).float()
    rel = {name: ((x - got).abs() / got.abs()).max().item()
           for name, x in (("plain", want), ("p_in_f32", p_in_f32))}
    if not (rel["plain"] <= 2 ** -7 < rel["p_in_f32"]):
        raise AssertionError(f"flash attention p-cast check: max relative "
                             f"difference of the kernel to {rel} (bound "
                             f"2**-7: one bf16 step)")
    p_cast = {"kernel_output": got.max().item(), "max_rel_diff": rel,
              "bound": 2 ** -7}
    # The backward's casts, on designed inputs at T = 2048: P and dS in
    # dK/dV, dS in dQ.
    bf16, f32 = bwd_cast_inputs(dev)
    q, k, v, o, lse, do = bf16
    dk, dv = fa.load_ops().flash_attention_bwd_dkv(q, k, v, o, do, lse, False,
                                                   0.125)
    _, want_dk, want_dv = fa.flash_attention_bwd_reference(*bf16)
    _, ctrl_dk, ctrl_dv = fa.flash_attention_bwd_reference(*f32)
    bf16, f32 = dq_cast_inputs(dev)
    q, k, v, o, lse, do = bf16
    dq, _ = fa.load_ops().flash_attention_bwd_dq(q, k, v, o, do, lse, False,
                                                 0.125)
    torch.cuda.synchronize()
    want_dq = fa.flash_attention_bwd_reference(*bf16)[0]
    ctrl_dq = fa.flash_attention_bwd_reference(*f32)[0]
    bwd_cast = {}
    for name, got, want, ctrl in (
            ("dk_col0", dk[..., 0], want_dk[..., 0], ctrl_dk[..., 0]),
            ("dv", dv, want_dv, ctrl_dv),
            ("dq_col1", dq[..., 1], want_dq[..., 1], ctrl_dq[..., 1])):
        got = got.float()
        rel = {"plain": ((want.float() - got).abs() / got.abs()).max().item(),
               "p_and_ds_in_f32": ((ctrl.bfloat16().float() - got).abs()
                                   / got.abs()).max().item()}
        if not (rel["plain"] <= 2 ** -7 < rel["p_and_ds_in_f32"]):
            raise AssertionError(f"flash attention backward cast check "
                                 f"({name}): max relative difference of the "
                                 f"kernel to {rel} (bound 2**-7)")
        bwd_cast[name] = {"kernel_output": got.abs().max().item(),
                          "max_rel_diff": rel}
    if dk[..., 1:].float().any() or dq[..., 2:].float().any():
        raise AssertionError("backward cast check: dK outside column 0 or "
                             "dQ past column 1 != 0")
    _phase("fa_kernel_check", cases=len(cases) + 3, max_abs_err=worst,
           tolerance={k: {"fwd": f, "bwd": bw} for k, (f, bw) in FA_TOL.items()},
           bf16_err_to_max={"kernel": worst_to_max,
                            "p_and_ds_in_f32_control": control,
                            "bound": BF16_ERR_TO_MAX},
           p_cast_case=p_cast, bwd_cast_case={**bwd_cast, "bound": 2 ** -7})


def _train_model(dev, dtype, use_flash, params):
    from container_engine_accelerators_tpu_torch.models.transformer import (
        TransformerLM,
    )

    model = TransformerLM(dtype=dtype, use_flash=use_flash, device=dev)
    model.load_state_dict(params)
    return model


def check_train_parity(dev):
    """Phase 7: the full-width train step, kernels on vs dense attention."""
    import numpy as np
    import torch

    from container_engine_accelerators_tpu_torch.models import lm_train
    from container_engine_accelerators_tpu_torch.models.transformer import (
        TransformerLM,
        init_params,
    )

    params = init_params(TransformerLM(device="meta"),
                         torch.Generator().manual_seed(0))
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, 32000, (2, 2048))).to(dev)
    labels, mask = lm_train.next_token_targets(toks)
    out = {}
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
        run = {}
        for flash in (True, False):
            model = _train_model(dev, dtype, flash, params)
            num, den = lm_train._loss(model, toks, labels, mask, None)
            loss = num / den
            loss.backward()
            run[flash] = (loss.item(),
                          {n: p.grad for n, p in model.named_parameters()})
            del model
        rel = abs(run[True][0] - run[False][0]) / abs(run[False][0])
        grad_err = max(((run[True][1][n] - g).abs().max()
                        / g.abs().max()).item()
                       for n, g in run[False][1].items())
        if not (rel <= tol and math.isfinite(run[True][0])):
            raise AssertionError(f"train loss, kernels vs dense "
                                 f"({_name(dtype)}): {run[True][0]} vs "
                                 f"{run[False][0]}")
        if dtype == torch.float32 and not grad_err <= 1e-4:
            raise AssertionError(f"f32 gradient, kernels vs dense: "
                                 f"{grad_err} of the leaf's max |g|")
        out[_name(dtype)] = {"loss_kernels": run[True][0],
                             "loss_dense": run[False][0],
                             "loss_rel_diff": rel,
                             "max_grad_err_to_leaf_max": grad_err}
        del run
    _phase("train_parity", config="12L 8x64 mlp2048 vocab32000, batch 2 "
           "x 2048", tolerance={"float32": {"loss_rel": 1e-5,
                                             "grad_to_leaf_max": 1e-4},
                                 "bfloat16": {"loss_rel": 2e-2}}, **out)


def train(fa, dev, card):
    """Phase 8: the main path — the trainer's main() at its defaults."""
    import numpy as np
    import torch

    from container_engine_accelerators_tpu_torch.cmd import train_lm
    from container_engine_accelerators_tpu_torch.models import lm_train
    from container_engine_accelerators_tpu_torch.models.transformer import (
        TransformerLM,
    )

    argv = ["--train-steps", str(TRAIN_STEPS), "--steps-per-eval", "1"]
    args = train_lm.parse_args(argv)
    ends = []

    def on_step(step, loss, metrics):
        torch.cuda.synchronize()
        ends.append(time.perf_counter())

    for name in fa.LAUNCHES:
        fa.LAUNCHES[name] = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    losses = train_lm.main(argv, on_step=on_step)
    peak = torch.cuda.max_memory_allocated()
    launches = dict(fa.LAUNCHES)
    layers_steps = args.num_layers * TRAIN_STEPS
    want = {"flash_attention_fwd": 2 * layers_steps,
            "flash_attention_bwd_dq": layers_steps,
            "flash_attention_bwd_dkv": layers_steps}
    if launches != want:
        raise AssertionError(f"flash attention launches on the main path "
                             f"{launches}, expected {want}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite train loss: {losses}")
    # The first step's loss with dense attention: same seed, same batch.
    model = TransformerLM(use_flash=False, device=dev)
    lm_train.create_lm_train_state(model, torch.Generator().manual_seed(0))
    toks, labels, mask = (torch.from_numpy(x).to(dev) for x in
                          train_lm.synthetic_batches(args)[0])
    with torch.no_grad():
        num, den = lm_train._loss(model, toks.long(), labels.long(), mask,
                                  None)
    dense = (num / den).item()
    del model
    if not abs(losses[0] - dense) <= 2e-2 * abs(dense):
        raise AssertionError(f"first train loss {losses[0]} != dense "
                             f"attention's {dense}")
    steady = [b - a for a, b in zip(ends[1:], ends[2:])]
    step_ms = statistics.median(steady) * 1e3
    tokens = args.train_batch_size * args.seq_len
    _phase("train", entry="cmd/train_lm.py main() at its defaults: 12L 8x64 "
           "mlp2048 vocab32000, seq 2048, batch 8, bf16, remat",
           card=card, steps=TRAIN_STEPS, losses=losses,
           first_loss_dense=dense, launches=launches,
           expected_launches=f"fwd 2 x {args.num_layers} layers x "
                             f"{TRAIN_STEPS} steps (remat), bwd "
                             f"{args.num_layers} x {TRAIN_STEPS}",
           wall_s=round(time.perf_counter() - t0, 3),
           steady_step_ms=step_ms, steady_steps=len(steady),
           step_ms_each=[round(x * 1e3, 3) for x in steady],
           tokens_per_s=tokens / (step_ms / 1e3), peak_memory_bytes=peak)
    return launches, losses, {"steady_step_ms": step_ms,
                              "tokens_per_s": tokens / (step_ms / 1e3),
                              "peak_memory_bytes": peak}


def time_fa_kernels(fa, dev):
    """Phase 9 for flash attention: each kernel at the training shape
    (bf16, causal) beside its plain version, SDPA and its bound; then the
    port's whole backward beside SDPA's, both in CUDA graphs."""
    import torch
    import torch.nn.functional as F

    dtype = torch.bfloat16
    b, t, h, d = TRAIN_SHAPE
    scale = d ** -0.5
    gen = torch.Generator(device=dev).manual_seed(12)
    tensor_bytes = b * t * h * d * 2
    lse_bytes = b * h * t * 4
    n_inputs = max(3, math.ceil(2.5 * L2_BYTES / (5 * tensor_bytes)))
    inputs = []
    for _ in range(n_inputs):
        q, k, v, do = (torch.randn(b, t, h, d, device=dev, generator=gen)
                       .to(dtype) for _ in range(4))
        o, lse = fa.flash_forward(q, k, v, True, scale)
        inputs.append((q, k, v, o, lse, do))
    errs, _ = _fa_case(fa, *(inputs[0][i] for i in (0, 1, 2, 5)), True)
    pairs = b * h * t * (t + 1) // 2  # causal (query, key) pairs
    # Bytes each must move: inputs read once, outputs written once.
    nbytes = {"flash_attention_fwd": 4 * tensor_bytes + lse_bytes,
              "flash_attention_bwd_dq": 6 * tensor_bytes + lse_bytes,
              "flash_attention_bwd_dkv": 7 * tensor_bytes + lse_bytes}

    def sdpa(q, k, v, *_):
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=True)

    # SDPA's backward kernel (its flash backend: dq, dk and dv in one
    # call) on the residuals of its own forward, called directly so that a
    # CUDA graph captures it as it captures the port's ops.
    lib_inputs = []
    for q, k, v, _, _, do in inputs:
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        out, lse, cum_q, cum_k, max_q, max_k, seed, offset, _ = (
            torch.ops.aten._scaled_dot_product_flash_attention(
                qt, kt, vt, 0.0, True, scale=scale))
        lib_inputs.append((do.transpose(1, 2), qt, kt, vt, out, lse, cum_q,
                           cum_k, max_q, max_k, seed, offset))

    def sdpa_bwd(g, qt, kt, vt, out, lse, cum_q, cum_k, max_q, max_k, seed,
                 offset):
        return torch.ops.aten._scaled_dot_product_flash_attention_backward(
            g, qt, kt, vt, out, lse, cum_q, cum_k, max_q, max_k, 0.0, True,
            seed, offset, scale=scale)

    kernel = {"flash_attention_fwd": lambda q, k, v, o, lse, do:
              fa.flash_forward(q, k, v, True, scale),
              "flash_attention_bwd_dq": lambda q, k, v, o, lse, do:
              fa.load_ops().flash_attention_bwd_dq(q, k, v, o, do, lse, True,
                                                   scale),
              "flash_attention_bwd_dkv": lambda q, k, v, o, lse, do:
              fa.load_ops().flash_attention_bwd_dkv(q, k, v, o, do, lse,
                                                    True, scale)}
    plain = {"flash_attention_fwd": lambda q, k, v, o, lse, do:
             fa.flash_attention_reference(q, k, v, True),
             "flash_attention_bwd_dq": lambda *a:
             fa.flash_attention_bwd_reference(*a, True)[0],
             "flash_attention_bwd_dkv": lambda *a:
             fa.flash_attention_bwd_reference(*a, True)[1:]}
    library_fwd = _graph_ms(sdpa, inputs)
    library_bwd = _graph_ms(sdpa_bwd, lib_inputs)
    rows = {}
    for name, (line, products, src) in FA_KERNELS.items():
        flops = 2 * products * d * pairs
        bytes_ms = nbytes[name] / HBM_BYTES_PER_S * 1e3
        ops_ms = flops / PEAK_FLOPS["bfloat16"] * 1e3
        err_keys = {"flash_attention_fwd": ("o",),
                    "flash_attention_bwd_dq": ("dq",),
                    "flash_attention_bwd_dkv": ("dk", "dv")}[name]
        rows[name] = {
            "shape": f"B={b} T={t} H={h} D={d} causal bf16",
            "distinct_inputs": n_inputs,
            "max_abs_err": max(errs[k][0] for k in err_keys),
            "source": src,
            "ms": _graph_ms(kernel[name], inputs),
            "plain_ms": _graph_ms(plain[name], inputs),
            "library_ms": library_fwd if name == "flash_attention_fwd"
            else library_bwd,
            "library": "F.scaled_dot_product_attention(is_causal=True)"
                       if name == "flash_attention_fwd"
                       else "aten._scaled_dot_product_flash_attention_"
                            "backward (dq, dk and dv in one call)",
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "flops": flops, "bytes": nbytes[name]}
        row = rows[name]
        row["tflops"] = flops / row["ms"] / 1e9
        row["share_of_bound"] = row["bound_ms"] / row["ms"]
        _phase("fa_kernel_time", kernel=name, **row)
    # The port's whole backward against SDPA's: dQ, dK and dV, in CUDA
    # graphs over the same inputs.  7 products; q, k, v, o, dO and lse read
    # once, dq, dk and dv written once.
    bwd_ms = _graph_ms(lambda q, k, v, o, lse, do:
                       fa.flash_backward(q, k, v, o, lse, do, True, scale), inputs)
    bytes_ms = (8 * tensor_bytes + lse_bytes) / HBM_BYTES_PER_S * 1e3
    ops_ms = 2 * 7 * d * pairs / PEAK_FLOPS["bfloat16"] * 1e3
    _phase("fa_backward_time", what="flash_attention_bwd: the port's whole "
           "bf16 backward (flash_backward: the dQ op with the delta pre-pass, "
           "then the dK/dV op with its delta) and SDPA's backward kernel, "
           "both in CUDA graphs", shape=f"B={b} T={t} H={h} D={d} causal bf16",
           distinct_inputs=n_inputs, ms=bwd_ms, library_bwd_ms=library_bwd,
           ratio_to_library=bwd_ms / library_bwd,
           bound_ms=max(bytes_ms, ops_ms),
           tflops=2 * 7 * d * pairs / bwd_ms / 1e9)
    return rows


def profile_train_step(dev):
    """Phase 10 for training: one train step at the trainer's defaults
    traced with torch.profiler, after a warm-up step."""
    import torch

    from container_engine_accelerators_tpu_torch.cmd import train_lm
    from container_engine_accelerators_tpu_torch.models import lm_train
    from container_engine_accelerators_tpu_torch.models.transformer import (
        TransformerLM,
    )

    args = train_lm.parse_args([])
    model = TransformerLM(device=dev)
    state = lm_train.create_lm_train_state(model,
                                           torch.Generator().manual_seed(0))
    step = lm_train.make_lm_train_step()[0]
    batches = [tuple(torch.from_numpy(x).to(dev) for x in batch)
               for batch in train_lm.synthetic_batches(args)[:2]]
    batches = [(t.long(), l.long(), m) for t, l, m in batches]
    step(state, *batches[0])
    torch.cuda.synchronize()
    device_ms, wall_ms, by_name, count = _traced(
        lambda: step(state, *batches[1]))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    names = ("fa_fwd", "fa_bwd_dq", "fa_bwd_dkv", "fa_bwd_delta")
    launches = {name: sum(v for k, v in count.items() if name in k)
                for name in names}
    # delta once per backward: one pre-pass per layer, not one per op.
    if launches["fa_bwd_delta"] != args.num_layers:
        raise AssertionError(f"{launches['fa_bwd_delta']} delta pre-pass "
                             f"launches in one train step, expected "
                             f"{args.num_layers}")
    _phase("profile_train", step="one train step at the trainer's defaults "
           "(B=8, T=2048, bf16, remat)", wall_ms=wall_ms,
           device_ms=device_ms, device_busy_share=device_ms / wall_ms,
           flash_attention_ms={
               name: sum(v for k, v in by_name.items() if name in k)
               for name in names},
           flash_attention_launches=launches,
           top=[[k[:70], v] for k, v in top])
    return device_ms


def _http_server(handler):
    from http.server import ThreadingHTTPServer

    srv = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    return srv, thread


def _shutdown(srv, thread):
    srv.shutdown()
    srv.server_close()
    thread.join(timeout=30)


def _check_rows(name, prompts, rows, n_new, vocab):
    for p, t in zip(prompts, rows):
        if len(t) != len(p) + n_new or t[:len(p)] != p:
            raise AssertionError(f"{name}: bad token row length or echo")
        if not all(0 <= x < vocab for x in t):
            raise AssertionError(f"{name}: token outside the vocab")


def _agreement(rows, want, prompts):
    """Share of generated tokens equal position by position, and rows
    identical."""
    same = total = 0
    for p, a, b in zip(prompts, rows, want):
        same += sum(x == y for x, y in zip(a[len(p):], b[len(p):]))
        total += len(b) - len(p)
    return {"tokens": same / total,
            "rows_identical": sum(a == b for a, b in zip(rows, want)),
            "rows": len(want)}


def _solo_tokens(model, prompt_ids, n_new, max_prompt_len, temperature=0.0,
                 seed=None):
    """Per-request generate() as the server runs it: the prompt padded to
    its bucket, the sampled path on a generator seeded with ``seed``."""
    import torch

    from container_engine_accelerators_tpu_torch.models.batching import (
        bucket_len,
    )
    from container_engine_accelerators_tpu_torch.models.generate import (
        generate,
    )

    dev = model.embed.device
    plen = len(prompt_ids)
    bucket = bucket_len(plen, max_prompt_len)
    prompt = torch.tensor([prompt_ids + [0] * (bucket - plen)], device=dev)
    gen = (torch.Generator(device=dev).manual_seed(seed) if temperature
           else None)
    with torch.inference_mode():
        out = generate(model, prompt, n_new, temperature=temperature,
                       generator=gen, prompt_len=plen)
    return out[0, :plen + n_new].tolist()


def slot_prompt_lens():
    """The serve_slots phase's prompt lengths, from a seed over 5..700."""
    import numpy as np

    return np.random.default_rng(SLOTS_SEED).integers(5, 701, SLOTS).tolist()


def slot_prompts(vocab, rng=None):
    """The serve_slots phase's eight prompts (lengths from
    :func:`slot_prompt_lens`, tokens from ``rng``, by default the phase's
    own generator at its start)."""
    import numpy as np

    if rng is None:
        rng = np.random.default_rng(SLOTS_SEED + 1)
    return [rng.integers(0, vocab, n).tolist() for n in slot_prompt_lens()]


def serve_slots(fd, dev, card):
    """Phase 11: the server with --slots (the continuous-batching engine)
    as main() wires it, beside the per-request path."""
    import numpy as np
    import torch

    from container_engine_accelerators_tpu_torch.cmd import serve_lm
    from container_engine_accelerators_tpu_torch.models.batching import (
        DecodeEngine,
    )
    from container_engine_accelerators_tpu_torch.models.transformer import (
        TransformerLM,
    )

    args = serve_lm.parse_args(SERVE_FLAGS + ["--slots", str(SLOTS),
                                              "--port", "0"])
    serve_lm.validate_args(args)
    run = serve_lm.build_generate(args)
    engine_loop = serve_lm.start_engine(run, args)
    engine = engine_loop.engine
    lens = slot_prompt_lens()
    rng = np.random.default_rng(SLOTS_SEED + 1)
    prompts = slot_prompts(args.vocab_size, rng)
    sampled = {"prompt_ids": [rng.integers(0, args.vocab_size, 12).tolist()],
               "temperature": 0.8, "seed": 4321}
    n_new = args.max_new_tokens
    solo_srv = _http_server(serve_lm.make_handler(run, args))
    slots_srv = _http_server(serve_lm.make_handler(run, args, engine_loop))
    try:
        # The per-request path: the same requests, one after another.
        solo, solo_lat = [], []
        t0 = time.perf_counter()
        for p in prompts:
            _, resp, _ = _post(solo_srv[0].server_address[1],
                               {"prompt_ids": [p], "temperature": 0})
            solo.append(resp["tokens"][0])
            solo_lat.append(resp["latency_ms"])
        solo_wall_ms = (time.perf_counter() - t0) * 1e3
        solo_sampled = _post(solo_srv[0].server_address[1],
                             sampled)[1]["tokens"]
        # The slots path: all eight at once, launch counts around it.
        for name in fd.LAUNCHES:
            fd.LAUNCHES[name] = 0
        steps0 = engine.steps
        got, client_ms = [None] * SLOTS, [None] * SLOTS

        def ask(i):
            _, got[i], client_ms[i] = _post(slots_srv[0].server_address[1],
                                            {"prompt_ids": [prompts[i]],
                                             "temperature": 0})

        threads = [threading.Thread(target=ask, args=(i,))
                   for i in range(SLOTS)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        slots_wall_ms = (time.perf_counter() - t0) * 1e3
        if any(g is None or "tokens" not in g for g in got):
            raise AssertionError(f"slots: a request failed: {got}")
        twice = [_post(slots_srv[0].server_address[1], sampled)[1]["tokens"]
                 for _ in range(2)]
        launches = fd.LAUNCHES["flash_decode"]
        fleet_steps = engine.steps - steps0
    finally:
        _shutdown(*solo_srv)
        _shutdown(*slots_srv)
        engine_loop.close()
    rows = [g["tokens"][0] for g in got]
    _check_rows("slots", prompts, rows, n_new, args.vocab_size)
    _check_rows("per-request", prompts, solo, n_new, args.vocab_size)
    _check_rows("sampled", sampled["prompt_ids"], twice[0], n_new,
                args.vocab_size)
    if twice[0] != twice[1]:
        raise AssertionError("slots: the sampled request gave other tokens "
                             "the second time")
    if launches != args.num_layers * fleet_steps:
        raise AssertionError(f"flash_decode launched {launches} times over "
                             f"{fleet_steps} fleet steps of "
                             f"{args.num_layers} layers")

    # f32 at full width: the engine's tokens are per-request generate()'s.
    model = TransformerLM(vocab_size=args.vocab_size,
                          num_layers=args.num_layers,
                          num_heads=args.num_heads, head_dim=args.head_dim,
                          mlp_dim=args.mlp_dim, dtype=torch.float32,
                          decode=True, use_flash_decode=True, device=dev)
    model.load_state_dict(run.params)
    eng32 = DecodeEngine(model, SLOTS, engine.max_len)
    rids = [eng32.submit(p, n_new) for p in prompts]
    eng32.run_until_drained()
    s_ids = sampled["prompt_ids"][0]
    rid = eng32.submit(s_ids, n_new, temperature=0.8, seed=4321)
    eng32.run_until_drained()
    for p, r in zip(prompts, rids):
        if p + eng32.result(r) != _solo_tokens(model, p, n_new,
                                               args.max_prompt_len):
            raise AssertionError("f32 engine greedy tokens differ from "
                                 "per-request generate")
    if s_ids + eng32.result(rid) != _solo_tokens(
            model, s_ids, n_new, args.max_prompt_len, 0.8, 4321):
        raise AssertionError("f32 engine sampled tokens differ from "
                             "per-request generate with the same seed")
    del model, eng32

    # Fleet steps of eight live lanes: ten timed on the host clock, then
    # one traced.
    for p in prompts:
        engine.submit(p, n_new)
    engine.step()
    torch.cuda.synchronize()
    step_ms = []
    for _ in range(10):
        t0 = time.perf_counter()
        engine.step()  # reads its tokens: ends synchronized
        step_ms.append((time.perf_counter() - t0) * 1e3)
    device_ms, wall_ms, by_name, count = _traced(engine.step)
    engine.run_until_drained()
    fd_calls = sum(v for k, v in count.items() if "flash_decode" in k)
    if fd_calls != args.num_layers:
        raise AssertionError(f"a traced fleet step ran {fd_calls} flash "
                             f"decode kernels, expected {args.num_layers}")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    tokens = SLOTS * n_new
    _phase("serve_slots", card=card,
           flags=f"{' '.join(SERVE_FLAGS)} --slots {SLOTS}",
           prompt_lens=lens, max_len=engine.max_len,
           launches={"flash_decode": launches}, fleet_steps=fleet_steps,
           expected_launches=f"{args.num_layers} layers x {fleet_steps} "
                             f"fleet steps (8 greedy + 2 sampled requests)",
           per_request_path={"latency_ms": solo_lat, "wall_ms": solo_wall_ms,
                             "decode_tokens_per_s":
                             tokens / (solo_wall_ms / 1e3)},
           slots_path={"latency_ms": [g["latency_ms"] for g in got],
                       "client_ms": client_ms,
                       "batch_wall_ms": slots_wall_ms,
                       "decode_tokens_per_s": tokens / (slots_wall_ms / 1e3)},
           throughput_ratio=solo_wall_ms / slots_wall_ms,
           bf16_greedy_agreement=_agreement(rows, solo, prompts),
           sampled={"same_tokens_twice": True,
                    "bf16_agreement_with_per_request":
                    _agreement(twice[0], solo_sampled,
                               sampled["prompt_ids"])},
           f32_engine={"greedy_rows_identical_to_generate": SLOTS,
                       "sampled_identical_to_generate": True},
           fleet_step_ms={"median": statistics.median(step_ms),
                          "each": step_ms},
           fleet_step_profile={
               "wall_ms": wall_ms, "device_ms": device_ms,
               "device_busy_share": device_ms / wall_ms,
               "flash_decode_ms": sum(v for k, v in by_name.items()
                                      if "flash_decode" in k),
               "flash_decode_launches": fd_calls,
               "top": [[k[:70], v] for k, v in top]})
    return launches


def train_resume(dev, unbroken, card):
    """Phase 12: the trainer checkpoints, is restarted and resumes; the
    server then serves the saved weights."""
    import numpy as np
    import torch

    from container_engine_accelerators_tpu_torch.cmd import serve_lm, train_lm
    from container_engine_accelerators_tpu_torch.models.checkpoint import (
        STATE_FILE,
        TrainCheckpointer,
    )
    from container_engine_accelerators_tpu_torch.models.transformer import (
        TransformerLM,
    )

    step_ms = []

    def timer(run_name, interval):
        last = []

        def on_step(step, loss, metrics):
            torch.cuda.synchronize()
            now = time.perf_counter()
            if last:
                # This interval holds step `step` and, when the step before
                # it ended an interval, that step's save.
                step_ms.append({"run": run_name, "step": step,
                                "ms": (now - last[0]) * 1e3,
                                "after_save": step % interval == 0})
            last[:] = [now]
        return on_step

    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as tmp:
        ck = os.path.join(tmp, "ckpt")
        argv = ["--checkpoint-dir", ck, "--checkpoint-interval", "2",
                "--steps-per-eval", "1"]
        t0 = time.perf_counter()
        first = train_lm.main(argv + ["--train-steps", "4"],
                              on_step=timer("first", 2))
        first_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        resumed = train_lm.main(argv + ["--train-steps", str(TRAIN_STEPS)],
                                on_step=timer("resumed", 2))
        resumed_s = time.perf_counter() - t0
        saved_steps = TrainCheckpointer(ck).all_steps()
        ckpt_bytes = os.path.getsize(os.path.join(ck, str(TRAIN_STEPS),
                                                  STATE_FILE))
        losses = first + resumed
        if len(first) != 4 or len(resumed) != TRAIN_STEPS - 4:
            raise AssertionError(f"resume ran {len(first)} + {len(resumed)} "
                                 f"steps")
        if saved_steps != [2, 4, TRAIN_STEPS]:
            raise AssertionError(f"saved steps {saved_steps}")
        rel = max(abs(a - b) / abs(b) for a, b in zip(losses, unbroken))
        if not rel <= 2e-2:
            raise AssertionError(f"resumed losses {losses} vs unbroken "
                                 f"{unbroken}")

        # The server on that directory: the saved weights, and greedy
        # tokens equal to generate()'s on them.
        args = serve_lm.parse_args(SERVE_FLAGS + ["--checkpoint-dir", ck,
                                                  "--port", "0"])
        serve_lm.validate_args(args)
        run = serve_lm.build_generate(args)
        saved = torch.load(os.path.join(ck, str(TRAIN_STEPS), STATE_FILE),
                           map_location="cpu", weights_only=True)["model"]
    if saved.keys() != run.params.keys() or not all(
            torch.equal(saved[k], run.params[k]) for k in saved):
        raise AssertionError("the server's weights are not the checkpoint's")
    model = TransformerLM(vocab_size=args.vocab_size,
                          num_layers=args.num_layers,
                          num_heads=args.num_heads, head_dim=args.head_dim,
                          mlp_dim=args.mlp_dim, decode=True,
                          use_flash_decode=True, device=dev)
    model.load_state_dict(saved)
    rng = np.random.default_rng(8)
    prompts = [rng.integers(0, args.vocab_size, n).tolist() for n in (9, 300)]
    srv = _http_server(serve_lm.make_handler(run, args))
    try:
        rows = _post(srv[0].server_address[1],
                     {"prompt_ids": prompts, "temperature": 0})[1]["tokens"]
    finally:
        _shutdown(*srv)
    want = [_solo_tokens(model, p, args.max_new_tokens, args.max_prompt_len)
            for p in prompts]
    if rows != want:
        raise AssertionError("the server's greedy tokens on the checkpoint "
                             "differ from generate()'s on the saved weights")
    nonsave = [r["ms"] for r in step_ms if not r["after_save"]]
    _phase("train_resume", card=card,
           entry="cmd/train_lm.py main() at its defaults with "
                 "--checkpoint-dir, --checkpoint-interval 2: 4 steps, then "
                 f"a restart to step {TRAIN_STEPS}",
           losses=losses, unbroken_losses=unbroken,
           losses_exact=losses == unbroken, max_rel_diff=rel,
           tolerance="exact if equal, else within 2e-2 relative (the train "
                     "phase's bf16 tolerance)",
           saved_steps=saved_steps, checkpoint_bytes=ckpt_bytes,
           run_seconds={"first": first_s, "resumed": resumed_s},
           step_ms=step_ms,
           median_step_ms_without_save=(statistics.median(nonsave)
                                        if nonsave else None),
           server={"loaded_step": TRAIN_STEPS, "weights": "equal to the "
                   "checkpoint's", "greedy_rows_identical_to_generate":
                   len(prompts)})


def profile_dir(train_step_device_ms, card):
    """Phase 13: the trainer's --profile-dir, read by cmd/trace_summary.py
    as a user would run it."""
    from container_engine_accelerators_tpu_torch.cmd import train_lm

    with tempfile.TemporaryDirectory(prefix="chip_smoke_prof_") as tmp:
        t0 = time.perf_counter()
        losses = train_lm.main(["--train-steps", str(PROFILE_STEPS),
                                "--profile-dir", tmp])
        train_s = time.perf_counter() - t0
        proc = subprocess.run(
            [sys.executable, "-m",
             "container_engine_accelerators_tpu_torch.cmd.trace_summary",
             tmp, "--top", "100000"],
            cwd=HERE, capture_output=True, text=True, timeout=600)
        if proc.returncode:
            raise AssertionError(f"trace_summary failed: {proc.stderr[-2000:]}")
        summary = json.loads(proc.stdout.strip().splitlines()[-1])
        trace_bytes = os.path.getsize(summary["trace"])
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite profiled train loss: {losses}")
    layers = train_lm.parse_args([]).num_layers
    ops = summary["ops"]
    launches = {name: sum(o["launches"] for o in ops if name in o["name"])
                for name in ("fa_fwd", "fa_bwd_dq", "fa_bwd_dkv",
                             "fa_bwd_delta")}
    want = {"fa_fwd": 2 * layers * TRACED_STEPS,
            "fa_bwd_dq": layers * TRACED_STEPS,
            "fa_bwd_dkv": layers * TRACED_STEPS,
            "fa_bwd_delta": layers * TRACED_STEPS}
    if summary["steps"] != TRACED_STEPS or launches != want:
        raise AssertionError(f"trace of {summary['steps']} steps with "
                             f"launches {launches}, expected "
                             f"{TRACED_STEPS} steps and {want}")
    per_step = summary["device_ms_per_step"]
    rel = abs(per_step - train_step_device_ms) / train_step_device_ms
    if not rel <= 0.1:
        raise AssertionError(f"device ms a traced step {per_step} vs the "
                             f"profile_train phase's {train_step_device_ms}")
    _phase("profile_dir", card=card,
           entry=f"cmd/train_lm.py main() at its defaults, --train-steps "
                 f"{PROFILE_STEPS} --profile-dir; cmd/trace_summary.py",
           train_seconds=train_s, trace_bytes=trace_bytes,
           traced_steps=summary["steps"], window_ms=summary["window_ms"],
           device_ms=summary["device_ms"],
           device_ms_per_step=per_step,
           profile_train_device_ms=train_step_device_ms,
           rel_diff_to_profile_train=rel,
           busy_share=summary["busy_share"], launches=launches,
           expected_launches=want,
           top=[[o["name"][:70], o["ms"], o["launches"]] for o in ops[:8]])


# ---- phases 14-17: the server's single-GPU features ------------------------

FEATURE_SEED = 11  # prompts of the feature phases
SPEC_K = 4
INT8_LENS = [5, 64, 300, 700]  # per-request prompts of serve_int8/serve_spec
CHUNK = 256  # serve_chunked's --prefill-chunk, on prompts of 7/8..1 x 1024
PREFIX_LEN = 512
SUFFIX_LENS = (16, 200)


def _reset(fd):
    for name in fd.LAUNCHES:
        fd.LAUNCHES[name] = 0


def _feature_server(flags):
    """serve_lm with ``SERVE_FLAGS + flags`` as main() wires it with
    ``--slots 8``: (args, run, engine loop, per-request server, slots
    server)."""
    from container_engine_accelerators_tpu_torch.cmd import serve_lm

    args = serve_lm.parse_args(SERVE_FLAGS + flags + ["--slots", str(SLOTS),
                                                      "--port", "0"])
    serve_lm.validate_args(args)
    run = serve_lm.build_generate(args)
    engine_loop = serve_lm.start_engine(run, args)
    return (args, run, engine_loop,
            _http_server(serve_lm.make_handler(run, args)),
            _http_server(serve_lm.make_handler(run, args, engine_loop)))


def _close(engine_loop, *servers):
    for srv in servers:
        _shutdown(*srv)
    engine_loop.close()


def _ask_each(srv, bodies):
    """Bodies one after another -> (each body's first token row, server
    latencies ms)."""
    rows, lat = [], []
    for body in bodies:
        status, resp, _ = _post(srv[0].server_address[1], body)
        if status != 200 or "tokens" not in resp:
            raise AssertionError(f"bad response {status} {resp}")
        rows.append(resp["tokens"][0])
        lat.append(resp["latency_ms"])
    return rows, lat


def _ask_all(srv, bodies):
    """Bodies all at once -> (rows, latencies ms, the batch's wall ms)."""
    got = [None] * len(bodies)

    def ask(i):
        got[i] = _post(srv[0].server_address[1], bodies[i])[1]

    threads = [threading.Thread(target=ask, args=(i,))
               for i in range(len(bodies))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    wall_ms = (time.perf_counter() - t0) * 1e3
    if any(g is None or "tokens" not in g for g in got):
        raise AssertionError(f"a concurrent request failed: {got}")
    return ([g["tokens"][0] for g in got], [g["latency_ms"] for g in got],
            wall_ms)


def _greedy_bodies(prompts, **extra):
    return [{"prompt_ids": [p], "temperature": 0, **extra} for p in prompts]


def _twin(args, params, dev, dtype, **over):
    """A decode model of the server's widths in ``dtype`` (flash decode
    on) holding ``params``."""
    from container_engine_accelerators_tpu_torch.models.transformer import (
        TransformerLM,
    )

    cfg = dict(vocab_size=args.vocab_size, num_layers=args.num_layers,
               num_heads=args.num_heads, head_dim=args.head_dim,
               mlp_dim=args.mlp_dim, dtype=dtype, decode=True,
               use_flash_decode=True, device=dev)
    cfg.update(over)
    model = TransformerLM(**cfg)
    model.load_state_dict(params)
    return model.eval()


def _padded(ids, max_prompt_len, dev):
    """A prompt as the server pads it -> ([1, bucket] tensor, length)."""
    import torch

    from container_engine_accelerators_tpu_torch.models.batching import (
        bucket_len,
    )

    bucket = bucket_len(len(ids), max_prompt_len)
    return torch.tensor([ids + [0] * (bucket - len(ids))], dtype=torch.long,
                        device=dev), len(ids)


def _engine_tokens(engine, prompts, n_new, prefix=None):
    rids = [engine.submit(p, n_new, prefix=prefix) for p in prompts]
    engine.run_until_drained()
    return [p + engine.result(r) for p, r in zip(prompts, rids)]


def _check_launches(fd, phase, want, what):
    got = fd.LAUNCHES["flash_decode"]
    if got != want:
        raise AssertionError(f"{phase}: flash_decode launched {got} times, "
                             f"expected {want} ({what})")
    return {"flash_decode": got, "expected": want, "counted_as": what}


def _ms_median(fn, reps=5):
    """Median host ms of ``fn()``, which must end synchronized."""
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        out.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(out)


def serve_int8(fd, dev, card, plain):
    """Phase 14: ``--weights int8`` per request and with --slots 8."""
    import numpy as np
    import torch

    from container_engine_accelerators_tpu_torch.models.batching import (
        DecodeEngine,
    )
    from container_engine_accelerators_tpu_torch.models.quant import (
        dequantize_params,
        param_bytes,
        serving_params,
    )

    args, run, loop, solo, slots = _feature_server(["--weights", "int8"])
    engine, n_new, layers = loop.engine, args.max_new_tokens, args.num_layers
    rng = np.random.default_rng(FEATURE_SEED)
    prompts = [rng.integers(0, args.vocab_size, n).tolist()
               for n in INT8_LENS]
    fleet_prompts = [rng.integers(0, args.vocab_size, n).tolist()
                     for n in slot_prompt_lens()]
    try:
        _reset(fd)
        steps0 = engine.steps
        rows, lat = _ask_each(solo, _greedy_bodies(prompts))
        srows, slat, swall = _ask_all(slots, _greedy_bodies(fleet_prompts))
        fleet = engine.steps - steps0
        launches = _check_launches(
            fd, "serve_int8", layers * ((n_new - 1) * len(prompts) + fleet),
            f"{layers} layers x ({n_new - 1} steps x {len(prompts)} requests "
            f"+ {fleet} fleet steps)")
        prows, plat = _ask_each(plain[1], _greedy_bodies(prompts))
    finally:
        _close(loop, solo, slots)
    _check_rows("int8", prompts, rows, n_new, args.vocab_size)
    _check_rows("int8 slots", fleet_prompts, srows, n_new, args.vocab_size)
    # Exact: a bf16 model on the dequantized weights multiplies the same
    # bf16 kernels (per request, and in a fleet fed the same submits).
    q = serving_params(run.params, "int8")
    deq = _twin(args, dequantize_params(q), dev, torch.bfloat16)
    for p, r in zip(prompts, rows):
        if r != _solo_tokens(deq, p, n_new, args.max_prompt_len):
            raise AssertionError("int8 tokens differ from the dequantized "
                                 "bf16 model's")
    fleets = [_engine_tokens(DecodeEngine(m, SLOTS, engine.max_len),
                             fleet_prompts, n_new)
              for m in (run.model, deq)]
    if fleets[0] != fleets[1]:
        raise AssertionError("int8 fleet tokens differ from the dequantized "
                             "bf16 fleet's")
    plain_fleet = [_solo_tokens(plain[0].model, p, n_new,
                                args.max_prompt_len) for p in fleet_prompts]
    del deq
    _phase("serve_int8", card=card,
           flags=f"{' '.join(SERVE_FLAGS)} --weights int8 [--slots {SLOTS}]",
           prompt_lens=INT8_LENS, launches=launches,
           param_bytes={"int8": param_bytes(q),
                        "bf16": param_bytes(serving_params(run.params,
                                                           "bf16"))},
           per_request={"int8_latency_ms": lat, "bf16_latency_ms": plat,
                        "int8_decode_tokens_per_s":
                        n_new * len(prompts) / (sum(lat) / 1e3),
                        "bf16_decode_tokens_per_s":
                        n_new * len(prompts) / (sum(plat) / 1e3)},
           slots={"latency_ms": slat, "batch_wall_ms": swall,
                  "decode_tokens_per_s": n_new * SLOTS / (swall / 1e3),
                  "fleet_steps": fleet},
           dequantized_bf16_identical={"per_request_rows": len(prompts),
                                       "fleet_rows": SLOTS},
           agreement_with_bf16_original_weights={
               "per_request": _agreement(rows, prows, prompts),
               "slots": _agreement(srows, plain_fleet, fleet_prompts)})
    return launches["flash_decode"]


def serve_chunked(fd, dev, card, plain):
    """Phase 15: ``--prefill-chunk 256`` on ~1000-token prompts."""
    import numpy as np
    import torch

    from container_engine_accelerators_tpu_torch.models.generate import (
        generate,
        prefill,
        prefill_chunked,
    )

    chunk = CHUNK
    args, run, loop, solo, slots = _feature_server(["--prefill-chunk",
                                                    str(chunk)])
    engine, n_new, layers = loop.engine, args.max_new_tokens, args.num_layers
    rng = np.random.default_rng(FEATURE_SEED + 1)
    low, high = args.max_prompt_len * 7 // 8, args.max_prompt_len + 1
    lens = rng.integers(low, high, 3).tolist()
    prompts = [rng.integers(0, args.vocab_size, n).tolist() for n in lens]
    fleet_lens = rng.integers(low, high, SLOTS).tolist()
    fleet_prompts = [rng.integers(0, args.vocab_size, n).tolist()
                     for n in fleet_lens]
    try:
        _reset(fd)
        steps0 = engine.steps
        rows, lat = _ask_each(solo, _greedy_bodies(prompts))
        srows, slat, swall = _ask_all(slots, _greedy_bodies(fleet_prompts))
        fleet = engine.steps - steps0
        launches = _check_launches(
            fd, "serve_chunked",
            layers * ((n_new - 1) * len(prompts) + fleet),
            f"{layers} layers x ({n_new - 1} steps x {len(prompts)} requests "
            f"+ {fleet} fleet steps); the 256-token pieces take the einsum")
        prows, plat = _ask_each(plain[1], _greedy_bodies(prompts))
    finally:
        _close(loop, solo, slots)
    _check_rows("chunked", prompts, rows, n_new, args.vocab_size)
    _check_rows("chunked slots", fleet_prompts, srows, n_new,
                args.vocab_size)

    # TTFT in process (prefill + the first token read on the host) and the
    # prefill's peak memory, single-shot vs chunked, on the served model.
    x, plen = _padded(prompts[0], args.max_prompt_len, dev)
    cache_len = x.shape[1] + n_new
    ttft, peak = {}, {}
    with torch.inference_mode():
        for name, fn in (
                ("single_shot", lambda: prefill(run.model, x, plen,
                                                cache_len)),
                ("chunked", lambda: prefill_chunked(run.model, x, plen,
                                                    cache_len, chunk))):
            fn()[1].argmax(-1).item()
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            ttft[name] = _ms_median(lambda: fn()[1].argmax(-1).item())
            peak[name] = torch.cuda.max_memory_allocated() - base

    # f32 at full width: chunked logits equal single-shot's within 1e-4
    # (atol and rtol: the pieces' GEMMs may sum in another order), and the
    # greedy tokens are identical.
    m32 = _twin(args, run.params, dev, torch.float32)
    worst = 0.0
    with torch.inference_mode():
        for p in prompts:
            x, plen = _padded(p, args.max_prompt_len, dev)
            c = prefill_chunked(m32, x, plen, x.shape[1] + n_new, chunk)[1]
            s_ = prefill(m32, x, plen, x.shape[1] + n_new)[1]
            worst = max(worst, (c - s_).abs().max().item())
            if not torch.allclose(c, s_, atol=1e-4, rtol=1e-4):
                raise AssertionError(f"f32 chunked prefill logits differ "
                                     f"by {(c - s_).abs().max().item()}")
            a = generate(m32, x, n_new, prompt_len=plen, prefill_chunk=chunk)
            b = generate(m32, x, n_new, prompt_len=plen)
            if not torch.equal(a[:, :plen + n_new], b[:, :plen + n_new]):
                raise AssertionError("f32 chunked greedy tokens differ")
    del m32
    _phase("serve_chunked", card=card,
           flags=f"{' '.join(SERVE_FLAGS)} --prefill-chunk {chunk} "
                 f"[--slots {SLOTS}]",
           prompt_lens=lens, fleet_prompt_lens=fleet_lens, launches=launches,
           ttft_ms={"prompt_len": lens[0], **ttft},
           prefill_peak_bytes=peak,
           per_request={"chunked_latency_ms": lat,
                        "unchunked_latency_ms": plat},
           slots={"latency_ms": slat, "batch_wall_ms": swall,
                  "decode_tokens_per_s": n_new * SLOTS / (swall / 1e3)},
           f32={"max_abs_logit_diff": worst, "tolerance": 1e-4,
                "greedy_rows_identical": len(prompts)},
           bf16_agreement_with_unchunked=_agreement(rows, prows, prompts))
    return launches["flash_decode"]


def serve_prefix(fd, dev, card, plain):
    """Phase 16: ``--prefix-cache`` — 8 requests behind one 512-token
    prefix, per request and with --slots 8."""
    import numpy as np
    import torch

    from container_engine_accelerators_tpu_torch.models.batching import (
        DecodeEngine,
    )
    from container_engine_accelerators_tpu_torch.models.generate import (
        generate,
        init_cache,
        prefill,
        prefill_continue,
        splice_prefix,
    )
    from container_engine_accelerators_tpu_torch.models.prefix_cache import (
        PrefixCache,
        generate_with_prefix,
    )

    args, run, loop, solo, slots = _feature_server(["--prefix-cache", "4"])
    engine, n_new, layers = loop.engine, args.max_new_tokens, args.num_layers
    rng = np.random.default_rng(FEATURE_SEED + 2)
    prefix = rng.integers(0, args.vocab_size, PREFIX_LEN).tolist()
    sfx_lens = rng.integers(SUFFIX_LENS[0], SUFFIX_LENS[1] + 1,
                            SLOTS).tolist()
    suffixes = [rng.integers(0, args.vocab_size, n).tolist()
                for n in sfx_lens]
    bodies = _greedy_bodies(suffixes, prefix_ids=prefix)
    full = [prefix + s for s in suffixes]
    try:
        _reset(fd)
        steps0 = engine.steps
        rows, lat = _ask_each(solo, bodies)  # the first one misses
        after_solo = run.prefix_cache.stats()
        srows, slat, swall = _ask_all(slots, bodies)
        fleet = engine.steps - steps0
        launches = _check_launches(
            fd, "serve_prefix", layers * ((n_new - 1) * SLOTS + fleet),
            f"{layers} layers x ({n_new - 1} steps x {SLOTS} requests + "
            f"{fleet} fleet steps); the prefix and suffix prefills take the "
            f"einsum")
        stats = run.prefix_cache.stats()
        prows, plat = _ask_each(plain[1], _greedy_bodies(full))
    finally:
        _close(loop, solo, slots)
    _check_rows("prefix", full, rows, n_new, args.vocab_size)
    _check_rows("prefix slots", full, srows, n_new, args.vocab_size)
    if after_solo["misses"] != 1 or stats["hits"] != 2 * SLOTS - 1:
        raise AssertionError(f"prefix cache stats {after_solo} / {stats}")

    # TTFT in process: a hit (copy the block, prefill the suffix) against a
    # miss's work without the cache (prefill the whole prompt).
    block, plen = run.prefix_cache.get_or_build(tuple(prefix))
    before = {k: v.clone() for k, v in block.items()}
    x, slen = _padded(suffixes[0], args.max_prompt_len, dev)
    xf, flen = _padded(full[0], args.max_prompt_len, dev)

    def hit():
        cache = init_cache(run.model, 1, block["cached_key"].shape[2]
                           + x.shape[1] + n_new, dev)
        splice_prefix(cache, block, plen, 1)
        return prefill_continue(run.model, cache, x, plen, plen + slen)[1]

    with torch.inference_mode():
        hit().argmax(-1).item()
        ttft = {"hit": _ms_median(lambda: hit().argmax(-1).item()),
                "no_cache": _ms_median(lambda: prefill(
                    run.model, xf, flen, xf.shape[1] + n_new)[1]
                    .argmax(-1).item())}
    if not all(torch.equal(block[k], before[k]) for k in before):
        raise AssertionError("a request changed the cached prefix block")

    # f32 at full width: the spliced path's tokens are generate()'s over
    # the concatenated prompt, per request and through an engine.
    m32 = _twin(args, run.params, dev, torch.float32)
    b32, p32 = PrefixCache(m32, args.max_prompt_len).get_or_build(
        tuple(prefix))
    want = []
    with torch.inference_mode():
        for s, f in zip(suffixes, full):
            x, slen = _padded(s, args.max_prompt_len, dev)
            got = generate_with_prefix(m32, b32, p32, x, n_new,
                                       suffix_len=slen)
            xf, flen = _padded(f, args.max_prompt_len, dev)
            ref = generate(m32, xf, n_new, prompt_len=flen)
            want.append(ref[0, :flen + n_new].tolist())
            if prefix + got[0, :slen + n_new].tolist() != want[-1]:
                raise AssertionError("f32 prefix tokens differ from the "
                                     "concatenated prompt's")
    fleet32 = _engine_tokens(DecodeEngine(m32, SLOTS, engine.max_len),
                             suffixes, n_new, prefix=(b32, p32))
    if [prefix + r for r in fleet32] != want:
        raise AssertionError("f32 prefix engine tokens differ")
    del m32, b32
    later = lat[1:]
    _phase("serve_prefix", card=card,
           flags=f"{' '.join(SERVE_FLAGS)} --prefix-cache 4 "
                 f"[--slots {SLOTS}]",
           prefix_len=PREFIX_LEN, suffix_lens=sfx_lens, launches=launches,
           cache_stats=stats,
           per_request={"latency_ms": lat, "first_miss_ms": lat[0],
                        "later_hits_median_ms": statistics.median(later),
                        "no_cache_latency_ms": plat},
           ttft_ms={"suffix_len": sfx_lens[0], **ttft},
           slots={"latency_ms": slat, "batch_wall_ms": swall,
                  "decode_tokens_per_s": n_new * SLOTS / (swall / 1e3)},
           block_unchanged_after_requests=True,
           f32={"per_request_rows_identical": SLOTS,
                "engine_rows_identical": SLOTS},
           bf16_agreement_with_no_cache={
               "per_request": _agreement(rows, prows, full),
               "slots": _agreement(srows, prows, full)})
    return launches["flash_decode"]


def _self_draft_checkpoint(directory, args):
    """The target's own random weights (seed 0) saved by the port's
    TrainCheckpointer, as the trainer saves a step."""
    import torch

    from container_engine_accelerators_tpu_torch.models.checkpoint import (
        TrainCheckpointer,
    )
    from container_engine_accelerators_tpu_torch.models.lm_train import (
        create_lm_train_state,
    )
    from container_engine_accelerators_tpu_torch.models.transformer import (
        TransformerLM,
    )

    model = TransformerLM(vocab_size=args.vocab_size,
                          num_layers=args.num_layers,
                          num_heads=args.num_heads, head_dim=args.head_dim,
                          mlp_dim=args.mlp_dim, device="cpu")
    state = create_lm_train_state(model, torch.Generator().manual_seed(0))
    state.step = 1
    ck = TrainCheckpointer(directory)
    ck.save(state)
    ck.close()


def _spec_case(fd, dev, name, flags, plain):
    """One draft of phase 17: per request and with --slots 8."""
    import numpy as np
    import torch

    from container_engine_accelerators_tpu_torch.cmd import serve_lm
    from container_engine_accelerators_tpu_torch.models.generate import (
        generate,
    )
    from container_engine_accelerators_tpu_torch.models.speculative import (
        generate_speculative,
    )

    args, run, loop, solo, slots = _feature_server(flags)
    engine, n_new, k = loop.engine, args.max_new_tokens, args.speculative
    d_layers = run.draft.num_layers
    rng = np.random.default_rng(FEATURE_SEED + 3)
    prompts = [rng.integers(0, args.vocab_size, n).tolist()
               for n in INT8_LENS]
    fleet_prompts = [rng.integers(0, args.vocab_size, n).tolist()
                     for n in slot_prompt_lens()]
    sampled = {"prompt_ids": [rng.integers(0, args.vocab_size, 12).tolist()],
               "temperature": 0.8, "seed": 4321}
    try:
        _reset(fd)
        r0, a0, d0 = run.spec_rounds, run.spec_accepted, run.spec_drafted
        e0 = (engine.spec_rounds, engine.spec_accepted, engine.spec_drafted)
        rows, lat = _ask_each(solo, _greedy_bodies(prompts))
        per_req = {"rounds": run.spec_rounds - r0,
                   "accepted": run.spec_accepted - a0,
                   "drafted": run.spec_drafted - d0}
        twice = _ask_each(solo, [sampled, sampled])[0]
        srows, slat, swall = _ask_all(slots, _greedy_bodies(fleet_prompts))
        fleet = {"rounds": engine.spec_rounds - e0[0],
                 "accepted": engine.spec_accepted - e0[1],
                 "drafted": engine.spec_drafted - e0[2]}
        stwice = _ask_each(slots, [sampled, sampled])[0]
        rounds = (run.spec_rounds - r0) + (engine.spec_rounds - e0[0])
        launches = _check_launches(
            fd, f"serve_spec ({name})", d_layers * (k + 1) * rounds,
            f"{d_layers} draft layers x {k + 1} draft steps x {rounds} "
            f"rounds (per request and fleet); verify chunks and prefills "
            f"take the einsum")
        prows, plat = _ask_each(plain[1], _greedy_bodies(prompts))
    finally:
        _close(loop, solo, slots)
    _check_rows(name, prompts, rows, n_new, args.vocab_size)
    _check_rows(f"{name} slots", fleet_prompts, srows, n_new,
                args.vocab_size)
    if twice[0] != twice[1] or stwice[0] != stwice[1]:
        raise AssertionError(f"{name}: a sampled request gave other tokens "
                             f"for the same seed")
    plain_fleet = [_solo_tokens(plain[0].model, p, n_new,
                                args.max_prompt_len) for p in fleet_prompts]

    # f32 at full width: speculative greedy tokens are generate()'s.
    m32 = _twin(args, run.params, dev, torch.float32)
    d32 = _twin(args, serve_lm.load_draft_params(args), dev, torch.float32,
                num_layers=d_layers)
    f32_stats = {"accepted": 0, "drafted": 0}
    with torch.inference_mode():
        for p in prompts:
            x, plen = _padded(p, args.max_prompt_len, dev)
            got, st = generate_speculative(m32, d32, x, n_new, k=k,
                                           prompt_len=plen)
            ref = generate(m32, x, n_new, prompt_len=plen)
            if not torch.equal(got[:, :plen + n_new], ref[:, :plen + n_new]):
                raise AssertionError(f"{name}: f32 speculative tokens differ "
                                     f"from generate's")
            f32_stats["accepted"] += int(st["accepted"].sum())
            f32_stats["drafted"] += int(st["drafted"].sum())
    del m32, d32

    def rate(st):
        return st["accepted"] / max(st["drafted"], 1)

    return {"draft_layers": d_layers, "k": k, "launches": launches,
            "per_request": {"latency_ms": lat, "plain_latency_ms": plat,
                            "acceptance": rate(per_req),
                            "tokens_per_round": 1 + per_req["accepted"]
                            / max(per_req["rounds"], 1), **per_req},
            "slots": {"latency_ms": slat, "batch_wall_ms": swall,
                      "decode_tokens_per_s": n_new * SLOTS / (swall / 1e3),
                      "acceptance": rate(fleet),
                      "tokens_per_lane_round": 1 + fleet["accepted"]
                      / max(fleet["drafted"] / k, 1), **fleet},
            "sampled_same_tokens_twice": {"per_request": True,
                                          "slots": True},
            "f32": {"greedy_rows_identical_to_generate": len(prompts),
                    "acceptance": rate(f32_stats)},
            "bf16_agreement_with_plain": {
                "per_request": _agreement(rows, prows, prompts),
                "slots": _agreement(srows, plain_fleet, fleet_prompts)}}


def serve_spec(fd, dev, card, plain):
    """Phase 17: ``--speculative 4`` with a random 3-layer draft
    (acceptance ~0, the worst case), then with the target's own weights
    as its draft through --draft-checkpoint-dir (acceptance ~1)."""
    k = str(SPEC_K)
    random = _spec_case(fd, dev, "random draft", [
        "--speculative", k, "--draft-layers", "3"], plain)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_draft_") as tmp:
        args = plain[0].args
        _self_draft_checkpoint(tmp, args)
        self_draft = _spec_case(fd, dev, "self draft", [
            "--checkpoint-dir", tmp, "--speculative", k, "--draft-layers",
            str(args.num_layers), "--draft-checkpoint-dir", tmp], plain)
    if self_draft["per_request"]["acceptance"] < 0.5:
        raise AssertionError("the self-draft accepted under half its "
                             "proposals")
    _phase("serve_spec", card=card,
           flags=f"{' '.join(SERVE_FLAGS)} --speculative {SPEC_K} "
                 f"[--slots {SLOTS}]",
           prompt_lens=INT8_LENS, fleet_prompt_lens=slot_prompt_lens(),
           random_draft=random, self_draft=self_draft)
    return (random["launches"]["flash_decode"]
            + self_draft["launches"]["flash_decode"])


# ---- phases 18-20: the MoE-LM (--num-experts 8, Switch top-1) --------------

MOE_FLAGS = ["--num-experts", "8"]
# The train step's routing shape at the trainer's defaults: N = 8 x 2048
# tokens, D 512, H 2048, E 8 (capacity C = ceil(1.25 N / E) = 2560).
MOE_FFN = {"n": 16384, "d": 512, "h": 2048, "e": 8}
MOE_LEAVES = ("x", "router", "wi_gate", "wi_up", "wo")
MOE_F64_TOL = 1e-9  # f64 card vs CPU: of the leaf's largest |value|
MOE_FLIP_SHARE = 1e-3  # f32 card vs CPU: tokens whose expert may differ
MOE_OUT_TOL = 1e-4  # f32: output error on tokens routed alike, of the max
# Full-width MoE-LM, f32 loss with flash kernels vs dense attention: a
# route flipped by rounding moves one token's FFN output, ~3e-5 of the
# loss; dense models hold 1e-5 (train_parity).
MOE_LM_LOSS_REL = 1e-4


def _moe_ffn_case(dev, dtype, leaves, wt, grad):
    """``ops/moe.py::moe_ffn`` on ``dev`` in ``dtype`` over the CPU f64
    ``leaves`` (MOE_LEAVES' order) -> CPU results; with ``grad`` also the
    gradients of ``sum(out * wt) + 0.3 * aux``."""
    import torch

    from container_engine_accelerators_tpu_torch.ops import moe

    ts = [t.to(dev, dtype, copy=True).requires_grad_(grad) for t in leaves]
    out, aux, dropped = moe.moe_ffn(*ts, dtype)
    cap = moe.capacity(MOE_FFN["n"], MOE_FFN["e"], 1.25, False)
    r = moe.route(ts[0].detach(), ts[1].detach(), cap)
    res = {"out": out.detach().cpu(), "aux": aux.item(),
           "dropped": dropped.item(), "expert": r.expert.cpu(),
           "keep": r.keep.cpu()}
    if grad:
        ((out * wt.to(dev, dtype)).sum() + 0.3 * aux).backward()
        res["grads"] = {n: t.grad.cpu() for n, t in zip(MOE_LEAVES, ts)}
    return res


def _to_max(got, want):
    return ((got - want).abs().max() / want.abs().max()).item()


def _moe_lm(args, dev, **kw):
    """A train-mode TransformerLM of ``args``' widths and experts."""
    from container_engine_accelerators_tpu_torch.models.transformer import (
        TransformerLM,
    )

    return TransformerLM(vocab_size=args.vocab_size,
                         num_layers=args.num_layers, num_heads=args.num_heads,
                         head_dim=args.head_dim, mlp_dim=args.mlp_dim,
                         num_experts=args.num_experts, device=dev, **kw)


def moe_parity(dev, card):
    """Phase 18: the MoE FFN at the train shape, card against CPU (f64,
    then f32), and the full-width MoE-LM's loss with the flash kernels
    against dense attention."""
    import numpy as np
    import torch

    from container_engine_accelerators_tpu_torch.models import lm_train
    from container_engine_accelerators_tpu_torch.models.transformer import (
        TransformerLM,
        init_params,
    )
    from container_engine_accelerators_tpu_torch.ops import moe

    from container_engine_accelerators_tpu_torch.cmd import train_lm

    n, d, h, e = (MOE_FFN[k] for k in "ndhe")
    g = torch.Generator().manual_seed(21)

    def draw(*shape, fan_in=1):
        return torch.randn(*shape, generator=g,
                           dtype=torch.float64) / fan_in ** 0.5

    leaves = [draw(n, d), draw(d, e, fan_in=d), draw(e, d, h, fan_in=d),
              draw(e, d, h, fan_in=d), draw(e, h, d, fan_in=h)]
    wt = draw(n, d)
    card64, cpu64 = (_moe_ffn_case(w, torch.float64, leaves, wt, True)
                     for w in (dev, "cpu"))
    if not (torch.equal(card64["expert"], cpu64["expert"])
            and torch.equal(card64["keep"], cpu64["keep"])):
        raise AssertionError("f64 routing differs between card and CPU")
    f64 = {"out": _to_max(card64["out"], cpu64["out"]),
           "aux_rel": abs(card64["aux"] - cpu64["aux"]) / abs(cpu64["aux"]),
           **{f"grad_{k}": _to_max(card64["grads"][k], cpu64["grads"][k])
              for k in MOE_LEAVES}}
    if not all(v <= MOE_F64_TOL for v in f64.values()):
        raise AssertionError(f"f64 MoE FFN, card vs CPU: {f64}")
    dropped = cpu64["dropped"]
    del card64, cpu64
    card32, cpu32 = (_moe_ffn_case(w, torch.float32, leaves, wt, False)
                     for w in (dev, "cpu"))
    flipped = card32["expert"] != cpu32["expert"]
    alike = ~flipped & (card32["keep"] == cpu32["keep"])
    out_err = ((card32["out"] - cpu32["out"])[alike].abs().max()
               / cpu32["out"].abs().max()).item()
    share = flipped.float().mean().item()
    if not (share <= MOE_FLIP_SHARE and out_err <= MOE_OUT_TOL):
        raise AssertionError(f"f32 MoE FFN, card vs CPU: {share} of tokens "
                             f"routed differently, output error {out_err}")
    del card32, cpu32

    # The full-width MoE-LM (the trainer's widths), batch 2, f32: the
    # flash kernels vs dense attention.
    args = train_lm.parse_args(MOE_FLAGS)
    params = init_params(_moe_lm(args, "meta"),
                         torch.Generator().manual_seed(0))
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, args.vocab_size, (2, args.seq_len))).to(dev)
    labels, mask = lm_train.next_token_targets(toks)
    lm = {}
    for flash in (True, False):
        model = _moe_lm(args, dev, dtype=torch.float32, use_flash=flash)
        model.load_state_dict(params)
        routes = []

        def hook(mod, inp, out):
            x = inp[0]
            routes.append(moe.route(x.reshape(-1, x.shape[-1]), mod.router,
                                    1).expert)

        hooks = [b.moe.register_forward_hook(hook) for b in model.blocks]
        with torch.no_grad():
            num, den, aux = lm_train._loss(model, toks, labels, mask, None,
                                           with_aux=True)
        for hk in hooks:
            hk.remove()
        lm[flash] = ((num / den).item(), aux.loss.item(), aux.dropped.item(),
                     torch.stack(routes))
        del model
    rel = abs(lm[True][0] - lm[False][0]) / abs(lm[False][0])
    differ = int((lm[True][3] != lm[False][3]).sum())
    if not (rel <= MOE_LM_LOSS_REL and math.isfinite(lm[True][0])):
        raise AssertionError(f"MoE-LM f32 loss, kernels vs dense: "
                             f"{lm[True][0]} vs {lm[False][0]}")
    _phase("moe_parity", card=card,
           ffn={"shape": f"N={n} D={d} H={h} E={e} C="
                         f"{moe.capacity(n, e, 1.25, False)}",
                "f64_routing": "identical expert index and kept set",
                "f64_err_to_leaf_max": f64, "f64_tolerance": MOE_F64_TOL,
                "dropped_share": dropped,
                "f32_tokens_routed_differently": int(flipped.sum()),
                "f32_share_routed_differently": share,
                "f32_share_bound": MOE_FLIP_SHARE,
                "f32_out_err_to_max_on_tokens_routed_alike": out_err,
                "f32_out_tolerance": MOE_OUT_TOL, "tf32": False},
           lm={"config": f"{args.num_layers}L {args.num_heads}x{args.head_dim} "
                         f"mlp{args.mlp_dim} vocab{args.vocab_size} "
                         f"E{args.num_experts}, batch 2 x {args.seq_len}, f32",
               "loss_kernels": lm[True][0], "loss_dense": lm[False][0],
               "loss_rel_diff": rel, "tolerance": MOE_LM_LOSS_REL,
               "aux_kernels": lm[True][1], "aux_dense": lm[False][1],
               "dropped_share": lm[True][2],
               "routes_differing": differ, "routes": lm[True][3].numel()})


MOE_KINDS = ("expert_gemms", "routing", "attention", "lm_head_and_loss",
             "embedding", "other")


def _moe_kind(names, shapes, vocab, router_shape):
    """The kind of a kernel from the names of the ops around its launch
    (innermost first) and their input shapes."""
    chain = " ".join(names).lower()
    if "embedding" in chain:
        return "embedding"
    if (any(k in chain for k in ("cross_entropy", "nll", "log_softmax",
                                 "logsoftmax"))
            or any(isinstance(s, list) and vocab in s for s in shapes)):
        return "lm_head_and_loss"
    if "flash_attention" in chain or "flashattention" in chain:
        return "attention"
    if "bmm" in chain:
        return "expert_gemms"
    if router_shape in shapes or any(k in chain for k in (
            "index", "scatter", "gather", "cumsum", "one_hot", "argmax",
            "softmax")):
        return "routing"
    return "other"


def _traced_kinds(fn, vocab, router_shape):
    """(device ms by kind, device ms, wall ms, launches by kind) of
    ``fn()`` — which must end synchronized — traced by torch.profiler;
    each kernel is charged to the ops around the call that launched it
    (``_moe_kind``)."""
    from collections import Counter, defaultdict

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.events()
    device_ms = sum(e.time_range.elapsed_us() for e in events
                    if e.device_type == DeviceType.CUDA) / 1e3
    kinds, launches = defaultdict(float), Counter()
    for ev in events:
        if ev.device_type != DeviceType.CPU or not ev.kernels:
            continue
        names, shapes, p = [], [], ev
        while p is not None:
            names.append(p.name)
            shapes.extend(p.input_shapes or [])
            p = p.cpu_parent
        kind = _moe_kind(names, shapes, vocab, router_shape)
        for k in ev.kernels:
            kinds[kind] += k.duration / 1e3
            launches[kind] += 1
    if not device_ms:
        raise AssertionError("the profiler recorded no device activity")
    return dict(kinds), device_ms, wall_ms, dict(launches)


def train_moe(fa, dev, card, ckpt):
    """Phase 19: the trainer's main() at its defaults plus --num-experts 8
    (launch counts reset around it), one step traced by kind, and a
    checkpointed run resumed to the same step.  -> (flash launches, the
    losses)."""
    import shutil

    import torch

    from container_engine_accelerators_tpu_torch.cmd import train_lm
    from container_engine_accelerators_tpu_torch.models import lm_train
    from container_engine_accelerators_tpu_torch.models.checkpoint import (
        STATE_FILE,
        TrainCheckpointer,
    )

    argv = MOE_FLAGS + ["--train-steps", str(TRAIN_STEPS),
                        "--steps-per-eval", "1"]
    args = train_lm.parse_args(argv)
    ends, aux, dropped = [], [], []

    def on_step(step, loss, metrics):
        torch.cuda.synchronize()
        ends.append(time.perf_counter())
        aux.append(metrics["moe_aux"])
        dropped.append(metrics["moe_dropped"])

    for name in fa.LAUNCHES:
        fa.LAUNCHES[name] = 0
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    losses = train_lm.main(argv, on_step=on_step)
    wall_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = dict(fa.LAUNCHES)
    layers_steps = args.num_layers * TRAIN_STEPS
    want = {"flash_attention_fwd": 2 * layers_steps,
            "flash_attention_bwd_dq": layers_steps,
            "flash_attention_bwd_dkv": layers_steps}
    if launches != want:
        raise AssertionError(f"flash attention launches on the MoE path "
                             f"{launches}, expected {want}")
    aux = [float(a) for a in aux]
    dropped = [float(x) for x in dropped]
    if not all(math.isfinite(x) for x in losses + aux):
        raise AssertionError(f"non-finite MoE loss or aux: {losses} {aux}")
    steady = [b - a for a, b in zip(ends[1:], ends[2:])]
    step_ms = statistics.median(steady) * 1e3
    tokens = args.train_batch_size * args.seq_len

    # One step traced: device time by kind, after a warm-up step.
    model = _moe_lm(args, dev)
    state = lm_train.create_lm_train_state(model,
                                           torch.Generator().manual_seed(0))
    step = lm_train.make_lm_train_step()[0]
    batches = [tuple(torch.from_numpy(x).to(dev) for x in b)
               for b in train_lm.synthetic_batches(args)[:2]]
    batches = [(t.long(), lb.long(), m) for t, lb, m in batches]
    step(state, *batches[0])
    torch.cuda.synchronize()
    d = args.num_heads * args.head_dim
    kinds, device_ms, traced_ms, kind_launches = _traced_kinds(
        lambda: step(state, *batches[1]), args.vocab_size,
        [d, args.num_experts])
    del model, state, batches
    torch.cuda.empty_cache()

    # Resume: 4 steps at interval 2, then a restart to step 6.
    argv = MOE_FLAGS + ["--checkpoint-dir", ckpt, "--checkpoint-interval",
                        "2", "--steps-per-eval", "1"]
    t0 = time.perf_counter()
    first = train_lm.main(argv + ["--train-steps", "4"])
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    resumed = train_lm.main(argv + ["--train-steps", str(TRAIN_STEPS)])
    resumed_s = time.perf_counter() - t0
    saved_steps = TrainCheckpointer(ckpt).all_steps()
    ckpt_bytes = os.path.getsize(os.path.join(ckpt, str(TRAIN_STEPS),
                                              STATE_FILE))
    if len(first) != 4 or len(resumed) != TRAIN_STEPS - 4:
        raise AssertionError(f"resume ran {len(first)} + {len(resumed)} "
                             f"steps")
    if saved_steps != [2, 4, TRAIN_STEPS]:
        raise AssertionError(f"saved steps {saved_steps}")
    rel = max(abs(a - b) / abs(b) for a, b in zip(first + resumed, losses))
    if not rel <= 2e-2:
        raise AssertionError(f"resumed MoE losses {first + resumed} vs "
                             f"unbroken {losses}")
    for old in saved_steps[:-1]:  # serve_moe reads the last step only
        shutil.rmtree(os.path.join(ckpt, str(old)))
    _phase("train_moe", card=card,
           entry="cmd/train_lm.py main() at its defaults plus --num-experts "
                 "8: 12L 8x64 mlp2048 vocab32000 E8, seq 2048, batch 8, "
                 "bf16, remat, capacity factor 1.25, aux weight 0.01",
           steps=TRAIN_STEPS, losses=losses, aux_per_step=aux,
           dropped_share_per_step=dropped, launches=launches,
           expected_launches=f"fwd 2 x {args.num_layers} layers x "
                             f"{TRAIN_STEPS} steps (remat), bwd "
                             f"{args.num_layers} x {TRAIN_STEPS}",
           wall_s=wall_s, steady_step_ms=step_ms, steady_steps=len(steady),
           step_ms_each=[x * 1e3 for x in steady],
           tokens_per_s=tokens / (step_ms / 1e3),
           peak_memory_bytes=peak, resident_before_bytes=resident,
           traced_step={"wall_ms": traced_ms, "device_ms": device_ms,
                        "device_busy_share": device_ms / traced_ms,
                        "device_ms_by_kind": kinds,
                        "launches_by_kind": kind_launches,
                        "attributed_share": sum(kinds.values()) / device_ms},
           resume={"losses": first + resumed, "unbroken_losses": losses,
                   "losses_exact": first + resumed == losses,
                   "max_rel_diff": rel,
                   "tolerance": "exact if equal, else within 2e-2 "
                                "relative (bf16)",
                   "saved_steps": saved_steps,
                   "checkpoint_bytes": ckpt_bytes,
                   "run_seconds": {"first": first_s,
                                   "resumed": resumed_s}})
    return launches, losses, dropped


def serve_moe(fd, dev, card, plain, ckpt):
    """Phase 20: the MoE server per request and with --slots 8, beside
    the dense server; int8, speculative and --checkpoint-dir."""
    import numpy as np
    import torch

    from container_engine_accelerators_tpu_torch.cmd import serve_lm
    from container_engine_accelerators_tpu_torch.models.batching import (
        DecodeEngine,
    )
    from container_engine_accelerators_tpu_torch.models.checkpoint import (
        STATE_FILE,
    )
    from container_engine_accelerators_tpu_torch.models.generate import (
        generate,
    )
    from container_engine_accelerators_tpu_torch.models.quant import (
        dequantize_params,
        param_bytes,
        serving_params,
    )
    from container_engine_accelerators_tpu_torch.models.speculative import (
        generate_speculative,
    )
    from container_engine_accelerators_tpu_torch.models.transformer import (
        TransformerLM,
    )

    experts = int(MOE_FLAGS[1])
    args, run, loop, solo, slots = _feature_server(MOE_FLAGS)
    engine, n_new, layers = loop.engine, args.max_new_tokens, args.num_layers
    requests = serve_requests(args.vocab_size)
    fleet_prompts = slot_prompts(args.vocab_size)
    greedy = []  # (prompt, the server's row) of the greedy requests
    try:
        _reset(fd)
        steps0 = engine.steps
        per_request, rows = [], 0
        for name, body in requests:
            resp = _post(solo[0].server_address[1], body)[1]
            _check_rows(name, body["prompt_ids"], resp["tokens"], n_new,
                        args.vocab_size)
            rows += len(body["prompt_ids"])
            if name == "sampled":
                # Same seed, same tokens.
                rows += 1
                if _post(solo[0].server_address[1],
                         body)[1]["tokens"] != resp["tokens"]:
                    raise AssertionError("MoE sampled request not "
                                         "reproducible from its seed")
            else:
                greedy += list(zip(body["prompt_ids"], resp["tokens"]))
            per_request.append({"request": name,
                                "latency_ms": resp["latency_ms"],
                                "new_tokens": n_new
                                * len(body["prompt_ids"])})
        srows, slat, swall = _ask_all(slots, _greedy_bodies(fleet_prompts))
        fleet = engine.steps - steps0
        launches = _check_launches(
            fd, "serve_moe", layers * ((n_new - 1) * rows + fleet),
            f"{layers} layers x ({n_new - 1} steps x {rows} generates + "
            f"{fleet} fleet steps)")
        dense = [_ask_each(plain[1], [body])[1][0] for _, body in requests]
    finally:
        _close(loop, solo, slots)
    _check_rows("moe slots", fleet_prompts, srows, n_new, args.vocab_size)
    moe_ms = [r["latency_ms"] for r in per_request]
    new_tokens = sum(r["new_tokens"] for r in per_request)

    # The server's rows are generate()'s (bf16); in f32, the engine's are
    # per-request generate()'s.
    for p, row in greedy:
        if row != _solo_tokens(run.model, p, n_new, args.max_prompt_len):
            raise AssertionError("MoE server rows differ from generate()'s")
    f32 = _twin(args, run.params, dev, torch.float32, num_experts=experts)
    f32_solo = [_solo_tokens(f32, p, n_new, args.max_prompt_len)
                for p in fleet_prompts]
    f32_fleet = _engine_tokens(DecodeEngine(f32, SLOTS, engine.max_len),
                               fleet_prompts, n_new)
    if f32_fleet != f32_solo:
        raise AssertionError("f32 MoE engine tokens differ from per-request "
                             "generate()'s")
    del f32

    # --weights int8: attention kernels int8, experts bf16 (float).
    rng = np.random.default_rng(FEATURE_SEED)
    prompts = [rng.integers(0, args.vocab_size, n).tolist()
               for n in INT8_LENS]
    qargs = serve_lm.parse_args(SERVE_FLAGS + MOE_FLAGS
                                + ["--weights", "int8", "--port", "0"])
    qrun = serve_lm.build_generate(qargs)
    _reset(fd)
    qrows = [qrun(*_padded(p, args.max_prompt_len, "cpu"), 0.0, 0,
                  False)[0, :len(p) + n_new].tolist() for p in prompts]
    q_launches = _check_launches(
        fd, "serve_moe int8", layers * (n_new - 1) * len(prompts),
        f"{layers} layers x {n_new - 1} steps x {len(prompts)} requests")
    q = serving_params(qrun.params, "int8")
    deq = _twin(args, dequantize_params(q), dev, torch.bfloat16,
                num_experts=experts)
    if qrows != [_solo_tokens(deq, p, n_new, args.max_prompt_len)
                 for p in prompts]:
        raise AssertionError("MoE int8 tokens differ from the dequantized "
                             "bf16 model's")
    q_bytes = {"int8": param_bytes(q),
               "bf16": param_bytes(serving_params(qrun.params, "bf16"))}
    del qrun, deq, q

    # --speculative 4: the draft inherits the experts; f32 exactness.
    sargs = serve_lm.parse_args(SERVE_FLAGS + MOE_FLAGS
                                + ["--speculative", str(SPEC_K), "--port",
                                   "0"])
    srun = serve_lm.build_generate(sargs)
    d_cfg = serve_lm._draft_cfg(sargs)
    if srun.draft.blocks[0].moe is None:
        raise AssertionError("the speculative draft has no experts")
    for p in prompts[:2]:
        srun(*_padded(p, args.max_prompt_len, "cpu"), 0.0, 0, False)
    spec_stats = {"rounds": srun.spec_rounds, "drafted": srun.spec_drafted,
                  "accepted": srun.spec_accepted}
    t32 = _twin(sargs, srun.params, dev, torch.float32, num_experts=experts)
    d32 = TransformerLM(**d_cfg, dtype=torch.float32, decode=True,
                        use_flash_decode=True, device=dev)
    d32.load_state_dict(serve_lm.load_draft_params(sargs))
    for p in prompts[:2]:
        x, plen = _padded(p, args.max_prompt_len, dev)
        with torch.inference_mode():
            got, _ = generate_speculative(t32, d32.eval(), x, n_new,
                                          k=SPEC_K, prompt_len=plen)
            want = generate(t32, x, n_new, prompt_len=plen)
        if not torch.equal(got[:, :plen + n_new], want[:, :plen + n_new]):
            raise AssertionError("f32 MoE speculative tokens differ from "
                                 "generate()'s")
    del srun, t32, d32

    # --checkpoint-dir: train_moe's last step.
    cargs = serve_lm.parse_args(SERVE_FLAGS + MOE_FLAGS
                                + ["--checkpoint-dir", ckpt, "--port", "0"])
    crun = serve_lm.build_generate(cargs)
    saved = torch.load(os.path.join(ckpt, str(TRAIN_STEPS), STATE_FILE),
                       map_location="cpu", weights_only=True)["model"]
    if saved.keys() != crun.params.keys() or not all(
            torch.equal(saved[k], crun.params[k]) for k in saved):
        raise AssertionError("the MoE server's weights are not the "
                             "checkpoint's")
    twin = _twin(cargs, saved, dev, torch.bfloat16, num_experts=experts)
    p = prompts[1]
    if (crun(*_padded(p, args.max_prompt_len, "cpu"), 0.0, 0,
             False)[0, :len(p) + n_new].tolist()
            != _solo_tokens(twin, p, n_new, args.max_prompt_len)):
        raise AssertionError("the MoE server's tokens on the checkpoint "
                             "differ from generate()'s on the saved weights")
    del crun, twin, saved
    torch.cuda.empty_cache()
    _phase("serve_moe", card=card,
           flags=f"{' '.join(SERVE_FLAGS + MOE_FLAGS)} [--slots {SLOTS}]",
           launches=launches,
           per_request={"requests": per_request,
                        "moe_latency_ms": moe_ms, "dense_latency_ms": dense,
                        "moe_decode_tokens_per_s":
                        new_tokens / (sum(moe_ms) / 1e3),
                        "dense_decode_tokens_per_s":
                        new_tokens / (sum(dense) / 1e3),
                        "latency_ratio_moe_to_dense":
                        statistics.median(m / x for m, x in zip(moe_ms,
                                                                dense))},
           slots={"prompt_lens": slot_prompt_lens(), "latency_ms": slat,
                  "batch_wall_ms": swall,
                  "decode_tokens_per_s": n_new * SLOTS / (swall / 1e3),
                  "fleet_steps": fleet,
                  "dense": "the serve_slots phase, same prompts"},
           f32_identical={"server_rows_to_generate": len(greedy),
                          "engine_rows_to_per_request": SLOTS},
           int8={"param_bytes": q_bytes, "launches": q_launches,
                 "dequantized_bf16_identical_rows": len(prompts)},
           speculative={"k": SPEC_K, "draft_layers": d_cfg["num_layers"],
                        "draft_experts": d_cfg["num_experts"],
                        "server_stats": spec_stats,
                        "f32_rows_identical_to_generate": 2},
           checkpoint={"step": TRAIN_STEPS, "weights": "equal to the "
                       "checkpoint's", "greedy_row_identical": True})
    return launches["flash_decode"] + q_launches["flash_decode"]


# ---- phases 21-24: the image-model path (ResNet-50, Inception-v3) ----------

IMAGE_BATCH, IMAGE_SIZE = 8, 224  # resnet_parity's batch and images
IMAGE_STEPS = 30  # train_resnet: steps 10-20 traced (--profile-dir)
IMAGE_TRACED = range(10, 21)
INCEPTION_STEPS = 6
RESUME_STEPS, RESUME_AT = 12, 6
SERVE_REQUESTS = 20
IMAGE_TOL = {"logits_to_max": 1e-4, "loss_rel": 1e-4, "stats_to_leaf_max": 1e-4,
             "f64_loss_rel": 1e-9, "f64_to_leaf_max": 1e-6,
             # The card's f32 gradients may sit no more than this many
             # times farther from the f64 ones than the CPU's f32 do.
             "f32_grad_vs_cpu_f32": 2.0}


def _bf16_peak(card_name):
    """NVIDIA's dense bf16 peak for an H100 by its name (the data sheet:
    SXM 989 TFLOP/s, PCIe 756), else None."""
    if "H100" not in card_name:
        return None
    return 756e12 if "PCIe" in card_name else 989e12


def _kernel_counts():
    """Every launch counter of the port's kernels, for the phases that
    must launch none of them."""
    from container_engine_accelerators_tpu_torch.ops import flash_attention
    from container_engine_accelerators_tpu_torch.ops import flash_decode

    return {**flash_decode.LAUNCHES, **flash_attention.LAUNCHES}


def _launches_none(phase, before):
    after = _kernel_counts()
    if after != before:
        raise AssertionError(f"{phase} launched the port's kernels: "
                             f"{before} -> {after}")


def _drawn_image_state(model, gen):
    """init_params's values, then every BatchNorm scale, bias and running
    statistic drawn from ``gen``: the zero-initialised last scale of each
    block would zero that branch and every gradient behind it."""
    import torch

    from container_engine_accelerators_tpu_torch.models.resnet import (
        init_params,
    )

    state = init_params(model, gen)
    for name, t in state.items():
        if t.ndim != 1 or name.startswith("head."):
            continue
        if name.endswith(("weight", "running_var")):
            state[name] = torch.rand(t.shape, generator=gen) * 0.4 + 0.8
        else:
            state[name] = torch.randn(t.shape, generator=gen) * 0.1
    return state


def _leaf_max_errs(got, want):
    """{name: max |got - want| / max |want|} over two state-like dicts."""
    return {k: ((got[k].float().cpu() - want[k].float()).abs().max()
                / want[k].float().abs().max().clamp_min(1e-30)).item()
            for k in want}


def resnet_parity(dev, card):
    """Phase 21: ResNet-50 at full width on the card against the same
    model on the CPU — eval logits in f32 with TF32 off, one train step
    (loss, every gradient, the running statistics) in f64 and in f32 —
    and the card's bf16 eval logits against its f32 ones."""
    import numpy as np
    import torch

    from container_engine_accelerators_tpu_torch.models import train as ptrain
    from container_engine_accelerators_tpu_torch.models.resnet import resnet

    before = _kernel_counts()
    rng = np.random.default_rng(0)
    x = rng.standard_normal((IMAGE_BATCH, IMAGE_SIZE, IMAGE_SIZE, 3)).astype(
        np.float32)
    y = rng.integers(0, 1000, IMAGE_BATCH).astype(np.int64)
    cpu = resnet(50, dtype=torch.float32)
    state = _drawn_image_state(cpu, torch.Generator().manual_seed(0))
    cpu.load_state_dict(state)
    card_f32 = resnet(50, dtype=torch.float32, device=dev)
    card_f32.load_state_dict(state)
    images = torch.from_numpy(x).permute(0, 3, 1, 2)
    out = {}
    with torch.inference_mode():
        want = cpu.eval()(images)
        got = card_f32.eval()(images.to(dev)).cpu()
    err = (got - want).abs().max().item()
    out["eval_f32"] = {"max_abs_err": err,
                       "to_max": err / want.abs().max().item(),
                       "top1_agree": (got.argmax(-1) == want.argmax(-1))
                       .float().mean().item()}
    if not out["eval_f32"]["to_max"] <= IMAGE_TOL["logits_to_max"]:
        raise AssertionError(f"card f32 eval logits vs the CPU's: {out}")

    def step(model, device, dtype):
        s = ptrain.create_train_state(model, None, ptrain.cosine_sgd(
            total_steps=10, warmup_steps=1))
        before_params = {n: p.detach().clone()
                         for n, p in model.named_parameters()}
        s, metrics = ptrain.train_step(s, images.to(device, dtype),
                                       torch.from_numpy(y).to(device))
        moved = [n for n, p in model.named_parameters()
                 if not torch.equal(p.detach(), before_params[n])]
        grads = {n: p.grad.detach() for n, p in model.named_parameters()}
        stats = {k: v for k, v in model.state_dict().items()
                 if "running" in k}
        return metrics["loss"].item(), grads, stats, moved

    def compare(got, want):
        grad_errs = _leaf_max_errs(got[1], want[1])
        worst = max(grad_errs, key=grad_errs.get)
        return {"loss_rel": abs(got[0] - want[0]) / abs(want[0]),
                "max_grad_err_to_leaf_max": grad_errs[worst],
                "worst_grad_leaf": worst,
                "median_grad_err_to_leaf_max":
                    statistics.median(grad_errs.values()),
                "max_stats_err_to_leaf_max":
                    max(_leaf_max_errs(got[2], want[2]).values())}

    # The step's arithmetic in f64 on both sides, then f32 on both, each
    # f32 side also against the CPU's f64 (its own rounding error).
    runs = {}
    for name, device, dtype in (("cpu_f64", "cpu", torch.float64),
                                ("card_f64", dev, torch.float64),
                                ("cpu_f32", "cpu", torch.float32),
                                ("card_f32", dev, torch.float32)):
        model = resnet(50, dtype=dtype, device=device).to(dtype)
        model.load_state_dict(state)
        runs[name] = step(model, device, dtype)
        del model
    out["train_f64"] = {"loss": runs["card_f64"][0],
                        **compare(runs["card_f64"], runs["cpu_f64"])}
    out["train_f32"] = {"loss": runs["card_f32"][0],
                        "loss_cpu": runs["cpu_f32"][0],
                        **compare(runs["card_f32"], runs["cpu_f32"]),
                        "card_vs_f64": compare(runs["card_f32"],
                                               runs["cpu_f64"]),
                        "cpu_vs_f64": compare(runs["cpu_f32"],
                                              runs["cpu_f64"])}
    out["params_moved_at_step_0"] = sum(len(r[3]) for r in runs.values())
    t64, t32 = out["train_f64"], out["train_f32"]
    if (t64["loss_rel"] > IMAGE_TOL["f64_loss_rel"]
            or t64["max_grad_err_to_leaf_max"] > IMAGE_TOL["f64_to_leaf_max"]
            or t64["max_stats_err_to_leaf_max"]
            > IMAGE_TOL["f64_to_leaf_max"]):
        raise AssertionError(f"card f64 train step vs the CPU's: {t64}")
    if (t32["loss_rel"] > IMAGE_TOL["loss_rel"]
            or t32["max_stats_err_to_leaf_max"]
            > IMAGE_TOL["stats_to_leaf_max"]
            or t32["card_vs_f64"]["max_grad_err_to_leaf_max"]
            > IMAGE_TOL["f32_grad_vs_cpu_f32"]
            * t32["cpu_vs_f64"]["max_grad_err_to_leaf_max"]):
        raise AssertionError(f"card f32 train step vs the CPU's: {t32}")
    # optax reads the schedule at the count before it increments: lr 0.
    if out["params_moved_at_step_0"]:
        raise AssertionError("step 0 moved params at lr 0")
    del cpu, card_f32, runs

    card_bf16 = resnet(50, device=dev)
    card_bf16.load_state_dict(state)
    with torch.inference_mode():
        low = card_bf16.eval()(images.to(dev)).cpu()
    diff = (low - got).abs().max().item()  # got: the card's f32 logits
    out["eval_bf16_vs_f32"] = {
        "top1_agree": (low.argmax(-1) == got.argmax(-1)).float().mean()
        .item(), "max_abs_diff": diff,
        "to_max": diff / got.abs().max().item()}
    if not torch.isfinite(low).all():
        raise AssertionError("non-finite bf16 logits")
    del card_bf16
    _launches_none("resnet_parity", before)
    _phase("resnet_parity", card=card,
           config=f"ResNet-50, {IMAGE_SIZE}x{IMAGE_SIZE}, batch "
                  f"{IMAGE_BATCH}, weights from seed 0 with every BatchNorm "
                  f"value drawn from it",
           tolerance=IMAGE_TOL, launches="none of the port's kernels", **out)


def _image_step_ms(ends, skip=()):
    """Steady-state step ms from the on_step clock: intervals after the
    first two steps, leaving out the steps in ``skip``."""
    return [(b - a) * 1e3 for i, (a, b) in enumerate(zip(ends, ends[1:]), 1)
            if i >= 2 and i not in skip]


# Device time of an image step by kind of kernel, by name (first match).
KERNEL_KINDS = (("batch_norm", ("batch_norm", "bn_")),
                ("convolution", ("xmma", "cutlass", "cudnn", "conv",
                                 "implicit_gemm", "sm90_", "sm80_")),
                ("pooling", ("pool",)),
                ("copy", ("Memcpy", "Memset")),
                ("elementwise", ("elementwise", "reduce_kernel")))


def _by_kind(ops, steps):
    """{kind: device ms a step} over trace_summary's ops (sorted by time),
    and the three largest kernels left as "other"."""
    out, other = {}, []
    for o in ops:
        kind = next((k for k, keys in KERNEL_KINDS
                     if any(key in o["name"] for key in keys)), "other")
        out[kind] = out.get(kind, 0.0) + o["ms"] / steps
        if kind == "other" and len(other) < 3:
            other.append([o["name"][:80], o["ms"] / steps])
    return {**out, "other_top": other}


def _summary(trace_dir):
    proc = subprocess.run(
        [sys.executable, "-m",
         "container_engine_accelerators_tpu_torch.cmd.trace_summary",
         trace_dir, "--top", "100000"],
        cwd=HERE, capture_output=True, text=True, timeout=600)
    if proc.returncode:
        raise AssertionError(f"trace_summary failed: {proc.stderr[-2000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def train_resnet(dev, card, model_dir):
    """Phase 22: the main image path — cmd/train_resnet.py's main() at its
    defaults (ResNet-50, batch 128, 224x224, bf16, channels_last) with
    --profile-dir and --model-dir, then --model inception-v3 at 299x299."""
    import torch

    from container_engine_accelerators_tpu_torch.cmd import train_resnet as tr
    from container_engine_accelerators_tpu_torch.models.inception import (
        inception_v3,
    )
    from container_engine_accelerators_tpu_torch.models.resnet import (
        forward_flops,
        resnet,
    )

    before = _kernel_counts()
    ends = []

    def on_step(step, loss):
        torch.cuda.synchronize()
        ends.append(time.perf_counter())

    args = tr.parse_args([])
    with tempfile.TemporaryDirectory(prefix="chip_smoke_rprof_") as prof:
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        losses = tr.main(["--train-steps", str(IMAGE_STEPS),
                          "--steps-per-eval", "10", "--profile-dir", prof,
                          "--model-dir", model_dir], on_step=on_step)
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        summary = _summary(prof)
    if len(losses) != IMAGE_STEPS or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"train_resnet losses: {losses}")
    if summary["steps"] != len(IMAGE_TRACED) or not summary[
            "device_ms_per_step"]:
        raise AssertionError(f"traced {summary['steps']} steps, device ms "
                             f"a step {summary['device_ms_per_step']}")
    # Traced steps, and the ones beside the profiler's start and stop, run
    # slower: leave them out.
    steady = _image_step_ms(ends, skip=range(IMAGE_TRACED.start,
                                             IMAGE_TRACED.stop + 1))
    step_ms = statistics.median(steady)
    flops = forward_flops(resnet(50, device=dev), args.image_size)
    peak_flops = _bf16_peak(torch.cuda.get_device_name(0))
    images_per_s = args.train_batch_size / (step_ms / 1e3)
    achieved = images_per_s * 3 * flops
    torch.cuda.empty_cache()

    ends.clear()
    inc_losses = tr.main(["--model", "inception-v3", "--image-size", "299",
                          "--train-steps", str(INCEPTION_STEPS),
                          "--steps-per-eval", str(INCEPTION_STEPS)],
                         on_step=on_step)
    if not all(math.isfinite(v) for v in inc_losses):
        raise AssertionError(f"inception losses: {inc_losses}")
    inc_steady = _image_step_ms(ends)
    inc_flops = forward_flops(inception_v3(device=dev), 299)
    torch.cuda.empty_cache()
    _launches_none("train_resnet", before)
    _phase("train_resnet", card=card,
           entry="cmd/train_resnet.py main() at its defaults: ResNet-50, "
                 "batch 128, 224x224, bf16, channels_last, nesterov SGD",
           steps=IMAGE_STEPS, wall_s=wall, losses=losses,
           steady_step_ms=step_ms, step_ms_min=min(steady),
           step_ms_max=max(steady), steady_steps=len(steady),
           step_ms_each=[round(v, 3) for v in steady],
           images_per_s=images_per_s, peak_memory_bytes=peak,
           forward_flops_per_image=flops,
           train_flops_per_image=3 * flops,
           achieved_tflops=achieved / 1e12,
           bf16_peak_tflops=(peak_flops / 1e12 if peak_flops else None),
           share_of_bf16_peak=(achieved / peak_flops if peak_flops else None),
           trace={"traced_steps": summary["steps"],
                  "device_ms_per_step": summary["device_ms_per_step"],
                  "busy_share": summary["busy_share"],
                  "device_ms_over_untraced_step": (
                      summary["device_ms_per_step"] / step_ms),
                  "device_ms_per_step_by_kind": _by_kind(summary["ops"],
                                                         summary["steps"]),
                  "launches_per_step": summary["launches"] / summary["steps"],
                  "top": [[o["name"][:80], o["ms"], o["launches"]]
                          for o in summary["ops"][:12]]},
           inception_v3={"image_size": 299, "batch": args.train_batch_size,
                         "steps": INCEPTION_STEPS, "losses": inc_losses,
                         "steady_step_ms": statistics.median(inc_steady),
                         "step_ms_each": [round(v, 3) for v in inc_steady],
                         "images_per_s": args.train_batch_size
                         / (statistics.median(inc_steady) / 1e3),
                         "forward_flops_per_image": inc_flops},
           launches="none of the port's kernels")
    return losses


def train_resnet_resume(card):
    """Phase 23: the image trainer at its defaults, 12 steps unbroken
    against a run SIGTERMed at step 6 (it checkpoints and exits 80) and
    restarted from the checkpoint — with cuDNN's default algorithms, then
    with torch.backends.cudnn.deterministic."""
    import torch

    from container_engine_accelerators_tpu_torch.cmd import train_resnet as tr

    before = _kernel_counts()
    runs = {}
    for det in (False, True):
        torch.backends.cudnn.deterministic = det
        ends = []

        def on_step(step, loss):
            torch.cuda.synchronize()
            ends.append(time.perf_counter())

        first = []

        def preempt(step, loss):
            # A drain's SIGTERM during step RESUME_AT - 1: the trainer
            # saves step RESUME_AT and exits 80, as a Job's pod would.
            first.append(float(loss))
            if step == RESUME_AT - 1:
                os.kill(os.getpid(), signal.SIGTERM)

        argv = ["--train-steps", str(RESUME_STEPS), "--steps-per-eval", "100"]
        with tempfile.TemporaryDirectory(prefix="chip_smoke_rckpt_") as tmp:
            ck = ["--checkpoint-dir", tmp]
            unbroken = tr.main(argv, on_step=on_step)
            step_ms = _image_step_ms(ends)
            try:
                tr.main(argv + ck, on_step=preempt)
                raise AssertionError("the preempted run did not exit")
            except SystemExit as e:
                if e.code != 80:
                    raise AssertionError(f"preempted run exited {e.code}")
            resumed = tr.main(argv + ck)
        losses = first + resumed
        if len(first) != RESUME_AT or len(resumed) != RESUME_STEPS - RESUME_AT:
            raise AssertionError(f"resume ran {len(first)} + {len(resumed)}")
        rel = max(abs(a - b) / abs(b) for a, b in zip(losses, unbroken))
        if not rel <= 2e-2:
            raise AssertionError(f"resumed losses {losses} vs unbroken "
                                 f"{unbroken}")
        runs["deterministic" if det else "default"] = {
            "losses": losses, "unbroken_losses": unbroken,
            "exact": losses == unbroken, "max_rel_diff": rel,
            "median_step_ms": statistics.median(step_ms),
            "step_ms_each": [round(v, 3) for v in step_ms]}
    torch.backends.cudnn.deterministic = False
    torch.cuda.empty_cache()
    _launches_none("train_resnet_resume", before)
    cost = (runs["deterministic"]["median_step_ms"]
            / runs["default"]["median_step_ms"])
    _phase("train_resnet_resume", card=card,
           entry=f"cmd/train_resnet.py main() at its defaults, "
                 f"--train-steps {RESUME_STEPS}: unbroken, against a run "
                 f"with --checkpoint-dir SIGTERMed in step {RESUME_AT - 1} "
                 f"(exit 80, checkpoint at {RESUME_AT}) and restarted",
           tolerance="exact if equal, else within 2e-2 relative (bf16)",
           deterministic_needed_for_exact=(not runs["default"]["exact"]
                                           and runs["deterministic"]["exact"]),
           deterministic_step_cost=cost, **runs)


def serve_resnet(dev, card, model_dir):
    """Phase 24: cmd/serve_resnet.py behind a real HTTP server on the card:
    latency at batch 1 and 8, predictions against a direct eval forward
    and an ``inputs`` request, then --model-dir from phase 22."""
    import numpy as np
    import torch

    from container_engine_accelerators_tpu_torch.cmd import serve_resnet as sr

    before = _kernel_counts()

    def call(port, body):
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/predict", data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"})
        t0 = time.perf_counter()
        with urllib.request.urlopen(req, timeout=300) as r:
            resp = json.load(r)
        return resp, (time.perf_counter() - t0) * 1e3

    args = sr.parse_args(["--port", "0"])
    t0 = time.perf_counter()
    forward = sr.build_forward(args)
    build_s = time.perf_counter() - t0
    srv = _http_server(sr.make_handler(forward, args))
    port = srv[0].server_address[1]
    latency = {}
    try:
        for batch in (1, 8):
            server_ms, client_ms, preds = [], [], None
            for _ in range(SERVE_REQUESTS):
                resp, ms = call(port, {"batch": batch})
                server_ms.append(resp["latency_ms"])
                client_ms.append(ms)
                if preds is not None and resp["predictions"] != preds:
                    raise AssertionError("the same request gave other "
                                         "predictions")
                preds = resp["predictions"]
            x = sr.request_images({"batch": batch}, args)
            with torch.inference_mode():
                direct = forward.model(torch.from_numpy(x).to(dev).permute(
                    0, 3, 1, 2)).argmax(-1).tolist()
            if preds != direct:
                raise AssertionError(f"batch {batch}: server {preds} != "
                                     f"direct forward {direct}")
            latency[f"batch_{batch}"] = {
                "server_ms_median": statistics.median(server_ms),
                "server_ms_min": min(server_ms),
                "server_ms_max": max(server_ms),
                "client_ms_median": statistics.median(client_ms),
                "images_per_s": batch / (statistics.median(server_ms) / 1e3),
                "predictions": preds}
        x1 = sr.request_images({"batch": 1}, args)
        sent, _ = call(port, {"inputs": x1.tolist()})
        if sent["predictions"] != latency["batch_1"]["predictions"]:
            raise AssertionError("an inputs request of the same array "
                                 "predicted otherwise")
    finally:
        _shutdown(*srv)
    # Where a request's time goes: forward() called back to back in this
    # thread (no HTTP), and one call traced (device time against wall).
    for batch in (1, 8):
        xb = sr.request_images({"batch": batch}, args)
        entry = latency[f"batch_{batch}"]
        entry["direct_ms_median"] = _ms_median(lambda: forward(xb), reps=10)

        def in_new_thread():  # as ThreadingHTTPServer runs each request
            worker = threading.Thread(target=forward, args=(xb,))
            worker.start()
            worker.join()

        entry["new_thread_ms_median"] = _ms_median(in_new_thread, reps=10)
        device_ms, wall_ms, by_name, count = _traced(lambda: forward(xb))
        entry["traced"] = {
            "wall_ms": wall_ms, "device_ms": device_ms,
            "busy_share": device_ms / wall_ms,
            "launches": sum(count.values()),
            "top": [[k[:70], v] for k, v in sorted(
                by_name.items(), key=lambda kv: -kv[1])[:5]]}
    del forward

    loaded = sr.build_forward(sr.parse_args(["--model-dir", model_dir]))
    saved = torch.load(os.path.join(model_dir, sr.PARAMS_FILE),
                       map_location="cpu", weights_only=True)
    for name, p in loaded.model.named_parameters():
        if not torch.equal(p.detach().cpu(), saved[name]):
            raise AssertionError(f"--model-dir: {name} is not the saved one")
    stats = {k: v for k, v in loaded.model.state_dict().items()
             if "running" in k}
    if any(v.any() for k, v in stats.items() if k.endswith("mean")) or any(
            (v != 1).any() for k, v in stats.items() if k.endswith("var")):
        raise AssertionError("--model-dir changed the running statistics")
    model_dir_preds = loaded(x1).tolist()
    del loaded
    torch.cuda.empty_cache()
    _launches_none("serve_resnet", before)
    _phase("serve_resnet", card=card,
           entry="cmd/serve_resnet.py build_forward / make_handler at its "
                 "defaults (ResNet-50, 224x224, bf16, channels_last)",
           build_and_warm_s=build_s, requests_each=SERVE_REQUESTS,
           latency=latency,
           inputs_request="equal to the batch-1 request's predictions",
           direct_forward="equal at batch 1 and 8",
           model_dir={"params": "equal to the trainer's params.pt",
                      "running_stats": "initial (mean 0, var 1), as the "
                                       "JAX server",
                      "predictions_batch_1": model_dir_preds},
           launches="none of the port's kernels")


# ---- the node layer on the card: NVML, the device plugin, health, metrics --

NODE_LOAD_BYTES = 8 << 30  # nvml_load's child allocates and touches this
NODE_LOAD_SECONDS = 5
NODE_RECOVERY_S = 10  # the daemon's --health-recovery-window
NODE_XID = "31,13,43"  # what an illegal address raises on Hopper (XID_CONFIG)
NODE_FAULT_XID = 31
# A GPU host whose driver runs under gVisor (as the H100 this script was
# measured on) delivers no Xid to the process: an idle
# nvmlEventSetWait_v2 times out, but once a child has died of an illegal
# address every wait, in every process, answers NVML_ERROR_OPERATING_SYSTEM
# (17) and no Xid arrives (PERF.md §6).  So the phase drives the daemon's
# health state machine through its fault file, and records what NVML's
# wait answers in each run.
XID_INJECTION = ("dropped: nvmlEventSetWait_v2 delivers no Xid under "
                 "gVisor; the fault goes in through GPU_FAULT_FILE")
# ctypes struct of gpulib/nvml.py -> its C type in the toolkit's nvml.h
NVML_STRUCTS = {"PciInfo": "nvmlPciInfo_t", "Memory": "nvmlMemory_t",
                "Value": "nvmlValue_t", "Sample": "nvmlSample_t",
                "EventData": "nvmlEventData_t",
                "Utilization": "nvmlUtilization_t"}
NVML_INCLUDE = "/usr/local/cuda/include"
LOAD_CHILD = r"""
import sys, time, torch
n, seconds = int(sys.argv[1]), float(sys.argv[2])
held = torch.ones(n, dtype=torch.uint8, device="cuda")  # allocated, touched
a = torch.randn(8192, 8192, device="cuda", dtype=torch.bfloat16)
torch.cuda.synchronize()
print("ready", flush=True)
end = time.monotonic() + seconds
while time.monotonic() < end:
    for _ in range(8):
        b = a @ a
    torch.cuda.synchronize()
print("done", held.numel(), flush=True)
"""


def _smi(fields):
    """nvidia-smi's --query-gpu rows, one list of strings a GPU."""
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return [[c.strip() for c in line.split(",")]
            for line in out.strip().splitlines()]


def _nvml_layouts(tmp):
    """sizeof and offsetof of every ctypes struct of gpulib/nvml.py against
    a C program built with g++ on the toolkit's nvml.h."""
    import ctypes

    from container_engine_accelerators_tpu_torch.gpulib import nvml

    want, body = {}, []
    for cls_name, ctype in NVML_STRUCTS.items():
        cls = getattr(nvml, cls_name)
        want[f"{cls_name}.sizeof"] = ctypes.sizeof(cls)
        body.append(f'printf("{cls_name}.sizeof %zu\\n", sizeof({ctype}));')
        for field, _ in cls._fields_:
            want[f"{cls_name}.{field}"] = getattr(cls, field).offset
            body.append(f'printf("{cls_name}.{field} %zu\\n", '
                        f'offsetof({ctype}, {field}));')
    src = os.path.join(tmp, "nvml_layout.cpp")
    with open(src, "w") as f:
        f.write("#include <cstddef>\n#include <cstdio>\n#include <nvml.h>\n"
                "int main() {\n" + "\n".join(body) + "\nreturn 0;\n}\n")
    exe = os.path.join(tmp, "nvml_layout")
    subprocess.run(["g++", f"-I{NVML_INCLUDE}", src, "-o", exe], check=True,
                   timeout=120)
    out = subprocess.run([exe], capture_output=True, text=True, check=True,
                         timeout=60).stdout
    got = {k: int(v) for k, v in (line.rsplit(" ", 1)
                                  for line in out.strip().splitlines())}
    bad = {k: (want[k], got.get(k)) for k in want if got.get(k) != want[k]}
    if bad:
        raise AssertionError(f"ctypes layout != nvml.h (ctypes, C): {bad}")
    return {k: v for k, v in got.items() if k.endswith(".sizeof")}


def _median_us(fn, n=200):
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e6)
    return statistics.median(times)


def node_nvml(card):
    """NvmlLib against the card, nvidia-smi and torch."""
    import torch

    from container_engine_accelerators_tpu_torch.gpulib.nvml import NvmlLib

    t0 = time.perf_counter()
    lib = NvmlLib()
    open_ms = (time.perf_counter() - t0) * 1e3
    try:
        devs = lib.devices()
        smi = _smi("name,uuid,pci.bus_id,memory.total")
        if not len(devs) == torch.cuda.device_count() == len(smi):
            raise AssertionError(f"device count: NVML {len(devs)}, torch "
                                 f"{torch.cuda.device_count()}, nvidia-smi "
                                 f"{len(smi)}")
        rows = []
        for info, (name, uuid, bus_id, total_mib) in zip(devs, smi):
            props = torch.cuda.get_device_properties(info.index)
            mem = lib.memory_info(info.name)
            torch_uuid = f"GPU-{props.uuid}"
            checks = {
                "name": info.model == name == props.name,
                "uuid": info.uuid == uuid,
                # A driver under gVisor may redact the UUID in NVML (and so in
                # nvidia-smi); CUDA's own is then not comparable.
                "uuid_vs_torch": (info.uuid == torch_uuid
                                  or "REDACTED" in info.uuid),
                # None: NVML answered NOT_SUPPORTED, nvidia-smi prints N/A.
                "pci_bus_id": (bus_id.strip("[]") == "N/A"
                               if info.pci_bus_id is None
                               else info.pci_bus_id.lower() == bus_id.lower()),
                "memory_total": mem.total_bytes == int(total_mib) * 2**20,
                # torch's total is cudaMemGetInfo's: NVML's less the
                # driver's reservation.
                "memory_vs_torch": 0 <= mem.total_bytes - props.total_memory
                <= mem.total_bytes // 100,
                "dev_node": os.path.exists(f"/dev/{info.name}"),
            }
            if not all(checks.values()):
                smi_row = (name, uuid, bus_id, total_mib)
                raise AssertionError(f"{info.name}: {checks}; NVML {info}, "
                                     f"{mem}; nvidia-smi {smi_row}; torch "
                                     f"{props}")
            rows.append({"name": info.name, "index": info.index,
                         "minor": info.minor, "model": info.model,
                         "uuid": info.uuid, "torch_uuid": torch_uuid,
                         "pci_bus_id": info.pci_bus_id,
                         "torch_pci_bus_id": props.pci_bus_id,
                         "memory_total": mem.total_bytes,
                         "torch_total_memory": props.total_memory,
                         "memory_used": mem.used_bytes,
                         "mig_mode": lib.mig_mode(info.name)})
        with tempfile.TemporaryDirectory(prefix="chip_smoke_nvml_") as tmp:
            sizes = _nvml_layouts(tmp)
        registered = lib.register_xid_events()
        if registered != [d.name for d in devs]:
            raise AssertionError(f"Xid registration: {registered} of "
                                 f"{[d.name for d in devs]}")
        name = devs[0].name
        lib.duty_cycle(name)
        _phase("nvml", card=card, open_ms=round(open_ms, 3), devices=rows,
               struct_sizes=sizes, layouts="ctypes == nvml.h (g++)",
               xid_registered=registered,
               memory_info_us=round(_median_us(lambda: lib.memory_info(name)),
                                    2),
               duty_cycle_us=round(_median_us(lambda: lib.duty_cycle(name)), 2),
               duty_cycle_source=lib.duty_cycle_source(name))
    finally:
        lib.close()


def node_nvml_load(card):
    """Duty cycle and memory under a known load in a child, and after it,
    beside nvidia-smi's numbers at the same moments."""
    import torch

    from container_engine_accelerators_tpu_torch.gpulib.nvml import NvmlLib

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    lib = NvmlLib()
    try:
        name = lib.devices()[0].name

        def reading(at):
            duty, mem = lib.duty_cycle(name), lib.memory_info(name)
            util, used = _smi("utilization.gpu,memory.used")[0]
            return {"at": at, "duty_cycle": duty,
                    "memory_used": mem.used_bytes,
                    "smi_utilization_gpu": int(util),
                    "smi_memory_used_mib": int(used)}

        lib.duty_cycle(name)
        time.sleep(1.0)
        idle = reading("before")
        child = subprocess.Popen(
            [sys.executable, "-c", LOAD_CHILD, str(NODE_LOAD_BYTES),
             str(NODE_LOAD_SECONDS)], stdout=subprocess.PIPE, text=True)
        try:
            if child.stdout.readline().strip() != "ready":
                raise AssertionError("load child did not start")
            time.sleep(1.0)
            lib.duty_cycle(name)  # the window starts under load
            time.sleep(2.0)
            busy = reading("loaded")
            tail = child.stdout.read()
            if child.wait(timeout=120) != 0 or "done" not in tail:
                raise AssertionError(f"load child failed: {child.returncode}")
        finally:
            if child.poll() is None:
                child.kill()
                child.wait()
        time.sleep(3.0)
        lib.duty_cycle(name)
        time.sleep(1.0)
        after = reading("after")
    finally:
        lib.close()
    grew = busy["memory_used"] - idle["memory_used"]
    back = abs(after["memory_used"] - idle["memory_used"])
    checks = {"busy_duty>=80": busy["duty_cycle"] >= 80,
              "memory_grew>=load": grew >= NODE_LOAD_BYTES,
              "idle_duty<=10": after["duty_cycle"] <= 10,
              "memory_back<=256MiB": back <= 256 << 20}
    _phase("nvml_load", card=card, load_bytes=NODE_LOAD_BYTES,
           load="bf16 8192^3 matmuls", readings=[idle, busy, after],
           memory_grew=grew, memory_back_within=back, checks=checks)
    if not all(checks.values()):
        raise AssertionError(f"nvml_load: {checks}")


class _NodeRig:
    """The real daemon on the card's /dev and NVML, a kubelet stub that
    takes its registration and a PodResources stub that gives the first
    GPU to default/train-0/worker; closed by ``close``."""

    def __init__(self, tmp, config=None, env=None, args=()):
        import concurrent.futures
        import queue
        import socket

        import grpc

        from container_engine_accelerators_tpu_torch.deviceplugin import api
        from container_engine_accelerators_tpu_torch.deviceplugin import (
            deviceplugin_v1beta1_pb2 as pb,
        )
        from container_engine_accelerators_tpu_torch.gpulib.nvml import NvmlLib
        from container_engine_accelerators_tpu_torch.metrics import (
            podresources_v1_pb2 as prpb,
        )

        lib = NvmlLib()
        try:
            self.names = [d.name for d in lib.devices()]
            self.totals = {n: lib.memory_info(n).total_bytes
                           for n in self.names}
        finally:
            lib.close()
        self.tmp = tmp
        self.procs, self.servers = [], []
        plugins = os.path.join(tmp, "plugins")
        os.makedirs(plugins)
        self.plugins = plugins
        self.registrations = queue.Queue()
        rig = self

        class Kubelet:
            def Register(self, request, context):
                rig.registrations.put((time.monotonic(), request))
                return pb.Empty()

        kubelet = grpc.server(concurrent.futures.ThreadPoolExecutor(2))
        api.add_registration_servicer(kubelet, Kubelet())
        kubelet.add_insecure_port(
            f"unix:{os.path.join(plugins, api.KUBELET_SOCKET)}")
        kubelet.start()
        self.servers.append(kubelet)

        pods = prpb.ListPodResourcesResponse()
        pod = pods.pod_resources.add(name="train-0", namespace="default")
        pod.containers.add(name="worker").devices.add(
            resource_name=api.RESOURCE_NAME, device_ids=self.names[:1])
        pod_resources = grpc.server(concurrent.futures.ThreadPoolExecutor(2))
        pod_resources.add_generic_rpc_handlers((
            grpc.method_handlers_generic_handler("v1.PodResourcesLister", {
                "List": grpc.unary_unary_rpc_method_handler(
                    lambda req, ctx: pods,
                    request_deserializer=prpb.ListPodResourcesRequest
                    .FromString,
                    response_serializer=prpb.ListPodResourcesResponse
                    .SerializeToString)}),))
        self.pr_socket = os.path.join(tmp, "pod-resources.sock")
        pod_resources.add_insecure_port(f"unix:{self.pr_socket}")
        pod_resources.start()
        self.servers.append(pod_resources)

        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            self.port = s.getsockname()[1]
        self.fault_file = os.path.join(tmp, "faults")
        self.log_path = os.path.join(tmp, "daemon.log")
        self.log = open(self.log_path, "w")
        config_path = os.path.join(tmp, "gpu_config.json")
        if config is not None:
            with open(config_path, "w") as f:
                json.dump(config, f)
        env = {**os.environ, "XID_CONFIG": NODE_XID,
               "GPU_FAULT_FILE": self.fault_file, **(env or {})}
        self.started = time.monotonic()
        self.procs.append(subprocess.Popen(
            [sys.executable, "-m",
             "container_engine_accelerators_tpu_torch.cmd.gpu_device_plugin",
             "--plugin-directory", plugins, "--gpu-config", config_path,
             "--enable-health-monitoring", "--enable-container-gpu-metrics",
             "--health-recovery-window", str(NODE_RECOVERY_S),
             "--gpu-metrics-port", str(self.port),
             "--gpu-metrics-collection-interval", "0.5",
             "--pod-resources-socket", self.pr_socket, *args],
            cwd=HERE, env=env, stderr=self.log))
        self.channel = None
        self.stream = None

    def registered(self, timeout=60):
        """(monotonic time, RegisterRequest) of the next registration."""
        try:
            return self.registrations.get(timeout=timeout)
        except Exception:
            raise AssertionError(f"no registration in {timeout} s; daemon: "
                                 f"{self.log_tail()}") from None

    def watch(self, endpoint):
        """Dial the plugin and open ListAndWatch; its first device list."""
        from container_engine_accelerators_tpu_torch.deviceplugin import (
            deviceplugin_v1beta1_pb2 as pb,
        )

        client = self.dial(endpoint)
        self.stream = client.list_and_watch(pb.Empty(), timeout=300)
        return client, {d.ID: d.health for d in next(self.stream).devices}

    def wait_health(self, name, health):
        """Read ListAndWatch until ``name`` is ``health``: (monotonic
        time, the device list)."""
        while True:
            state = {d.ID: d.health for d in next(self.stream).devices}
            if state.get(name) == health:
                return time.monotonic(), state

    def wait_log(self, needle, timeout=30.0):
        """The first daemon log line holding ``needle``."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with open(self.log_path) as f:
                for line in f:
                    if needle in line:
                        return line.rstrip("\n")
            time.sleep(0.1)
        raise AssertionError(f"{needle!r} not logged in {timeout} s; daemon: "
                             f"{self.log_tail()}")

    def watch_list(self):
        """The list the daemon's checker logged as registered for Xids."""
        watching = [line for line in self.log_tail(400)
                    if "starting GPU health checker" in line]
        return (ast.literal_eval(watching[-1].rsplit("watching ", 1)[1])
                if watching else None)

    def dial(self, endpoint):
        import grpc

        from container_engine_accelerators_tpu_torch.deviceplugin import api

        self.channel = grpc.insecure_channel(
            f"unix:{os.path.join(self.plugins, endpoint)}")
        grpc.channel_ready_future(self.channel).result(timeout=30)
        return api.DevicePluginClient(self.channel)

    def scrape(self):
        return _scrape(self.port)

    def close(self):
        if self.channel is not None:
            self.channel.close()
        for p in self.procs:
            if p.poll() is None:
                p.terminate()
                try:
                    p.wait(timeout=20)
                except subprocess.TimeoutExpired:
                    p.kill()
                    p.wait()
        for s in self.servers:
            s.stop(grace=0).wait()
        self.log.close()

    def log_tail(self, n=20):
        with open(self.log_path) as f:
            return f.read().splitlines()[-n:]


def _gauges(text, family):
    """{labels string: value} of one gauge family in a /metrics text."""
    out = {}
    for line in text.splitlines():
        if line.startswith(family + "{"):
            labels, value = line[len(family):].rsplit(" ", 1)
            out[labels] = float(value)
    return out


def _allocate(client, ids):
    from container_engine_accelerators_tpu_torch.deviceplugin import (
        deviceplugin_v1beta1_pb2 as pb,
    )

    req = pb.AllocateRequest()
    req.container_requests.add().devicesIDs.extend(ids)
    return client.allocate(req, timeout=10)


def _refused(client, ids):
    import grpc

    try:
        _allocate(client, ids)
    except grpc.RpcError as e:
        return e.code() == grpc.StatusCode.INVALID_ARGUMENT
    return False


def node_device_plugin(rig, card):
    """The daemon on the real /dev and NVML: registration, ListAndWatch,
    Allocate and /metrics."""
    from container_engine_accelerators_tpu_torch.deviceplugin import api
    from container_engine_accelerators_tpu_torch.deviceplugin.manager import (
        CONTROL_DEVICES,
        DRIVER_CONTAINER_PATH,
        DRIVER_HOST_PATH,
        OPTIONAL_DEVICES,
    )

    at, reg = rig.registered()
    register_s = rig.register_s = at - rig.started
    if reg.resource_name != api.RESOURCE_NAME:
        raise AssertionError(f"registered {reg.resource_name}")
    t0 = time.perf_counter()
    client, first = rig.watch(reg.endpoint)
    first_law_ms = (time.perf_counter() - t0) * 1e3
    if first != {n: "Healthy" for n in rig.names}:
        raise AssertionError(f"ListAndWatch {first}, NVML {rig.names}")
    control = [f"/dev/{d}" for d in CONTROL_DEVICES] + [
        f"/dev/{d}" for d in OPTIONAL_DEVICES if os.path.exists(f"/dev/{d}")]
    alloc_ms = []
    for name in rig.names:
        for _ in range(20):
            t0 = time.perf_counter()
            resp = _allocate(client, [name]).container_responses[0]
            alloc_ms.append((time.perf_counter() - t0) * 1e3)
        paths = [d.host_path for d in resp.devices]
        mounts = [(m.host_path, m.container_path, m.read_only)
                  for m in resp.mounts]
        if (paths != [f"/dev/{name}"] + control
                or mounts != [(DRIVER_HOST_PATH, DRIVER_CONTAINER_PATH, True)]):
            raise AssertionError(f"Allocate {name}: {paths}, {mounts}")
    if not _refused(client, ["nvidia99"]):
        raise AssertionError("Allocate of an unknown ID was not refused")
    deadline, text = time.monotonic() + 30, ""
    want = f'accelerator_id="{rig.names[0]}"'
    while time.monotonic() < deadline:
        text = rig.scrape()
        if any(want in k and 'pod="train-0"' in k
               for k in _gauges(text, "duty_cycle")):
            break
        time.sleep(0.25)
    node_total = _gauges(text, "memory_total_gpu_node")
    container = _gauges(text, "memory_total")
    checks = {
        "container_gauges": any(want in k and 'pod="train-0"' in k
                                for k in container),
        "node_gauges": all(
            any(f'accelerator_id="{n}"' in k and v == rig.totals[n]
                for k, v in node_total.items()) for n in rig.names),
        "duty_cycle_gpu_node": bool(_gauges(text, "duty_cycle_gpu_node")),
        "make_nvidia": all('make="nvidia"' in k for k in node_total),
    }
    if not all(checks.values()):
        raise AssertionError(f"/metrics: {checks}\n{text[-3000:]}")
    _phase("device_plugin", card=card, resource=reg.resource_name,
           endpoint=reg.endpoint, devices=first,
           register_s=round(register_s, 3),
           first_list_and_watch_ms=round(first_law_ms, 3),
           allocate_ms_median=round(statistics.median(alloc_ms), 3),
           allocate_ms_max=round(max(alloc_ms), 3), allocate_calls=len(alloc_ms),
           allocate_devices=paths, mounts=mounts, unknown_id="refused",
           metrics=checks)
    return client


def node_xid(rig, client, card):
    """Xid registration, and the health state machine of the real daemon
    driven through its fault file: Unhealthy on ListAndWatch, Allocate
    refused, Healthy again after the recovery window."""
    from container_engine_accelerators_tpu_torch.gpulib.nvml import (
        NvmlError,
        NvmlLib,
    )

    lib = NvmlLib()
    try:
        registered = lib.register_xid_events()
        try:
            event = lib.wait_for_event(0.5)
            event_wait = "timeout" if event is None else repr(event)
        except NvmlError as e:
            event_wait = f"NVML {e.code}: {e}"
    finally:
        lib.close()
    if registered != rig.names:
        raise AssertionError(f"Xid registration: {registered} of {rig.names}")
    watching = [line for line in rig.log_tail(200)
                if "starting GPU health checker" in line]
    # The checker logs the list it registered, as "... watching ['nvidia0']".
    daemon_registered = rig.watch_list()
    name = rig.names[0]
    t0 = time.monotonic()
    with open(rig.fault_file, "a") as f:
        f.write(f"fault {name} {NODE_FAULT_XID}\n")
    t_bad, bad = rig.wait_health(name, "Unhealthy")
    refused = _refused(client, [name])
    t_good, good = rig.wait_health(name, "Healthy")
    allocates_again = bool(_allocate(client, [name]).container_responses)
    events = _gauges(rig.scrape(), "agent_events")
    checks = {"registered_in_daemon": daemon_registered == rig.names,
              "refused": refused,
              "window_respected": t_good - t_bad >= NODE_RECOVERY_S - 0.5,
              "allocates_after": allocates_again}
    _phase("xid", card=card, xid_config=NODE_XID, registered=registered,
           daemon_log=watching[-1:], injection=XID_INJECTION,
           event_wait=event_wait,
           fault=f"fault {name} {NODE_FAULT_XID} (GPU_FAULT_FILE)",
           fault_to_unhealthy_s=round(t_bad - t0, 3),
           unhealthy_to_healthy_s=round(t_good - t_bad, 3),
           recovery_window_s=NODE_RECOVERY_S, states=[bad, good],
           agent_events=events, checks=checks)
    if not all(checks.values()):
        raise AssertionError(f"xid: {checks}; daemon: {rig.log_tail()}")


# ---- the node layer's second slice: fault sites, MIG, maintenance, MPS ---

# node_faults arms the daemon: its first Register attempt fails, and its
# checker's first event wait drops.
NODE_FAULT_SPEC = "kubelet.register:fail@1;health.stream:drop@1"
NODE_GAUGES = ("memory_total_gpu_node", "memory_used_gpu_node",
               "duty_cycle_gpu_node", "agent_events")
MIG_SIZE = "1g.10gb"
MIG_SMI_QUERY = ["--query-gpu=index,mig.mode.current,mig.mode.pending",
                 "--format=csv,noheader"]
# nvidia-smi behind the mig phase's shim: read-only queries reach the
# card, every other command is recorded and refused, so the phase never
# changes the card's MIG mode.
MIG_SHIM = """#!/bin/bash
case "$*" in
  --query-gpu=*|"mig -lgip"|"mig -lgi"|"mig -lci"|-L)
    printf 'pass %s\\n' "$*" >> "{log}"
    exec "{real}" "$@" ;;
esac
printf 'refused %s\\n' "$*" >> "{log}"
echo "refused by the recording shim: $*" >&2
exit 1
"""
MAINTENANCE_EVENT = "TERMINATE_ON_HOST_MAINTENANCE"
MPS_CONFIG = {"GPUSharingConfig": {"GPUSharingStrategy": "mps",
                                   "MaxSharedClientsPerGPU": 2}}
# The card's machine runs NVIDIA's MPS control daemon, which answers its
# queries, but every MPS server it starts for a client logs "Creating
# server context on device 0 ... Failed to start : operation not
# supported" (gVisor), and the client's CUDA start-up fails with error 805
# (PERF.md §6).  So the mps phase drives the device plugin's whole mps
# path and asserts that a child run with the Allocate envs is refused; on
# a machine whose MPS server starts, set this to "runs": the child must
# then hold 90% of its pinned limit and run out of memory past it.
MPS_CLIENTS = "refused"
MPS_CHILD = r"""
import sys, torch
limit = int(sys.argv[1]) * 2**20
props = torch.cuda.get_device_properties(0)
free, total = torch.cuda.mem_get_info()
print("sees", props.multi_processor_count, free, total, flush=True)
held = torch.empty(int(limit * 0.9), dtype=torch.uint8, device="cuda")
held.fill_(1)
torch.cuda.synchronize()
print("alloc90 ok", flush=True)
try:
    more = torch.empty(int(limit * 0.2), dtype=torch.uint8, device="cuda")
    more.fill_(1)
    torch.cuda.synchronize()
    print("alloc110 ok", flush=True)
except torch.OutOfMemoryError:
    print("alloc110 OOM", flush=True)
"""


def _scrape(port):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                timeout=10) as resp:
        return resp.read().decode()


def _events(text):
    """agent_events of a /metrics text: {event: value}."""
    return {k.split('"')[1]: v for k, v in _gauges(text, "agent_events")
            .items()}


def node_faults(card, unarmed_register_s):
    """The daemon armed with NODE_FAULT_SPEC registers on its second
    attempt and its checker rides the dropped wait; MetricServer.rebind
    moves /metrics; the Xid watch list."""
    from container_engine_accelerators_tpu_torch.gpulib.nvml import NvmlLib
    from container_engine_accelerators_tpu_torch.metrics import counters
    from container_engine_accelerators_tpu_torch.metrics.metrics import (
        MetricServer,
    )

    with tempfile.TemporaryDirectory(prefix="chip_smoke_faults_") as tmp:
        rig = _NodeRig(tmp, env={"TPU_FAULT_SPEC": NODE_FAULT_SPEC})
        try:
            at, reg = rig.registered()
            register_s = at - rig.started
            _, first = rig.watch(reg.endpoint)
            name = rig.names[0]
            dropped = rig.wait_log("fault injection: health.stream drop")
            t0 = time.monotonic()
            with open(rig.fault_file, "a") as f:
                f.write(f"fault {name} {NODE_FAULT_XID}\n")
            t_bad, bad = rig.wait_health(name, "Unhealthy")
            deadline, events = time.monotonic() + 30, {}
            while time.monotonic() < deadline:
                events = _events(rig.scrape())
                if events.get("health.unhealthy"):
                    break
                time.sleep(0.25)
            failed_attempt = rig.wait_log("kubelet registration attempt 1 "
                                          "failed")
            watching = rig.watch_list()
        finally:
            rig.close()

        lib = NvmlLib()
        server = MetricServer(lib=lib, port=0, collection_interval_s=3600,
                              pod_resources_socket=os.path.join(tmp, "none"))
        try:
            registered = lib.register_xid_events()
            recount = [d.name for d in lib.devices()]
            server.start()
            server.collect_once()
            old = server.port
            before = {f: _gauges(_scrape(old), f) for f in NODE_GAUGES}
            rebinds = counters.get("metrics.rebind")
            t1 = time.perf_counter()
            new = server.rebind(0)
            rebind_ms = (time.perf_counter() - t1) * 1e3
            rebinds = counters.get("metrics.rebind") - rebinds
            after = {f: _gauges(_scrape(new), f) for f in NODE_GAUGES}
            try:
                _scrape(old)
                old_closed = False
            except OSError:
                old_closed = True
        finally:
            server.stop()
            lib.close()
    checks = {
        "registered_on_retry": (events.get("fault.fired.kubelet.register") == 1
                                and events.get("kubelet.register.failed") == 1
                                and events.get("kubelet.register.retried")
                                == 1),
        "stream_drop_absorbed": (events.get("fault.fired.health.stream") == 1
                                 and events.get("health.stream.errors", 0)
                                 >= 1),
        "fault_file_still_works": bad.get(name) == "Unhealthy",
        "watch_list": watching == rig.names,
        "hot_add_list_is_the_libs": (registered == rig.names
                                     and recount == rig.names),
        "rebind_moved": new != old and old_closed and rebinds == 1,
        "gauges_carried_over": after == before and bool(
            before["memory_total_gpu_node"]),
    }
    _phase("node_faults", card=card, spec=NODE_FAULT_SPEC,
           register_s=round(register_s, 3),
           unarmed_register_s=round(unarmed_register_s, 3),
           first_attempt=failed_attempt.split(" ERROR ")[-1],
           stream_drop=dropped.split(" WARNING ")[-1], devices=first,
           fault_to_unhealthy_s=round(t_bad - t0, 3),
           agent_events={k: v for k, v in events.items()
                         if k.startswith(("fault.", "kubelet.", "health."))},
           daemon_watch_list=watching, xid_registered=registered,
           devices_recounted=recount,
           hot_add="one card: the GPU registered at start is in the watch "
                   "list; a GPU NVML maps later is registered as it is "
                   "mapped (CPU test)",
           metrics_port=[old, new], rebind_ms=round(rebind_ms, 3),
           gauges=after, checks=checks)
    if not all(checks.values()):
        raise AssertionError(f"node_faults: {checks}")


def _smi_run(args):
    proc = subprocess.run(["nvidia-smi", *args], capture_output=True,
                          text=True, timeout=60)
    return proc.returncode, proc.stdout.strip()


def node_mig(card):
    """MIG as this card reports it; the daemon with GPUPartitionSize on
    this MIG-off card refuses, naming the GPU and the path; the
    partitioner behind MIG_SHIM reads the card's real state and issues
    exactly the expected first mutating command."""
    import shutil

    from container_engine_accelerators_tpu_torch.cmd import partition_gpu
    from container_engine_accelerators_tpu_torch.gpulib.nvml import NvmlLib

    lib = NvmlLib()
    try:
        infos = lib.devices()
        nvml_modes = {d.name: lib.mig_mode(d.name) for d in infos}
    finally:
        lib.close()
    rc, modes_before = _smi_run(MIG_SMI_QUERY)
    lgip_rc, lgip = _smi_run(["mig", "-lgip"])
    lgi_rc, lgi = _smi_run(["mig", "-lgi"])
    caps_root = "/proc/driver/nvidia"
    proc_tree = {"/proc/driver/nvidia": sorted(os.listdir(caps_root))
                 if os.path.isdir(caps_root) else None,
                 "capabilities": os.path.isdir(
                     os.path.join(caps_root, "capabilities")),
                 "/dev/nvidia-caps": os.path.isdir("/dev/nvidia-caps")}
    smi_modes = [[c.strip() for c in line.split(",")]
                 for line in modes_before.splitlines()]
    if rc != 0 or any(m[1:] != ["Disabled", "Disabled"] for m in smi_modes):
        raise AssertionError(f"the mig phase expects MIG off: {modes_before}")
    first = sorted(infos, key=lambda d: d.minor)[0]

    with tempfile.TemporaryDirectory(prefix="chip_smoke_mig_") as tmp:
        rig = _NodeRig(tmp, config={"GPUPartitionSize": MIG_SIZE})
        try:
            refusal = rig.wait_log("failed to start the GPU manager")
            time.sleep(1.0)
            advertised = not rig.registrations.empty()
        finally:
            rig.close()

        real = shutil.which("nvidia-smi")
        shim_log = os.path.join(tmp, "shim.log")
        bin_dir = os.path.join(tmp, "bin")
        os.makedirs(bin_dir)
        shim = os.path.join(bin_dir, "nvidia-smi")
        with open(shim, "w") as f:
            f.write(MIG_SHIM.format(log=shim_log, real=real))
        os.chmod(shim, 0o755)
        config = os.path.join(tmp, "gpu_config.json")
        with open(config, "w") as f:
            json.dump({"GPUPartitionSize": MIG_SIZE}, f)
        state = os.path.join(tmp, "state", "mig_pending.json")
        env = dict(os.environ, PATH=bin_dir + os.pathsep + os.environ["PATH"])
        t0 = time.perf_counter()
        tool = subprocess.run(
            [sys.executable, "-m",
             "container_engine_accelerators_tpu_torch.cmd.partition_gpu",
             "--gpu-config", config, "--nvidia-smi-path", shim,
             "--state-file", state], cwd=HERE, env=env, capture_output=True,
            text=True, timeout=120)
        tool_s = time.perf_counter() - t0
        with open(shim_log) as f:
            commands = f.read().splitlines()
        state_written = os.path.exists(state)
    _, modes_after = _smi_run(MIG_SMI_QUERY)
    want_first = f"-i {min(int(m[0]) for m in smi_modes)} -mig 1"
    refused = [c.split(" ", 1)[1] for c in commands if c.startswith("refused")]
    want_refusal = (f"{first.name}: no MIG partition under "
                    f"/proc/driver/nvidia/capabilities/gpu{first.minor}/mig")
    checks = {
        "nvml_mode_off": all(m == {"current": 0, "pending": 0}
                             for m in nvml_modes.values()),
        "daemon_refuses": want_refusal in refusal and not advertised,
        "tool_exit_1": tool.returncode == 1,
        "tool_read_the_card": commands[:1] == [
            "pass " + " ".join(MIG_SMI_QUERY)],
        "first_mutating_command": refused == [want_first],
        "no_state_written": not state_written,
        "mode_unchanged": modes_after == modes_before,
    }
    _phase("mig", card=card, nvml_mig_modes=nvml_modes,
           smi_mig_modes=modes_before, lgip_rc=lgip_rc,
           lgip_profiles=partition_gpu.parse_profiles(lgip),
           lgi=lgi.splitlines()[-1:], lgi_rc=lgi_rc, proc=proc_tree,
           size=MIG_SIZE, daemon_refusal=refusal.split(" ERROR ")[-1],
           partitioner_commands=commands, partitioner_rc=tool.returncode,
           partitioner_error=[line for line in tool.stderr.splitlines()
                              if " ERROR " in line][-1:],
           partitioner_s=round(tool_s, 3), mode_after=modes_after,
           checks=checks)
    if not all(checks.values()):
        raise AssertionError(f"mig: {checks}; tool: {tool.stderr[-2000:]}")


class _K8sStubs:
    """A GCE metadata server and a Kubernetes API server (one node, n0,
    with one foreign taint) on localhost: what the maintenance watcher
    talks to."""

    FOREIGN = {"key": "dedicated", "value": "ml", "effect": "NoSchedule"}

    def __init__(self, event):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        from container_engine_accelerators_tpu_torch.health import maintenance

        self.event = event
        self.node = {"metadata": {"name": "n0", "resourceVersion": "1"},
                     "spec": {"taints": [dict(self.FOREIGN)]}}
        self.requests = []
        stubs = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):
                pass

            def _send(self, code, body):
                data = (body if isinstance(body, str)
                        else json.dumps(body)).encode()
                self.send_response(code)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):
                stubs.requests.append(("GET", self.path))
                if self.path.endswith(maintenance.METADATA_PATH):
                    return self._send(200, stubs.event)
                if self.path == "/api/v1/nodes/n0":
                    return self._send(200, stubs.node)
                self._send(404, {})

            def do_PATCH(self):
                body = json.loads(self.rfile.read(
                    int(self.headers["Content-Length"])))
                stubs.requests.append(("PATCH", self.path))
                rv = body.get("metadata", {}).get("resourceVersion")
                if rv != stubs.node["metadata"]["resourceVersion"]:
                    return self._send(409, {"reason": "Conflict"})
                stubs.node["spec"]["taints"] = body["spec"]["taints"]
                stubs.node["metadata"]["resourceVersion"] = str(int(rv) + 1)
                self._send(200, stubs.node)

        self.server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.thread = threading.Thread(target=self.server.serve_forever,
                                       daemon=True)
        self.thread.start()
        self.url = f"http://127.0.0.1:{self.server.server_port}"

    def close(self):
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(timeout=10)


def node_maintenance(card):
    """cmd/maintenance_watcher.py --once against the stubs, armed with one
    k8s.patch conflict: the node tainted (the foreign taint kept) and
    every GPU Unhealthy on the daemon's ListAndWatch; then NONE removes
    the taint."""
    from container_engine_accelerators_tpu_torch.health import maintenance

    stubs = _K8sStubs(MAINTENANCE_EVENT)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mw_") as tmp:
        rig = _NodeRig(tmp, env={
            "XID_CONFIG": str(maintenance.MAINTENANCE_XID)})
        try:
            _, reg = rig.registered()
            _, first = rig.watch(reg.endpoint)

            def watcher(spec=""):
                env = dict(os.environ, TPU_FAULT_SPEC=spec)
                return subprocess.run(
                    [sys.executable, "-m", "container_engine_accelerators_"
                     "tpu_torch.cmd.maintenance_watcher", "--once",
                     "--api-host", stubs.url, "--metadata-base", stubs.url,
                     "--node-name", "n0", "--fault-file", rig.fault_file],
                    cwd=HERE, env=env, capture_output=True, text=True,
                    timeout=60)

            drain = watcher("k8s.patch:conflict@1")
            posted = os.stat(rig.fault_file).st_mtime
            _, bad = rig.wait_health(rig.names[-1], "Unhealthy")
            while set(bad.values()) != {"Unhealthy"}:
                _, bad = rig.wait_health(rig.names[-1], "Unhealthy")
            event_to_unhealthy_ms = (time.time() - posted) * 1e3
            tainted = json.loads(json.dumps(stubs.node["spec"]["taints"]))
            drain_requests = list(stubs.requests)
            with open(rig.fault_file) as f:
                line = f.read().strip()
            stubs.event = "NONE"
            clear = watcher()
            cleared = stubs.node["spec"]["taints"]
        finally:
            rig.close()
            stubs.close()
    want_taint = {"key": maintenance.TAINT_KEY, "value": MAINTENANCE_EVENT,
                  "effect": "NoSchedule"}
    checks = {
        "watcher_ok": drain.returncode == 0 and clear.returncode == 0,
        "event_read": f"maintenance event: {MAINTENANCE_EVENT}" in drain.stdout,
        "tainted_foreign_kept": tainted == [_K8sStubs.FOREIGN, want_taint],
        "conflict_ridden": ("fault injection: k8s.patch conflict"
                            in drain.stderr
                            and "conflicted (409)" in drain.stderr
                            and [r for r in drain_requests
                                 if r[0] == "PATCH"] == [
                                     ("PATCH", "/api/v1/nodes/n0")]),
        "all_unhealthy": bad == {n: "Unhealthy" for n in rig.names},
        "untainted": cleared == [_K8sStubs.FOREIGN],
    }
    _phase("maintenance", card=card, event=MAINTENANCE_EVENT,
           xid=maintenance.MAINTENANCE_XID, fault_line=line,
           devices_before=first, devices_after=bad,
           event_to_unhealthy_ms=round(event_to_unhealthy_ms, 3),
           taints=tainted, api_requests=drain_requests,
           watcher_log=[ln.split(" ", 2)[-1] for ln in
                        drain.stderr.splitlines()][-4:], cleared=cleared,
           checks=checks)
    if not all(checks.values()):
        raise AssertionError(f"maintenance: {checks}; {drain.stderr[-2000:]}")


def _mps_processes():
    """Live processes of NVIDIA's MPS binaries (zombies excluded)."""
    found = []
    for pid in filter(str.isdigit, os.listdir("/proc")):
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                cmdline = f.read().replace(b"\0", b" ").decode().strip()
        except OSError:
            continue
        if "nvidia-cuda-mps" in cmdline and int(pid) != os.getpid():
            found.append((int(pid), cmdline))
    return found


def node_mps(card):
    """The daemon under mps: no MPS daemon, no devices (the gate's error
    logged); NVIDIA's MPS control daemon started with a private pipe
    directory, vGPUs advertised and Allocate giving the node, the pipe
    mount and the client limits; a child with those envs (MPS_CLIENTS);
    the MPS daemon quit, Allocate refused.  The MPS daemon is always quit
    and no MPS process outlives the phase."""
    import shutil

    import torch

    from container_engine_accelerators_tpu_torch.deviceplugin.manager import (
        CONTROL_DEVICES,
        MPS_PINNED_MEMORY_ENV,
        MPS_THREAD_PERCENTAGE_ENV,
        OPTIONAL_DEVICES,
    )

    control = shutil.which("nvidia-cuda-mps-control")
    if control is None:
        raise AssertionError("nvidia-cuda-mps-control is not on PATH")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mps_") as tmp:
        pipe, logs = os.path.join(tmp, "pipe"), os.path.join(tmp, "log")
        driver = os.path.join(tmp, "driver")
        for d in (pipe, logs, os.path.join(driver, "bin")):
            os.makedirs(d)
        os.symlink(control, os.path.join(driver, "bin",
                                         "nvidia-cuda-mps-control"))
        mps_env = dict(os.environ, CUDA_MPS_PIPE_DIRECTORY=pipe,
                       CUDA_MPS_LOG_DIRECTORY=logs)
        rig = _NodeRig(tmp, config=MPS_CONFIG,
                       env={"CUDA_MPS_PIPE_DIRECTORY": pipe},
                       args=["--host-path", driver])
        running = False
        try:
            gate_error = rig.wait_log("failed to start the GPU manager")
            advertised_without = not rig.registrations.empty()
            subprocess.run([control, "-d"], env=mps_env, check=True,
                           timeout=30)
            running = True
            at, reg = rig.registered(timeout=30)
            client, devices = rig.watch(reg.endpoint)
            name = rig.names[0]
            t0 = time.perf_counter()
            resp = _allocate(client, [f"{name}/vgpu0"]).container_responses[0]
            allocate_ms = (time.perf_counter() - t0) * 1e3
            envs = dict(resp.envs)
            child_env = {k: v for k, v in os.environ.items()
                         if not k.startswith("CUDA_MPS_")}
            child_env.update(envs)
            limit_mib = envs[MPS_PINNED_MEMORY_ENV].split("=")[1].rstrip("M")
            t0 = time.perf_counter()
            child = subprocess.run([sys.executable, "-c", MPS_CHILD,
                                    limit_mib], env=child_env,
                                   capture_output=True, text=True,
                                   timeout=300)
            child_s = time.perf_counter() - t0
            with open(os.path.join(logs, "server.log")) as f:
                server_log = [ln.split("] ", 1)[-1] for ln in f
                              if "Failed" in ln or "Creating" in ln][-2:]
            quit_ = subprocess.run([control], input="quit\n", env=mps_env,
                                   capture_output=True, text=True,
                                   timeout=30)
            deadline = time.monotonic() + 10
            while _mps_processes() and time.monotonic() < deadline:
                time.sleep(0.1)
            running = bool(_mps_processes())
            query = subprocess.run(
                [control], input="get_default_active_thread_percentage\n",
                env=mps_env, capture_output=True, text=True, timeout=30)
            refused_after = _refused(client, [f"{name}/vgpu0"])
        finally:
            if running:
                subprocess.run([control], input="quit\n", env=mps_env,
                               capture_output=True, timeout=30)
            for pid, _ in _mps_processes():
                try:
                    os.kill(pid, signal.SIGKILL)
                except OSError:
                    pass
            rig.close()
    left = _mps_processes()
    total = rig.totals[name]
    control_nodes = [f"/dev/{d}" for d in CONTROL_DEVICES] + [
        f"/dev/{d}" for d in OPTIONAL_DEVICES if os.path.exists(f"/dev/{d}")]
    child_out = child.stdout + child.stderr
    checks = {
        "gate_refuses_without_daemon": (
            "Cannot find MPS control daemon process" in gate_error
            and not advertised_without),
        "vgpus": devices == {f"{n}/vgpu{j}": "Healthy" for n in rig.names
                             for j in range(2)},
        "allocate_node": [d.host_path for d in resp.devices] == [
            f"/dev/{name}"] + control_nodes,
        "pipe_mount": (pipe, pipe, False) in [
            (m.host_path, m.container_path, m.read_only)
            for m in resp.mounts],
        "thread_percentage": envs.get(MPS_THREAD_PERCENTAGE_ENV) == "50",
        "pinned_limit": envs.get(MPS_PINNED_MEMORY_ENV)
        == f"0={total // 2 // 2**20}M",
        "child": (child.returncode != 0 and "805" in child_out
                  if MPS_CLIENTS == "refused" else
                  child.returncode == 0 and "alloc90 ok" in child_out
                  and "alloc110 OOM" in child_out),
        "daemon_quit": query.returncode != 0
        and "Cannot find MPS control daemon" in query.stderr,
        "refused_after_quit": refused_after,
        "no_mps_process_left": not left,
    }
    _phase("mps", card=card, config=MPS_CONFIG, gate_error=gate_error.split(
               " ERROR ")[-1], devices=devices,
           allocate_ms=round(allocate_ms, 3),
           allocate_devices=[d.host_path for d in resp.devices],
           mounts=[(m.host_path, m.container_path, m.read_only)
                   for m in resp.mounts], envs=envs,
           nvml_memory_total=total, card_sms=torch.cuda.get_device_properties(
               0).multi_processor_count,
           mps_clients=MPS_CLIENTS, child_rc=child.returncode,
           child_s=round(child_s, 3),
           child_said=[ln for ln in child_out.splitlines()
                       if ln.startswith(("sees", "alloc", "RuntimeError"))],
           mps_server_log=server_log, quit_rc=quit_.returncode,
           query_after_quit=query.stderr.strip(), checks=checks)
    if not all(checks.values()):
        raise AssertionError(f"mps: {checks}; child: {child_out[-2000:]}; "
                             f"daemon: {rig.log_tail()}")


# ---- phases 41-42: the NRI device injector and the topology scheduler -----

NRI_CONTAINER = "worker"
NRI_ROUND_TRIPS = 200
# The plugin's reconnect budget in the smoke: a re-dial within seconds.
NRI_RETRY = dict(max_attempts=6, initial_backoff_s=0.01, max_backoff_s=0.05,
                 deadline_s=10.0)
# The scheduler's fleet: clusters x racks x hosts, each an 8-GPU node but
# the one named for this machine, which carries the count NVML reads.
SCHED_FLEET = (2, 2, 4)
SCHED_GATE = "gke.io/topology-aware-auto-smoke"
SCHED_JOBS = (("job-a", 4, 8), ("job-b", 2, 1))  # (name, pods, GPUs a pod)
METADATA_PREFIX = "/computeMetadata/v1"


class _NriRuntime:
    """containerd's side of the NRI socket, on the port's mux and ttrpc:
    takes RegisterPlugin and calls the plugin's service."""

    def __init__(self, sock):
        from container_engine_accelerators_tpu_torch.nri import mux
        from container_engine_accelerators_tpu_torch.nri import (
            nri_v1alpha1_pb2 as pb,
        )
        from container_engine_accelerators_tpu_torch.nri import plugin
        from container_engine_accelerators_tpu_torch.nri import ttrpc

        self.pb, self.plugin = pb, plugin
        self.mux = mux.Mux(sock)
        self.registered = threading.Event()
        self.register_req = None
        self.registered_at = None
        server = ttrpc.TtrpcServer(self.mux.open(mux.RUNTIME_SERVICE_CONN))
        server.register(plugin.RUNTIME_SERVICE, "RegisterPlugin",
                        self._register)
        self.client = ttrpc.TtrpcClient(self.mux.open(mux.PLUGIN_SERVICE_CONN))
        self.mux.start_reader()
        threading.Thread(target=server.serve, daemon=True).start()

    def _register(self, payload):
        self.registered_at = time.monotonic()
        self.register_req = self.pb.RegisterPluginRequest.FromString(payload)
        self.registered.set()
        return self.pb.Empty().SerializeToString()

    def call(self, method, request, response_type):
        raw = self.client.call(self.plugin.PLUGIN_SERVICE, method,
                               request.SerializeToString())
        return response_type.FromString(raw)

    def create(self, annotation):
        pb = self.pb
        req = pb.CreateContainerRequest(
            pod=pb.PodSandbox(name="train-0", namespace="default",
                              annotations={
                                  f"devices.gke.io/container.{NRI_CONTAINER}":
                                      annotation}),
            container=pb.Container(name=NRI_CONTAINER))
        return self.call("CreateContainer", req, pb.CreateContainerResponse)


def _allocated_paths():
    """The host paths the port's device plugin Allocates to one container
    that asks for the first GPU NVML reports: its node, CONTROL_DEVICES
    and the OPTIONAL_DEVICES present (``deviceplugin/manager.py``)."""
    from container_engine_accelerators_tpu_torch.deviceplugin import (
        deviceplugin_v1beta1_pb2 as dpb,
    )
    from container_engine_accelerators_tpu_torch.deviceplugin.manager import (
        DRIVER_CONTAINER_PATH,
        DRIVER_HOST_PATH,
        GpuManager,
    )
    from container_engine_accelerators_tpu_torch.deviceplugin.service import (
        DevicePluginService,
    )
    from container_engine_accelerators_tpu_torch.gpulib.nvml import NvmlLib
    from container_engine_accelerators_tpu_torch.utils.config import GPUConfig
    from container_engine_accelerators_tpu_torch.utils.device import Mount

    lib = NvmlLib()
    try:
        driver = Mount(host_path=DRIVER_HOST_PATH,
                       container_path=DRIVER_CONTAINER_PATH, read_only=True)
        manager = GpuManager("/dev", [driver], GPUConfig(), lib=lib)
        manager.start()
        name = [d.name for d in lib.devices()][0]
        req = dpb.AllocateRequest()
        req.container_requests.add().devicesIDs.append(name)
        resp = DevicePluginService(manager).Allocate(req, None)
    finally:
        lib.close()
    return name, [d.host_path for d in resp.container_responses[0].devices]


def node_nri(card):
    """The port's NRI plugin (``nri/plugin.py``) against an in-process
    fake runtime on a real unix socket: it registers and subscribes to
    CreateContainer only; a container annotated with the device plugin's
    Allocate list gets exactly those nodes, type ``c``, the major and
    minor of ``os.stat``; a path that does not exist fails the container;
    the runtime closes its trunk once and the plugin registers again
    (``nri.reconnect`` 1)."""
    import socket
    import stat as stat_module

    from container_engine_accelerators_tpu_torch.metrics import counters
    from container_engine_accelerators_tpu_torch.nri import (
        nri_v1alpha1_pb2 as pb,
    )
    from container_engine_accelerators_tpu_torch.nri import plugin
    from container_engine_accelerators_tpu_torch.nri.ttrpc import TtrpcError
    from container_engine_accelerators_tpu_torch.utils.retry import RetryPolicy

    before = _kernel_counts()
    gpu, paths = _allocated_paths()
    lstats = {}
    for p in paths:
        st = os.lstat(p)
        lstats[p] = {"mode": oct(st.st_mode),
                     "char": stat_module.S_ISCHR(st.st_mode),
                     "rdev": [os.major(st.st_rdev), os.minor(st.st_rdev)]}
    tmp = tempfile.mkdtemp(prefix="nri")  # short: a socket path <= 107 bytes
    sock_path = os.path.join(tmp, "nri.sock")
    listener = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    listener.bind(sock_path)
    listener.listen(2)
    listener.settimeout(30)
    injector = plugin.DeviceInjectorPlugin(socket_path=sock_path)
    reconnects = counters.get("nri.reconnect")
    started = time.monotonic()
    thread = threading.Thread(target=injector.run, daemon=True,
                              kwargs={"retry": RetryPolicy(**NRI_RETRY)})
    thread.start()
    conns = []
    try:
        conn, _ = listener.accept()
        conns.append(conn)
        rt = _NriRuntime(conn)
        if not rt.registered.wait(30):
            raise AssertionError("the NRI plugin did not register")
        register_ms = (rt.registered_at - started) * 1e3
        events = rt.call("Configure", pb.ConfigureRequest(
            runtime_name="containerd", runtime_version="2.0"),
            pb.ConfigureResponse).events
        annotation = "".join(f"- path: {p}\n" for p in paths)
        got = rt.create(annotation).adjust.linux.devices
        injected = [(d.path, d.type, d.major, d.minor) for d in got]
        want = [(p, "c", os.major(os.stat(p).st_rdev),
                 os.minor(os.stat(p).st_rdev)) for p in paths]
        round_trips = []
        for _ in range(NRI_ROUND_TRIPS):
            t0 = time.perf_counter()
            rt.create(annotation)
            round_trips.append((time.perf_counter() - t0) * 1e6)
        missing = "/dev/nvidia-smoke-absent"
        try:
            rt.create(annotation + f"- path: {missing}\n")
            refused = None
        except TtrpcError as e:
            refused = str(e)
        # The runtime restarts: its trunk closes once.
        conn.shutdown(socket.SHUT_RDWR)
        conn.close()
        conn2, _ = listener.accept()
        conns.append(conn2)
        rt2 = _NriRuntime(conn2)
        reregistered = rt2.registered.wait(30)
        again = ([(d.path, d.type, d.major, d.minor)
                  for d in rt2.create(annotation).adjust.linux.devices]
                 if reregistered else None)
        reconnect = counters.get("nri.reconnect") - reconnects
        rt2.call("Shutdown", pb.Empty(), pb.Empty)
        thread.join(timeout=10)
    finally:
        for c in conns:
            c.close()
        listener.close()
        os.unlink(sock_path)
        os.rmdir(tmp)
    _launches_none("node_nri", before)
    checks = {
        "registered": (rt.register_req.plugin_name, rt.register_req.plugin_idx)
        == (plugin.PLUGIN_NAME, plugin.PLUGIN_IDX),
        "create_container_only": events == plugin.event_mask(
            pb.CREATE_CONTAINER),
        "allocate_list_injected": injected == want,
        "all_char_devices": all(v["char"] for v in lstats.values()),
        "missing_path_fails": refused is not None and missing in refused,
        "reregistered": reregistered and again == want,
        "reconnect_counted_once": reconnect == 1,
        "plugin_stopped": not thread.is_alive(),
    }
    _phase("node_nri", card=card, gpu=gpu, allocate_paths=paths,
           lstat=lstats, injected=injected, events=events,
           register_ms=round(register_ms, 3),
           create_container_us_median=round(statistics.median(round_trips),
                                            1),
           create_container_us_max=round(max(round_trips), 1),
           round_trips=len(round_trips), missing_path_error=refused,
           reconnect=reconnect, checks=checks)
    if not all(checks.values()):
        raise AssertionError(f"node_nri: {checks}")


class _ApiStubs:
    """A GCE metadata server and a Kubernetes API server on localhost:
    nodes, pods and PATCH / PUT, in memory."""

    def __init__(self, nodes, pods):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        self.nodes = {n["metadata"]["name"]: n for n in nodes}
        self.pods = {p["metadata"]["name"]: p for p in pods}
        self.metadata = {}
        self.writes = []
        stubs = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):
                pass

            def _send(self, code, body):
                data = (body if isinstance(body, str)
                        else json.dumps(body)).encode()
                self.send_response(code)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def _body(self):
                return json.loads(self.rfile.read(
                    int(self.headers["Content-Length"])))

            def do_GET(self):
                path = self.path
                if path.startswith(METADATA_PREFIX):
                    value = stubs.metadata.get(path[len(METADATA_PREFIX):])
                    return self._send(*((200, value) if value is not None
                                        else (404, "")))
                if path == "/api/v1/namespaces":
                    return self._send(200, {"items": [
                        {"metadata": {"name": "default"}}]})
                if path == "/api/v1/nodes":
                    return self._send(200, {"items": list(
                        stubs.nodes.values())})
                if path == "/api/v1/namespaces/default/pods":
                    return self._send(200, {"items": list(
                        stubs.pods.values())})
                name = path.rsplit("/", 1)[-1]
                if path.startswith("/api/v1/namespaces/default/pods/") \
                        and name in stubs.pods:
                    return self._send(200, stubs.pods[name])
                self._send(404, {})

            def do_PUT(self):
                body = self._body()
                name = self.path.rsplit("/", 1)[-1]
                stubs.writes.append(("PUT", self.path, body))
                stubs.pods[name] = body
                self._send(200, body)

            def do_PATCH(self):
                body = self._body()
                name = self.path.rsplit("/", 1)[-1]
                stubs.writes.append(("PATCH", self.path, body))
                stubs.nodes[name]["metadata"].setdefault("labels", {}).update(
                    body["metadata"]["labels"])
                self._send(200, stubs.nodes[name])

        self.server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.thread = threading.Thread(target=self.server.serve_forever,
                                       daemon=True)
        self.thread.start()
        self.url = f"http://127.0.0.1:{self.server.server_port}"

    def close(self):
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(timeout=10)


def _plain_distance(a, b):
    """The scheduler's pair distance from its definition: DCN_MIN plus
    DCN_FAR / 100**k at the first of (placement group, cluster, rack,
    host) where the two differ after k equal levels; DCN_MIN alone when
    all four are equal."""
    from container_engine_accelerators_tpu_torch.scheduler import topology

    for k, label in enumerate(topology.DCN_LABELS):
        if a[label] != b[label]:
            return 1000.0 + 1e6 / 100.0 ** k
    return 1000.0


def node_scheduler(card):
    """``cmd/label_nodes.py --once`` for every node of a 16-node fleet
    (metadata and API servers in process, over HTTP), then
    ``cmd/topology_scheduler.py --once --settle-seconds 0`` against the
    same API server with two gated jobs: every gate removed, every pod
    pinned by nodeAffinity, and the first job on the set of nodes that a
    plain ``itertools.combinations`` search over the same sorted nodes
    finds closest."""
    import itertools
    import socket

    from container_engine_accelerators_tpu_torch.cmd import label_nodes
    from container_engine_accelerators_tpu_torch.cmd import topology_scheduler
    from container_engine_accelerators_tpu_torch.deviceplugin.api import (
        RESOURCE_NAME,
    )
    from container_engine_accelerators_tpu_torch.gpulib.nvml import NvmlLib
    from container_engine_accelerators_tpu_torch.scheduler import labeler
    from container_engine_accelerators_tpu_torch.scheduler import topology

    before = _kernel_counts()
    lib = NvmlLib()
    try:
        local_gpus = len(lib.devices())
    finally:
        lib.close()
    here = socket.gethostname()
    clusters, racks, hosts = SCHED_FLEET
    places = list(itertools.product(range(clusters), range(racks),
                                    range(hosts)))
    names = [here] + [f"gpu-node-{i:02d}" for i in range(1, len(places))]
    nodes = [{"metadata": {"name": n, "labels": {
        topology.PLACEMENT_GROUP_LABEL: "pg-smoke"}},
        "spec": {"taints": []},
        "status": {"allocatable": {
            "cpu": "208", "memory": "1843Gi",
            RESOURCE_NAME: str(local_gpus if n == here else 8)}}}
        for n in names]
    pods = []
    for j, (job, n_pods, gpus) in enumerate(SCHED_JOBS):
        for i in range(n_pods):
            pods.append({
                "metadata": {"name": f"{job}-{i}", "namespace": "default",
                             "creationTimestamp": f"2026-01-01T00:00:0{j}Z",
                             "labels": {
                                 "job-name": job,
                                 "batch.kubernetes.io/job-completion-index":
                                     str(i)}},
                "spec": {"schedulingGates": [{"name": SCHED_GATE}],
                         "containers": [{"name": "main", "resources": {
                             "requests": {"cpu": "8", "memory": "64Gi",
                                          RESOURCE_NAME: str(gpus)}}}]},
                "status": {}})
    stubs = _ApiStubs(nodes, pods)
    metadata_base = stubs.url + METADATA_PREFIX
    try:
        label_ms, patched, computed = [], {}, {}
        for name, (c, r, h) in zip(names, places):
            stubs.metadata = {"/instance/name": name,
                              "/instance/attributes/physical_host":
                                  f"/cluster-{c}/rack-{c}{r}/host-{c}{r}{h}"}
            t0 = time.perf_counter()
            if label_nodes.main(["--once", "--api-host", stubs.url,
                                 "--metadata-base", metadata_base]) != 0:
                raise AssertionError(f"label_nodes failed for {name}")
            label_ms.append((time.perf_counter() - t0) * 1e3)
            patched[name] = stubs.writes[-1][2]["metadata"]["labels"]
            computed[name] = labeler.compute_labels(
                labeler.metadata_fetcher(metadata_base))
        labeled = {n: dict(stubs.nodes[n]["metadata"]["labels"])
                   for n in names}
        t0 = time.perf_counter()
        if topology_scheduler.main(["--once", "--settle-seconds", "0",
                                    "--api-host", stubs.url]) != 0:
            raise AssertionError("topology_scheduler failed")
        pass_ms = (time.perf_counter() - t0) * 1e3
        puts = [w for w in stubs.writes if w[0] == "PUT"]
        bound = {}
        for _, _, pod in puts:
            expr = pod["spec"]["affinity"]["nodeAffinity"][
                "requiredDuringSchedulingIgnoredDuringExecution"][
                "nodeSelectorTerms"][0]["matchExpressions"][0]
            bound[pod["metadata"]["name"]] = (
                expr["values"][0] if expr["key"] == "kubernetes.io/hostname"
                else None)
        gates_left = [p["metadata"]["name"] for p in stubs.pods.values()
                      if p["spec"].get("schedulingGates")]
    finally:
        stubs.close()
    # The plain search: the same sorted nodes, every 4-set that holds the
    # first job, the least summed distance of neighbours in that order.
    job, n_pods, gpus = SCHED_JOBS[0]
    ordered = sorted(names, key=lambda n: tuple(
        labeled[n][k] for k in topology.DCN_LABELS))
    free = {n: int(stubs.nodes[n]["status"]["allocatable"][RESOURCE_NAME])
            for n in names}
    t0 = time.perf_counter()
    best, best_d, n_sets = None, float("inf"), 0
    for combo in itertools.combinations(ordered, n_pods):
        n_sets += 1
        if any(free[n] < gpus for n in combo):
            continue
        d = sum(_plain_distance(labeled[combo[i - 1]], labeled[combo[i]])
                for i in range(1, n_pods))
        if d < best_d:
            best, best_d = combo, d
    plain_ms = (time.perf_counter() - t0) * 1e3
    first_job = [bound.get(f"{job}-{i}") for i in range(n_pods)]
    _launches_none("node_scheduler", before)
    checks = {
        "labels_patched": all(patched[n] == computed[n] for n in names),
        "labels_dcn": all(set(patched[n]) == {topology.CLUSTER_LABEL,
                                              topology.RACK_LABEL,
                                              topology.HOST_LABEL}
                          for n in names),
        "every_gate_removed": not gates_left,
        "every_pod_pinned": sorted(bound) == sorted(
            p["metadata"]["name"] for p in pods)
        and None not in bound.values(),
        "first_job_is_plain_minimum": first_job == list(best),
    }
    _phase("node_scheduler", card=card, node=here, local_gpus=local_gpus,
           fleet=dict(zip(("clusters", "racks", "hosts"), SCHED_FLEET)),
           labels_here=patched[here], label_ms_median=round(
               statistics.median(label_ms), 3),
           pass_ms=round(pass_ms, 3), bound=bound,
           first_job_plain=list(best), first_job_distance=best_d,
           plain_sets=n_sets,
           plain_search_ms=round(plain_ms, 3), checks=checks)
    if not all(checks.values()):
        raise AssertionError(f"node_scheduler: {checks}")


# ---- phase 42a: the observability layer in the node daemon ----------------

OBS_ALLOCATES = 100
OBS_SPAN_REPS = 10_000
OBS_SCRAPES = 20
OBS_PAGE = 64  # spans a /spans page when paging by cursor


def _get(port, path):
    """(ms, body bytes) of one GET on the daemon's metrics port."""
    t0 = time.perf_counter()
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=10) as resp:
        if resp.status != 200:
            raise AssertionError(f"GET {path}: {resp.status}")
        body = resp.read()
    return (time.perf_counter() - t0) * 1e3, body


def _latency_buckets(text, op):
    """{le µs: cumulative count} and the total of one agent_latency op."""
    buckets, total = {}, 0.0
    for labels, v in _gauges(text, "agent_latency").items():
        if f'op="{op}"' not in labels:
            continue
        le = labels.split('bucket="')[1].split('"')[0]
        if le == "+Inf":
            total = v
        else:
            buckets[int(le)] = v
    return buckets, total


def _bucket_quantile(buckets, total, q):
    """The upper bound (µs) of the bucket where the cumulative count
    reaches q of the total: what a scraper reads off the buckets."""
    for le in sorted(buckets):
        if buckets[le] >= q * total:
            return le
    return None


def _span_us(trace, n):
    """Median µs of one empty span opened and closed in this process."""
    times = []
    for _ in range(n):
        t0 = time.perf_counter_ns()
        with trace.span("chip_smoke.bench"):
            pass
        times.append(time.perf_counter_ns() - t0)
    return statistics.median(times) / 1e3


def _tool(module, *args):
    """One ``python -m`` run of the port's agent tools: (rc, out, err)."""
    proc = subprocess.run(
        [sys.executable, "-m",
         f"container_engine_accelerators_tpu_torch.cmd.{module}", *args],
        cwd=HERE, capture_output=True, text=True, timeout=60)
    return proc.returncode, proc.stdout, proc.stderr


def node_obs(card):
    """Phase 42a: ``obs/`` in the real daemon, read through /metrics,
    /spans, /profile, the flight recorder and the agent tools."""
    from importlib import metadata

    from container_engine_accelerators_tpu_torch.obs import trace

    before = _kernel_counts()
    checks = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_obs_") as tmp:
        spans_file = os.path.join(tmp, "spans.jsonl")
        flight_file = os.path.join(tmp, "flight.jsonl")
        rig = _NodeRig(tmp, env={"TPU_TRACE_FILE": spans_file,
                                 "TPU_FLIGHT_FILE": flight_file})
        try:
            _, reg = rig.registered()
            client, _first = rig.watch(reg.endpoint)
            name = rig.names[0]

            # 1. Allocates: the client's times and the daemon's buckets.
            client_us = []
            for _ in range(OBS_ALLOCATES):
                t0 = time.perf_counter()
                _allocate(client, [name])
                client_us.append((time.perf_counter() - t0) * 1e6)
            deadline, text = time.monotonic() + 30, ""
            total = 0.0
            while time.monotonic() < deadline:
                text = rig.scrape()
                buckets, total = _latency_buckets(text, "plugin.allocate")
                if total >= OBS_ALLOCATES:
                    break
                time.sleep(0.25)
            checks["allocate_count"] = total >= OBS_ALLOCATES
            exemplars = {int(k.split('bucket="')[1].split('"')[0]):
                         k.split('trace="')[1].split('"')[0]
                         for k in _gauges(text, "agent_exemplar")
                         if 'op="plugin.allocate"' in k}
            worst_le = max(exemplars) if exemplars else None
            worst_trace = exemplars.get(worst_le)

            # 2. A fault and its clear: Unhealthy and back.
            with open(rig.fault_file, "a") as f:
                f.write(f"fault {name} {NODE_FAULT_XID}\n")
            t_fault = time.monotonic()
            t_bad, _ = rig.wait_health(name, "Unhealthy")
            with open(rig.fault_file, "a") as f:
                f.write(f"clear {name}\n")
            t_good, _ = rig.wait_health(name, "Healthy")

            # 3. /spans by cursor, the exemplar's trace in it; /profile.
            _, body = _get(rig.port, f"/spans?since=0&limit={OBS_PAGE}")
            page1 = json.loads(body)
            _, body = _get(rig.port,
                           f"/spans?since={page1['cursor']}&limit={OBS_PAGE}")
            page2 = json.loads(body)
            full_ms, full = [], b""
            for _ in range(OBS_SCRAPES):
                ms, full = _get(rig.port, "/spans?since=0")
                full_ms.append(ms)
            every = json.loads(full)
            names = [s["name"] for s in every["spans"]]
            checks["spans_paged"] = (
                page1["dropped"] == 0 and page2["dropped"] == 0
                and len(page1["spans"]) == OBS_PAGE and page2["spans"]
                and [s["span"] for s in page1["spans"] + page2["spans"]]
                == [s["span"] for s in every["spans"]][
                    :len(page1["spans"]) + len(page2["spans"])])
            checks["exemplar_in_spans"] = any(
                s["trace"] == worst_trace and s["name"] == "plugin.allocate"
                for s in every["spans"])
            fault_spans = [s for s in every["spans"]
                           if s["name"] == "health.fault_file"]
            checks["fault_spans"] = (
                [s["attrs"]["kind"] for s in fault_spans] == ["fault", "clear"]
                and "health.recover" in names and "health.event" in names)
            deadline, recovery = time.monotonic() + 30, 0.0
            while time.monotonic() < deadline and recovery < 1:
                _, recovery = _latency_buckets(rig.scrape(),
                                               "health.recovery")
                time.sleep(0.1)
            checks["recovery_observed"] = recovery >= 1
            metrics_ms, metrics_body = [], b""
            for _ in range(OBS_SCRAPES):
                ms, metrics_body = _get(rig.port, "/metrics")
                metrics_ms.append(ms)
            text = metrics_body.decode()
            overhead = _gauges(text, "agent_gauge").get(
                '{name="prof.overhead_ratio"}')
            _, body = _get(rig.port, "/profile")
            prof = json.loads(body)
            shares = {k: round(v / sum(prof["subsystems"].values()), 4)
                      for k, v in prof["subsystems"].items()}
            checks["profile"] = prof["samples"] > 0 and bool(shares)

            # 4. SIGUSR1: one flight blob.
            pid = rig.procs[0].pid
            os.kill(pid, signal.SIGUSR1)
            deadline, blobs = time.monotonic() + 15, []
            while time.monotonic() < deadline:
                if os.path.exists(flight_file):
                    with open(flight_file) as f:
                        raw = f.read()
                    if raw.endswith("\n"):
                        blobs = raw.splitlines()
                        break
                time.sleep(0.05)
            sigusr1 = "delivered" if blobs else "not delivered in 15 s"
            blob = json.loads(blobs[0]) if blobs else {}
            if blobs:
                checks["flight_blob"] = (
                    len(blobs) == 1 and blob.get("flight_recorder") == 1
                    and blob["reason"] == f"signal {int(signal.SIGUSR1)}"
                    and bool(blob["spans"]) and bool(blob["counters"])
                    and "plugin.allocate" in blob["histograms"])

            # 5. The agent tools on the daemon's file and port.
            fault_trace = fault_spans[0]["trace"] if fault_spans else ""
            rc_sum, out_sum, err_sum = _tool("agent_trace", spans_file)
            rc_tree, _, err_tree = _tool("agent_trace", spans_file,
                                         "--trace", fault_trace)
            rc_top, out_top, _ = _tool("agent_top", "--once", "--port",
                                       str(rig.port))
            rc_prof, out_prof, _ = _tool("agent_prof", "--port",
                                         str(rig.port))
            checks["agent_trace"] = (rc_sum == 0 and "plugin.allocate"
                                     in err_sum and rc_tree == 0
                                     and "health.fault_file" in err_tree)
            checks["agent_top"] = rc_top == 0 and "plugin.allocate" in out_top
            checks["agent_prof"] = rc_prof == 0 and "samples" in out_prof
        finally:
            daemon_log = rig.log_tail()
            rig.close()
        flight_bytes = len(blobs[0].encode()) if blobs else None
    _launches_none("node_obs", before)

    # µs a span in this process: the ring alone, then with the sink.
    trace.reset()
    ring_us = _span_us(trace, OBS_SPAN_REPS)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_sink_") as tmp:
        trace.configure(os.path.join(tmp, "bench.jsonl"))
        sink_us = _span_us(trace, OBS_SPAN_REPS)
        trace.configure(None)
    trace.reset()

    client_us.sort()
    _phase("node_obs", card=card,
           prometheus_client=metadata.version("prometheus_client"),
           allocates=OBS_ALLOCATES,
           allocate_client_us={
               "median": round(statistics.median(client_us), 1),
               "p99": round(client_us[int(0.99 * len(client_us)) - 1], 1)},
           allocate_bucket_us={
               "median": _bucket_quantile(buckets, total, 0.5),
               "p99": _bucket_quantile(buckets, total, 0.99),
               "count": total},
           exemplar={"bucket_us": worst_le, "trace": worst_trace},
           fault_to_unhealthy_s=round(t_bad - t_fault, 3),
           unhealthy_to_healthy_s=round(t_good - t_bad, 3),
           span_us={"ring": round(ring_us, 3), "jsonl_sink": round(sink_us, 3),
                    "reps": OBS_SPAN_REPS},
           metrics_scrape={"ms_median": round(statistics.median(metrics_ms),
                                              3),
                           "bytes": len(metrics_body)},
           spans_page={"ms_median": round(statistics.median(full_ms), 3),
                       "bytes": len(full), "spans": len(every["spans"])},
           spans_pages=[len(page1["spans"]), len(page2["spans"])],
           profile={"samples": prof["samples"], "hz": prof["hz"],
                    "shares": shares},
           prof_overhead_ratio=overhead, sigusr1=sigusr1,
           flight_bytes=flight_bytes,
           flight_keys=sorted(blob), checks=checks)
    if not all(checks.values()):
        raise AssertionError(f"node_obs: {checks}; daemon: {daemon_log}")


# ---- phases 25-29: the multi-GPU layer on a world of one card --------------
#
# The card's machine has one GPU, and NCCL refuses two ranks on one GPU, so
# these phases run the mesh paths at world size 1 on a real NCCL group and
# real DTensors: what they show is the host cost of DTensor dispatch on
# paths that are host-bound already.  Multi-rank correctness is held on the
# CPU under gloo (tests/test_torch_dist_*.py).

DCN_WORLD = 2
DCN_SEED = 0  # the trainer's init seed: the shard is its parameters' half
# (lane, env for the client's PipelineConfig, exchange_shard(pipelined=)).
DCN_LANES = (("serial", {}, False),
             ("socket", {"TPU_DCN_SHM": "0", "TPU_DCN_SHM_DIRECT": "0"},
              True),
             ("default", {}, None),
             ("native", {}, False))
DCN_LANE_ENV = ("TPU_DCN_SHM", "TPU_DCN_SHM_DIRECT")
DCN_SERIES = ("shm_direct", "shm", "socket")
# The leg's latency histograms (sums of their spans): the exchange and
# its phases, and the read-back (serial: base64 over the control socket;
# pipelined: DXR1 ranges or the shm mapping).
DCN_SPANS = ("dcn.exchange", "dcn.exchange.register", "dcn.exchange.barrier",
             "dcn.exchange.stage", "dcn.exchange.send", "dcn.exchange.land",
             "dcn.exchange.pipeline", "dcn.read", "dcn.chunk.read",
             "dcn.shm.read")
DCN_TIMEOUT_S = 300
DCNXFERD_SRC = "native/dcnxferd/dcnxferd.cc"
DCNXFERD_BIN = "native/dcnxferd/build/dcnxferd"  # listed in .gitignore
DCNXFERD_POOL = 1 << 30  # both flows of a leg, with room
DCN_BENCH_SIZES = (65536, 1048576, 16777216, 67108864)
DCN_BENCH_ARGS = ["--producer", "--ring-socket", "--tuned", "--sizes",
                  ",".join(map(str, DCN_BENCH_SIZES)), "--iters", "5"]


def _dcnxferd():
    """The native daemon, built at first use with the Makefile's recipe.
    -> (path, seconds the build took, 0 when it was there)."""
    binary = os.path.join(HERE, DCNXFERD_BIN)
    t0 = time.perf_counter()
    if not os.path.exists(binary):
        os.makedirs(os.path.dirname(binary), exist_ok=True)
        subprocess.run(["g++", "-std=c++17", "-O2", "-Wall", "-Wextra",
                        "-o", binary, os.path.join(HERE, DCNXFERD_SRC)],
                       check=True, capture_output=True, timeout=600)
    return binary, round(time.perf_counter() - t0, 3)


def _native_daemon(binary, uds):
    proc = subprocess.Popen(
        [binary, "--uds_path", uds, "--pool_bytes", str(DCNXFERD_POOL),
         "--max_flows", "8", "--data_port", "0"],
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
    deadline = time.monotonic() + 30
    while not os.path.exists(os.path.join(uds, "xferd.sock")):
        if proc.poll() is not None:
            raise RuntimeError(f"dcnxferd exited: {proc.stderr.read()}")
        if time.monotonic() > deadline:
            proc.kill()
            proc.wait()
            raise TimeoutError("dcnxferd never made its socket")
        time.sleep(0.02)
    return proc


def _gbps(nbytes, ms):
    return round(nbytes / ms / 1e6, 3) if ms > 0 else None


def _dcn_rank(rank, world, tmp, addr, native_dirs):
    """One rank of phase 42b, a spawned process: its shard on the card,
    its own ``PyXferd``, one ``exchange_shard`` a lane."""
    import warnings

    import torch
    import torch.distributed as dist

    from container_engine_accelerators_tpu_torch.fleet.xferd import PyXferd
    from container_engine_accelerators_tpu_torch.models.transformer import (
        TransformerLM,
        init_params,
    )
    from container_engine_accelerators_tpu_torch.obs import histo, timeseries
    from container_engine_accelerators_tpu_torch.parallel import dcn

    dcn.initialize(env={"WORLD_SIZE": str(world), "RANK": str(rank),
                        "MASTER_ADDR": addr[0], "MASTER_PORT": str(addr[1])},
                   device="cpu")
    peer = 1 - rank
    dev = torch.device("cuda", 0)

    daemon = PyXferd(os.path.join(tmp, f"x{rank}"), node=f"rank{rank}")
    try:
        params = init_params(TransformerLM(dtype=torch.float32,
                                           device="meta"),
                             torch.Generator().manual_seed(DCN_SEED))
        flat = torch.cat([p.reshape(-1) for p in params.values()])
        del params
        half = flat.numel() // world
        shard = flat[rank * half:(rank + 1) * half].to(dev)
        out = {"model_params": flat.numel(), "shard_elems": half,
               "shard_bytes": half * 4, "lanes": {}}
        del flat
        nbytes = half * 4
        pinned = torch.empty(half, dtype=torch.float32, pin_memory=True)
        daemon.start()
        for lane, env, pipelined in DCN_LANES:
            for key in DCN_LANE_ENV:
                os.environ.pop(key, None)
            os.environ.update(env)
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            host = shard.cpu()
            d2h_ms = (time.perf_counter() - t0) * 1e3
            t0 = time.perf_counter()
            pinned.copy_(shard)
            torch.cuda.synchronize(dev)
            pinned_ms = (time.perf_counter() - t0) * 1e3
            t0 = time.perf_counter()
            data = host.numpy().tobytes()
            bytes_ms = (time.perf_counter() - t0) * 1e3
            uds = native_dirs[rank] if lane == "native" else daemon.uds_dir
            client = dcn.make_xfer_client(uds)
            ports = [None] * world
            dist.all_gather_object(ports, client.data_port())
            gauges = dict(timeseries.gauges())
            timeseries.gauge("dcn.exposed_ratio", float("nan"))
            histo.reset()
            barrier = dist.barrier
            if lane == "native" and rank:
                # A native daemon's send holds its one event loop until
                # the peer daemon has read the whole frame, so two
                # daemons sending to each other at once both wait for
                # the other: rank 1 sends once rank 0's shard landed.
                def barrier(c=client, flow=f"grad{peer}.{lane}"):
                    dist.barrier()
                    dcn.wait_flow_rx(c, flow, nbytes, DCN_TIMEOUT_S)
            dist.barrier()
            with client:
                t0 = time.perf_counter()
                raw = dcn.exchange_shard(
                    client, local_flow=f"grad{rank}.{lane}",
                    peer_flow=f"grad{peer}.{lane}", data=data,
                    peer_host="127.0.0.1", peer_port=ports[peer],
                    barrier=barrier, pipelined=pipelined,
                    timeout_s=DCN_TIMEOUT_S)
                xchg_ms = (time.perf_counter() - t0) * 1e3
            spans = {name: round(h["sum_us"] / 1e3, 3)
                     for name, h in histo.snapshot().items()
                     if name in DCN_SPANS}
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")  # bytes are read-only
                peer_host = torch.frombuffer(raw, dtype=torch.float32)
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            peer_dev = peer_host.to(dev)
            torch.cuda.synchronize(dev)
            h2d_ms = (time.perf_counter() - t0) * 1e3
            total = shard + peer_dev
            want = host.clone()
            dist.all_reduce(want)
            equal = torch.equal(total.cpu().view(torch.int32),
                                want.view(torch.int32))
            after = timeseries.gauges()
            moved = {k: int(after.get(f"dcn.lane.{k}.total_bytes", 0.0)
                            - gauges.get(f"dcn.lane.{k}.total_bytes", 0.0))
                     for k in DCN_SERIES}
            exposed = after.get("dcn.exposed_ratio")
            out["lanes"][lane] = {
                "bit_equal": bool(equal), "bytes_in": len(raw),
                "d2h_pageable_ms": round(d2h_ms, 3),
                "d2h_pageable_gbps": _gbps(nbytes, d2h_ms),
                "d2h_pinned_ms": round(pinned_ms, 3),
                "d2h_pinned_gbps": _gbps(nbytes, pinned_ms),
                "tobytes_ms": round(bytes_ms, 3),
                "exchange_ms": round(xchg_ms, 3),
                "exchange_gbps": _gbps(nbytes, xchg_ms),
                "h2d_ms": round(h2d_ms, 3),
                "h2d_gbps": _gbps(nbytes, h2d_ms),
                "span_ms": spans, "lane_bytes": moved,
                "exposed_ratio": (None if exposed is None
                                  or math.isnan(exposed) else exposed)}
            if not equal or len(raw) != nbytes:
                raise AssertionError(f"rank {rank} lane {lane}: the sum is "
                                     f"not gloo's all_reduce ({len(raw)} "
                                     f"of {nbytes} bytes)")
            dist.barrier()
    finally:
        daemon.stop()
        dcn.shutdown()
    with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _dcn_bench():
    """The port's ``cmd/dcn_bench.py`` as a user runs it: each mode's
    best GB/s and exposed ratio at the largest size, and memcpy's."""
    proc = subprocess.run(
        [sys.executable, "-m",
         "container_engine_accelerators_tpu_torch.cmd.dcn_bench",
         *DCN_BENCH_ARGS], cwd=HERE, capture_output=True, text=True,
        timeout=900)
    if proc.returncode != 0:
        raise AssertionError(f"dcn_bench exited {proc.returncode}: "
                             f"{proc.stderr[-2000:]}")
    rows = [json.loads(line) for line in proc.stdout.splitlines()
            if line.startswith("{")]
    rows = [r for r in rows if r.get("bench") == "dcn_xfer"]
    modes = sorted({r["mode"] for r in rows})
    cells = {(r["mode"], r["bytes"]) for r in rows}
    want = {(m, n) for m in modes for n in DCN_BENCH_SIZES}
    if cells != want or len(modes) != 7:
        raise AssertionError(f"dcn_bench rows: modes {modes}, missing "
                             f"{sorted(want - cells)}")
    top = max(DCN_BENCH_SIZES)
    at_top = {r["mode"]: {"best_gbps": round(r["mbps"] / 1e3, 4),
                          "best_ms": round(r["best_s"] * 1e3, 3),
                          "median_ms": round(r["median_s"] * 1e3, 3),
                          "exposed_ratio": r["exposed_ratio"],
                          "pct_of_memcpy": r["pct_of_memcpy"]}
              for r in rows if r["bytes"] == top}
    return {"argv": DCN_BENCH_ARGS, "rows": len(rows), "bytes": top,
            "modes": at_top, "memcpy_gbps": at_top["memcpy"]["best_gbps"],
            "summary": proc.stderr.strip().splitlines()[-1]}


def dcn_xfer_phase(card):
    """Phase 42b: the cross-node leg of a collective on a GPU node."""
    import torch.multiprocessing as mp

    binary, build_s = _dcnxferd()
    with tempfile.TemporaryDirectory(prefix="cs_dcn_") as tmp:
        dirs = [os.path.join(tmp, f"n{r}") for r in range(DCN_WORLD)]
        natives = [_native_daemon(binary, d) for d in dirs]
        try:
            t0 = time.perf_counter()
            ctx = mp.start_processes(
                _dcn_rank, args=(DCN_WORLD, tmp,
                                 ("127.0.0.1", _free_port()), dirs),
                nprocs=DCN_WORLD, join=False, start_method="spawn")
            deadline = time.monotonic() + 2 * DCN_TIMEOUT_S
            try:
                while not ctx.join(timeout=1.0):
                    if time.monotonic() > deadline:
                        raise TimeoutError("dcn_xfer ranks did not finish")
            finally:
                for proc in ctx.processes:
                    if proc.is_alive():
                        proc.kill()
                    proc.join()
            ranks_s = round(time.perf_counter() - t0, 3)
            ranks = []
            for r in range(DCN_WORLD):
                with open(os.path.join(tmp, f"rank{r}.json")) as f:
                    ranks.append(json.load(f))
        finally:
            for proc in natives:
                proc.terminate()
            for proc in natives:
                proc.wait(timeout=30)
    bench = _dcn_bench()
    _phase("dcn_xfer", card=card,
           shard="half of the f32 parameters of cmd/train_lm.py's default "
                 "model (12L 8x64 mlp2048 vocab32000, seed 0) a rank, on "
                 "cuda:0",
           model_params=ranks[0]["model_params"],
           shard_elems=ranks[0]["shard_elems"],
           shard_bytes=ranks[0]["shard_bytes"],
           ranks="2 spawned processes, gloo; each its own port PyXferd on "
                 "loopback (the native lane: a native dcnxferd each)",
           check="shard + peer's bytes on the card == gloo all_reduce of "
                 "the host copies, bit for bit, every lane and rank",
           native_build_s=build_s, ranks_s=ranks_s,
           lanes={lane: [rk["lanes"][lane] for rk in ranks]
                  for lane, _, _ in DCN_LANES},
           bench=bench)


MESH_STEPS = 6  # == TRAIN_STEPS: mesh_train's losses beside the train phase's
MESH_IMAGE_STEPS = 8
MESH_PARITY_BATCH = 32  # ResNet-50 f32 parity step (TF32 off)
# Its steps and schedule: step 0 trains at lr 0 (warmup), so four steps
# at lr 0.01 compare the losses after two real updates.
MESH_PARITY_STEPS, MESH_PARITY_LR = 4, 0.01
MESH_SERVE_NEW = 16  # cut from 32 to make room for phases 32a-32e
# A request through DTensor decode costs ~11.5 s of host dispatch on the
# card (torch 2.11, PERF.md §6): few repeats, and the f32 check decodes few
# tokens.
MESH_REQUEST_REPS, MESH_SLOTS_REPS = 2, 1
MESH_F32_NEW = 8


def _cuda_ms(fn, reps=5):
    """Median wall ms of ``fn()`` with the device synchronized around."""
    import torch

    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(out), out


def nccl_phase(card):
    """Phase 25: a world-size-1 NCCL group on the card (kept for the mesh
    phases): NCCL's version, one all_reduce, all_gather_into_tensor and
    reduce_scatter_tensor, each checked."""
    import torch
    import torch.distributed as dist

    from container_engine_accelerators_tpu_torch.parallel import dcn

    t0 = time.perf_counter()
    world, rank = dcn.initialize(device="cuda", force=True)
    init_s = time.perf_counter() - t0
    if (world, rank) != (1, 0) or dist.get_backend() != "nccl":
        raise AssertionError(f"group {world}/{rank} {dist.get_backend()}")
    x = torch.arange(1 << 20, dtype=torch.float32, device="cuda")
    checks = {}
    y = x.clone()
    dist.all_reduce(y)
    checks["all_reduce"] = torch.equal(y, x)
    g = torch.empty_like(x)
    dist.all_gather_into_tensor(g, x)
    checks["all_gather_into_tensor"] = torch.equal(g, x)
    r = torch.empty_like(x)
    dist.reduce_scatter_tensor(r, x)
    checks["reduce_scatter_tensor"] = torch.equal(r, x)
    if not all(checks.values()):
        raise AssertionError(f"NCCL collectives on one rank: {checks}")
    ms = {"all_reduce": _cuda_ms(lambda: dist.all_reduce(y))[0],
          "all_gather_into_tensor": _cuda_ms(
              lambda: dist.all_gather_into_tensor(g, x))[0],
          "reduce_scatter_tensor": _cuda_ms(
              lambda: dist.reduce_scatter_tensor(r, x))[0]}
    version = torch.cuda.nccl.version()
    _phase("nccl", card=card, backend=dist.get_backend(), world=world,
           nccl_version=".".join(map(str, version)) if isinstance(
               version, tuple) else version,
           init_s=init_s, checked=checks, bytes=x.numel() * 4,
           ms_one_rank=ms,
           note="one rank: each collective is a local copy through NCCL; "
                "NCCL across ranks is not measured on this machine")


def _megatron_lm(args, on_step):
    """``cmd/train_lm.py``'s training loop at ``args`` on the (1, 1) mesh
    under ``megatron``: the trainer's model, seed, AdamW and synthetic
    batches through ``make_lm_train_step(create_mesh(1, 1), ...)`` (the
    CLI takes the mesh at one rank only for ``--param-sharding fsdp``).
    -> the losses as floats."""
    import torch

    from container_engine_accelerators_tpu_torch.cmd import train_lm
    from container_engine_accelerators_tpu_torch.models.lm_train import (
        create_lm_train_state,
        make_lm_train_step,
    )
    from container_engine_accelerators_tpu_torch.models.transformer import (
        TransformerLM,
    )
    from container_engine_accelerators_tpu_torch.parallel import dcn
    from container_engine_accelerators_tpu_torch.parallel.mesh import (
        create_mesh,
        from_local_batch,
    )

    dcn.initialize(device="cuda", force=True)
    mesh = create_mesh(1, 1)
    device = dcn.local_device("cuda")
    model = TransformerLM(
        vocab_size=args.vocab_size, num_layers=args.num_layers,
        num_heads=args.num_heads, head_dim=args.head_dim,
        mlp_dim=args.mlp_dim, num_kv_heads=args.kv_heads or None,
        num_experts=args.num_experts, device=device)
    state = create_lm_train_state(
        model, torch.Generator().manual_seed(0),
        torch.optim.AdamW(model.parameters(), lr=args.learning_rate,
                          weight_decay=0.1))
    step_fn, state = make_lm_train_step(mesh, state, None, "megatron")

    def on_device(toks, labels, mask):
        return tuple(from_local_batch(x, mesh) for x in (
            torch.from_numpy(toks).to(device, torch.long),
            torch.from_numpy(labels).to(device, torch.long),
            torch.from_numpy(mask).to(device)))

    batches = [on_device(*b) for b in train_lm.synthetic_batches(args)]
    losses = []
    for step in range(args.train_steps):
        state, metrics = step_fn(state, *batches[step % len(batches)])
        losses.append(metrics["loss"])
        on_step(step, metrics["loss"], metrics)
    return [float(x) for x in losses]


def mesh_train(fa, card, plain_losses, plain):
    """Phase 26: cmd/train_lm.py at its defaults on the (1, 1) mesh,
    megatron (its training loop through ``make_lm_train_step`` on
    ``create_mesh(1, 1)``) and then ``main()`` with ``--param-sharding
    fsdp``: losses equal to the train phase's (same seed), flash launch
    counts, step ms, tokens/s, peak memory."""
    import torch

    from container_engine_accelerators_tpu_torch.cmd import train_lm

    args = train_lm.parse_args(["--train-steps", str(MESH_STEPS)])
    tokens = args.train_batch_size * args.seq_len
    layers_steps = args.num_layers * MESH_STEPS
    want = {"flash_attention_fwd": 2 * layers_steps,
            "flash_attention_bwd_dq": layers_steps,
            "flash_attention_bwd_dkv": layers_steps}
    runs, total = {}, {k: 0 for k in fa.LAUNCHES}
    for sharding in ("megatron", "fsdp"):
        ends = []

        def on_step(step, loss, metrics):
            torch.cuda.synchronize()
            ends.append(time.perf_counter())

        for name in fa.LAUNCHES:
            fa.LAUNCHES[name] = 0
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        if sharding == "megatron":
            losses = _megatron_lm(args, on_step)
        else:
            losses = train_lm.main(["--train-steps", str(MESH_STEPS),
                                    "--steps-per-eval", str(MESH_STEPS),
                                    "--param-sharding", sharding],
                                   on_step=on_step)
        peak = torch.cuda.max_memory_allocated()
        launches = dict(fa.LAUNCHES)
        if launches != want:
            raise AssertionError(f"mesh_train {sharding}: flash launches "
                                 f"{launches}, expected {want}")
        for k, v in launches.items():
            total[k] += v
        if losses != plain_losses:
            raise AssertionError(f"mesh_train {sharding} losses {losses} "
                                 f"differ from the plain trainer's "
                                 f"{plain_losses}")
        steady = [b - a for a, b in zip(ends[1:], ends[2:])]
        step_ms = statistics.median(steady) * 1e3
        runs[sharding] = {"losses": losses, "launches": launches,
                          "steady_step_ms": step_ms,
                          "step_ms_each": [round(x * 1e3, 3) for x in steady],
                          "tokens_per_s": tokens / (step_ms / 1e3),
                          "peak_memory_bytes": peak}
    _phase("mesh_train", card=card,
           entry={"megatron": "cmd/train_lm.py's loop at its defaults "
                              "through make_lm_train_step(create_mesh(1, 1),"
                              " state, None, 'megatron')",
                  "fsdp": "cmd/train_lm.py main() at its defaults with "
                          "--param-sharding fsdp: the (1, 1) mesh"},
           steps=MESH_STEPS, plain=plain, plain_losses=plain_losses,
           megatron=runs["megatron"], fsdp=runs["fsdp"],
           expected_launches=f"fwd 2 x {args.num_layers} layers x "
                             f"{MESH_STEPS} steps (remat), bwd "
                             f"{args.num_layers} x {MESH_STEPS}, each run",
           tolerance="bit-equal losses: one rank computes the plain "
                     "trainer's operations in its order")
    return total


def mesh_resume(card, plain_losses):
    """Phase 27: a checkpoint saved on the (1, 1) mesh under fsdp restored
    into the plain single-GPU trainer: its resumed losses beside the
    train phase's unbroken ones."""
    from container_engine_accelerators_tpu_torch.cmd import train_lm

    with tempfile.TemporaryDirectory(prefix="chip_smoke_mckpt_") as tmp:
        argv = ["--checkpoint-dir", tmp, "--checkpoint-interval", "2",
                "--steps-per-eval", str(MESH_STEPS)]
        t0 = time.perf_counter()
        first = train_lm.main(argv + ["--train-steps", "4",
                                      "--param-sharding", "fsdp"])
        first_s = time.perf_counter() - t0
        resumed = train_lm.main(argv + ["--train-steps", str(MESH_STEPS)])
    losses = first + resumed
    if len(first) != 4 or len(resumed) != MESH_STEPS - 4:
        raise AssertionError(f"mesh_resume ran {len(first)} + "
                             f"{len(resumed)} steps")
    if losses != plain_losses:
        raise AssertionError(f"mesh_resume losses {losses} differ from the "
                             f"unbroken {plain_losses}")
    _phase("mesh_resume", card=card,
           entry="cmd/train_lm.py: 4 steps on the (1, 1) mesh under fsdp "
                 "with --checkpoint-dir (interval 2), then the plain "
                 f"single-GPU trainer resumed to step {MESH_STEPS}",
           losses=losses, unbroken_losses=plain_losses,
           mesh_run_s=first_s, tolerance="bit-equal losses")


def _mesh_image(phase, build, size, dev, batch32=MESH_PARITY_BATCH,
                batch16=128, steps16=MESH_IMAGE_STEPS, f64_batch=None):
    """The sharded image step (models/train.py::make_sharded_train_step)
    of ``build(dtype, device)`` at ``size`` x ``size`` on the (1, 1) mesh
    beside the plain step, from the seed-0 weights: f32 with TF32 off at
    ``batch32``, four steps at lr 0.01 (loss and running statistics after
    two updates), then bf16 at ``batch16`` on the default schedule (loss,
    running statistics and step ms) -> the phase's fields.  With
    ``f64_batch`` (a model whose f32 train-mode gradients are
    ill-conditioned) the f32 losses are held only before the first
    update (steps 0 and 1: step 0 trains at lr 0), the four steps are
    held in f64 at ``f64_batch``, and the bf16 run at the other bf16
    phases' 2e-2."""
    import numpy as np
    import torch

    from container_engine_accelerators_tpu_torch.models.resnet import (
        BatchNorm,
        init_params,
    )
    from container_engine_accelerators_tpu_torch.models.train import (
        cosine_sgd,
        create_train_state,
        make_sharded_train_step,
        train_step,
    )
    from container_engine_accelerators_tpu_torch.parallel.mesh import (
        create_mesh,
    )

    before = _kernel_counts()
    mesh = create_mesh(1, 1)
    weights = init_params(build(torch.float32, "meta"),
                          torch.Generator().manual_seed(0))

    def stats(model):
        return {n: torch.cat([m.running_mean, m.running_var]).float().cpu()
                for n, m in model.named_modules()
                if isinstance(m, BatchNorm)}

    def run(dtype, batch, steps, sharded, timed=False, tx=None):
        model = build(dtype, dev)
        if dtype == torch.float64:
            model = model.double()
        model.load_state_dict(weights)
        state = create_train_state(model, tx=tx)
        step = train_step
        if sharded:
            step, state = make_sharded_train_step(mesh, state)
        rng = np.random.default_rng(3)
        xs = [torch.from_numpy(rng.standard_normal(
            (batch, size, size, 3), dtype=np.float32)).to(dev).permute(
                0, 3, 1, 2) for _ in range(2)]
        ys = [torch.from_numpy(rng.integers(0, 1000, batch)).to(dev)
              for _ in range(2)]
        losses, ends = [], []
        for i in range(steps):
            state, m = step(state, xs[i % 2], ys[i % 2])
            losses.append(m["loss"])
            if timed:
                torch.cuda.synchronize()
                ends.append(time.perf_counter())
        losses = [float(v) for v in losses]
        steady = [(b - a) * 1e3 for a, b in zip(ends[1:], ends[2:])]
        out = losses, stats(model), steady
        del model, state
        torch.cuda.empty_cache()
        return out

    def compare(a, b):
        return max(float((a[k] - b[k]).abs().max() / b[k].abs().max())
                   for k in b)

    def moved(losses):
        """How far the updates moved the loss: the relative change
        between two steps on the same batch, the last and the first."""
        return abs(losses[(len(losses) - 1) // 2 * 2] - losses[0]) / losses[0]

    # Tolerances: one-pass statistics over DTensors against cuDNN's, the
    # only arithmetic that differs on one rank (CPU probe of the same
    # f32 run at ResNet-50 64x64: losses 1.2e-7 apart); each loss bound
    # is held at least 10x below the change the updates made.
    tol32, stat_tol32, tol16, stat_tol16 = 1e-5, 1e-4, 1e-4, 2e-3
    torch.backends.cudnn.allow_tf32 = False
    tx = cosine_sgd(base_lr=MESH_PARITY_LR, total_steps=100, warmup_steps=1)
    plain32, stats32, _ = run(torch.float32, batch32, MESH_PARITY_STEPS,
                              False, tx=tx)
    mesh32, mstats32, _ = run(torch.float32, batch32, MESH_PARITY_STEPS,
                              True, tx=tx)
    rel_each = [abs(a - b) / abs(b) for a, b in zip(mesh32, plain32)]
    rel32, stat32 = max(rel_each), compare(mstats32, stats32)
    f64 = None
    if f64_batch is None:
        ok32 = (rel32 <= tol32 and stat32 <= stat_tol32
                and moved(plain32) > 10 * tol32)
    else:
        ok32 = max(rel_each[:2]) <= tol32
        # resnet_parity's f64 bounds: flax's one-pass variance cancels
        # where a channel's mean dwarfs its spread, in f64 too.
        tol64, stat_tol64 = (IMAGE_TOL["f64_loss_rel"],
                             IMAGE_TOL["f64_to_leaf_max"])
        plain64, stats64, _ = run(torch.float64, f64_batch,
                                  MESH_PARITY_STEPS, False, tx=tx)
        mesh64, mstats64, _ = run(torch.float64, f64_batch,
                                  MESH_PARITY_STEPS, True, tx=tx)
        rel64 = max(abs(a - b) / abs(b) for a, b in zip(mesh64, plain64))
        stat64 = compare(mstats64, stats64)
        if not (rel64 <= tol64 and stat64 <= stat_tol64
                and moved(plain64) > 10 * tol64):
            raise AssertionError(f"{phase} f64: loss rel {rel64}, running "
                                 f"statistics {stat64}, moved "
                                 f"{moved(plain64)}")
        f64 = {"batch": f64_batch, "steps": MESH_PARITY_STEPS,
               "plain_losses": plain64, "mesh_losses": mesh64,
               "loss_max_rel_diff": rel64, "loss_moved": moved(plain64),
               "running_stats_max_err_to_max": stat64,
               "tolerance": f"loss {tol64}, statistics {stat_tol64}"}
    if not ok32:
        raise AssertionError(f"{phase} f32: loss rel {rel_each}, running "
                             f"statistics {stat32}, moved "
                             f"{moved(plain32)}")
    plain16, stats16, plain_ms = run(torch.bfloat16, batch16, steps16,
                                     False, timed=True)
    torch.cuda.reset_peak_memory_stats()
    mesh16, mstats16, mesh_ms = run(torch.bfloat16, batch16, steps16,
                                    True, timed=True)
    peak = torch.cuda.max_memory_allocated()
    rel16_each = [abs(a - b) / abs(b) for a, b in zip(mesh16, plain16)]
    rel16, stat16 = max(rel16_each), compare(mstats16, stats16)
    if f64_batch is None:
        ok16 = (rel16 <= tol16 and stat16 <= stat_tol16
                and moved(plain16) > 10 * tol16)
    else:
        # An ill-conditioned step: a bf16 rounding that falls otherwise
        # in one BatchNorm (flax's arithmetic on the mesh, cuDNN's in the
        # plain step) moves the loss by far more than ResNet-50's, so its
        # bf16 run (for the step ms) is held at the bound the other bf16
        # phases use (train_parity, seq_train, the resumes).
        tol16 = stat_tol16 = 2e-2
        ok16 = rel16 <= tol16 and stat16 <= stat_tol16
    if not ok16:
        raise AssertionError(f"{phase} bf16: loss rel {rel16}, running "
                             f"statistics {stat16}, moved "
                             f"{moved(plain16)}")
    _launches_none(phase, before)
    held32 = (f"loss {tol32}, statistics {stat_tol32}" if f64_batch is None
              else f"loss {tol32} at steps 0-1 (before any update); after "
                   f"updates shown, and held in f64")
    out = {
        "f32": {"batch": batch32, "steps": MESH_PARITY_STEPS,
                "lr": f"{MESH_PARITY_LR} after a 1-step warmup",
                "plain_losses": plain32, "mesh_losses": mesh32,
                "loss_rel_diff_each": rel_each,
                "loss_max_rel_diff": rel32, "loss_moved": moved(plain32),
                "running_stats_max_err_to_max": stat32,
                "tolerance": f"{held32} (TF32 off): BatchNorm's statistics "
                             f"are flax's one-pass mean(x^2) - mean^2 over "
                             f"DTensors on the mesh, cuDNN's own in the "
                             f"plain step"},
        "bf16": {"batch": batch16, "steps": steps16,
                 "plain_losses": plain16, "mesh_losses": mesh16,
                 "loss_rel_diff_each": rel16_each,
                 "loss_max_rel_diff": rel16, "loss_moved": moved(plain16),
                 "running_stats_max_err_to_max": stat16,
                 "tolerance": f"loss {tol16}, statistics {stat_tol16}",
                 "plain_step_ms": statistics.median(plain_ms),
                 "mesh_step_ms": statistics.median(mesh_ms),
                 "plain_step_ms_each": [round(v, 3) for v in plain_ms],
                 "mesh_step_ms_each": [round(v, 3) for v in mesh_ms],
                 "mesh_peak_memory_bytes": peak}}
    if f64 is not None:
        out["f64"] = f64
    return out


def mesh_resnet(dev, card):
    """Phase 28: the sharded ResNet-50 step on the (1, 1) mesh beside the
    plain step (:func:`_mesh_image` at 224x224): f32 with TF32 off at
    batch 32, bf16 at batch 128."""
    from container_engine_accelerators_tpu_torch.models.resnet import resnet

    out = _mesh_image("mesh_resnet",
                      lambda dtype, device: resnet(50, dtype=dtype,
                                                   device=device),
                      224, dev)
    _phase("mesh_resnet", card=card,
           entry="models/train.py::make_sharded_train_step on the (1, 1) "
                 "mesh vs train_step: ResNet-50, 224x224, seed-0 weights",
           **out, launches="none of the port's kernels")


# mesh_inception's batches: bf16 at the trainer's default 128 (the
# train_resnet phase trains Inception-v3 at 299x299 there), f32 at
# mesh_resnet's 32 (twice the bytes an activation, and TF32 off), f64 at
# 8; one model is in memory at a time, and the phase prints the mesh
# step's peak.  Inception-v3's f32 train-mode gradients are
# ill-conditioned in the plain step and the mesh step alike (a CPU probe
# at 299x299, batch 8: each 0.14-0.16 of a leaf's largest |g| from the
# f64 gradients; ResNet-50 at 64x64: 5e-6), so its losses after updates
# are held in f64.
MESH_INCEPTION_BATCH16, MESH_INCEPTION_STEPS = 128, 6
MESH_INCEPTION_F64_BATCH = 8


def mesh_inception(dev, card):
    """Phase 28b: the sharded Inception-v3 step (the step ResNet takes)
    on the (1, 1) mesh beside the plain step, at its published widths
    (299x299, 1000 classes; :func:`_mesh_image`): f32 with TF32 off at
    batch 32 (held before the first update), f64 at batch 8 (held after
    two updates), bf16 at batch 128.  The block concatenations and the SAME
    pools run on the mesh's batch rows (``models/inception.py::
    cat_channels``)."""
    from container_engine_accelerators_tpu_torch.models.inception import (
        inception_v3,
    )

    out = _mesh_image("mesh_inception",
                      lambda dtype, device: inception_v3(
                          num_classes=1000, dtype=dtype, device=device),
                      299, dev, batch16=MESH_INCEPTION_BATCH16,
                      steps16=MESH_INCEPTION_STEPS,
                      f64_batch=MESH_INCEPTION_F64_BATCH)
    _phase("mesh_inception", card=card,
           entry="models/train.py::make_sharded_train_step on the (1, 1) "
                 "mesh vs train_step: Inception-v3, 299x299, 1000 classes, "
                 "seed-0 weights",
           batch_choice=f"bf16 {MESH_INCEPTION_BATCH16}, the trainer's "
                        f"default; f32 {MESH_PARITY_BATCH} as mesh_resnet "
                        f"(twice the bytes an activation); f64 "
                        f"{MESH_INCEPTION_F64_BATCH}; one model in memory "
                        f"at a time",
           **out, launches="none of the port's kernels")


# mesh_conv_shards: the model-axis sizes, and the tolerances against the
# whole convolution, of the largest |y|: an output-channel shard is the
# same sums (another cuDNN algorithm may order them otherwise), an
# input-channel shard's partial sums are rounded to the dtype and summed
# in it, as the all-reduce does (bf16: a few bf16 steps of 2**-8 on the
# largest output).
CONV_SHARD_M = (2, 4)
CONV_SHARD_BATCH = 128  # train_resnet's default batch
CONV_SHARD_TOL = {"bfloat16": 1e-2, "float32": 1e-5}


def _event_ms(fn, reps=10):
    """Mean device ms of ``fn()`` over ``reps`` calls after two warm-up
    calls, between two CUDA events."""
    import torch

    for _ in range(2):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _resnet_conv_shapes(batch):
    """{(in, out, kernel, strides, H, W): count} of ResNet-50's
    convolutions at 224x224 and ``batch`` images, read from a forward on
    the meta device."""
    import torch

    from container_engine_accelerators_tpu_torch.models.resnet import (
        Conv,
        resnet,
    )

    model = resnet(50, device="meta")
    shapes = {}

    def record(module, args, output):
        c_out, c_in, kh, kw = module.weight.shape
        key = (c_in, c_out, (kh, kw), module.strides, *args[0].shape[2:])
        shapes[key] = shapes.get(key, 0) + 1

    hooks = [m.register_forward_hook(record) for m in model.modules()
             if isinstance(m, Conv)]
    with torch.no_grad():
        model(torch.empty(batch, 3, 224, 224, device="meta"))
    for h in hooks:
        h.remove()
    return shapes


def mesh_conv_shards(dev, card):
    """Phase 28a: the model-parallel convolution's per-rank work on cuDNN,
    in channels_last: for every distinct convolution shape of ResNet-50
    at batch 128 and for its head, at M = 2 and 4, each model rank's
    local product (``models/resnet.py::conv_same``,
    ``conv_channel_slice`` / ``Dense._linear``, what ``Conv`` and
    ``Dense`` run on a mesh) computed in one process
    and combined as the collective would (concatenate output-channel
    shards, sum input-channel shards in the dtype), against the whole
    product, in bf16 and in f32 with TF32 off; and rank 0's shard's ms
    beside the whole product's (CUDA events)."""
    import torch

    from container_engine_accelerators_tpu_torch.models.resnet import (
        Conv,
        Dense,
        conv_channel_slice,
        conv_same,
    )
    from container_engine_accelerators_tpu_torch.parallel.mesh import (
        MODEL_AXIS,
        flax_axes,
        flax_spec,
    )

    before = _kernel_counts()
    batch = CONV_SHARD_BATCH
    gen = torch.Generator(device=dev).manual_seed(5)

    def split_dim(module, shape, m):
        """The port axis the JAX rule splits over a model axis of m."""
        spec = flax_spec(module, "weight", shape, 1, m)
        if MODEL_AXIS not in spec:
            return None
        return list(flax_axes(module, "weight", len(shape))).index(
            spec.index(MODEL_AXIS))

    def shards(fns, x, w, dim, m):
        """Each rank's local product, and the combined output: a rank's
        weight shard as ``shard_params`` stores it (DTensor's contiguous
        chunk), its x the whole rows (O) or ``split_to_model``'s channel
        slice, a view (I)."""
        width, fn = w.shape[dim] // m, fns[dim]
        outs = []
        for r in range(m):
            w_r = w.narrow(dim, r * width, width).contiguous()
            x_r = x if dim == 0 else x.narrow(1, r * width, width)
            outs.append((fn, x_r, w_r))
        local = [f(a, b) for f, a, b in outs]
        if dim == 0:
            return outs[0], torch.cat(local, dim=1)
        total = local[0]
        for y in local[1:]:
            total = total + y
        return outs[0], total

    rows, totals, worst = [], {}, {}
    conv_shapes = _resnet_conv_shapes(batch)
    cases = [("conv", key, count) for key, count in sorted(
        conv_shapes.items(), key=lambda kv: kv[0][4:] + kv[0][:2])]
    cases.append(("head", (2048, 1000), 1))
    for kind, key, count in cases:
        if kind == "conv":
            c_in, c_out, kernel, strides, h, w_ = key
            module = Conv(c_in, c_out, kernel, strides, device="meta")

            def fn(x, w, kernel=kernel, strides=strides):
                return conv_same(x, w, kernel, strides)

            def fn_i(x, w, kernel=kernel, strides=strides):
                return conv_channel_slice(x, w, kernel, strides)

            x_shape, fns = (batch, c_in, h, w_), (fn, fn_i)
        else:
            c_in, c_out = key
            module, fn = Dense(c_in, c_out, device="meta"), Dense._linear
            x_shape, fns = (batch, c_in), (fn, fn)
        w_shape = tuple(module.weight.shape)
        # The head computes in f32 in both models (flax's Dense(dtype=
        # float32)): its bf16 case would be its f32 case again.
        dtypes = ((torch.float32,) if kind == "head"
                  else (torch.bfloat16, torch.float32))
        for dtype in dtypes:
            x = torch.randn(x_shape, generator=gen, device=dev).to(dtype)
            w = torch.randn(w_shape, generator=gen, device=dev)
            if kind == "conv":
                x = x.contiguous(memory_format=torch.channels_last)
                w = w.contiguous(memory_format=torch.channels_last)
            whole = fn(x, w)
            whole_ms = _event_ms(lambda: fn(x, w))
            for m in CONV_SHARD_M:
                dim = split_dim(module, w_shape, m)
                if dim not in (0, 1):
                    raise AssertionError(f"{kind} {key} at M={m}: the rule "
                                         f"splits port dim {dim}")
                (f, a, b), combined = shards(fns, x, w, dim, m)
                err = ((combined.float() - whole.float()).abs().max()
                       / whole.float().abs().max()).item()
                name = str(dtype).split(".")[1]
                if not err <= CONV_SHARD_TOL[name]:
                    raise AssertionError(f"{kind} {key} M={m} {name}: "
                                         f"{err} of the largest |y|")
                shard_ms = _event_ms(lambda: f(a, b))
                rows.append({"kind": kind, "shape": list(key[:2]) + (
                    [list(key[2]), list(key[3]), key[4], key[5]]
                    if kind == "conv" else []), "count": count, "m": m,
                    "dtype": name, "split": "O" if dim == 0 else "I",
                    "max_err_to_max": err, "whole_ms": whole_ms,
                    "shard_ms": shard_ms,
                    "shard_over_whole": shard_ms / whole_ms})
                t = totals.setdefault(f"{kind} M={m} {name}",
                                      {"whole_ms": 0.0, "shard_ms": 0.0})
                t["whole_ms"] += count * whole_ms
                t["shard_ms"] += count * shard_ms
                key_w = f"M={m} {name}"
                worst[key_w] = max(worst.get(key_w, 0.0), err)
            del x, w, whole
    for t in totals.values():
        t["shard_over_whole"] = t["shard_ms"] / t["whole_ms"]
    _launches_none("mesh_conv_shards", before)
    _phase("mesh_conv_shards", card=card,
           what="each model rank's local product (conv_same, "
                "conv_channel_slice, Dense._linear: what Conv and Dense "
                "call on a mesh) vs the "
                "whole product; O = output channels split (the shards "
                "concatenated), I = input channels split (the partial sums "
                "added in the dtype); ResNet-50 at batch 128, 224x224, "
                "channels_last; the head 2048 -> 1000 in f32",
           distinct_conv_shapes=len(conv_shapes), tolerance=CONV_SHARD_TOL,
           max_err_to_max=worst,
           totals_weighted_by_count=totals, rows=rows,
           timing="CUDA events, mean of 10 calls after 2; rank 0's shard")


def collectives_phase(card):
    """Phase 25a: ``collectives/bench.py``'s ``main`` (the NCCL sweep)
    at world 1 on phase 25's group, for each of the four ops, 1M-64M:
    exit 0, the verdict file's keys and values, each result's size_bytes
    the nccl-tests accounting (S a step, x2), time_us and algbw; every
    run mirrored into a port ``PyXferd`` through ``DCN_UDS_DIR``."""
    with tempfile.TemporaryDirectory(prefix="cs_coll_") as tmp, \
            _BenchAccounting(tmp) as acct:
        return _collectives_sweeps(card, acct)


class _BenchAccounting:
    """A port ``PyXferd`` behind ``DCN_UDS_DIR`` for the sweeps; each
    ``DcnBenchAccounting``'s flow stats are read (over its own
    connection) as it closes.  ``check(op, results)``: the flow and the
    daemon's total count the sweep's bytes."""

    def __init__(self, tmp):
        from container_engine_accelerators_tpu_torch.collectives import bench
        from container_engine_accelerators_tpu_torch.fleet.xferd import (
            PyXferd,
        )

        self.bench, self.flows, self.tmp = bench, {}, tmp
        self.daemon = PyXferd(os.path.join(tmp, "dcn"), node="bench")
        self._close = bench.DcnBenchAccounting.close

    def __enter__(self):
        from container_engine_accelerators_tpu_torch.parallel import dcn

        self.daemon.start()
        os.environ[dcn.DCN_UDS_ENV] = self.daemon.uds_dir
        flows, close = self.flows, self._close

        def read_then_close(acct):
            if acct._client is not None:
                stats = acct._client.stats(flow=acct._flow)
                flows[acct._flow] = next(
                    f for f in stats["flows"] if f["flow"] == acct._flow)
            close(acct)

        self.bench.DcnBenchAccounting.close = read_then_close
        self.total = self._total()
        return self

    def _total(self):
        from container_engine_accelerators_tpu_torch.parallel.dcn_client \
            import DcnXferClient

        with DcnXferClient(self.daemon.uds_dir) as c:
            return c.stats()["total_transferred"]

    def check(self, op, results):
        want = sum(r["size_bytes"] for r in results)
        got = self.flows.pop(f"bench-{op}", {}).get("transferred")
        total, self.total = self._total() - self.total, self._total()
        if got != want or total != want:
            raise AssertionError(f"DcnBenchAccounting of {op}: flow "
                                 f"{got}, daemon total {total}, sweep {want}")
        return want

    def __exit__(self, *exc):
        from container_engine_accelerators_tpu_torch.parallel import dcn

        self.bench.DcnBenchAccounting.close = self._close
        os.environ.pop(dcn.DCN_UDS_ENV, None)
        self.daemon.stop()


def _collectives_sweeps(card, acct):
    import contextlib
    import io

    import torch

    bench = acct.bench

    # The JAX rig's verdict keys (collectives/bench.py::main).
    keys = {"op", "devices", "platform", "device_kind", "dtype", "iters",
            "warmup", "results", "peak_busbw_gbps", "line_rate_gbps",
            "pass_threshold", "line_rate_fraction", "pass"}
    sizes = [2**20 * 2**i for i in range(7)]  # 1M .. 64M
    out = {}
    accounted = {}
    tmp = acct.tmp
    for op in bench.OPS:
        path = os.path.join(tmp, f"{op}.json")
        with contextlib.redirect_stdout(io.StringIO()):
            rc = bench.main(["-b", "1M", "-e", "64M", "-f", "2",
                             "--op", op, "--verdict-json", path])
        with open(path) as f:
            verdict = json.load(f)
        got = [r["size_bytes"] for r in verdict["results"]]
        if (rc != 0 or set(verdict) != keys or got != sizes
                or verdict["platform"] != "gpu" or verdict["devices"] != 1
                or verdict["device_kind"] != torch.cuda.get_device_name()
                or verdict["pass"] is not None):
            head = {k: v for k, v in verdict.items() if k != "results"}
            raise AssertionError(f"collectives {op}: rc {rc}, verdict "
                                 f"{head}, sizes {got}")
        accounted[op] = acct.check(op, verdict["results"])
        out[op] = {"time_us": [round(r["time_us"], 3)
                               for r in verdict["results"]],
                   "alg_bw_gbps": [round(r["alg_bw_gbps"], 2)
                                   for r in verdict["results"]],
                   "bus_bw_gbps": [round(r["bus_bw_gbps"], 2)
                                   for r in verdict["results"]]}
    tails = _percentiles_run(bench, tmp, acct)
    _phase("collectives", card=card,
           entry="collectives/bench.py main(['-b', '1M', '-e', '64M', '-f', "
                 "'2', '--op', OP, '--verdict-json', F]): bf16, 100 chained "
                 "rounds after 5, between two CUDA events",
           sizes_bytes=sizes, ops=out, percentiles=tails,
           dcn_accounting={"daemon": "port PyXferd via DCN_UDS_DIR",
                           "flow": "bench-<op>", "bytes": accounted},
           note="one rank: every collective is a local copy through NCCL "
                "(the shift a clone); busbw is 0 by nccl-tests' factor "
                "2(n-1)/n or (n-1)/n at n = 1 (the shift's factor is 1); "
                "NCCL across cards is not measured on this machine")


PERCENTILE_ITERS = 50


def _percentiles_run(bench, tmp, acct):
    """``collectives/bench.py --percentiles`` at world 1: each round one
    ``bench.iter`` span feeding the ``bench.all_reduce`` histogram."""
    import contextlib
    import io

    from container_engine_accelerators_tpu_torch.obs import histo, trace

    path = os.path.join(tmp, "percentiles.json")
    trace.reset()
    histo.reset()
    with contextlib.redirect_stdout(io.StringIO()):
        rc = bench.main(["-b", "1M", "-e", "4M", "-f", "2", "--op",
                         "all_reduce", "--iters", str(PERCENTILE_ITERS),
                         "--percentiles", "--verdict-json", path])
    with open(path) as f:
        results = json.load(f)["results"]
    acct.check("all_reduce", results)
    spans = [s for s in trace.tail() if s["name"] == "bench.iter"]
    count = histo.snapshot().get("bench.all_reduce", {}).get("count")
    want = PERCENTILE_ITERS * len(results)
    checks = {"rc": rc == 0, "sizes": len(results) == 3,
              "tails": all(r["p50_us"] and r["p99_us"] >= r["p50_us"]
                           for r in results),
              "spans": len(spans) == want
              and {s["attrs"]["op"] for s in spans} == {"all_reduce"},
              "histogram": count == want}
    if not all(checks.values()):
        raise AssertionError(f"collectives --percentiles: {checks}")
    trace.reset()
    histo.reset()
    return {"op": "all_reduce", "iters": PERCENTILE_ITERS,
            "sizes_bytes": [r["size_bytes"] for r in results],
            "mean_us": [round(r["time_us"], 3) for r in results],
            "p50_us": [round(r["p50_us"], 3) for r in results],
            "p99_us": [round(r["p99_us"], 3) for r in results],
            "bench_iter_spans": len(spans), "histogram_count": count}


def mesh_serve(fd, dev, card):
    """Phase 29: cmd/serve_lm.py's TP serving functions on the (1, 1) mesh
    (build_generate with ``create_mesh(1, 1)`` — ``serving_mesh`` takes a
    mesh only for ``--tp > 1`` —, the engine with the broadcast hook)
    beside the plain server:
    one 16-token greedy request's latency (2 repeats) and an 8-request
    --slots 8 batch's wall time; identical greedy tokens; flash decode
    launched alike; then f32 greedy tokens of a TP-sharded model equal
    to the plain model's."""
    import numpy as np
    import torch

    from container_engine_accelerators_tpu_torch.cmd import serve_lm
    from container_engine_accelerators_tpu_torch.models.transformer import (
        TransformerLM,
        init_params,
    )
    from container_engine_accelerators_tpu_torch.parallel.mesh import (
        create_mesh,
        shard_params,
    )

    flags = SERVE_FLAGS + ["--port", "0", "--max-new-tokens",
                           str(MESH_SERVE_NEW)]
    rng = np.random.default_rng(11)
    vocab = serve_lm.parse_args([]).vocab_size
    one = rng.integers(0, vocab, 64).tolist()
    batch = slot_prompts(vocab, rng)
    out = {}
    for name, on_mesh in (("plain", False), ("mesh", True)):
        res = {}
        for slots in (0, SLOTS):
            argv = flags + (["--slots", str(SLOTS)] if slots else [])
            args = serve_lm.parse_args(argv)
            serve_lm.validate_args(args)
            if serve_lm.serving_mesh(args) is not None:
                raise AssertionError("serving_mesh took a mesh at --tp 1")
            mesh = create_mesh(1, 1) if on_mesh else None
            run = serve_lm.build_generate(args, mesh)
            engine_loop = serve_lm.start_engine(run, args)
            srv = _http_server(serve_lm.make_handler(run, args, engine_loop))
            port = srv[0].server_address[1]
            try:
                _reset(fd)
                if not slots:
                    lat = []
                    for _ in range(MESH_REQUEST_REPS):
                        t0 = time.perf_counter()
                        rows = _post(port, {"prompt_ids": [one],
                                            "temperature": 0})[1]["tokens"]
                        lat.append((time.perf_counter() - t0) * 1e3)
                    res["request_ms"] = statistics.median(lat)
                    res["request_ms_each"] = [round(v, 3) for v in lat]
                    res["one_row"] = rows[0]
                else:
                    walls = []
                    for _ in range(MESH_SLOTS_REPS):
                        rows, _, wall = _ask_all(srv, _greedy_bodies(batch))
                        walls.append(wall)
                    res["slots_batch_ms"] = min(walls)
                    res["slots_batch_ms_each"] = [round(v, 3) for v in walls]
                    res["slots_rows"] = rows
                res.setdefault("flash_decode_launches", {})[
                    "slots" if slots else "per_request"] = dict(fd.LAUNCHES)
            finally:
                _shutdown(*srv)
                serve_lm.stop_followers(run, engine_loop)
        out[name] = res
    if out["mesh"]["one_row"] != out["plain"]["one_row"] or \
            out["mesh"]["slots_rows"] != out["plain"]["slots_rows"]:
        raise AssertionError("mesh_serve: the TP server's greedy tokens "
                             "differ from the plain server's")
    if out["mesh"]["flash_decode_launches"] != \
            out["plain"]["flash_decode_launches"]:
        raise AssertionError(f"mesh_serve: flash decode launches "
                             f"{out['mesh']['flash_decode_launches']} vs "
                             f"plain {out['plain']['flash_decode_launches']}")
    launches = sum(out["mesh"]["flash_decode_launches"][k]["flash_decode"]
                   for k in ("per_request", "slots"))

    # f32: a TP-sharded decode model's greedy tokens equal the plain one's.
    args = serve_lm.parse_args([])
    cfg = dict(vocab_size=args.vocab_size, num_layers=args.num_layers,
               num_heads=args.num_heads, head_dim=args.head_dim,
               mlp_dim=args.mlp_dim)
    weights = init_params(TransformerLM(**cfg, decode=True, device="meta"),
                          torch.Generator().manual_seed(0))
    models = []
    for sharded in (False, True):
        m = TransformerLM(**cfg, dtype=torch.float32, decode=True,
                          device=dev)
        m.load_state_dict(weights)
        if sharded:
            shard_params(m, create_mesh(1, 1))
        models.append(m)
    prompts = [rng.integers(0, args.vocab_size, n).tolist() for n in (300,)]
    f32 = [[_solo_tokens(m, p, MESH_F32_NEW, args.max_prompt_len)
            for p in prompts] for m in models]
    if f32[0] != f32[1]:
        raise AssertionError("mesh_serve: f32 greedy tokens of the sharded "
                             "model differ from the plain model's")
    del models
    torch.cuda.empty_cache()
    for res in out.values():
        for k in ("one_row", "slots_rows"):
            res.pop(k)
    _phase("mesh_serve", card=card,
           entry="cmd/serve_lm.py build_generate(args, create_mesh(1, 1)) "
                 "+ start_engine behind a real HTTP server, "
                 + " ".join(SERVE_FLAGS) + f", {MESH_SERVE_NEW} new tokens",
           plain=out["plain"], mesh=out["mesh"],
           greedy_rows_identical=f"per request (1 row x "
                                 f"{MESH_REQUEST_REPS}) and --slots 8 (8 "
                                 f"rows x {MESH_SLOTS_REPS})",
           f32_greedy_identical=f"{len(prompts)} prompt of 300 tokens, "
                                f"{MESH_F32_NEW} new tokens")
    return launches


# ---- phases 30-32: sequence parallelism on the flash kernels ----------------

SEQ_SHAPE = (2, 2048, 8, 64)  # B, T, H, D of the composed ring blocks
# (layout, virtual ranks): a zigzag half at n = 8 is 128 rows, the
# kernels' tile.
SEQ_CASES = [("contiguous", 2), ("contiguous", 4), ("zigzag", 2),
             ("zigzag", 4), ("zigzag", 8)]
SEQ_KINDS = ("ring", "ring-zigzag", "ulysses")
SEQ_REPS = 3  # timed compositions a case, the median kept


def _compose_ring(q, k, v, do, n, layout, kernel, times=None):
    """Every virtual rank's forward, then backward ring steps
    (``parallel/seq.py::ring_forward_step`` / ``ring_backward_step``,
    causal), composed in one process on stored-order ``q, k, v, do``
    ``[B, T, H, D]``: rank r holds rows r*T/n.. of each, and the step
    (r, s) attends rank r's queries to rank (r - s) % n's keys, as the
    ring would.  -> (o, dq, dk, dv) in the stored order and q's dtype.
    ``times``, an [n][n] list, gets each (rank, step)'s forward plus
    backward ms (CUDA events)."""
    import torch

    from container_engine_accelerators_tpu_torch.parallel import seq

    b, t, h, d = q.shape
    tq, scale = t // n, d ** -0.5
    qs = [(x * scale).contiguous() for x in q.split(tq, 1)]
    ks, vs, dos = ([x.contiguous() for x in y.split(tq, 1)]
                   for y in (k, v, do))
    events = []

    def timed(r, s, fn):
        if times is None:
            return fn()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((r, s, start, end))

    outs, lses = [], []
    for r in range(n):
        o = torch.zeros(b, tq, h, d, device=q.device)
        lse = torch.full((b * h, tq), float("-inf"), device=q.device)
        for s in range(n):
            src = (r - s) % n
            timed(r, s, lambda: seq.ring_forward_step(
                qs[r], ks[src], vs[src], o, lse, r, src, n, layout, True,
                kernel))
        outs.append(o.to(q.dtype))
        lses.append(lse)
    dq, dk, dv = ([torch.zeros(b, tq, h, d, device=q.device)
                   for _ in range(n)] for _ in range(3))
    for r in range(n):
        for s in range(n):
            src = (r - s) % n
            timed(r, s, lambda: seq.ring_backward_step(
                qs[r], dos[r], outs[r], lses[r], ks[src], vs[src], dq[r],
                dk[src], dv[src], r, src, n, layout, True, kernel))
    torch.cuda.synchronize()
    for r, s, start, end in events:
        times[r][s] += start.elapsed_time(end)
    return (torch.cat(outs, 1), (torch.cat(dq, 1) * scale).to(q.dtype),
            torch.cat(dk, 1).to(q.dtype), torch.cat(dv, 1).to(q.dtype))


def seq_ring_blocks(fa, dev, card):
    """Phase 30: the ring's blocks on the flash kernels, every virtual
    rank composed in one process (B=2, T=2048, H=8, D=64, causal; bf16
    and f32; contiguous at n = 2, 4, zigzag at n = 2, 4, 8): o, dq, dk,
    dv against ``flash_attention`` over the whole sequence on the card,
    and against the plain per-block ring in f32; the kernel launches
    against the port's block count; the busiest virtual rank's ms and
    the critical path's, beside ``ring_skip_stats``' predicted ratio."""
    import torch

    from container_engine_accelerators_tpu_torch.parallel import seq

    b, t, h, d = SEQ_SHAPE
    scale = d ** -0.5
    gen = torch.Generator(device=dev).manual_seed(13)
    base = [torch.randn(b, t, h, d, device=dev, generator=gen)
            for _ in range(4)]
    rows, timing = [], {}
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v, do = (x.to(dtype) for x in base)
        o_w, lse_w = fa.flash_forward(q, k, v, True, scale)
        whole = (o_w,) + fa.flash_backward(q, k, v, o_w, lse_w, do, True,
                                           scale)
        fwd_tol, bwd_tol = FA_TOL[_name(dtype)]
        for layout, n in SEQ_CASES:

            def stored(x):
                return seq.to_zigzag(x, n) if layout == "zigzag" else x

            def natural(xs):
                return [seq.from_zigzag(x, n) if layout == "zigzag" else x
                        for x in xs]

            ins = [stored(x) for x in (q, k, v, do)]
            for name in fa.LAUNCHES:
                fa.LAUNCHES[name] = 0
            got = natural(_compose_ring(*ins, n, layout, True))
            torch.cuda.synchronize()
            blocks = seq.count_ring_blocks(n, layout)
            launches = dict(fa.LAUNCHES)
            if set(launches.values()) != {blocks}:
                raise AssertionError(f"seq_ring_blocks {layout} n={n} "
                                     f"{_name(dtype)}: launches {launches}, "
                                     f"expected {blocks} each")
            plain = natural(_compose_ring(*(x.float() for x in ins), n,
                                          layout, False))
            row = {"layout": layout, "n": n, "dtype": _name(dtype),
                   "blocks": blocks, "launches": launches}
            for i, name in enumerate(("o", "dq", "dk", "dv")):
                tol = fwd_tol if name == "o" else bwd_tol
                try:
                    err, to_max = _agrees(got[i], whole[i], dtype, tol)
                except AssertionError as e:
                    raise AssertionError(f"seq_ring_blocks {layout} n={n} "
                                         f"{name}: ring != whole-sequence "
                                         f"flash attention: {e}") from None
                gap = (got[i].float() - plain[i]).abs().max().item()
                if dtype == torch.float32 and not torch.allclose(
                        got[i], plain[i], atol=tol, rtol=tol):
                    raise AssertionError(f"seq_ring_blocks {layout} n={n} "
                                         f"{name}: kernel ring != plain "
                                         f"per-block ring (f32): {gap}")
                row[name] = {"max_abs_err_to_whole": err,
                             "err_to_max_of_whole": to_max,
                             "gap_to_plain_ring_f32": gap}
            if dtype == torch.bfloat16:
                times = [[0.0] * n for _ in range(n)]
                for _ in range(SEQ_REPS):
                    _compose_ring(*ins, n, layout, True, times)
                per = [[x / SEQ_REPS for x in r_] for r_ in times]
                timing[(layout, n)] = {
                    "busiest_rank_ms": max(sum(r_) for r_ in per),
                    "critical_path_ms": sum(max(per[r][s] for r in range(n))
                                            for s in range(n)),
                    "all_ranks_ms": sum(map(sum, per))}
            rows.append(row)
    ratios = {}
    for n in (2, 4):
        c, z = timing[("contiguous", n)], timing[("zigzag", n)]
        ratios[f"n={n}"] = {
            "predicted": seq.ring_skip_stats(t, n)["critical"]
            / seq.ring_skip_stats(t, n, "zigzag")["critical"],
            "busiest_rank": c["busiest_rank_ms"] / z["busiest_rank_ms"],
            "critical_path": c["critical_path_ms"] / z["critical_path_ms"]}
    _phase("seq_ring_blocks", card=card,
           shape=f"B={b} T={t} H={h} D={d} causal",
           cases=rows, tolerance={k: {"fwd": f, "bwd": bw}
                                  for k, (f, bw) in FA_TOL.items()},
           bf16_err_to_max_bound=BF16_ERR_TO_MAX,
           bf16_ms={f"{layout} n={n}": v for (layout, n), v in timing.items()},
           contiguous_over_zigzag=ratios,
           note="one process composes every virtual rank's steps; ms per "
                "(rank, step) are the step's kernels and its lse merge, "
                f"CUDA events, median of {SEQ_REPS}; no NCCL")


def seq_train(fa, card, plain_losses, plain):
    """Phase 31: cmd/train_lm.py's main() at its defaults with
    --seq-parallel ring, ring-zigzag and ulysses on the world-1 NCCL group
    of phase 25: launch counts reset around each (the ring's blocks a
    step: 2 x layers forwards under remat, layers dQ and dK/dV, times the
    blocks of one rank: contiguous 1, zigzag 3; Ulysses none), losses
    within 2e-2 relative of phase 8's, step ms, tokens/s and peak memory
    beside phase 8's."""
    import torch

    from container_engine_accelerators_tpu_torch.cmd import train_lm
    from container_engine_accelerators_tpu_torch.parallel import seq

    args = train_lm.parse_args([])
    tokens = args.train_batch_size * args.seq_len
    layers_steps = args.num_layers * TRAIN_STEPS
    runs, total = {}, {k: 0 for k in fa.LAUNCHES}
    for kind in SEQ_KINDS:
        ends = []

        def on_step(step, loss, metrics):
            torch.cuda.synchronize()
            ends.append(time.perf_counter())

        for name in fa.LAUNCHES:
            fa.LAUNCHES[name] = 0
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        losses = train_lm.main(["--train-steps", str(TRAIN_STEPS),
                                "--steps-per-eval", str(TRAIN_STEPS),
                                "--seq-parallel", kind], on_step=on_step)
        peak = torch.cuda.max_memory_allocated()
        launches = dict(fa.LAUNCHES)
        blocks = (0 if kind == "ulysses" else seq.count_ring_blocks(
            1, "zigzag" if kind == "ring-zigzag" else "contiguous"))
        want = {"flash_attention_fwd": 2 * layers_steps * blocks,
                "flash_attention_bwd_dq": layers_steps * blocks,
                "flash_attention_bwd_dkv": layers_steps * blocks}
        if launches != want:
            raise AssertionError(f"seq_train {kind}: flash launches "
                                 f"{launches}, expected {want}")
        for k, v in launches.items():
            total[k] += v
        rel = [abs(a - b) / abs(b) for a, b in zip(losses, plain_losses)]
        if len(losses) != TRAIN_STEPS or not max(rel) <= 2e-2:
            raise AssertionError(f"seq_train {kind} losses {losses} vs the "
                                 f"plain trainer's {plain_losses}")
        steady = [y - x for x, y in zip(ends[1:], ends[2:])]
        step_ms = statistics.median(steady) * 1e3
        runs[kind] = {"losses": losses, "max_rel_to_plain": max(rel),
                      "launches": launches, "steady_step_ms": step_ms,
                      "step_ms_each": [round(x * 1e3, 3) for x in steady],
                      "tokens_per_s": tokens / (step_ms / 1e3),
                      "peak_memory_gb": peak / 1e9}
    _phase("seq_train", card=card,
           entry="cmd/train_lm.py main() at its defaults with --seq-parallel "
                 "KIND: 12L 8x64 mlp2048 vocab32000, seq 2048, batch 8, bf16, "
                 "remat; a (1, 1) mesh on one NCCL rank",
           steps=TRAIN_STEPS, plain={**plain, "losses": plain_losses,
                                     "peak_memory_gb":
                                     plain["peak_memory_bytes"] / 1e9},
           **{kind.replace("-", "_"): runs[kind] for kind in SEQ_KINDS},
           tolerance="losses within 2e-2 relative of the plain trainer's "
                     "(bf16: other attention arithmetic)")
    return total, runs["ring-zigzag"]["losses"]


def seq_resume(fa, card, unbroken):
    """Phase 32: --seq-parallel ring-zigzag with --checkpoint-dir, 4 steps
    at an interval of 2, then a restart to step 6: losses equal to phase
    31's unbroken ring-zigzag run.  -> the flash launches of both runs."""
    from container_engine_accelerators_tpu_torch.cmd import train_lm

    for name in fa.LAUNCHES:
        fa.LAUNCHES[name] = 0
    with tempfile.TemporaryDirectory(prefix="chip_smoke_sckpt_") as tmp:
        argv = ["--seq-parallel", "ring-zigzag", "--checkpoint-dir", tmp,
                "--checkpoint-interval", "2", "--steps-per-eval",
                str(TRAIN_STEPS)]
        first = train_lm.main(argv + ["--train-steps", "4"])
        resumed = train_lm.main(argv + ["--train-steps", str(TRAIN_STEPS)])
    losses = first + resumed
    if len(first) != 4 or losses != unbroken:
        raise AssertionError(f"seq_resume losses {first} + {resumed} differ "
                             f"from the unbroken {unbroken}")
    _phase("seq_resume", card=card,
           entry="cmd/train_lm.py --seq-parallel ring-zigzag: 4 steps with "
                 "--checkpoint-dir (interval 2), then resumed to step "
                 f"{TRAIN_STEPS}", losses=losses, unbroken_losses=unbroken,
           tolerance="bit-equal losses")
    return dict(fa.LAUNCHES)


# ---- phases 32a-32e: pipeline and expert parallelism, the MoE-LM and the
# serving features on the mesh, the JAX dry run's regimes ----------------------

PIPE_SHAPE = (8, 2048)  # rows, tokens: the trainer's batch
PIPE_MICROBATCHES = 4
# bf16, of the largest |x|: the output and every weight's gradient
# At one stage / one rank these paths do the single-device arithmetic: the
# pipeline, the expert-sharded layer and the MoE mesh step are held
# bit-equal to their plain versions.
FEATURE_MESH_FLAGS = ["--num-experts", "8", "--weights", "int8",
                      "--prefix-cache", "4", "--max-prompt-len", "256",
                      "--max-new-tokens", "8"]
FEATURE_MESH_PREFIX = 64  # tokens of the shared prefix
FEATURE_MESH_ROWS = (5, 40, 17, 90)  # suffix lengths


def _leaf_errs(got, want):
    """Each leaf's max |got - want| over its largest |want|."""
    return {k: _to_max(got[k].float(), want[k].float()) for k in want}


def pipeline_phase(fa, dev, card):
    """Phase 32a: the trainer's default blocks (12 x 8 heads x 64, mlp
    2048; f32 weights, bf16 compute, flash attention) as the layer of
    ``parallel/pipeline.py``'s GPipe schedule at S = 1 (the (1, 1) pipe x
    data mesh on phase 25's NCCL group), M = 4 microbatches of a [8,
    2048, 512] batch: output and every weight's gradient bit-equal to
    the same blocks applied in order to the same microbatches; the flash launches of the pipelined run (12 layers x
    M steps each kernel, no remat); both runs' ms.  -> those launches."""
    import torch
    from torch.func import functional_call

    from container_engine_accelerators_tpu_torch.cmd import train_lm
    from container_engine_accelerators_tpu_torch.models.transformer import (
        TransformerLM,
        init_params,
    )
    from container_engine_accelerators_tpu_torch.parallel.pipeline import (
        create_pipeline_mesh,
        make_pipeline_apply,
        place_staged,
        stage_params,
        unstage_params,
    )

    args = train_lm.parse_args([])
    model = TransformerLM(vocab_size=args.vocab_size,
                          num_layers=args.num_layers,
                          num_heads=args.num_heads, head_dim=args.head_dim,
                          mlp_dim=args.mlp_dim, device=dev)
    model.load_state_dict(init_params(model, torch.Generator().manual_seed(0)))
    template = model.blocks[0]
    names = [n for n, _ in template.named_parameters()]
    stacked = {n: torch.stack([dict(b.named_parameters())[n].detach()
                               for b in model.blocks]) for n in names}
    del model
    b, t = PIPE_SHAPE
    d = args.num_heads * args.head_dim
    positions = torch.arange(t, device=dev)

    def layer_fn(p, h):
        return functional_call(template, p, (h, positions))[0]

    g = torch.Generator(device=dev).manual_seed(21)
    x = torch.randn(b, t, d, generator=g, device=dev).to(torch.bfloat16)
    w = torch.randn(b, t, d, generator=g, device=dev)
    mesh = create_pipeline_mesh(1, 1)
    staged = place_staged(mesh, stage_params(stacked, 1))
    apply = make_pipeline_apply(layer_fn, mesh, PIPE_MICROBATCHES)
    for name in fa.LAUNCHES:
        fa.LAUNCHES[name] = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    y = apply(staged, x)
    (y.float() * w).sum().backward()
    torch.cuda.synchronize()
    pipe_ms = (time.perf_counter() - t0) * 1e3
    launches = dict(fa.LAUNCHES)
    steps = PIPE_MICROBATCHES  # M + S - 1 at S = 1
    want = {k: args.num_layers * steps for k in launches}
    grads = unstage_params({n: p.grad.full_tensor()
                            for n, p in staged.items()})

    # The same blocks in order, microbatch by microbatch.
    leaves = {n: v.clone().requires_grad_() for n, v in stacked.items()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = []
    for h in x.chunk(PIPE_MICROBATCHES):
        for i in range(args.num_layers):
            h = layer_fn({n: v[i] for n, v in leaves.items()}, h)
        outs.append(h)
    ref = torch.cat(outs)
    (ref.float() * w).sum().backward()
    torch.cuda.synchronize()
    seq_ms = (time.perf_counter() - t0) * 1e3
    out_err = _to_max(y.float(), ref.float())
    grad_errs = _leaf_errs(grads, {n: v.grad for n, v in leaves.items()})
    if not (out_err == 0 and max(grad_errs.values()) == 0):
        raise AssertionError(f"pipeline vs sequential blocks: output "
                             f"{out_err}, gradients {grad_errs}")
    if launches != want:
        raise AssertionError(f"pipeline: flash launches {launches}, "
                             f"expected {want}")
    _phase("pipeline", card=card,
           entry="parallel/pipeline.py make_pipeline_apply over "
                 "create_pipeline_mesh(1, 1), staged by stage_params / "
                 "place_staged",
           layer="the trainer's default Block (8 x 64 heads, mlp 2048, f32 "
                 "weights, bf16 compute, flash attention), 12 layers",
           batch=[b, t, d], microbatches=PIPE_MICROBATCHES, stages=1,
           launches=launches, expected_launches=f"{args.num_layers} layers "
           f"x {steps} schedule steps, each kernel (no remat)",
           out_err_to_max=out_err, grad_err_to_leaf_max=grad_errs,
           tolerance="bit-equal", pipeline_ms=pipe_ms, sequential_ms=seq_ms)
    return launches


def expert_parallel_phase(dev, card):
    """Phase 32b: ``MoEFFN`` at full width (E 8, D 512, F 2048; f32
    weights, bf16 compute, capacity factor 1.25) on the trainer's [8,
    2048, 512] tokens, expert-sharded (``ops/moe.py::expert_sharding`` on
    the model axis of the (1, 1) mesh: the all-to-all path, one rank)
    against the unsharded layer, on tokens that lean toward one expert:
    output, aux, drop share and every gradient bit-equal, and both
    forward + backward ms."""
    import copy

    import torch
    from torch import nn

    from container_engine_accelerators_tpu_torch.models.transformer import (
        init_params,
    )
    from container_engine_accelerators_tpu_torch.ops.moe import (
        MoEFFN,
        expert_sharding,
    )
    from container_engine_accelerators_tpu_torch.parallel.mesh import (
        create_mesh,
    )

    d, e, f = 512, 8, 2048
    layer = MoEFFN(d, e, f, torch.bfloat16, lambda *s, dtype: nn.Parameter(
        torch.empty(*s, dtype=torch.float32, device=dev)))
    layer.load_state_dict(init_params(layer, torch.Generator().manual_seed(3)))
    sharded = expert_sharding(create_mesh(1, 1), copy.deepcopy(layer))
    g = torch.Generator(device=dev).manual_seed(22)
    # Tokens that lean toward expert 0 (a unit step along its router
    # column), so its queue overflows and the drop path runs (~a quarter
    # of the tokens dropped; random normal tokens spread evenly and drop
    # none).
    col = layer.router[:, 0].detach()
    x0 = (torch.randn(*PIPE_SHAPE, d, generator=g, device=dev)
          + col / col.norm()).to(torch.bfloat16)
    w = torch.randn(*PIPE_SHAPE, d, generator=g, device=dev)
    res = {}
    for name, m in (("plain", layer), ("expert_sharded", sharded)):
        x = x0.clone().requires_grad_()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, aux, dropped = m(x)
        ((out.float() * w).sum() + 0.01 * aux).backward()
        torch.cuda.synchronize()
        grads = {k: (p.grad.full_tensor() if hasattr(p.grad, "full_tensor")
                     else p.grad) for k, p in m.named_parameters()}
        res[name] = dict(out=out.detach(), aux=aux.item(),
                         dropped=dropped.item(), grads=dict(grads, x=x.grad),
                         ms=(time.perf_counter() - t0) * 1e3)
    p, s = res["plain"], res["expert_sharded"]
    out_err = _to_max(s["out"].float(), p["out"].float())
    grad_errs = _leaf_errs(s["grads"], p["grads"])
    aux_rel = abs(s["aux"] - p["aux"]) / abs(p["aux"])
    if not (out_err == 0 and aux_rel == 0 and max(grad_errs.values()) == 0
            and s["dropped"] == p["dropped"]):
        raise AssertionError(f"expert-sharded MoE vs plain: out {out_err}, "
                             f"aux {aux_rel}, grads {grad_errs}, dropped "
                             f"{s['dropped']} vs {p['dropped']}")
    _phase("expert_parallel", card=card,
           entry="ops/moe.py MoEFFN + expert_sharding(create_mesh(1, 1), "
                 "layer) (the all-to-all path at one rank)",
           shape={"tokens": PIPE_SHAPE[0] * PIPE_SHAPE[1], "d": d,
                  "experts": e, "mlp": f, "capacity_factor": 1.25},
           dropped_share=s["dropped"], aux=s["aux"],
           out_err_to_max=out_err, aux_rel=aux_rel,
           grad_err_to_leaf_max=grad_errs,
           tolerance="bit-equal", plain_ms=p["ms"], expert_sharded_ms=s["ms"])


def mesh_train_moe(fa, card, moe_losses, moe_dropped):
    """Phase 32c: cmd/train_lm.py at its defaults plus --num-experts 8 on
    the (1, 1) mesh, megatron (its loop through ``make_lm_train_step(
    create_mesh(1, 1), ...)``) and ``main()`` with ``--param-sharding
    fsdp``: losses and drop shares equal to phase 19's, flash launch
    counts exact, step ms.  -> the launches of both runs."""
    import torch

    from container_engine_accelerators_tpu_torch.cmd import train_lm

    argv = MOE_FLAGS + ["--train-steps", str(TRAIN_STEPS)]
    args = train_lm.parse_args(argv)
    layers_steps = args.num_layers * TRAIN_STEPS
    want = {"flash_attention_fwd": 2 * layers_steps,
            "flash_attention_bwd_dq": layers_steps,
            "flash_attention_bwd_dkv": layers_steps}
    runs, total = {}, {k: 0 for k in fa.LAUNCHES}
    for sharding in ("megatron", "fsdp"):
        ends, dropped = [], []

        def on_step(step, loss, metrics):
            torch.cuda.synchronize()
            ends.append(time.perf_counter())
            dropped.append(metrics["moe_dropped"])

        for name in fa.LAUNCHES:
            fa.LAUNCHES[name] = 0
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        if sharding == "megatron":
            losses = _megatron_lm(args, on_step)
        else:
            losses = train_lm.main(argv + ["--steps-per-eval",
                                           str(TRAIN_STEPS),
                                           "--param-sharding", sharding],
                                   on_step=on_step)
        launches = dict(fa.LAUNCHES)
        for k, v in launches.items():
            total[k] += v
        dropped = [float(x) for x in dropped]
        if losses != moe_losses or dropped != moe_dropped:
            raise AssertionError(f"mesh_train_moe {sharding}: losses "
                                 f"{losses}, dropped {dropped} vs "
                                 f"train_moe's {moe_losses}, {moe_dropped}")
        steady = [b - a for a, b in zip(ends[1:], ends[2:])]
        runs[sharding] = {"losses": losses, "dropped_share": dropped,
                          "launches": launches,
                          "steady_step_ms": statistics.median(steady) * 1e3,
                          "step_ms_each": [round(x * 1e3, 3)
                                           for x in steady],
                          "peak_memory_bytes":
                              torch.cuda.max_memory_allocated()}
    for sharding, run in runs.items():
        if run["launches"] != want:
            raise AssertionError(f"mesh_train_moe {sharding}: flash "
                                 f"launches {run['launches']}, expected "
                                 f"{want}")
    _phase("mesh_train_moe", card=card,
           entry={"megatron": "cmd/train_lm.py's loop at its defaults "
                              "+ --num-experts 8 through make_lm_train_step("
                              "create_mesh(1, 1), state, None, 'megatron')",
                  "fsdp": "cmd/train_lm.py main() --num-experts 8 "
                          "--param-sharding fsdp: the (1, 1) mesh"},
           steps=TRAIN_STEPS, train_moe_losses=moe_losses,
           train_moe_dropped_share=moe_dropped,
           megatron=runs["megatron"], fsdp=runs["fsdp"],
           expected_launches=f"fwd 2 x {args.num_layers} layers x "
                             f"{TRAIN_STEPS} steps (remat), bwd "
                             f"{args.num_layers} x {TRAIN_STEPS}, each run",
           tolerance="losses and drop shares bit-equal to train_moe's")
    return total


def mesh_serve_features(fd, card):
    """Phase 32d: cmd/serve_lm.py with ``FEATURE_MESH_FLAGS`` (the MoE-LM,
    int8 weights, the prefix cache: what ``--tp`` now composes with) on
    the (1, 1) mesh against the plain server, per request and with
    ``--slots 8``: requests carrying a 64-token ``prefix_ids`` with
    suffixes of ``FEATURE_MESH_ROWS`` tokens; identical greedy tokens,
    one prefix-cache miss and the rest hits on every server (the prefix
    is looked up inside the step, so requests that arrive together build
    it once), each request's latency and the batch's wall."""
    import numpy as np

    from container_engine_accelerators_tpu_torch.cmd import serve_lm
    from container_engine_accelerators_tpu_torch.parallel.mesh import (
        create_mesh,
    )

    rng = np.random.default_rng(FEATURE_SEED)
    vocab = serve_lm.parse_args([]).vocab_size
    prefix = rng.integers(0, vocab, FEATURE_MESH_PREFIX).tolist()
    bodies = _greedy_bodies([rng.integers(0, vocab, n).tolist()
                             for n in FEATURE_MESH_ROWS], prefix_ids=prefix)
    out = {}
    _reset(fd)
    for name, on_mesh in (("plain", False), ("mesh", True)):
        res = {}
        for slots in (0, SLOTS):
            argv = FEATURE_MESH_FLAGS + ["--port", "0"] + (
                ["--slots", str(SLOTS)] if slots else [])
            args = serve_lm.parse_args(argv)
            serve_lm.validate_args(args)
            run = serve_lm.build_generate(
                args, create_mesh(1, 1) if on_mesh else None)
            engine_loop = serve_lm.start_engine(run, args)
            srv = _http_server(serve_lm.make_handler(run, args, engine_loop))
            try:
                if slots:
                    rows, lat, wall = _ask_all(srv, bodies)
                    res["slots"] = {"rows": rows, "latency_ms": lat,
                                    "batch_wall_ms": wall}
                else:
                    rows, lat = _ask_each(srv, bodies)
                    res["per_request"] = {"rows": rows, "latency_ms": lat}
                res["per_request" if not slots else "slots"][
                    "prefix_cache"] = run.prefix_cache.stats()
            finally:
                _shutdown(*srv)
                serve_lm.stop_followers(run, engine_loop)
        out[name] = res
    for mode in ("per_request", "slots"):
        if out["mesh"][mode]["rows"] != out["plain"][mode]["rows"]:
            raise AssertionError(f"mesh_serve_features {mode}: the mesh "
                                 f"server's greedy tokens differ from the "
                                 f"plain server's")
        for name in out:
            stats = out[name][mode]["prefix_cache"]
            if (stats["misses"], stats["hits"]) != (
                    1, len(FEATURE_MESH_ROWS) - 1):
                raise AssertionError(f"mesh_serve_features {name} {mode}: "
                                     f"prefix cache {stats}")
    if any(fd.LAUNCHES.values()):
        raise AssertionError(f"mesh_serve_features launched flash decode "
                             f"without --flash-decode: {fd.LAUNCHES}")
    for res in out.values():
        for mode in res.values():
            mode.pop("rows")
    _phase("mesh_serve_features", card=card,
           entry="cmd/serve_lm.py build_generate(args, create_mesh(1, 1)) + "
                 "start_engine behind a real HTTP server, "
                 + " ".join(FEATURE_MESH_FLAGS),
           prefix_tokens=FEATURE_MESH_PREFIX, suffix_tokens=FEATURE_MESH_ROWS,
           plain=out["plain"], mesh=out["mesh"],
           greedy_rows_identical="per request and --slots 8",
           no_flash_decode="--flash-decode is refused with --tp > 1 (as in "
                           "JAX), so these servers run the einsum decode")


def dryrun_phase(fa, fd, card):
    """Phase 32e: ``entry.dryrun_multichip(1)`` on phase 25's one-rank NCCL
    group: all nine regimes of the JAX dry run, each held by its own
    check; their values, seconds and the flash launches.  -> those
    launches."""
    from container_engine_accelerators_tpu_torch import entry

    for name in fa.LAUNCHES:
        fa.LAUNCHES[name] = 0
    _reset(fd)
    t0 = time.perf_counter()
    out = entry.dryrun_multichip(1)
    seconds = time.perf_counter() - t0
    if list(out) != list(entry.REGIMES):
        raise AssertionError(f"dryrun ran {list(out)}")
    if any(fd.LAUNCHES.values()):
        raise AssertionError(f"dryrun launched flash decode: {fd.LAUNCHES}")
    launches = dict(fa.LAUNCHES)
    _phase("dryrun", card=card, entry="entry.dryrun_multichip(1)",
           regimes=out, seconds=seconds, launches=launches,
           note="at one rank each regime's sharded run is held to its "
                "unsharded one (tokens) or to finiteness (losses); the "
                "regimes' sequences (T = 8) take the ring's plain "
                "per-block version and Ulysses' dense attention")
    return launches


def _plain_server():
    """The per-request server at SERVE_FLAGS (bf16 compute on the seed-0
    weights): the feature phases' reference.  -> (run, server)."""
    from container_engine_accelerators_tpu_torch.cmd import serve_lm

    args = serve_lm.parse_args(SERVE_FLAGS + ["--port", "0"])
    run = serve_lm.build_generate(args)
    run.args = args
    return run, _http_server(serve_lm.make_handler(run, args))


def _timed(name, fn, *args):
    t0 = time.perf_counter()
    out = fn(*args)
    _phase("timing", of=name, seconds=round(time.perf_counter() - t0, 3))
    return out


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 2
    from container_engine_accelerators_tpu_torch.ops import build
    from container_engine_accelerators_tpu_torch.ops import flash_attention as fa
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
    build.load_ops()
    seconds = round(time.perf_counter() - t0, 3)
    _phase("build", seconds=seconds, sources=list(build.SOURCES),
           tensor_core_source=f"{FA_CSRC}/flash_attention_sm90.cu",
           routing="bf16 forward (D 64/128/256), bf16 dQ and dK/dV (D "
                   "64/128): flash_attention_sm90.cu (TMA + wgmma); f32, and "
                   "bf16 dQ and dK/dV at D 256: flash_attention.cu (CUDA "
                   "cores)",
           route="one torch.utils.cpp_extension.load: nvcc sm_90a for the "
                 "kernels, the host compiler for the TORCH_LIBRARY bindings")

    _timed("kernel_check", check_kernel, fd, dev)
    _timed("kernel_launch", check_kernel_launch, fd, dev)
    _timed("model", check_model, dev)
    fd_launches, run = _timed("serve", serve, fd)
    _timed("fa_kernel_check", check_fa_kernels, fa, dev)
    _timed("train_parity", check_train_parity, dev)
    fa_launches, losses, plain_train = _timed("train", train, fa, dev, smi)
    t0 = time.perf_counter()
    serving = time_kernel(fd, dev, cache_len=1056, lengths=[731])
    time_kernel(fd, dev, cache_len=4096, lengths=[4096])
    # One KV head at batch 1: 8-row CTAs would make one row block.
    time_kernel(fd, dev, cache_len=4096, lengths=[4096], kv_heads=1)
    # What the batched engine sends: ragged GQA, lengths from a seed.
    ragged = torch.randint(1, 4097, (8,), generator=torch.Generator()
                           .manual_seed(9)).tolist()
    time_kernel(fd, dev, cache_len=4096, lengths=ragged, kv_heads=2)
    # The --slots fleet's calls: eight lanes of the server's heads at a
    # 1056-slot lane, each at its own length (mid-request).
    time_kernel(fd, dev, cache_len=1056,
                lengths=[n + 16 for n in slot_prompt_lens()])
    launch_floor(dev)
    _phase("timing", of="kernel_time", seconds=round(time.perf_counter() - t0,
                                                     3))
    fa_rows = _timed("fa_kernel_time", time_fa_kernels, fa, dev)
    # After the kernel timings: once traced, the process timed its
    # kernels slower.
    _timed("profile", profile_request, run)
    del run
    step_device_ms = _timed("profile_train", profile_train_step, dev)
    fd_launches += _timed("serve_slots", serve_slots, fd, dev, smi)
    _timed("train_resume", train_resume, dev, losses, smi)
    _timed("profile_dir", profile_dir, step_device_ms, smi)
    plain = _plain_server()
    for name, phase in (("serve_int8", serve_int8),
                        ("serve_chunked", serve_chunked),
                        ("serve_prefix", serve_prefix),
                        ("serve_spec", serve_spec)):
        fd_launches += _timed(name, phase, fd, dev, smi, plain)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_moe_") as moe_ckpt:
        _timed("moe_parity", moe_parity, dev, smi)
        moe_launches, moe_losses, moe_dropped = _timed(
            "train_moe", train_moe, fa, dev, smi, moe_ckpt)
        fd_launches += _timed("serve_moe", serve_moe, fd, dev, smi, plain,
                              moe_ckpt)
    _shutdown(*plain[1])
    del plain
    torch.cuda.empty_cache()

    _timed("resnet_parity", resnet_parity, dev, smi)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_rmodel_") as model_dir:
        _timed("train_resnet", train_resnet, dev, smi, model_dir)
        _timed("train_resnet_resume", train_resnet_resume, smi)
        _timed("serve_resnet", serve_resnet, dev, smi, model_dir)

    from container_engine_accelerators_tpu_torch.parallel import dcn

    _timed("nccl", nccl_phase, smi)
    _timed("collectives", collectives_phase, smi)
    mesh_launches = _timed("mesh_train", mesh_train, fa, smi, losses,
                           plain_train)
    _timed("mesh_resume", mesh_resume, smi, losses)
    _timed("mesh_resnet", mesh_resnet, dev, smi)
    _timed("mesh_conv_shards", mesh_conv_shards, dev, smi)
    _timed("mesh_inception", mesh_inception, dev, smi)
    fd_launches += _timed("mesh_serve", mesh_serve, fd, dev, smi)
    _timed("seq_ring_blocks", seq_ring_blocks, fa, dev, smi)
    seq_launches, zigzag_losses = _timed("seq_train", seq_train, fa, smi,
                                         losses, plain_train)
    resume_launches = _timed("seq_resume", seq_resume, fa, smi,
                             zigzag_losses)
    pipe_launches = _timed("pipeline", pipeline_phase, fa, dev, smi)
    _timed("expert_parallel", expert_parallel_phase, dev, smi)
    moe_mesh_launches = _timed("mesh_train_moe", mesh_train_moe, fa, smi,
                               moe_losses, moe_dropped)
    _timed("mesh_serve_features", mesh_serve_features, fd, smi)
    dry_launches = _timed("dryrun", dryrun_phase, fa, fd, smi)
    dcn.shutdown()
    torch.cuda.empty_cache()

    before = _kernel_counts()
    _timed("nvml", node_nvml, smi)
    _timed("nvml_load", node_nvml_load, smi)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_node_") as tmp:
        rig = _NodeRig(tmp)
        try:
            client = _timed("device_plugin", node_device_plugin, rig, smi)
            _timed("xid", node_xid, rig, client, smi)
        finally:
            rig.close()
    _timed("node_faults", node_faults, smi, rig.register_s)
    _timed("mig", node_mig, smi)
    _timed("maintenance", node_maintenance, smi)
    # Last of the phases that start the device plugin daemon: none after
    # it may run under an MPS daemon.
    _timed("mps", node_mps, smi)
    _timed("node_nri", node_nri, smi)
    _timed("node_scheduler", node_scheduler, smi)
    _timed("node_obs", node_obs, smi)
    _timed("dcn_xfer", dcn_xfer_phase, smi)
    _launches_none("the node and DCN phases", before)

    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    kernels = [{"name": "flash_decode", "route": "cuda", "source": KERNEL_SRC,
                "replaces": TPU_KERNEL, "launches": fd_launches,
                **{k: serving[k] for k in keys}}]
    kernels += [{"name": name, "route": "cuda", "source": src,
                 "replaces": line,
                 "launches": (fa_launches[name] + moe_launches[name]
                              + mesh_launches[name] + seq_launches[name]
                              + resume_launches[name] + pipe_launches[name]
                              + moe_mesh_launches[name]
                              + dry_launches[name]),
                 **{k: fa_rows[name][k] for k in keys}}
                for name, (line, _, src) in FA_KERNELS.items()]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
