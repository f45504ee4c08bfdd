"""GKE GPU device plugin for ``nvidia.com/gpu``: the node daemon.

The reference's main (ref: cmd/nvidia_gpu/nvidia_gpu.go:42-147; the JAX
package's ``cmd/tpu_device_plugin.py``): parse flags and the node config,
open NVML, wait for the installer's device nodes, start the manager,
optionally the metrics server and the Xid health checker, then run the
serve loop.  If NVML cannot load or initialise, the daemon exits non-zero:
it never carries on without it.

    python -m container_engine_accelerators_tpu_torch.cmd.gpu_device_plugin \\
        --enable-health-monitoring --enable-container-gpu-metrics

``--fake-gpu-fixture DIR`` reads a fake node written by
``gpulib/fake.py::write_fixture`` instead of NVML, and its MIG tree under
``DIR/proc`` instead of ``/proc`` (tests only).  Under the ``mps``
strategy the MPS daemon's pipe directory is ``CUDA_MPS_PIPE_DIRECTORY``
(default ``/tmp/nvidia-mps``), as for every MPS client.  A start that
fails (MIG partitions not found, an MPS daemon that does not answer) is
logged and retried every 5 s, as the reference's start loop does.

Observability (``obs/``): ``kill -USR1 <pid>`` dumps the flight recorder
(the last spans, counters, histograms, rates and the sampler's top
stacks) to stderr and to ``TPU_FLIGHT_FILE``; ``TPU_TRACE_FILE`` writes
every span as a JSONL line; the stack sampler runs unless ``TPU_PROF=0``.
With metrics enabled, the metrics port also serves ``/spans`` and
``/profile``.
"""

import argparse
import logging
import os
import signal
import sys
import threading

from container_engine_accelerators_tpu_torch.deviceplugin.api import (
    DEVICE_PLUGIN_PATH,
)
from container_engine_accelerators_tpu_torch.deviceplugin.manager import (
    DRIVER_CONTAINER_PATH,
    DRIVER_HOST_PATH,
    GpuManager,
)
from container_engine_accelerators_tpu_torch.gpulib import open_lib
from container_engine_accelerators_tpu_torch.obs import flight, profiler
from container_engine_accelerators_tpu_torch.sharing.gate import (
    DEFAULT_PIPE_DIRECTORY,
    PIPE_DIRECTORY_ENV,
)
from container_engine_accelerators_tpu_torch.utils.config import (
    CONFIG_PATH,
    GPUConfig,
)
from container_engine_accelerators_tpu_torch.utils.device import Mount

log = logging.getLogger("gpu-device-plugin")

START_RETRY_S = 5.0


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="GKE GPU device plugin")
    p.add_argument("--host-path", default=DRIVER_HOST_PATH,
                   help="Path on the host where the NVIDIA driver's "
                        "libraries and binaries are installed")
    p.add_argument("--container-path", default=DRIVER_CONTAINER_PATH,
                   help="Path where they are mounted into containers")
    p.add_argument("--plugin-directory", default=DEVICE_PLUGIN_PATH,
                   help="Directory holding the kubelet and plugin sockets")
    p.add_argument("--dev-directory", default="/dev")
    p.add_argument("--gpu-config", default=CONFIG_PATH,
                   help="Node GPU config JSON (sharing, partitions, Xids)")
    p.add_argument("--enable-container-gpu-metrics", action="store_true")
    p.add_argument("--enable-health-monitoring", action="store_true")
    p.add_argument("--health-recovery-window", type=float, default=None,
                   help="Seconds of quiet after which an Unhealthy GPU is "
                        "announced Healthy again (default: the checker's "
                        "window; 0 disables recovery)")
    p.add_argument("--gpu-metrics-port", type=int, default=2112)
    p.add_argument("--gpu-metrics-collection-interval", type=float,
                   default=30.0, help="Seconds between metric samples")
    p.add_argument("--pod-resources-socket", default=None,
                   help="kubelet PodResources API socket (default: the "
                        "in-cluster path)")
    p.add_argument("--fake-gpu-fixture", default=None,
                   help="Read a fake node under this directory instead of "
                        "NVML (tests only)")
    return p.parse_args(argv)


def main(argv=None):
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    args = parse_args(argv)

    # Before any thread starts: `kill -USR1 <pid>` dumps the flight
    # recorder without disturbing the agent, and the stack sampler feeds
    # the dumps and /profile (TPU_PROF=0 disables it).
    flight.install()
    profiler.start()

    config = GPUConfig.from_file(args.gpu_config)
    config.add_defaults_and_validate()
    config.add_health_critical_xid()
    log.info("GPU config: %s", config)

    try:
        lib = open_lib(args.fake_gpu_fixture)
    except OSError as e:
        log.error("cannot open NVML: %s", e)
        return 1
    log.info("GPUs: %s", [(d.name, d.model) for d in lib.devices()])
    try:
        return _run(args, config, lib)
    finally:
        lib.close()


def _run(args, config, lib) -> int:
    mounts = [Mount(host_path=args.host_path,
                    container_path=args.container_path, read_only=True)]
    # A fake node's MIG tree is under the fixture, as its /dev and NVML.
    proc_root = (os.path.join(args.fake_gpu_fixture, "proc")
                 if args.fake_gpu_fixture else "/proc")
    manager = GpuManager(
        args.dev_directory, mounts, config, lib=lib, proc_root=proc_root,
        mps_pipe_directory=os.environ.get(PIPE_DIRECTORY_ENV)
        or DEFAULT_PIPE_DIRECTORY)
    stopping = threading.Event()

    def on_term(signum, frame):
        log.info("signal %d: stopping", signum)
        stopping.set()
        manager.stop()

    signal.signal(signal.SIGTERM, on_term)
    signal.signal(signal.SIGINT, on_term)

    # Installer handshake: wait for the driver's control nodes
    # (nvidia_gpu.go:99-109).
    while not manager.check_device_paths():
        log.info("nvidiactl / nvidia-uvm not yet present in %s; waiting",
                 args.dev_directory)
        if stopping.wait(START_RETRY_S):
            return 0
    while True:
        try:
            manager.start()
            break
        except Exception as e:  # retry as the reference's Start loop does
            log.error("failed to start the GPU manager: %s; retrying", e)
            if stopping.wait(START_RETRY_S):
                return 0

    metrics = checker = None
    try:
        if args.enable_container_gpu_metrics:
            from container_engine_accelerators_tpu_torch.metrics.metrics import (
                MetricServer,
            )

            extra = ({"pod_resources_socket": args.pod_resources_socket}
                     if args.pod_resources_socket else {})
            metrics = MetricServer(
                lib=lib, port=args.gpu_metrics_port,
                collection_interval_s=args.gpu_metrics_collection_interval,
                **extra)
            metrics.start()
            log.info("metrics server on port %d", metrics.port)

        if args.enable_health_monitoring:
            from container_engine_accelerators_tpu_torch.health import (
                GpuHealthChecker,
            )

            kwargs = {}
            if args.health_recovery_window is not None:
                kwargs["recovery_window_s"] = (
                    args.health_recovery_window
                    if args.health_recovery_window > 0 else None)
            checker = GpuHealthChecker(
                manager, lib, critical_xid=config.health_critical_xid,
                **kwargs)
            checker.start()

        manager.serve(args.plugin_directory)
    finally:
        if checker is not None:
            checker.stop()
        if metrics is not None:
            metrics.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
