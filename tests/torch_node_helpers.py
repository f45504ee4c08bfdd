"""Test doubles of the kubelet for the PyTorch port's node layer: a
Registration server and a PodResourcesLister server, each real gRPC on a
temp unix socket, built on the port's own protobuf modules (the JAX
package's ``tests/kubelet_stub.py`` and ``tests/test_metrics.py`` stubs,
with GPU names)."""

import concurrent.futures
import os
import queue

import grpc

from container_engine_accelerators_tpu_torch.deviceplugin import api
from container_engine_accelerators_tpu_torch.deviceplugin import (
    deviceplugin_v1beta1_pb2 as pb,
)
from container_engine_accelerators_tpu_torch.metrics import (
    podresources_v1_pb2 as prpb,
)


class KubeletStub:
    def __init__(self, socket_path: str):
        self.socket_path = socket_path
        self.requests: "queue.Queue[pb.RegisterRequest]" = queue.Queue()
        self.server = grpc.server(
            concurrent.futures.ThreadPoolExecutor(max_workers=2))
        api.add_registration_servicer(self.server, self)
        self.server.add_insecure_port(f"unix:{socket_path}")

    def Register(self, request, context):
        self.requests.put(request)
        return pb.Empty()

    def start(self):
        self.server.start()

    def stop(self):
        self.server.stop(grace=0).wait()


class PodResourcesStub:
    def __init__(self, socket_path: str, response):
        self.response = response
        self.server = grpc.server(
            concurrent.futures.ThreadPoolExecutor(max_workers=2))
        handler = grpc.method_handlers_generic_handler(
            "v1.PodResourcesLister",
            {"List": grpc.unary_unary_rpc_method_handler(
                lambda req, ctx: self.response,
                request_deserializer=prpb.ListPodResourcesRequest.FromString,
                response_serializer=prpb.ListPodResourcesResponse.SerializeToString,
            )})
        self.server.add_generic_rpc_handlers((handler,))
        self.server.add_insecure_port(f"unix:{socket_path}")
        self.server.start()

    def stop(self):
        self.server.stop(grace=0).wait()


def make_pod_resources():
    """GPUs nvidia0+nvidia1 for default/train-job-0/worker, a time-shared
    vGPU (skipped) and a TPU container (another resource, ignored): the JAX
    package's fixture with GPU names."""
    resp = prpb.ListPodResourcesResponse()
    pod = resp.pod_resources.add(name="train-job-0", namespace="default")
    d = pod.containers.add(name="worker").devices.add(
        resource_name="nvidia.com/gpu")
    d.device_ids.extend(["nvidia0", "nvidia1"])
    pod2 = resp.pod_resources.add(name="shared-pod", namespace="default")
    d2 = pod2.containers.add(name="shared").devices.add(
        resource_name="nvidia.com/gpu")
    d2.device_ids.extend(["nvidia2/vgpu0"])
    pod3 = resp.pod_resources.add(name="tpu-pod", namespace="default")
    d3 = pod3.containers.add(name="jax").devices.add(
        resource_name="google.com/tpu")
    d3.device_ids.extend(["accel0"])
    return resp


# A stand-in for NVIDIA's nvidia-cuda-mps-control in its client role: it
# reads one command on stdin and answers as the real one does on the card
# ("Cannot find MPS control daemon process" and exit 1 without a daemon).
# The daemon is "up" while <pipe>/control exists; <pipe>/hang makes it
# hang, <pipe>/answer replaces the answer; every command is logged to
# <pipe>/queries.
FAKE_MPS_CONTROL = """#!/bin/sh
d="${CUDA_MPS_PIPE_DIRECTORY:-/tmp/nvidia-mps}"
read cmd
echo "$cmd" >> "$d/queries"
[ -e "$d/control" ] || { echo "Cannot find MPS control daemon process" >&2; exit 1; }
[ -e "$d/hang" ] && exec sleep 60
if [ -e "$d/answer" ]; then cat "$d/answer"; else echo 100.0; fi
"""


def write_fake_mps_control(driver_root):
    """``<driver_root>/bin/nvidia-cuda-mps-control``; returns its path."""
    bin_dir = os.path.join(str(driver_root), "bin")
    os.makedirs(bin_dir, exist_ok=True)
    path = os.path.join(bin_dir, "nvidia-cuda-mps-control")
    with open(path, "w") as f:
        f.write(FAKE_MPS_CONTROL)
    os.chmod(path, 0o755)
    return path


def set_mps_daemon(pipe_dir, up=True):
    """Start (``up``) or stop the fake MPS daemon of ``pipe_dir``."""
    os.makedirs(str(pipe_dir), exist_ok=True)
    control = os.path.join(str(pipe_dir), "control")
    if up:
        open(control, "w").close()
    elif os.path.exists(control):
        os.unlink(control)
