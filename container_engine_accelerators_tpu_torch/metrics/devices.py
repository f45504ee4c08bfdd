"""Container -> GPU assignment through the kubelet PodResources API
(ref: pkg/gpu/nvidia/metrics/devices.go:33-100; the JAX package's
``metrics/devices.py``): List every pod and collect the ``nvidia.com/gpu``
device IDs of each container.  Virtual (time-shared) IDs are skipped, as
the reference skips them (devices.go:86-92): per-container numbers mean
nothing on a shared GPU.
"""

import dataclasses
import logging
from typing import Dict, List

import grpc

from container_engine_accelerators_tpu_torch.deviceplugin.api import RESOURCE_NAME
from container_engine_accelerators_tpu_torch.metrics import (
    podresources_v1_pb2 as pb,
)
from container_engine_accelerators_tpu_torch.sharing import is_virtual_device_id

log = logging.getLogger(__name__)

POD_RESOURCES_SOCKET = "/var/lib/kubelet/pod-resources/kubelet.sock"


@dataclasses.dataclass(frozen=True)
class ContainerID:
    namespace: str
    pod: str
    container: str


class PodResourcesClient:
    """Thin client over the PodResourcesLister service."""

    def __init__(self, socket_path: str = POD_RESOURCES_SOCKET):
        self.socket_path = socket_path

    def list_pods(self) -> pb.ListPodResourcesResponse:
        with grpc.insecure_channel(f"unix:{self.socket_path}") as channel:
            lister = channel.unary_unary(
                "/v1.PodResourcesLister/List",
                request_serializer=pb.ListPodResourcesRequest.SerializeToString,
                response_deserializer=pb.ListPodResourcesResponse.FromString,
            )
            return lister(pb.ListPodResourcesRequest(), timeout=10)

    def get_devices_for_all_containers(self) -> Dict[ContainerID, List[str]]:
        """Each container's physical GPU IDs (ref: devices.go:51-100)."""
        out: Dict[ContainerID, List[str]] = {}
        for pod in self.list_pods().pod_resources:
            for container in pod.containers:
                device_ids = [
                    device_id
                    for dev in container.devices
                    if dev.resource_name == RESOURCE_NAME
                    for device_id in dev.device_ids
                    if not is_virtual_device_id(device_id)
                ]
                if device_ids:
                    out[ContainerID(namespace=pod.namespace, pod=pod.name,
                                    container=container.name)] = device_ids
        return out
