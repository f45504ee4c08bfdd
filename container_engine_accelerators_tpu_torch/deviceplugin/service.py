"""DevicePlugin v1beta1 gRPC service (ref: pkg/gpu/nvidia/beta_plugin.go:
35-103; the JAX package's ``deviceplugin/service.py``): ListAndWatch
streams the device list and sends it again on every health transition;
Allocate checks that the MPS daemon still answers (under ``mps``),
validates sharing, maps device IDs to device nodes and adds the default
device nodes, the mounts and the MPS envs.  PreStartContainer is a logged
no-op; GetPreferredAllocation returns the natural-order pick
(``preferred.py``).
"""

import logging
import queue

import grpc

from container_engine_accelerators_tpu_torch.deviceplugin import (
    deviceplugin_v1beta1_pb2 as pb,
)
from container_engine_accelerators_tpu_torch.deviceplugin import preferred
from container_engine_accelerators_tpu_torch.obs import trace
from container_engine_accelerators_tpu_torch.sharing import validate_request

log = logging.getLogger(__name__)

_HEALTH_POLL_S = 0.5


class DevicePluginService:
    def __init__(self, manager):
        self.manager = manager

    # -- small RPCs ----------------------------------------------------------

    def GetDevicePluginOptions(self, request, context):
        return pb.DevicePluginOptions(get_preferred_allocation_available=True)

    def PreStartContainer(self, request, context):
        log.error("device-plugin: PreStart should NOT be called for the GKE "
                  "GPU device plugin")
        return pb.PreStartContainerResponse()

    def GetPreferredAllocation(self, request, context):
        resp = pb.PreferredAllocationResponse()
        for creq in request.container_requests:
            ids = preferred.choose_preferred(
                list(creq.available_deviceIDs),
                list(creq.must_include_deviceIDs),
                creq.allocation_size,
            )
            resp.container_responses.add().deviceIDs.extend(ids)
        return resp

    # -- ListAndWatch --------------------------------------------------------

    def _device_list_response(self) -> pb.ListAndWatchResponse:
        resp = pb.ListAndWatchResponse()
        for dev in self.manager.list_devices().values():
            resp.devices.append(pb.Device(ID=dev.id, health=dev.health))
        return resp

    def ListAndWatch(self, request, context):
        log.info("device-plugin: ListAndWatch start")
        yield self._device_list_response()
        while context.is_active():
            try:
                d = self.manager.health_events.get(timeout=_HEALTH_POLL_S)
            except queue.Empty:
                continue
            log.info("device-plugin: %s device marked as %s", d.id, d.health)
            # The re-announce latency the kubelet sees: applying the
            # transition and rebuilding the device list.
            with trace.span("plugin.health_announce",
                            histogram="plugin.health_announce",
                            device=d.id, health=d.health):
                self.manager.set_device_health(d.id, d.health)
                resp = self._device_list_response()
            yield resp

    # -- Allocate ------------------------------------------------------------

    def Allocate(self, request, context):
        resps = pb.AllocateResponse()
        for rqt in request.container_requests:
            with trace.span("plugin.allocate", histogram="plugin.allocate",
                            devices=len(rqt.devicesIDs)):
                resps.container_responses.append(
                    self._allocate_one(rqt, context))
        return resps

    def _allocate_one(self, rqt, context):
        resp = pb.ContainerAllocateResponse()
        try:
            self.manager.verify_allocatable()
            validate_request(
                list(rqt.devicesIDs),
                len(self.manager.list_physical_devices()),
                self.manager.config.sharing.strategy,
            )
            seen_nodes = set()
            for device_id in rqt.devicesIDs:
                for spec in self.manager.device_spec(device_id):
                    # Several vGPUs map to one node; inject it once.
                    if spec.host_path in seen_nodes:
                        continue
                    seen_nodes.add(spec.host_path)
                    resp.devices.append(pb.DeviceSpec(
                        host_path=spec.host_path,
                        container_path=spec.container_path,
                        permissions=spec.permissions))
        except ValueError as e:
            context.abort(grpc.StatusCode.INVALID_ARGUMENT, str(e))
        for d in self.manager.default_devices:
            resp.devices.append(pb.DeviceSpec(host_path=d, container_path=d,
                                              permissions="mrw"))
        for m in self.manager.mount_paths:
            resp.mounts.append(pb.Mount(host_path=m.host_path,
                                        container_path=m.container_path,
                                        read_only=m.read_only))
        for k, v in self.manager.envs(list(rqt.devicesIDs)).items():
            resp.envs[k] = v
        return resp
