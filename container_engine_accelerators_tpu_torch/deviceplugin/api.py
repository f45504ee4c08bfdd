"""kubelet DevicePlugin v1beta1 gRPC wiring (a copy of the JAX package's
``deviceplugin/api.py``).

grpc_tools is not a dependency, so the service layer is wired by hand with
grpcio generic handlers around the protoc-generated message classes
(``deviceplugin_v1beta1_pb2``, a copy of the JAX package's).  Method paths
and wire format match the kubelet exactly; the reference gets the same
surface from Go codegen (ref: pkg/gpu/nvidia/beta_plugin.go:35-131).
"""

import grpc

from container_engine_accelerators_tpu_torch.deviceplugin import (
    deviceplugin_v1beta1_pb2 as pb,
)

# kubelet constants (k8s.io/kubelet/pkg/apis/deviceplugin/v1beta1/constants.go)
DEVICE_PLUGIN_PATH = "/var/lib/kubelet/device-plugins/"
KUBELET_SOCKET = "kubelet.sock"
API_VERSION = "v1beta1"
RESOURCE_NAME = "nvidia.com/gpu"

_DEVICE_PLUGIN_SERVICE = "v1beta1.DevicePlugin"
_REGISTRATION_SERVICE = "v1beta1.Registration"


# ---- server-side wiring ----------------------------------------------------


def add_device_plugin_servicer(server: grpc.Server, servicer) -> None:
    """Register a DevicePlugin servicer (methods: GetDevicePluginOptions,
    ListAndWatch, GetPreferredAllocation, Allocate, PreStartContainer)."""
    handlers = {
        "GetDevicePluginOptions": grpc.unary_unary_rpc_method_handler(
            servicer.GetDevicePluginOptions,
            request_deserializer=pb.Empty.FromString,
            response_serializer=pb.DevicePluginOptions.SerializeToString,
        ),
        "ListAndWatch": grpc.unary_stream_rpc_method_handler(
            servicer.ListAndWatch,
            request_deserializer=pb.Empty.FromString,
            response_serializer=pb.ListAndWatchResponse.SerializeToString,
        ),
        "GetPreferredAllocation": grpc.unary_unary_rpc_method_handler(
            servicer.GetPreferredAllocation,
            request_deserializer=pb.PreferredAllocationRequest.FromString,
            response_serializer=pb.PreferredAllocationResponse.SerializeToString,
        ),
        "Allocate": grpc.unary_unary_rpc_method_handler(
            servicer.Allocate,
            request_deserializer=pb.AllocateRequest.FromString,
            response_serializer=pb.AllocateResponse.SerializeToString,
        ),
        "PreStartContainer": grpc.unary_unary_rpc_method_handler(
            servicer.PreStartContainer,
            request_deserializer=pb.PreStartContainerRequest.FromString,
            response_serializer=pb.PreStartContainerResponse.SerializeToString,
        ),
    }
    server.add_generic_rpc_handlers(
        (grpc.method_handlers_generic_handler(_DEVICE_PLUGIN_SERVICE, handlers),)
    )


def add_registration_servicer(server: grpc.Server, servicer) -> None:
    """Register a kubelet Registration servicer (used by the KubeletStub in
    tests, mirroring beta_plugin_test.go:35-69)."""
    handlers = {
        "Register": grpc.unary_unary_rpc_method_handler(
            servicer.Register,
            request_deserializer=pb.RegisterRequest.FromString,
            response_serializer=pb.Empty.SerializeToString,
        ),
    }
    server.add_generic_rpc_handlers(
        (grpc.method_handlers_generic_handler(_REGISTRATION_SERVICE, handlers),)
    )


# ---- client-side wiring ----------------------------------------------------


class DevicePluginClient:
    """Client stub for the DevicePlugin service (kubelet's role)."""

    def __init__(self, channel: grpc.Channel):
        p = f"/{_DEVICE_PLUGIN_SERVICE}/"
        self.get_device_plugin_options = channel.unary_unary(
            p + "GetDevicePluginOptions",
            request_serializer=pb.Empty.SerializeToString,
            response_deserializer=pb.DevicePluginOptions.FromString,
        )
        self.list_and_watch = channel.unary_stream(
            p + "ListAndWatch",
            request_serializer=pb.Empty.SerializeToString,
            response_deserializer=pb.ListAndWatchResponse.FromString,
        )
        self.allocate = channel.unary_unary(
            p + "Allocate",
            request_serializer=pb.AllocateRequest.SerializeToString,
            response_deserializer=pb.AllocateResponse.FromString,
        )
        self.get_preferred_allocation = channel.unary_unary(
            p + "GetPreferredAllocation",
            request_serializer=pb.PreferredAllocationRequest.SerializeToString,
            response_deserializer=pb.PreferredAllocationResponse.FromString,
        )
        self.pre_start_container = channel.unary_unary(
            p + "PreStartContainer",
            request_serializer=pb.PreStartContainerRequest.SerializeToString,
            response_deserializer=pb.PreStartContainerResponse.FromString,
        )


class RegistrationClient:
    """Client stub for the kubelet Registration service (plugin's role)."""

    def __init__(self, channel: grpc.Channel):
        self.register = channel.unary_unary(
            f"/{_REGISTRATION_SERVICE}/Register",
            request_serializer=pb.RegisterRequest.SerializeToString,
            response_deserializer=pb.Empty.FromString,
        )


def register_with_v1beta1_kubelet(kubelet_endpoint: str,
                                  plugin_endpoint: str) -> None:
    """Dial kubelet.sock and Register (ref: beta_plugin.go:110-131)."""
    with grpc.insecure_channel(f"unix:{kubelet_endpoint}") as channel:
        grpc.channel_ready_future(channel).result(timeout=10)
        client = RegistrationClient(channel)
        client.register(
            pb.RegisterRequest(
                version=API_VERSION,
                endpoint=plugin_endpoint,
                resource_name=RESOURCE_NAME,
                # The kubelet only calls GetPreferredAllocation when the
                # registration advertises it.
                options=pb.DevicePluginOptions(
                    get_preferred_allocation_available=True
                ),
            ),
            timeout=10,
        )
