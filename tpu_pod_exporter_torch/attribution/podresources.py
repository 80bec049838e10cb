"""Kubelet podresources gRPC client — the real attribution source.

One local RPC per poll over the kubelet's unix socket replaces the
reference's O(pods × containers) ``kubectl exec`` fan-out plus cluster-wide
pod list (``main.go:77,101-109``): no apiserver traffic, no subprocesses,
and the device IDs it returns are the authoritative allocation record —
there is no PID heuristic to get wrong (``main.go:141-154``, SURVEY.md
§2.6).

The channel is created lazily and kept open across polls (HTTP/2 stream
reuse); any RPC failure surfaces as AttributionError so the collector's
bounded-staleness logic takes over.
"""

from __future__ import annotations

import logging
import threading

from tpu_pod_exporter_torch.attribution import (
    TPU_RESOURCE_NAME,
    AttributionError,
    AttributionProvider,
    AttributionSnapshot,
    DeviceAllocation,
)
from tpu_pod_exporter_torch.attribution.proto import podresources_pb2 as pb

log = logging.getLogger("tpu_pod_exporter_torch.attribution.podresources")

LIST_METHOD = "/v1.PodResourcesLister/List"
GET_ALLOCATABLE_METHOD = "/v1.PodResourcesLister/GetAllocatableResources"
DEFAULT_SOCKET = "/var/lib/kubelet/pod-resources/kubelet.sock"


def allocatable_from_response(
    resp: "pb.AllocatableResourcesResponse", resource_name: str
) -> tuple[str, ...]:
    """GetAllocatableResources → device IDs for one resource."""
    ids: list[str] = []
    for dev in resp.devices:
        if dev.resource_name == resource_name:
            ids.extend(dev.device_ids)
    return tuple(sorted(set(ids)))


def snapshot_from_response(
    resp: "pb.ListPodResourcesResponse",
    resource_prefixes: tuple[str, ...] = (),
    allocatable: tuple[str, ...] | None = None,
) -> AttributionSnapshot:
    """Pure conversion: protobuf → AttributionSnapshot (unit-testable with
    no socket). When ``resource_prefixes`` is non-empty, only matching
    resources are kept; otherwise all device allocations pass through and
    filtering happens at join time."""
    allocations: list[DeviceAllocation] = []
    for pod in resp.pod_resources:
        for container in pod.containers:
            for dev in container.devices:
                if resource_prefixes and not any(
                    dev.resource_name.startswith(p) for p in resource_prefixes
                ):
                    continue
                if not dev.device_ids:
                    continue
                allocations.append(
                    DeviceAllocation(
                        pod=pod.name,
                        namespace=pod.namespace,
                        container=container.name,
                        device_ids=tuple(dev.device_ids),
                        resource_name=dev.resource_name,
                    )
                )
    return AttributionSnapshot(tuple(allocations), allocatable_device_ids=allocatable)


class PodResourcesAttribution(AttributionProvider):
    name = "podresources"

    def __init__(
        self,
        socket_path: str = DEFAULT_SOCKET,
        timeout_s: float = 2.0,
        target: str | None = None,
        resource_name: str = TPU_RESOURCE_NAME,
    ) -> None:
        """``target`` overrides the unix-socket URI (tests use tmpdir sockets)."""
        import grpc  # deferred: keep import cost off the fake-only path

        self._grpc = grpc
        self._target = target if target is not None else f"unix://{socket_path}"
        self._timeout_s = timeout_s
        self._resource_name = resource_name
        self._lock = threading.Lock()
        self._channel = None
        self._list = None
        self._get_allocatable = None
        # GetAllocatableResources needs kubelet >=1.23 (and a feature gate on
        # older ones); probed once, degraded to None thereafter.
        self._allocatable_supported: bool | None = None

    def _ensure_channel(self) -> None:
        with self._lock:
            if self._channel is not None:
                return
            self._channel = self._grpc.insecure_channel(
                self._target,
                options=[
                    # podresources List responses are tiny, but never truncate
                    ("grpc.max_receive_message_length", 16 * 1024 * 1024),
                    ("grpc.enable_http_proxy", 0),
                ],
            )
            self._list = self._channel.unary_unary(
                LIST_METHOD,
                request_serializer=pb.ListPodResourcesRequest.SerializeToString,
                response_deserializer=pb.ListPodResourcesResponse.FromString,
            )
            self._get_allocatable = self._channel.unary_unary(
                GET_ALLOCATABLE_METHOD,
                request_serializer=pb.AllocatableResourcesRequest.SerializeToString,
                response_deserializer=pb.AllocatableResourcesResponse.FromString,
            )

    def snapshot(self) -> AttributionSnapshot:
        try:
            self._ensure_channel()
            resp = self._list(pb.ListPodResourcesRequest(), timeout=self._timeout_s)
        except self._grpc.RpcError as e:
            # Drop the channel so the next poll reconnects (kubelet restarts).
            self._reset_channel()
            raise AttributionError(f"podresources List failed: {e.code()}") from e
        except Exception as e:  # noqa: BLE001
            self._reset_channel()
            raise AttributionError(f"podresources List failed: {e}") from e
        return snapshot_from_response(resp, allocatable=self._read_allocatable())

    def _read_allocatable(self) -> tuple[str, ...] | None:
        """Best-effort inventory read; never fails the attribution poll."""
        if self._allocatable_supported is False:
            return None
        try:
            resp = self._get_allocatable(
                pb.AllocatableResourcesRequest(), timeout=self._timeout_s
            )
        except self._grpc.RpcError as e:
            if self._allocatable_supported is None and e.code() in (
                self._grpc.StatusCode.UNIMPLEMENTED,
                self._grpc.StatusCode.NOT_FOUND,
            ):
                log.info("GetAllocatableResources unsupported by this kubelet")
                self._allocatable_supported = False
            return None
        except Exception:  # noqa: BLE001
            return None
        self._allocatable_supported = True
        return allocatable_from_response(resp, self._resource_name)

    def _reset_channel(self) -> None:
        with self._lock:
            if self._channel is not None:
                try:
                    self._channel.close()
                except Exception:  # noqa: BLE001
                    pass
            self._channel = None
            self._list = None
            self._get_allocatable = None

    def close(self) -> None:
        self._reset_channel()
