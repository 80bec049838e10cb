"""The cases of tests/test_attribution.py against ``tpu_pod_exporter_torch``, with the
imports renamed.

Attribution tests: pure conversion, real gRPC over unix sockets, checkpoint
fallback, fault paths (SURVEY.md §4.2, §4.5)."""

import json
import os
import threading
from concurrent import futures

import grpc
import pytest

from tpu_pod_exporter_torch.attribution import (
    AttributionError,
    AttributionSnapshot,
    DeviceAllocation,
    TPU_RESOURCE_NAME,
)
from tpu_pod_exporter_torch.attribution.checkpoint import (
    CheckpointAttribution,
    parse_checkpoint,
)
from tpu_pod_exporter_torch.attribution.podresources import (
    LIST_METHOD,
    PodResourcesAttribution,
    snapshot_from_response,
)
from tpu_pod_exporter_torch.attribution.proto import podresources_pb2 as pb


def make_response(pods):
    """pods: [(name, ns, [(container, resource, [ids])])]"""
    resp = pb.ListPodResourcesResponse()
    for name, ns, containers in pods:
        p = resp.pod_resources.add()
        p.name, p.namespace = name, ns
        for cname, resource, ids in containers:
            c = p.containers.add()
            c.name = cname
            if ids is not None:
                d = c.devices.add()
                d.resource_name = resource
                d.device_ids.extend(ids)
    return resp


class TestSnapshotFromResponse:
    def test_basic(self):
        resp = make_response(
            [("train-0", "ml", [("main", TPU_RESOURCE_NAME, ["0", "1"])])]
        )
        snap = snapshot_from_response(resp)
        assert snap.allocations == (
            DeviceAllocation("train-0", "ml", "main", ("0", "1"), TPU_RESOURCE_NAME),
        )
        assert snap.by_device_id() == {
            "0": snap.allocations[0],
            "1": snap.allocations[0],
        }

    def test_non_tpu_resources_pass_through_but_join_filters(self):
        resp = make_response(
            [("pod", "ns", [("c", "nvidia.com/gpu", ["GPU-abc"])])]
        )
        snap = snapshot_from_response(resp)
        assert len(snap.allocations) == 1
        assert snap.by_device_id(TPU_RESOURCE_NAME) == {}

    def test_resource_prefix_filter(self):
        resp = make_response(
            [
                ("pod", "ns", [("c", "nvidia.com/gpu", ["x"])]),
                ("pod2", "ns", [("c", TPU_RESOURCE_NAME, ["0"])]),
            ]
        )
        snap = snapshot_from_response(resp, resource_prefixes=("google.com/",))
        assert len(snap.allocations) == 1
        assert snap.allocations[0].pod == "pod2"

    def test_deviceless_containers_skipped(self):
        resp = make_response([("pod", "ns", [("c", TPU_RESOURCE_NAME, None)])])
        assert snapshot_from_response(resp).allocations == ()

    def test_duplicate_device_id_first_claim_wins(self):
        snap = AttributionSnapshot(
            (
                DeviceAllocation("a", "ns", "c", ("0",)),
                DeviceAllocation("b", "ns", "c", ("0",)),
            )
        )
        assert snap.by_device_id()["0"].pod == "a"


class _FakeLister:
    """Scripted PodResourcesLister served over a real unix socket."""

    def __init__(self, response, allocatable_ids=None, allocatable_unimplemented=False):
        self.response = response
        self.allocatable_ids = allocatable_ids
        self.allocatable_unimplemented = allocatable_unimplemented
        self.calls = 0
        self.allocatable_calls = 0

    def __call__(self, request, context):
        self.calls += 1
        return self.response

    def get_allocatable(self, request, context):
        self.allocatable_calls += 1
        if self.allocatable_unimplemented:
            context.abort(grpc.StatusCode.UNIMPLEMENTED, "old kubelet")
        resp = pb.AllocatableResourcesResponse()
        if self.allocatable_ids is not None:
            d = resp.devices.add()
            d.resource_name = TPU_RESOURCE_NAME
            d.device_ids.extend(self.allocatable_ids)
        return resp


def serve_lister(socket_path, lister):
    server = grpc.server(futures.ThreadPoolExecutor(max_workers=2))
    handler = grpc.method_handlers_generic_handler(
        "v1.PodResourcesLister",
        {
            "List": grpc.unary_unary_rpc_method_handler(
                lister,
                request_deserializer=pb.ListPodResourcesRequest.FromString,
                response_serializer=pb.ListPodResourcesResponse.SerializeToString,
            ),
            "GetAllocatableResources": grpc.unary_unary_rpc_method_handler(
                lister.get_allocatable,
                request_deserializer=pb.AllocatableResourcesRequest.FromString,
                response_serializer=pb.AllocatableResourcesResponse.SerializeToString,
            ),
        },
    )
    server.add_generic_rpc_handlers((handler,))
    server.add_insecure_port(f"unix://{socket_path}")
    server.start()
    return server


class TestPodResourcesGrpc:
    def test_end_to_end_over_unix_socket(self, tmp_path):
        sock = str(tmp_path / "kubelet.sock")
        lister = _FakeLister(
            make_response(
                [("train-0", "ml", [("main", TPU_RESOURCE_NAME, ["0", "1", "2", "3"])])]
            )
        )
        server = serve_lister(sock, lister)
        try:
            provider = PodResourcesAttribution(socket_path=sock)
            snap = provider.snapshot()
            assert snap.allocations[0].pod == "train-0"
            assert snap.allocations[0].device_ids == ("0", "1", "2", "3")
            # channel reused across polls
            provider.snapshot()
            assert lister.calls == 2
            provider.close()
        finally:
            server.stop(0)

    def test_allocatable_inventory_reported(self, tmp_path):
        sock = str(tmp_path / "kubelet.sock")
        lister = _FakeLister(
            make_response([("p", "ns", [("c", TPU_RESOURCE_NAME, ["0"])])]),
            allocatable_ids=["0", "1", "2", "3"],
        )
        server = serve_lister(sock, lister)
        try:
            provider = PodResourcesAttribution(socket_path=sock)
            snap = provider.snapshot()
            assert snap.allocatable_device_ids == ("0", "1", "2", "3")
            provider.close()
        finally:
            server.stop(0)

    def test_allocatable_unimplemented_probed_once(self, tmp_path):
        sock = str(tmp_path / "kubelet.sock")
        lister = _FakeLister(
            make_response([("p", "ns", [("c", TPU_RESOURCE_NAME, ["0"])])]),
            allocatable_unimplemented=True,
        )
        server = serve_lister(sock, lister)
        try:
            provider = PodResourcesAttribution(socket_path=sock)
            assert provider.snapshot().allocatable_device_ids is None
            assert provider.snapshot().allocatable_device_ids is None
            assert lister.allocatable_calls == 1  # not re-probed
            provider.close()
        finally:
            server.stop(0)

    def test_missing_socket_raises_attribution_error(self, tmp_path):
        provider = PodResourcesAttribution(
            socket_path=str(tmp_path / "nope.sock"), timeout_s=0.2
        )
        with pytest.raises(AttributionError):
            provider.snapshot()
        provider.close()

    def test_kubelet_restart_reconnects(self, tmp_path):
        sock = str(tmp_path / "kubelet.sock")
        lister = _FakeLister(make_response([("p", "ns", [("c", TPU_RESOURCE_NAME, ["0"])])]))
        server = serve_lister(sock, lister)
        provider = PodResourcesAttribution(socket_path=sock, timeout_s=0.5)
        assert provider.snapshot().allocations[0].pod == "p"
        server.stop(0)
        if os.path.exists(sock):  # grpc may remove the socket file on stop
            os.unlink(sock)
        with pytest.raises(AttributionError):
            provider.snapshot()
        # kubelet comes back on the same path
        lister2 = _FakeLister(make_response([("q", "ns", [("c", TPU_RESOURCE_NAME, ["0"])])]))
        server2 = serve_lister(sock, lister2)
        try:
            assert provider.snapshot().allocations[0].pod == "q"
        finally:
            provider.close()
            server2.stop(0)


CHECKPOINT_V2 = {
    "Data": {
        "PodDeviceEntries": [
            {
                "PodUID": "uid-123",
                "ContainerName": "main",
                "ResourceName": TPU_RESOURCE_NAME,
                "DeviceIDs": {"-1": ["0", "1"]},
            }
        ],
        "RegisteredDevices": {TPU_RESOURCE_NAME: ["0", "1", "2", "3"]},
    },
    "Checksum": 12345,
}


class TestCheckpoint:
    def test_parse_v2_shape(self):
        snap = parse_checkpoint(json.dumps(CHECKPOINT_V2))
        assert snap.allocations == (
            DeviceAllocation("uid:uid-123", "", "main", ("0", "1"), TPU_RESOURCE_NAME),
        )

    def test_parse_legacy_flat_shape(self):
        doc = {
            "Data": {
                "PodDeviceEntries": [
                    {
                        "PodUID": "u",
                        "ContainerName": "c",
                        "ResourceName": TPU_RESOURCE_NAME,
                        "DeviceIDs": ["3"],
                    }
                ]
            }
        }
        snap = parse_checkpoint(json.dumps(doc))
        assert snap.allocations[0].device_ids == ("3",)

    def test_uid_hint_map(self):
        snap = parse_checkpoint(
            json.dumps(CHECKPOINT_V2), uid_to_pod={"uid-123": ("train-0", "ml")}
        )
        assert snap.allocations[0].pod == "train-0"
        assert snap.allocations[0].namespace == "ml"

    def test_bad_json_raises(self):
        with pytest.raises(AttributionError):
            parse_checkpoint("{not json")

    def test_empty_and_malformed_entries_skipped(self):
        doc = {"Data": {"PodDeviceEntries": [None, {}, {"PodUID": "u", "DeviceIDs": {}}]}}
        assert parse_checkpoint(json.dumps(doc)).allocations == ()

    def test_provider_reads_file(self, tmp_path):
        path = tmp_path / "kubelet_internal_checkpoint"
        path.write_text(json.dumps(CHECKPOINT_V2))
        provider = CheckpointAttribution(path=str(path))
        assert provider.snapshot().allocations[0].device_ids == ("0", "1")

    def test_provider_missing_file_raises(self, tmp_path):
        provider = CheckpointAttribution(path=str(tmp_path / "missing"))
        with pytest.raises(AttributionError):
            provider.snapshot()


class TestUidMap:
    """UID→(name, namespace) resolution for the checkpoint fallback: no
    pod="uid:…" when a source is wired."""

    def test_static_file_shapes(self, tmp_path):
        from tpu_pod_exporter_torch.attribution.uidmap import StaticUidMap

        p = tmp_path / "uids.json"
        p.write_text(json.dumps({
            "uid-123": {"name": "train-0", "namespace": "ml"},
            "uid-456": ["eval-1", "research"],
        }))
        m = StaticUidMap(str(p)).mapping()
        assert m["uid-123"] == ("train-0", "ml")
        assert m["uid-456"] == ("eval-1", "research")

    def test_static_file_reloads_on_mtime_change(self, tmp_path):
        import os

        from tpu_pod_exporter_torch.attribution.uidmap import StaticUidMap

        p = tmp_path / "uids.json"
        p.write_text(json.dumps({"u": ["a", "ns"]}))
        src = StaticUidMap(str(p))
        assert src.mapping()["u"] == ("a", "ns")
        p.write_text(json.dumps({"u": ["b", "ns"]}))
        os.utime(p, (1, 2))  # force a distinct mtime
        assert src.mapping()["u"] == ("b", "ns")

    def test_static_file_bad_shape_raises(self, tmp_path):
        from tpu_pod_exporter_torch.attribution.uidmap import StaticUidMap, UidMapError

        p = tmp_path / "uids.json"
        p.write_text(json.dumps({"u": "just-a-string"}))
        with pytest.raises(UidMapError):
            StaticUidMap(str(p)).mapping()

    def test_kubelet_pods_parse_and_ttl(self):
        from tpu_pod_exporter_torch.attribution.uidmap import KubeletPodsUidMap

        pods = {"items": [
            {"metadata": {"uid": "u1", "name": "p1", "namespace": "ns1"}},
            {"metadata": {"name": "no-uid-skipped"}},
        ]}
        calls = []
        clock = [0.0]

        def fetch(url, headers, timeout_s):
            calls.append(url)
            return json.dumps(pods).encode()

        src = KubeletPodsUidMap(
            "http://127.0.0.1:10255/pods", refresh_s=30,
            _fetch=fetch, _clock=lambda: clock[0],
        )
        assert src.mapping()["u1"] == ("p1", "ns1")
        assert len(src.mapping()) == 1
        assert len(calls) == 1  # TTL: second mapping() served from cache
        clock[0] = 31.0
        src.mapping()
        assert len(calls) == 2  # refreshed after TTL

    def test_kubelet_fetch_error_serves_last_good(self):
        from tpu_pod_exporter_torch.attribution.uidmap import KubeletPodsUidMap

        good = json.dumps(
            {"items": [{"metadata": {"uid": "u", "name": "p", "namespace": "n"}}]}
        ).encode()
        state = {"fail": False}
        clock = [0.0]

        def fetch(url, headers, timeout_s):
            if state["fail"]:
                raise ConnectionError("kubelet down")
            return good

        src = KubeletPodsUidMap("http://k:10255/pods", refresh_s=10,
                                _fetch=fetch, _clock=lambda: clock[0])
        assert src.mapping()["u"] == ("p", "n")
        state["fail"] = True
        clock[0] = 11.0
        assert src.mapping()["u"] == ("p", "n")  # last-good served
        assert src.fetch_errors == 1

    def test_bearer_token_over_unverified_https_refused(self, tmp_path):
        """An explicit token + https + no CA must refuse at
        startup, not quietly ship the credential over unverified TLS."""
        from tpu_pod_exporter_torch.attribution.uidmap import (
            KubeletPodsUidMap,
            UidMapError,
        )

        token = tmp_path / "token"
        token.write_text("secret")
        with pytest.raises(UidMapError, match="unverified TLS"):
            KubeletPodsUidMap(
                "https://127.0.0.1:10250/pods", token_file=str(token)
            )

    def test_bearer_token_unverified_https_explicit_opt_in(self, tmp_path):
        from tpu_pod_exporter_torch.attribution.uidmap import KubeletPodsUidMap

        token = tmp_path / "token"
        token.write_text("secret")
        src = KubeletPodsUidMap(
            "https://127.0.0.1:10250/pods",
            token_file=str(token),
            insecure_tls=True,
            _fetch=lambda url, headers, t: b'{"items": []}',
        )
        assert src.mapping() == {}

    def test_token_with_ca_or_plain_http_is_fine(self, tmp_path):
        from tpu_pod_exporter_torch.attribution.uidmap import KubeletPodsUidMap

        token = tmp_path / "token"
        token.write_text("secret")
        ca = tmp_path / "ca.crt"
        ca.write_text("---")
        KubeletPodsUidMap(
            "https://127.0.0.1:10250/pods",
            token_file=str(token), ca_file=str(ca),
        )
        KubeletPodsUidMap("http://127.0.0.1:10255/pods", token_file=str(token))

    def test_app_does_not_auto_default_token_without_ca(self, tmp_path, monkeypatch):
        """The auto path drops the token (with a warning) rather than
        leaking it, when the SA CA bundle is absent."""
        import tpu_pod_exporter_torch.app as app_mod
        from tpu_pod_exporter_torch.app import _build_uid_source
        from tpu_pod_exporter_torch.config import ExporterConfig

        token = tmp_path / "token"
        token.write_text("secret")
        monkeypatch.setattr(
            "tpu_pod_exporter_torch.attribution.uidmap.DEFAULT_TOKEN_FILE",
            str(token), raising=False,
        )
        monkeypatch.setattr(
            "tpu_pod_exporter_torch.attribution.uidmap.DEFAULT_CA_FILE",
            str(tmp_path / "absent-ca.crt"), raising=False,
        )
        cfg = ExporterConfig(kubelet_pods_url="https://127.0.0.1:10250/pods")
        src = _build_uid_source(cfg)
        assert src is not None
        assert src._token_file is None  # token NOT auto-sent unverified

    def test_checkpoint_provider_uses_live_source(self, tmp_path):
        from tpu_pod_exporter_torch.attribution.uidmap import StaticUidMap

        ckpt = tmp_path / "kubelet_internal_checkpoint"
        ckpt.write_text(json.dumps(CHECKPOINT_V2))
        uids = tmp_path / "uids.json"
        uids.write_text(json.dumps({"uid-123": ["train-0", "ml"]}))
        provider = CheckpointAttribution(
            path=str(ckpt), uid_source=StaticUidMap(str(uids))
        )
        alloc = provider.snapshot().allocations[0]
        assert (alloc.pod, alloc.namespace) == ("train-0", "ml")

    def test_checkpoint_provider_degrades_when_source_fails(self, tmp_path):
        from tpu_pod_exporter_torch.attribution.uidmap import StaticUidMap

        ckpt = tmp_path / "kubelet_internal_checkpoint"
        ckpt.write_text(json.dumps(CHECKPOINT_V2))
        provider = CheckpointAttribution(
            path=str(ckpt), uid_source=StaticUidMap(str(tmp_path / "missing"))
        )
        # Allocations survive; pods fall back to uid-keyed names.
        assert provider.snapshot().allocations[0].pod == "uid:uid-123"

    def test_uid_map_errors_reach_exporter_metrics(self, tmp_path):
        """Source failures must surface as
        tpu_exporter_poll_errors_total{source="attribution.uid_map"}, not just a log."""
        from tpu_pod_exporter_torch.attribution.uidmap import StaticUidMap
        from tpu_pod_exporter_torch.backend.fake import FakeBackend
        from tpu_pod_exporter_torch.collector import Collector
        from tpu_pod_exporter_torch.metrics import SnapshotStore

        ckpt = tmp_path / "kubelet_internal_checkpoint"
        ckpt.write_text(json.dumps(CHECKPOINT_V2))
        provider = CheckpointAttribution(
            path=str(ckpt), uid_source=StaticUidMap(str(tmp_path / "missing"))
        )
        store = SnapshotStore()
        c = Collector(FakeBackend(chips=1), provider, store)
        c.poll_once()
        c.poll_once()
        assert store.current().value(
            "tpu_exporter_poll_errors_total", {"source": "attribution.uid_map"}
        ) == 2.0
