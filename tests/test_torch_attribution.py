"""The port's kubelet attribution held against the JAX package's, and its
``/dev/nvidia*`` discovery.

The same kubelet checkpoint, UID map and podresources response (served
over a real unix-socket gRPC server) give equal snapshots from both
packages, for GPU allocations keyed by UUID under ``nvidia.com/gpu`` beside
TPU ones. Discovery scans a synthetic root.
"""

import json
from concurrent import futures

import grpc
import pytest

from test_torch_nvml import plain
from tpu_pod_exporter.attribution import checkpoint as jax_checkpoint
from tpu_pod_exporter.attribution import podresources as jax_podresources
from tpu_pod_exporter.attribution import uidmap as jax_uidmap
from tpu_pod_exporter.attribution.proto import podresources_pb2 as pb
from tpu_pod_exporter_torch import app as tapp
from tpu_pod_exporter_torch.attribution import checkpoint, podresources, uidmap
from tpu_pod_exporter_torch.attribution.fake import FakeAttribution
from tpu_pod_exporter_torch.backend import discovery
from tpu_pod_exporter_torch.config import ExporterConfig

GPU = "nvidia.com/gpu"
TPU = "google.com/tpu"
UUID = "GPU-bae8c9e4-2b9c-6a92-b426-c2e367abb292"
CHECKPOINT = {
    "Data": {
        "PodDeviceEntries": [
            {"PodUID": "uid-gpu", "ContainerName": "main", "ResourceName": GPU,
             "DeviceIDs": {"-1": [UUID]}},
            {"PodUID": "uid-tpu", "ContainerName": "main", "ResourceName": TPU,
             "DeviceIDs": {"0": ["0", "1"]}},
            {"PodUID": "uid-old", "ContainerName": "side", "ResourceName": GPU,
             "DeviceIDs": ["GPU-1111"]},  # the flat shape of older kubelets
            None, {}, {"PodUID": "u", "DeviceIDs": {}},
        ],
        "RegisteredDevices": {GPU: [UUID, "GPU-1111"]},
    },
    "Checksum": 12345,
}
UID_MAP = {"uid-gpu": {"name": "train-0", "namespace": "ml"},
           "uid-old": ["eval-1", "research"]}
PODS = {"items": [
    {"metadata": {"uid": "uid-gpu", "name": "train-0", "namespace": "ml"}},
    {"metadata": {"uid": "uid-tpu", "name": "tpu-job", "namespace": "ml"}},
    {"metadata": {"name": "no-uid"}},
]}


def _files(tmp_path):
    ckpt = tmp_path / "kubelet_internal_checkpoint"
    ckpt.write_text(json.dumps(CHECKPOINT))
    uids = tmp_path / "uids.json"
    uids.write_text(json.dumps(UID_MAP))
    return str(ckpt), str(uids)


class TestCheckpointAndUidMap:
    @pytest.mark.parametrize("uid_to_pod", [None, {"uid-gpu": ("train-0", "ml")}])
    def test_parse_checkpoint_equal(self, uid_to_pod):
        text = json.dumps(CHECKPOINT)
        want = jax_checkpoint.parse_checkpoint(text, uid_to_pod=uid_to_pod)
        got = checkpoint.parse_checkpoint(text, uid_to_pod=uid_to_pod)
        assert plain(got) == plain(want)
        assert got.by_device_id(GPU)[UUID].pod == (
            "train-0" if uid_to_pod else "uid:uid-gpu")

    def test_provider_with_static_uid_map_equal(self, tmp_path):
        ckpt, uids = _files(tmp_path)
        want = jax_checkpoint.CheckpointAttribution(
            path=ckpt, uid_source=jax_uidmap.StaticUidMap(uids)).snapshot()
        got = checkpoint.CheckpointAttribution(
            path=ckpt, uid_source=uidmap.StaticUidMap(uids)).snapshot()
        assert plain(got) == plain(want)
        assert {(a.pod, a.namespace) for a in got.allocations} == {
            ("train-0", "ml"), ("uid:uid-tpu", ""), ("eval-1", "research")}

    def test_kubelet_pods_map_equal(self):
        def fetch(url, headers, timeout_s):
            return json.dumps(PODS).encode()

        want = jax_uidmap.KubeletPodsUidMap("http://127.0.0.1:10255/pods", _fetch=fetch)
        got = uidmap.KubeletPodsUidMap("http://127.0.0.1:10255/pods", _fetch=fetch)
        assert got.mapping() == want.mapping() == {
            "uid-gpu": ("train-0", "ml"), "uid-tpu": ("tpu-job", "ml")}

    @pytest.mark.parametrize("raw", ['{"u": "just-a-string"}', "{not json", "[1, 2]"])
    def test_bad_uid_map_raises_in_both(self, raw):
        with pytest.raises(jax_uidmap.UidMapError):
            jax_uidmap.parse_uid_map_file(raw)
        with pytest.raises(uidmap.UidMapError):
            uidmap.parse_uid_map_file(raw)

    def test_app_builds_checkpoint_with_uid_map(self, tmp_path):
        ckpt, uids = _files(tmp_path)
        provider = tapp.build_attribution(ExporterConfig(
            attribution="checkpoint", checkpoint_path=ckpt, uid_map_file=uids))
        assert isinstance(provider, checkpoint.CheckpointAttribution)
        assert provider.snapshot().by_device_id(GPU)[UUID].pod == "train-0"


def _response():
    resp = pb.ListPodResourcesResponse()
    for name, ns, containers in (
            ("train-0", "ml", [("main", GPU, [UUID]), ("side", TPU, ["0", "1"])]),
            ("idle", "ml", [("main", GPU, None)])):
        pod = resp.pod_resources.add()
        pod.name, pod.namespace = name, ns
        for cname, resource, ids in containers:
            c = pod.containers.add()
            c.name = cname
            if ids is not None:
                d = c.devices.add()
                d.resource_name = resource
                d.device_ids.extend(ids)
    return resp


@pytest.fixture
def kubelet(tmp_path):
    """A PodResourcesLister on a unix socket; yields its path."""
    def allocatable(request, context):
        resp = pb.AllocatableResourcesResponse()
        d = resp.devices.add()
        d.resource_name = GPU
        d.device_ids.extend([UUID, "GPU-1111"])
        return resp

    sock = str(tmp_path / "kubelet.sock")
    server = grpc.server(futures.ThreadPoolExecutor(max_workers=2))
    server.add_generic_rpc_handlers((grpc.method_handlers_generic_handler(
        "v1.PodResourcesLister", {
            "List": grpc.unary_unary_rpc_method_handler(
                lambda request, context: _response(),
                request_deserializer=pb.ListPodResourcesRequest.FromString,
                response_serializer=pb.ListPodResourcesResponse.SerializeToString),
            "GetAllocatableResources": grpc.unary_unary_rpc_method_handler(
                allocatable,
                request_deserializer=pb.AllocatableResourcesRequest.FromString,
                response_serializer=pb.AllocatableResourcesResponse.SerializeToString),
        }),))
    server.add_insecure_port(f"unix://{sock}")
    server.start()
    try:
        yield sock
    finally:
        server.stop(0)


class TestPodResources:
    def test_snapshot_from_response_equal(self):
        for prefixes in ((), ("nvidia.com/",)):
            want = jax_podresources.snapshot_from_response(_response(), prefixes)
            got = podresources.snapshot_from_response(_response(), prefixes)
            assert plain(got) == plain(want)

    def test_over_unix_socket_equal(self, kubelet):
        providers = [jax_podresources.PodResourcesAttribution(kubelet, resource_name=GPU),
                     podresources.PodResourcesAttribution(kubelet, resource_name=GPU)]
        try:
            want, got = (p.snapshot() for p in providers)
        finally:
            for p in providers:
                p.close()
        assert plain(got) == plain(want)
        assert got.by_device_id(GPU)[UUID].pod == "train-0"
        assert got.allocatable_device_ids == ("GPU-1111", UUID)

    def test_auto_picks_podresources_when_the_socket_exists(self, kubelet, tmp_path):
        cfg = ExporterConfig(attribution="auto", podresources_socket=kubelet,
                             checkpoint_path=str(tmp_path / "absent"))
        provider = tapp.build_attribution(cfg, GPU)
        try:
            assert isinstance(provider, podresources.PodResourcesAttribution)
            assert provider.snapshot().by_device_id(GPU)[UUID].pod == "train-0"
        finally:
            provider.close()

    def test_auto_degrades_when_podresources_cannot_be_built(self, tmp_path, monkeypatch,
                                                             caplog):
        sock = tmp_path / "kubelet.sock"
        sock.write_text("")

        def unavailable(*args, **kwargs):
            raise ImportError("No module named 'grpc'")

        monkeypatch.setattr(podresources, "PodResourcesAttribution", unavailable)
        cfg = ExporterConfig(attribution="auto", podresources_socket=str(sock))
        assert isinstance(tapp.build_attribution(cfg), FakeAttribution)
        assert "auto-selected podresources attribution unavailable" in caplog.text


class TestDiscovery:
    def test_card_nodes_only_sorted_by_minor(self, tmp_path):
        dev = tmp_path / "dev"
        (dev / "nvidia-caps").mkdir(parents=True)
        for name in ("nvidia10", "nvidia2", "nvidia0", "nvidiactl", "nvidia-uvm",
                     "nvidia-uvm-tools", "nvidia-modeset", "nvidia3x", "accel0"):
            (dev / name).write_text("")
        (dev / "nvidia-caps" / "nvidia-cap1").write_text("")
        root = str(tmp_path)
        assert discovery.list_device_paths(root) == [
            "/dev/nvidia0", "/dev/nvidia2", "/dev/nvidia10"]
        assert discovery.local_chip_count(root) == 3
        chips = discovery.discover_chips(root)
        assert [(c.chip_id, c.device_path, c.device_ids, c.family) for c in chips] == [
            (0, "/dev/nvidia0", ("0",), "gpu"), (2, "/dev/nvidia2", ("2",), "gpu"),
            (10, "/dev/nvidia10", ("10",), "gpu")]

    def test_host_without_cards(self, tmp_path):
        (tmp_path / "dev").mkdir()
        (tmp_path / "dev" / "accel0").write_text("")
        assert discovery.local_chip_count(str(tmp_path)) == 0
        assert discovery.local_chip_count(str(tmp_path / "missing")) == 0
