"""The port's procfs holder scan held against the JAX package's, and its
GPU node filter.

The same synthetic proc tree (symlinks whose targets never need to exist)
goes through both ``ProcScanner``s. On a GPU node the port matches only
``/dev/nvidia<minor>``: the driver's control nodes share the prefix and are
held by every CUDA process. The JAX package's exporter builds its scanner
with the accel/vfio prefixes for every backend, so it finds no GPU holder
at all; the port picks the GPU prefixes for a gpu-family backend.
"""

import pytest

from test_torch_exporter import _get
from test_torch_nvml import plain
from tpu_pod_exporter.app import ExporterApp as JaxExporterApp
from tpu_pod_exporter.config import ExporterConfig as JaxExporterConfig
from tpu_pod_exporter.metrics.parse import parse_exposition
from tpu_pod_exporter.procscan import ProcScanner as JaxProcScanner
from tpu_pod_exporter_torch import app as tapp
from tpu_pod_exporter_torch.config import ExporterConfig
from tpu_pod_exporter_torch.procscan import (
    DEFAULT_DEVICE_PREFIXES,
    GPU_DEVICE_PREFIXES,
    DeviceHolder,
    ProcScanner,
)

UID = "3a61f333-1234-5678-9abc-def012345678"
CID = "0123456789abcdef0123456789abcdef0123456789abcdef0123456789abcdef"
CGROUP_V2 = (
    "0::/kubepods.slice/kubepods-burstable.slice/"
    f"kubepods-burstable-pod{UID.replace('-', '_')}.slice/"
    f"cri-containerd-{CID}.scope\n"
)
CGROUP_V1 = f"12:memory:/kubepods/burstable/pod{UID}/{CID}\n"
CGROUP_NON_POD = "0::/user.slice/user-0.slice/session-1.scope\n"
# Every node a CUDA process holds, the cards among them.
NVIDIA_LINKS = ["/dev/nvidiactl", "/dev/nvidia-uvm", "/dev/nvidia-uvm-tools",
                "/dev/nvidia-modeset", "/dev/nvidia-caps/nvidia-cap1",
                "/dev/nvidia10", "/dev/nvidia0", "/dev/nvidia0"]


def add_proc(root, pid, fds, comm="train_worker", cgroup=CGROUP_V2):
    d = root / str(pid)
    (d / "fd").mkdir(parents=True)
    for i, target in enumerate(fds):
        (d / "fd" / str(3 + i)).symlink_to(target)
    (d / "comm").write_text(comm + "\n")
    (d / "cgroup").write_text(cgroup)


@pytest.fixture
def accel_tree(tmp_path):
    add_proc(tmp_path, 100, ["/dev/accel0", "/dev/accel1", "/dev/null"])
    add_proc(tmp_path, 101, ["/dev/accel3 (deleted)"], cgroup=CGROUP_V1)
    add_proc(tmp_path, 60, ["/dev/vfio/17", "/dev/vfio/vfio"], cgroup=CGROUP_NON_POD)
    add_proc(tmp_path, 61, ["/dev/vfio/vfio"])  # the shared container node only
    add_proc(tmp_path, 200, ["/tmp/log", "/dev/null"])  # no device
    add_proc(tmp_path, 300, NVIDIA_LINKS)  # not an accel prefix
    (tmp_path / "self").mkdir()
    return tmp_path


class TestParity:
    def test_accel_tree_gives_equal_holders(self, accel_tree):
        want = JaxProcScanner(proc_root=str(accel_tree)).scan()
        got = ProcScanner(proc_root=str(accel_tree)).scan()
        assert plain(got) == plain(want)
        assert [(h.pid, h.device_path) for h in got] == [
            (60, "/dev/vfio/17"), (100, "/dev/accel0"), (100, "/dev/accel1"),
            (101, "/dev/accel3")]
        assert got[1] == DeviceHolder(100, "train_worker", "/dev/accel0", UID, CID)

    def test_incremental_scans_agree(self, accel_tree):
        scanners = [JaxProcScanner(proc_root=str(accel_tree), full_scan_every=3),
                    ProcScanner(proc_root=str(accel_tree), full_scan_every=3)]
        for step in range(5):
            if step == 2:  # a holder drops its chip: both rescan at once
                (accel_tree / "101" / "fd" / "3").unlink()
            want, got = (s.scan() for s in scanners)
            assert plain(got) == plain(want)
        assert [(s.full_scans, s.verify_scans) for s in scanners][1] == (
            scanners[0].full_scans, scanners[0].verify_scans)


class TestGpuNodes:
    def test_only_card_nodes_are_held(self, tmp_path):
        add_proc(tmp_path, 118, NVIDIA_LINKS)
        holders = ProcScanner(proc_root=str(tmp_path),
                              device_prefixes=GPU_DEVICE_PREFIXES).scan()
        assert [h.device_path for h in holders] == ["/dev/nvidia0", "/dev/nvidia10"]

    def test_deleted_card_node_still_joins(self, tmp_path):
        add_proc(tmp_path, 7, ["/dev/nvidia3 (deleted)", "/dev/nvidiactl (deleted)"])
        holders = ProcScanner(proc_root=str(tmp_path),
                              device_prefixes=GPU_DEVICE_PREFIXES).scan()
        assert [h.device_path for h in holders] == ["/dev/nvidia3"]

    @pytest.mark.parametrize("target", ["/dev/nvidia", "/dev/nvidia0x", "/dev/nvidia٣",
                                        "/dev/nvidia-caps/nvidia-cap0"])
    def test_non_numeric_suffixes_are_not_cards(self, tmp_path, target):
        add_proc(tmp_path, 9, [target])
        assert ProcScanner(proc_root=str(tmp_path),
                           device_prefixes=GPU_DEVICE_PREFIXES).scan() == ()

    def test_accel_prefixes_unchanged(self, accel_tree):
        assert DEFAULT_DEVICE_PREFIXES == ("/dev/accel", "/dev/vfio/")
        holders = ProcScanner(proc_root=str(accel_tree),
                              device_prefixes=GPU_DEVICE_PREFIXES).scan()
        assert [(h.pid, h.device_path) for h in holders] == [
            (300, "/dev/nvidia0"), (300, "/dev/nvidia10")]


def _process_rows(app) -> list:
    app.collector.poll_once()
    app.server.start()
    status, body = _get(f"http://127.0.0.1:{app.port}", "/metrics")
    assert status == 200
    return sorted((s.labels["pid"], s.labels["device_path"])
                  for s in parse_exposition(body.decode())
                  if s.name == "tpu_chip_process_info")


def test_exporter_joins_gpu_holders_by_card_node(tmp_path):
    """--process-metrics on a GPU node: the holder of /dev/nvidia0 joins the
    card NVML names /dev/nvidia0; the reference's accel prefixes miss it."""
    add_proc(tmp_path, 118, NVIDIA_LINKS)
    add_proc(tmp_path, 119, ["/dev/nvidiactl", "/dev/nvidia-uvm"])
    fields = dict(port=0, host="127.0.0.1", backend="nvml", nvml_sim_gpus=2,
                  attribution="none", process_metrics=True, proc_root=str(tmp_path),
                  legacy_metrics=True)
    apps = [tapp.ExporterApp(ExporterConfig(**fields)),
            JaxExporterApp(JaxExporterConfig(**fields))]
    try:
        assert apps[0].process_scanner._prefixes == GPU_DEVICE_PREFIXES
        assert _process_rows(apps[0]) == [("118", "/dev/nvidia0")]
        assert _process_rows(apps[1]) == []
    finally:
        for app in apps:
            app.stop()


def test_tpu_family_exporter_keeps_accel_prefixes(accel_tree):
    app = tapp.ExporterApp(ExporterConfig(
        port=0, host="127.0.0.1", backend="fake", fake_chips=2, attribution="none",
        process_metrics=True, proc_root=str(accel_tree)))
    try:
        assert app.process_scanner._prefixes == DEFAULT_DEVICE_PREFIXES
        assert _process_rows(app) == [("100", "/dev/accel0"), ("100", "/dev/accel1")]
    finally:
        app.stop()
