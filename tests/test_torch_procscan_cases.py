"""The cases of tests/test_procscan.py against ``tpu_pod_exporter_torch``, with the
imports renamed.

Procfs process↔chip attribution (SURVEY.md §2.6 inversion).

The reference harvests *container-namespace* PIDs via ``kubectl exec … ps``
and joins them against NVML *host* PIDs (broken by construction). Here the
scan reads ``/proc/<pid>/fd`` host-side over a synthetic proc tree — the
symlink targets never need to exist, so these tests run with zero devices.
"""

import os

import pytest

from tpu_pod_exporter_torch.attribution.fake import FakeAttribution, simple_allocation
from tpu_pod_exporter_torch.backend.fake import FakeBackend, FakeChipScript
from tpu_pod_exporter_torch.collector import Collector
from tpu_pod_exporter_torch.metrics import SnapshotStore
from tpu_pod_exporter_torch.procscan import DeviceHolder, ProcScanner, parse_cgroup_identity
from tpu_pod_exporter_torch.topology import HostTopology

UID = "3a61f333-1234-5678-9abc-def012345678"
CID = "0123456789abcdef0123456789abcdef0123456789abcdef0123456789abcdef"

CGROUP_V2 = (
    "0::/kubepods.slice/kubepods-burstable.slice/"
    f"kubepods-burstable-pod{UID.replace('-', '_')}.slice/"
    f"cri-containerd-{CID}.scope\n"
)
CGROUP_V1 = (
    "12:memory:/kubepods/burstable/pod" + UID + "/" + CID + "\n"
    "11:cpu,cpuacct:/kubepods/burstable/pod" + UID + "/" + CID + "\n"
)
CGROUP_DOCKER = (
    "0::/kubepods.slice/kubepods-pod" + UID.replace("-", "_") + ".slice/"
    "docker-" + CID + ".scope\n"
)
CGROUP_NON_POD = "0::/user.slice/user-0.slice/session-1.scope\n"


def add_proc(root, pid, fds, comm="train_worker", cgroup=CGROUP_V2):
    d = root / str(pid)
    (d / "fd").mkdir(parents=True)
    for i, target in enumerate(fds):
        os.symlink(target, d / "fd" / str(3 + i))
    (d / "comm").write_text(comm + "\n")
    (d / "cgroup").write_text(cgroup)


class TestParseCgroupIdentity:
    def test_v2_systemd(self):
        assert parse_cgroup_identity(CGROUP_V2) == (UID, CID)

    def test_v1_cgroupfs(self):
        assert parse_cgroup_identity(CGROUP_V1) == (UID, CID)

    def test_docker_scope(self):
        assert parse_cgroup_identity(CGROUP_DOCKER) == (UID, CID)

    def test_non_pod_process(self):
        assert parse_cgroup_identity(CGROUP_NON_POD) == ("", "")

    def test_empty(self):
        assert parse_cgroup_identity("") == ("", "")

    def test_pod_without_container_component(self):
        text = "0::/kubepods.slice/kubepods-pod" + UID.replace("-", "_") + ".slice\n"
        assert parse_cgroup_identity(text) == (UID, "")


class TestFullScan:
    def test_finds_holders_with_identity(self, tmp_path):
        add_proc(tmp_path, 100, ["/dev/accel0", "/dev/accel1"])
        add_proc(tmp_path, 200, ["/dev/null", "/tmp/log"])  # not a holder
        (tmp_path / "self").mkdir()  # non-numeric entries are skipped
        s = ProcScanner(proc_root=str(tmp_path))
        holders = s.scan()
        assert holders == (
            DeviceHolder(100, "train_worker", "/dev/accel0", UID, CID),
            DeviceHolder(100, "train_worker", "/dev/accel1", UID, CID),
        )

    def test_duplicate_fds_to_one_device_dedupe(self, tmp_path):
        add_proc(tmp_path, 50, ["/dev/accel2", "/dev/accel2", "/dev/accel2"])
        holders = ProcScanner(proc_root=str(tmp_path)).scan()
        assert [h.device_path for h in holders] == ["/dev/accel2"]

    def test_deleted_device_node_still_joins(self, tmp_path):
        # Runtime restart recreated /dev/accel0 while pid 70 holds the old
        # inode: readlink reports "… (deleted)". The wedged holder must still
        # attribute to the chip's canonical path.
        add_proc(tmp_path, 70, ["/dev/accel0 (deleted)"])
        holders = ProcScanner(proc_root=str(tmp_path)).scan()
        assert [h.device_path for h in holders] == ["/dev/accel0"]

    def test_vfio_paths_match(self, tmp_path):
        add_proc(tmp_path, 60, ["/dev/vfio/17"], cgroup=CGROUP_NON_POD)
        holders = ProcScanner(proc_root=str(tmp_path)).scan()
        assert holders == (DeviceHolder(60, "train_worker", "/dev/vfio/17"),)

    def test_vfio_container_node_excluded(self, tmp_path):
        # /dev/vfio/vfio is the shared container node every vfio-using
        # process opens (including non-TPU passthrough users) — it must
        # not become a holder, while /dev/vfio/<group> still does.
        add_proc(tmp_path, 61, ["/dev/vfio/vfio"], cgroup=CGROUP_NON_POD)
        add_proc(tmp_path, 62, ["/dev/vfio/vfio", "/dev/vfio/9"],
                 cgroup=CGROUP_NON_POD)
        holders = ProcScanner(proc_root=str(tmp_path)).scan()
        assert [(h.pid, h.device_path) for h in holders] == [(62, "/dev/vfio/9")]

    def test_unreadable_fd_table_skips_process(self, tmp_path):
        d = tmp_path / "300"
        d.mkdir()
        (d / "fd").write_text("not a dir")  # listdir → NotADirectoryError
        add_proc(tmp_path, 301, ["/dev/accel0"])
        holders = ProcScanner(proc_root=str(tmp_path)).scan()
        assert [h.pid for h in holders] == [301]

    def test_missing_proc_root_raises(self, tmp_path):
        # A whole-scan failure must surface (collector error budget +
        # staleness fallback), not masquerade as an empty holder set.
        from tpu_pod_exporter_torch.procscan import ProcScanError

        s = ProcScanner(proc_root=str(tmp_path / "nope"))
        with pytest.raises(ProcScanError):
            s.scan()

    def test_proc_root_failure_preserves_cache_state(self, tmp_path):
        import shutil

        from tpu_pod_exporter_torch.procscan import ProcScanError

        add_proc(tmp_path, 100, ["/dev/accel0"])
        s = ProcScanner(proc_root=str(tmp_path), full_scan_every=2)
        assert len(s.scan()) == 1
        moved = str(tmp_path) + ".moved"
        shutil.move(str(tmp_path), moved)
        # Verify window exhausts (cached pid unreadable → escalate to full
        # scan → ProcScanError), state untouched.
        with pytest.raises(ProcScanError):
            for _ in range(4):
                s.scan()
        shutil.move(moved, str(tmp_path))
        assert [h.pid for h in s.scan()] == [100]

    def test_sorted_by_pid(self, tmp_path):
        add_proc(tmp_path, 900, ["/dev/accel1"])
        add_proc(tmp_path, 80, ["/dev/accel0"])
        holders = ProcScanner(proc_root=str(tmp_path)).scan()
        assert [h.pid for h in holders] == [80, 900]


class TestIncrementalScan:
    def test_new_holder_appears_after_full_scan_interval(self, tmp_path):
        add_proc(tmp_path, 100, ["/dev/accel0"])
        s = ProcScanner(proc_root=str(tmp_path), full_scan_every=3)
        assert len(s.scan()) == 1  # full scan #1
        add_proc(tmp_path, 101, ["/dev/accel1"])
        # Verify-only window: cached set unchanged, new pid not yet visible.
        assert len(s.scan()) == 1
        assert len(s.scan()) == 1
        assert len(s.scan()) == 1  # 3rd verify exhausts the window
        assert len(s.scan()) == 2  # next full scan picks up pid 101
        assert s.full_scans == 2

    def test_departed_holder_triggers_immediate_rescan(self, tmp_path):
        import shutil

        add_proc(tmp_path, 100, ["/dev/accel0"])
        add_proc(tmp_path, 101, ["/dev/accel1"])
        s = ProcScanner(proc_root=str(tmp_path), full_scan_every=1000)
        assert len(s.scan()) == 2
        shutil.rmtree(tmp_path / "100")  # chip 0 freed
        holders = s.scan()  # verify notices, falls through to full scan
        assert [h.pid for h in holders] == [101]
        assert s.full_scans == 2

    def test_empty_holder_set_is_also_cached(self, tmp_path):
        # Idle node (chips present, nothing holding them): the verify window
        # must apply to the empty result too, not degenerate into a full
        # /proc walk every poll.
        tmp_path.mkdir(exist_ok=True)
        s = ProcScanner(proc_root=str(tmp_path), full_scan_every=4)
        for _ in range(9):
            assert s.scan() == ()
        assert s.full_scans == 2  # polls 1 and 6, not all 9

    def test_cached_path_costs_only_holder_reads(self, tmp_path):
        add_proc(tmp_path, 100, ["/dev/accel0"])
        s = ProcScanner(proc_root=str(tmp_path), full_scan_every=5)
        s.scan()
        s.scan()
        s.scan()
        assert s.full_scans == 1
        assert s.verify_scans == 2


def make_collector(store, scanner, legacy=False, chips=2):
    backend = FakeBackend(
        chips=chips,
        script=FakeChipScript(hbm_total_bytes=100.0, hbm_used_bytes=25.0),
    )
    attr = FakeAttribution(
        [simple_allocation("train-0", ["0", "1"], namespace="ml")]
    )
    topo = HostTopology(accelerator="v4-8", slice_name="s0", host="h0", worker_id="0")
    return Collector(
        backend, attr, store, topology=topo,
        process_scanner=scanner, legacy_metrics=legacy,
    )


def process_labels(chip_id, pid, comm="train_worker", pod_uid=UID,
                   pod="train-0", namespace="ml", container="main"):
    return {
        "chip_id": str(chip_id),
        "device_path": f"/dev/accel{chip_id}",
        "accelerator": "v4-8",
        "slice_name": "s0",
        "host": "h0",
        "worker_id": "0",
        "pod": pod,
        "namespace": namespace,
        "container": container,
        "pid": str(pid),
        "comm": comm,
        "pod_uid": pod_uid,
    }


class TestCollectorIntegration:
    def test_chip_process_info_series(self, tmp_path):
        add_proc(tmp_path, 4242, ["/dev/accel0"])
        store = SnapshotStore()
        c = make_collector(store, ProcScanner(proc_root=str(tmp_path)))
        c.poll_once()
        snap = store.current()
        assert snap.value("tpu_chip_process_info", process_labels(0, 4242)) == 1.0
        # Chip 1 has no holder — no series for it.
        assert snap.value("tpu_chip_process_info", process_labels(1, 4242)) is None
        assert c.last_stats.process_scan_s >= 0.0

    def test_multiple_holders_one_chip(self, tmp_path):
        add_proc(tmp_path, 10, ["/dev/accel0"])
        add_proc(tmp_path, 11, ["/dev/accel0"])
        store = SnapshotStore()
        c = make_collector(store, ProcScanner(proc_root=str(tmp_path)))
        c.poll_once()
        snap = store.current()
        assert snap.value("tpu_chip_process_info", process_labels(0, 10)) == 1.0
        assert snap.value("tpu_chip_process_info", process_labels(0, 11)) == 1.0

    def test_legacy_pid_label_uses_primary_holder(self, tmp_path):
        add_proc(tmp_path, 500, ["/dev/accel0", "/dev/accel1"])
        store = SnapshotStore()
        c = make_collector(store, ProcScanner(proc_root=str(tmp_path)), legacy=True)
        c.poll_once()
        snap = store.current()
        # Both chips held by pid 500: one legacy series {pid="500", pod}.
        assert snap.value(
            "pod_gpu_memory_usage", {"pid": "500", "pod": "train-0"}
        ) == 50.0
        assert snap.value(
            "docker_gpu_memory_perc_usage", {"pid": "500", "pod": "train-0"}
        ) == 25.0

    def test_legacy_pid_empty_without_holders(self, tmp_path):
        store = SnapshotStore()
        c = make_collector(store, ProcScanner(proc_root=str(tmp_path)), legacy=True)
        c.poll_once()
        snap = store.current()
        assert snap.value(
            "pod_gpu_memory_usage", {"pid": "", "pod": "train-0"}
        ) == 50.0

    def test_transient_scan_failure_keeps_last_holders(self, tmp_path):
        # One failed scan must not blink tpu_chip_process_info out (nor flip
        # the legacy pid label): the last good holder set is reused within
        # the bounded-staleness window.
        add_proc(tmp_path, 4242, ["/dev/accel0"])
        real = ProcScanner(proc_root=str(tmp_path))

        class Flaky:
            fail = False

            def scan(self):
                if self.fail:
                    raise RuntimeError("transient")
                return real.scan()

        flaky = Flaky()
        store = SnapshotStore()
        c = make_collector(store, flaky)
        c.poll_once()
        flaky.fail = True
        stats = c.poll_once()
        assert "process_scan" in stats.errors
        snap = store.current()
        assert snap.value("tpu_chip_process_info", process_labels(0, 4242)) == 1.0

    def test_scanner_failure_is_contained(self):
        class BoomScanner:
            def scan(self):
                raise RuntimeError("boom")

        store = SnapshotStore()
        c = make_collector(store, BoomScanner())
        stats = c.poll_once()
        assert stats.ok  # device read fine; scan failure degrades only
        assert "process_scan" in stats.errors
        snap = store.current()
        assert snap.value(
            "tpu_exporter_poll_errors_total", {"source": "process_scan"}
        ) == 1.0
        # Chip metrics unaffected.
        assert snap.value("tpu_exporter_up") == 1.0

    def test_phase_timing_published(self, tmp_path):
        store = SnapshotStore()
        c = make_collector(store, ProcScanner(proc_root=str(tmp_path)))
        c.poll_once()
        snap = store.current()
        assert (
            snap.value("tpu_exporter_poll_duration_seconds", {"phase": "process_scan"})
            is not None
        )

    def test_no_scanner_means_no_family(self):
        store = SnapshotStore()
        c = make_collector(store, None)
        c.poll_once()
        text = store.current().encode().decode()
        assert "tpu_chip_process_info" not in text


class TestNativeParity:
    def _tree(self, tmp_path):
        add_proc(tmp_path, 100, ["/dev/accel0", "/dev/accel0", "/dev/accel1"])
        add_proc(tmp_path, 205, ["/dev/accel2 (deleted)"], comm="wedged",
                 cgroup=CGROUP_V1)
        add_proc(tmp_path, 30, ["/dev/vfio/7"], cgroup=CGROUP_NON_POD)
        add_proc(tmp_path, 40, ["/dev/null"])  # not a holder
        (tmp_path / "not-a-pid").mkdir()

    def test_native_and_python_full_scans_agree(self, tmp_path):
        from tpu_pod_exporter_torch import nativelib

        self._tree(tmp_path)
        s = ProcScanner(proc_root=str(tmp_path))
        if nativelib.load() is None:
            pytest.skip("native lib unavailable")
        native_found = s._native_full_scan()
        assert native_found is not None
        python_found = s._python_full_scan()
        assert native_found == python_found
        assert sorted(native_found) == [30, 100, 205]

    def test_python_fallback_when_native_unavailable(self, tmp_path, monkeypatch):
        from tpu_pod_exporter_torch import nativelib

        self._tree(tmp_path)
        monkeypatch.setattr(nativelib, "load", lambda: None)
        holders = ProcScanner(proc_root=str(tmp_path)).scan()
        assert sorted({h.pid for h in holders}) == [30, 100, 205]
        assert [h.device_path for h in holders if h.pid == 205] == ["/dev/accel2"]

    def test_weird_comm_parity(self, tmp_path):
        # prctl lets a process set comm to nearly anything; both scanners
        # must sanitize identically or the verify cache thrashes.
        from tpu_pod_exporter_torch import nativelib

        add_proc(tmp_path, 90, ["/dev/accel0"], comm="a\rb")
        add_proc(tmp_path, 91, ["/dev/accel1"], comm="\tworker ")
        add_proc(tmp_path, 92, ["/dev/accel2"], comm="odd\tname")
        s = ProcScanner(proc_root=str(tmp_path))
        python_found = s._python_full_scan()
        if nativelib.load() is not None:
            native_found = s._native_full_scan()
            assert native_found == python_found
        comms = {pid: hs[0].comm for pid, hs in python_found.items()}
        assert comms == {90: "a\rb", 91: "worker", 92: "odd?name"}

    def test_native_overflow_falls_back_to_python(self, tmp_path):
        # >16 distinct matching devices in one process: native must refuse
        # (-1) rather than truncate, and scan() must still return the truth.
        from tpu_pod_exporter_torch import nativelib

        add_proc(tmp_path, 95, [f"/dev/accel{i}" for i in range(20)])
        s = ProcScanner(proc_root=str(tmp_path))
        if nativelib.load() is not None:
            assert s._native_full_scan() is None
        holders = s.scan()
        assert len(holders) == 20
