"""The H100's own captures, replayed on the CPU through both packages.

``chip_smoke.py`` took them on one NVIDIA H100 80GB HBM3 along the port's
GPU node path, and they are committed as they came, each pinned by its
sha256 in ``tests/fixtures/h100-capture.json`` (with the card's
``nvidia-smi`` name and power limit, its driver and memory total, and which
phase took each file):

- ``h100-trace.jsonl``: phase 12's NVML closed loop recorded with
  ``record_to``: idle, the 16 GiB fill with the burn, release;
- ``h100-metrics.txt``: the node exporter's ``/metrics`` body (NVML,
  process metrics, checkpoint attribution) under the fill, phase 14;
- ``h100-status.json``: ``status --json`` in node mode under the fill,
  phase 14;
- ``h100-probe.json``: ``probe --runtime nvml --out`` under the fill,
  phase 15;
- ``h100-aggregate.txt``: the deployed aggregator's ``/metrics`` body over
  the DaemonSet's exporter on the card under the fill, phase 17.

A later change that alters what the card serves takes the capture again
(``chip_smoke.py`` writes it to ``chiprun_out/h100-capture/``); the files
here are never edited. The recorded PIDs are the chip machine's, so no
replay here joins them to this host's procfs. The tolerance is equality:
this is host code on the same recorded floats.
"""

import hashlib
import json
import re
from pathlib import Path

import pytest

import chip_smoke
from test_torch_exporter import (
    VOLATILE_FAMILIES,
    _get,
    _split,
    without_port_instrumentation,
)
from test_torch_fleet_parity import assert_same_exposition
from test_torch_nvml import plain
from tpu_pod_exporter import aggregate as jax_aggregate
from tpu_pod_exporter import collector as jax_collector
from tpu_pod_exporter import history as jax_history
from tpu_pod_exporter import trace as jax_trace
from tpu_pod_exporter.app import ExporterApp as JaxExporterApp
from tpu_pod_exporter.attribution import DeviceAllocation as JaxAllocation
from tpu_pod_exporter.attribution.fake import FakeAttribution as JaxFakeAttribution
from tpu_pod_exporter.backend import nvml as jax_nvml
from tpu_pod_exporter.backend import recorded as jax_recorded
from tpu_pod_exporter.config import ExporterConfig as JaxExporterConfig
from tpu_pod_exporter.metrics import SnapshotStore as JaxSnapshotStore
from tpu_pod_exporter.metrics import parse as jax_parse
from tpu_pod_exporter_torch import aggregate as port_aggregate
from tpu_pod_exporter_torch import collector as port_collector
from tpu_pod_exporter_torch import history as port_history
from tpu_pod_exporter_torch import trace as port_trace
from tpu_pod_exporter_torch.app import ExporterApp
from tpu_pod_exporter_torch.attribution import DeviceAllocation
from tpu_pod_exporter_torch.attribution.fake import FakeAttribution
from tpu_pod_exporter_torch.backend import nvml as port_nvml
from tpu_pod_exporter_torch.backend import recorded as port_recorded
from tpu_pod_exporter_torch.config import ExporterConfig
from tpu_pod_exporter_torch.metrics import SnapshotStore as PortSnapshotStore
from tpu_pod_exporter_torch.metrics import parse as port_parse

FIXTURES = Path(__file__).resolve().parent / "fixtures"
MANIFEST = json.loads((FIXTURES / chip_smoke.CAPTURE_MANIFEST).read_text())
CARD = MANIFEST["card"].split(",")[0]
TOTAL_BYTES = int(MANIFEST["memory_total"].split()[0]) << 20
TRACE = str(FIXTURES / "h100-trace.jsonl")
FILL = chip_smoke.FILL_BYTES
GIB = 1 << 30

PACKAGES = {
    "jax": dict(recorded=jax_recorded, collector=jax_collector, nvml=jax_nvml,
                aggregate=jax_aggregate, parse=jax_parse, trace=jax_trace,
                history=jax_history, SnapshotStore=JaxSnapshotStore,
                FakeAttribution=JaxFakeAttribution, DeviceAllocation=JaxAllocation,
                ExporterApp=JaxExporterApp, ExporterConfig=JaxExporterConfig),
    "port": dict(recorded=port_recorded, collector=port_collector, nvml=port_nvml,
                 aggregate=port_aggregate, parse=port_parse, trace=port_trace,
                 history=port_history, SnapshotStore=PortSnapshotStore,
                 FakeAttribution=FakeAttribution, DeviceAllocation=DeviceAllocation,
                 ExporterApp=ExporterApp, ExporterConfig=ExporterConfig),
}


def frames(pkg) -> list:
    backend = pkg["recorded"].RecordedBackend(TRACE, loop=False)
    return [backend.sample() for _ in range(len(backend))]


def body(name: str) -> str:
    return (FIXTURES / name).read_text()


def probe() -> dict:
    return json.loads(body("h100-probe.json"))


def sample_lines(text: str, prefixes=("gpu_", "tpu_chip_")) -> list:
    """The sample lines of an exposition whose family starts with one of
    ``prefixes``, outside VOLATILE_FAMILIES."""
    return [line for line in text.splitlines()
            if line.startswith(prefixes) and not line.startswith(VOLATILE_FAMILIES)]


def test_manifest_pins_every_file():
    assert re.fullmatch(r"NVIDIA H100[^,]*, \d+\.\d+ W", MANIFEST["card"])
    assert sorted(MANIFEST["files"]) == sorted(chip_smoke.CAPTURES)
    for name, entry in MANIFEST["files"].items():
        data = (FIXTURES / name).read_bytes()
        assert entry == {"phase": chip_smoke.CAPTURES[name], "bytes": len(data),
                         "sha256": hashlib.sha256(data).hexdigest()}, name
        assert len(data) < chip_smoke.CAPTURE_MAX_BYTES


def test_the_cards_check_passes_here():
    """The check the card ran on the capture it had just written."""
    replayed = chip_smoke.check_capture(FIXTURES)
    assert replayed["frames"] == len(frames(PACKAGES["port"]))


class TestTrace:
    def test_every_frame_replays_equal(self):
        want, got = frames(PACKAGES["jax"]), frames(PACKAGES["port"])
        assert len(got) == len(want) >= 40
        for w, g in zip(want, got):
            assert plain(g) == plain(w)
            assert g.partial_errors == w.partial_errors

    @pytest.mark.parametrize("package", PACKAGES)
    def test_the_card_fills_and_releases(self, package):
        pkg = PACKAGES[package]
        assert pkg["recorded"].RecordedBackend(TRACE).family == "gpu"
        chips = [s.chips for s in frames(pkg)]
        assert {len(c) for c in chips} == {1}
        chips = [c for (c,) in chips]
        assert {(c.info.family, c.info.device_kind) for c in chips} == {("gpu", CARD)}
        assert all(re.fullmatch(r"/dev/nvidia[0-9]+", c.info.device_path) for c in chips)
        assert all(abs(c.hbm_total_bytes - TOTAL_BYTES) <= 1 << 20 for c in chips)
        used = [c.hbm_used_bytes for c in chips]
        assert max(used) - used[0] >= FILL
        assert abs(used[-1] - used[0]) <= GIB
        loaded = [c for c in chips if c.hbm_used_bytes - used[0] >= FILL]
        assert loaded and all(max(p.used_bytes for p in c.processes) >= FILL
                              for c in loaded)

    def test_both_collectors_serve_the_same_lines(self):
        """Every frame through both Collectors with the same fake
        attribution (the card's UUID to the smoke pod); the recorded PIDs
        are joined to nothing on this host."""
        (uuid,) = {c.info.device_ids[0] for s in frames(PACKAGES["port"]) for c in s.chips}
        served = []
        for pkg in PACKAGES.values():
            store = pkg["SnapshotStore"]()
            attribution = pkg["FakeAttribution"]([pkg["DeviceAllocation"](
                chip_smoke.SMOKE_POD, "smoke", "burn", (uuid,), "nvidia.com/gpu")])
            collector = pkg["collector"].Collector(
                pkg["recorded"].RecordedBackend(TRACE, loop=False), attribution, store,
                resource_name="nvidia.com/gpu", legacy_metrics=True)
            lines = []
            for _ in range(len(frames(pkg))):
                collector.poll_once()
                lines.append(sample_lines(store.current().encode().decode()))
            collector.close()
            served.append(lines)
        assert served[1] == served[0]
        last = "\n".join(max(served[1], key=len))
        for family in ("gpu_hbm_used_bytes", "gpu_utilization_percent",
                       "gpu_process_memory_used_bytes", "gpu_pod_memory_used_bytes",
                       "gpu_chip_info"):
            assert f"{family}{{" in last, family

    @pytest.mark.parametrize("package", PACKAGES)
    def test_trace_replay_demo(self, package, capsys):
        assert PACKAGES[package]["trace"].main(["--replay", TRACE]) == 0
        out = capsys.readouterr().out
        assert "trace " in out and "device_read" in out and "publish" in out

    @pytest.mark.parametrize("package", PACKAGES)
    def test_history_replay_demo(self, package, capsys):
        assert PACKAGES[package]["history"].main(["--replay", TRACE, "--polls", "10"]) == 0
        assert "replayed 10 polls" in capsys.readouterr().out


class TestBodies:
    @pytest.mark.parametrize("package", PACKAGES)
    def test_layout_parser_roundtrips_the_node_body(self, package):
        parse, text = PACKAGES[package]["parse"], body("h100-metrics.txt")
        names = PACKAGES[package]["aggregate"].CONSUMED_NAMES
        layout = parse.LayoutCache()
        cold = parse.parse_exposition_layout(text, names, layout)
        warm = parse.parse_exposition_layout(text, names, layout)
        assert [tuple(s) for s in cold] == [tuple(s) for s in warm]
        assert [tuple(s) for s in cold] == [
            tuple(s) for s in parse.parse_exposition(text, names)]
        assert cold

    def test_node_body_folds_to_equal_snapshots(self):
        text = body("h100-metrics.txt")
        pod = [s.value for s in port_parse.parse_exposition(text)
               if s.name == "gpu_pod_memory_used_bytes"
               and s.labels.get("pod") == chip_smoke.SMOKE_POD]
        assert pod and pod[0] >= FILL
        folded = []
        for pkg in PACKAGES.values():
            store = pkg["SnapshotStore"]()
            agg = pkg["aggregate"].SliceAggregator(
                ("node:8000",), store, fetch=lambda target, timeout_s: text)
            agg.poll_once()
            agg.close()
            folded.append(store.current().encode().decode())
        assert assert_same_exposition(*folded) > 0
        table = chip_smoke.rollups(chip_smoke.parsed(folded[1].encode()))
        assert chip_smoke.pick(table, "tpu_slice_chip_count", family="gpu") == 1.0
        assert chip_smoke.pick(table, "tpu_slice_hbm_used_bytes", family="gpu") >= FILL

    @pytest.mark.parametrize("package", PACKAGES)
    def test_aggregate_body_is_honest(self, package):
        fams = {name: {tuple(sorted(s.labels.items())): s.value for s in ss}
                for name, ss in PACKAGES[package]["parse"].parse_families(
                    body("h100-aggregate.txt")).items()}
        (chips,) = fams["tpu_slice_chip_count"].items()
        assert dict(chips[0])["family"] == "gpu" and chips[1] == 1.0
        assert fams["tpu_aggregator_target_up"]
        assert set(fams["tpu_aggregator_target_up"].values()) == {1.0}
        (used,) = fams["tpu_slice_hbm_used_bytes"].items()
        assert dict(used[0])["family"] == "gpu" and used[1] >= FILL

    def test_status_names_the_card_and_the_pod(self):
        doc = json.loads(body("h100-status.json"))
        (chip,) = doc["chips"]
        assert chip["device_kind"] == CARD
        assert re.fullmatch(r"/dev/nvidia[0-9]+", chip["device_path"])
        assert chip["hbm_used_bytes"] >= FILL
        assert abs(chip["hbm_total_bytes"] - TOTAL_BYTES) <= 1 << 20
        assert (chip["pod"], chip["namespace"]) == (chip_smoke.SMOKE_POD, "smoke")
        assert chip["holders"]
        assert doc["pods"] == [{"namespace": "smoke", "pod": chip_smoke.SMOKE_POD, "chips": 1,
                                "hbm_used_bytes": chip["hbm_used_bytes"]}]


class TestProbe:
    def test_reachable_with_the_card(self):
        report = probe()
        assert report["reachable"] is True and report["count"] == 1
        (card,) = report["devices"]
        assert card["name"] == CARD
        assert abs(card["memory_total_bytes"] - TOTAL_BYTES) <= 1 << 20
        assert card["memory_used_bytes"] >= FILL
        # The card answered every call, so no field carries an NVML code and
        # the one code whose value the two packages' tables disagree on
        # (NVML_ERROR_IRQ_ISSUE: 11 in the port, 13 in the JAX package) does
        # not arise; a capture taken again with a failed call must expect
        # its code in each package.
        assert report["errors"] == {}
        assert report["supported"] == sorted(
            ["Init", "Shutdown", "DeviceGetCount", "DeviceGetHandleByIndex", "DeviceGetName",
             "DeviceGetUUID", "DeviceGetMinorNumber", "DeviceGetMemoryInfo",
             "DeviceGetUtilizationRates", "DeviceGetComputeRunningProcesses"])
        assert chip_smoke.probe_spec(report)["faults"] == []

    def test_answers_replay_equal_through_both_backends(self):
        spec = chip_smoke.probe_spec(probe())
        backends = [PACKAGES[p]["nvml"].NvmlBackend(
            driver=PACKAGES[p]["nvml"].sim_driver_from_spec(spec)) for p in PACKAGES]
        for _ in range(3):
            want, got = (b.sample() for b in backends)
            assert plain(got) == plain(want)
        (card,) = probe()["devices"]
        (chip,) = got.chips
        assert (chip.hbm_used_bytes, chip.hbm_total_bytes) == (
            card["memory_used_bytes"], card["memory_total_bytes"])
        assert chip.info.device_kind == CARD

    def test_answers_serve_the_same_metrics(self, tmp_path):
        spec = tmp_path / "spec.json"
        spec.write_text(json.dumps(chip_smoke.probe_spec(probe())))
        (card,) = probe()["devices"]
        fields = dict(port=0, host="127.0.0.1", backend="nvml", nvml_sim_spec=str(spec),
                      legacy_metrics=True)
        bodies = []
        for pkg in PACKAGES.values():
            app = pkg["ExporterApp"](pkg["ExporterConfig"](**fields),
                                     attribution=pkg["FakeAttribution"]([pkg["DeviceAllocation"](
                                         chip_smoke.SMOKE_POD, "smoke", "burn", (card["uuid"],),
                                         "nvidia.com/gpu")]))
            try:
                app.collector.poll_once()
                app.server.start()
                status, text = _get(f"http://127.0.0.1:{app.port}", "/metrics")
                assert status == 200
                bodies.append(text.decode())
            finally:
                app.stop()
        want, got = bodies[0].splitlines(), without_port_instrumentation(bodies[1]).splitlines()
        assert len(want) == len(got) > 100
        for want_line, got_line in zip(want, got):
            want_key, want_value = _split(want_line)
            got_key, got_value = _split(got_line)
            assert got_key == want_key
            if want_value != got_value:
                assert want_key.startswith(VOLATILE_FAMILIES), (want_line, got_line)
        for family in ("gpu_hbm_used_bytes", "gpu_utilization_percent",
                       "gpu_process_memory_used_bytes", "gpu_pod_memory_used_bytes"):
            assert f"\n{family}{{" in bodies[1], family

    def test_status_on_the_answers_names_the_pod(self, tmp_path, capsys, monkeypatch):
        """``status --json`` in node mode on the probe's answers, with a
        kubelet checkpoint that gives the card to the smoke pod (as phase 14
        runs it on the card): the port joins the card to the pod under
        ``--gpu-resource-name``. The JAX package's doctor joins under the
        TPU resource name for every backend and names no pod
        (``tpu_pod_exporter/status.py:926``), a reference defect kept there."""
        from tpu_pod_exporter import status as jax_status
        from tpu_pod_exporter_torch import status as port_status

        for var in ("TPU_ACCELERATOR_TYPE", "TPU_WORKER_ID", "TPU_SLICE_NAME"):
            monkeypatch.delenv(var, raising=False)
        spec = tmp_path / "spec.json"
        spec.write_text(json.dumps(chip_smoke.probe_spec(probe())))
        (card,) = probe()["devices"]
        kubelet = chip_smoke.kubelet_fixture(str(tmp_path), card["uuid"])
        argv = ["--backend", "nvml", "--nvml-sim-spec", str(spec), "--attribution",
                "checkpoint", "--checkpoint-path", kubelet["checkpoint_path"],
                "--uid-map-file", kubelet["uid_map_file"], "--json"]
        docs = {}
        for name, mod in (("jax", jax_status), ("port", port_status)):
            assert mod.main(argv) == 0
            docs[name] = json.loads(capsys.readouterr().out)
        (jax_chip,), (port_chip,) = docs["jax"]["chips"], docs["port"]["chips"]
        assert (port_chip["pod"], port_chip["namespace"]) == (chip_smoke.SMOKE_POD, "smoke")
        assert (jax_chip["pod"], jax_chip["namespace"]) == (None, None)
        joined = ("pod", "namespace", "container")
        assert {k: v for k, v in port_chip.items() if k not in joined} == {
            k: v for k, v in jax_chip.items() if k not in joined}
        assert port_chip["hbm_used_bytes"] == card["memory_used_bytes"]
        assert [p["pod"] for p in docs["port"]["pods"]] == [chip_smoke.SMOKE_POD]
        assert docs["jax"]["pods"] == []
