"""libtpu metrics backend tests against a scripted RuntimeMetricService
served over real gRPC (SURVEY.md §4.2: fake backends behind real seams)."""

from concurrent import futures

import grpc
import pytest

from tpu_pod_exporter_torch.backend import BackendError
from tpu_pod_exporter_torch.backend.libtpu import (
    DUTY_CYCLE,
    HBM_TOTAL,
    HBM_USAGE,
    ICI_TRANSFERRED,
    LibtpuMetricsBackend,
)
from tpu_pod_exporter_torch.backend.proto import tpu_metric_service_pb2 as pb


def metric_response(rows):
    """rows: [(device_id:int, value:float|int)]"""
    resp = pb.MetricResponse()
    for dev, value in rows:
        m = resp.metric.metrics.add()
        a = m.attribute.add()
        a.key = "device-id"
        a.value.int_attr = dev
        if isinstance(value, int):
            m.gauge.as_int = value
        else:
            m.gauge.as_double = value
    return resp


def link_response(rows, device_key="device-id", link_key="link-id",
                  link_first=False):
    """rows: [(device_id:int, link_id:int|str, value:int)] — two-attribute
    per-link rows, in either attribute order."""
    resp = pb.MetricResponse()
    for dev, link, value in rows:
        m = resp.metric.metrics.add()
        attrs = []
        d = pb.Attribute(key=device_key)
        d.value.int_attr = dev
        l = pb.Attribute(key=link_key)
        if isinstance(link, int):
            l.value.int_attr = link
        else:
            l.value.string_attr = link
        attrs = [l, d] if link_first else [d, l]
        m.attribute.extend(attrs)
        m.gauge.as_int = value
    return resp


class _FakeMetricService:
    def __init__(self):
        self.tables = {}
        self.fail_metrics = set()
        self.calls = []
        # None = serve UNIMPLEMENTED for ListSupportedMetrics (old runtime);
        # a list = enumeration returns exactly those names.
        self.supported: list | None = None
        self.list_calls = 0

    def set(self, metric_name, rows):
        self.tables[metric_name] = metric_response(rows)

    def __call__(self, request, context):
        self.calls.append(request.metric_name)
        if request.metric_name in self.fail_metrics:
            context.abort(grpc.StatusCode.UNAVAILABLE, "injected")
        if request.metric_name not in self.tables:
            context.abort(grpc.StatusCode.NOT_FOUND, "unsupported metric")
        return self.tables[request.metric_name]

    def list_supported(self, request, context):
        self.list_calls += 1
        if self.supported is None:
            context.abort(grpc.StatusCode.UNIMPLEMENTED, "old runtime")
        resp = pb.ListSupportedMetricsResponse()
        for name in self.supported:
            resp.supported_metric.add().metric_name = name
        return resp


@pytest.fixture
def metric_server(tmp_path):
    service = _FakeMetricService()
    server = grpc.server(futures.ThreadPoolExecutor(max_workers=2))
    handler = grpc.method_handlers_generic_handler(
        "tpu.monitoring.runtime.RuntimeMetricService",
        {
            "GetRuntimeMetric": grpc.unary_unary_rpc_method_handler(
                service,
                request_deserializer=pb.MetricRequest.FromString,
                response_serializer=pb.MetricResponse.SerializeToString,
            ),
            "ListSupportedMetrics": grpc.unary_unary_rpc_method_handler(
                service.list_supported,
                request_deserializer=pb.ListSupportedMetricsRequest.FromString,
                response_serializer=(
                    pb.ListSupportedMetricsResponse.SerializeToString
                ),
            ),
        },
    )
    server.add_generic_rpc_handlers((handler,))
    sock = str(tmp_path / "libtpu.sock")
    server.add_insecure_port(f"unix://{sock}")
    server.start()
    yield service, f"unix://{sock}"
    server.stop(0)


GIB = 1024**3


class TestLibtpuBackend:
    def test_full_sample(self, metric_server):
        service, addr = metric_server
        service.set(HBM_USAGE, [(0, 10 * GIB), (1, 20 * GIB)])
        service.set(HBM_TOTAL, [(0, 32 * GIB), (1, 32 * GIB)])
        service.set(DUTY_CYCLE, [(0, 55.5), (1, 0.0)])
        service.set(ICI_TRANSFERRED, [(0, 1000), (1, 2000)])
        backend = LibtpuMetricsBackend(addr=addr, device_paths={0: "/dev/accel0", 1: "/dev/accel1"})
        sample = backend.sample()
        assert len(sample.chips) == 2
        c0, c1 = sample.chips
        assert c0.info.chip_id == 0 and c0.info.device_path == "/dev/accel0"
        assert c0.hbm_used_bytes == 10 * GIB
        assert c0.hbm_total_bytes == 32 * GIB
        assert c0.tensorcore_duty_cycle_percent == 55.5
        assert c0.ici_links[0].transferred_bytes_total == 1000
        assert c1.info.device_ids == ("1",)
        assert sample.partial_errors == ()
        backend.close()

    def test_duty_cycle_failure_is_partial(self, metric_server):
        service, addr = metric_server
        service.set(HBM_USAGE, [(0, GIB)])
        service.set(HBM_TOTAL, [(0, 32 * GIB)])
        service.fail_metrics.add(DUTY_CYCLE)
        backend = LibtpuMetricsBackend(addr=addr, device_paths={})
        sample = backend.sample()
        assert len(sample.chips) == 1
        assert sample.chips[0].tensorcore_duty_cycle_percent is None
        assert len(sample.partial_errors) == 1
        backend.close()

    def test_ici_unsupported_probed_once(self, metric_server):
        service, addr = metric_server
        service.set(HBM_USAGE, [(0, GIB)])
        service.set(HBM_TOTAL, [(0, 32 * GIB)])
        service.set(DUTY_CYCLE, [(0, 1.0)])
        backend = LibtpuMetricsBackend(addr=addr, device_paths={})
        backend.sample()
        backend.sample()
        assert service.calls.count(ICI_TRANSFERRED) == 1  # not re-probed
        assert backend.sample().chips[0].ici_links == ()
        backend.close()

    def test_total_missing_for_one_device_is_none_plus_partial(
        self, metric_server
    ):
        # A device in the usage response but absent from
        # the total response must publish NO total (None → series omitted),
        # not a fake 0 — and the gap must be visible as a partial error.
        service, addr = metric_server
        service.set(HBM_USAGE, [(0, 10 * GIB), (1, 20 * GIB)])
        service.set(HBM_TOTAL, [(0, 32 * GIB)])  # device 1 missing
        service.set(DUTY_CYCLE, [(0, 1.0), (1, 2.0)])
        backend = LibtpuMetricsBackend(addr=addr, device_paths={})
        sample = backend.sample()
        c0, c1 = sample.chips
        assert c0.hbm_total_bytes == 32 * GIB
        assert c1.hbm_total_bytes is None
        assert c1.hbm_used_bytes == 20 * GIB  # usage still published
        assert any(
            "total missing" in e and "1" in e for e in sample.partial_errors
        )
        backend.close()

    def test_usage_missing_for_one_device_still_enumerates_it(
        self, metric_server
    ):
        # The symmetric case — a device served in the total
        # response but omitted from usage must not vanish from the sample
        # (chip presence drives chips/hosts_reporting downstream).
        service, addr = metric_server
        service.set(HBM_USAGE, [(0, 10 * GIB)])
        service.set(HBM_TOTAL, [(0, 32 * GIB), (1, 32 * GIB)])
        service.set(DUTY_CYCLE, [(0, 1.0), (1, 2.0)])
        backend = LibtpuMetricsBackend(addr=addr, device_paths={})
        sample = backend.sample()
        assert len(sample.chips) == 2
        c1 = sample.chips[1]
        assert c1.hbm_used_bytes is None
        assert c1.hbm_total_bytes == 32 * GIB
        assert c1.tensorcore_duty_cycle_percent == 2.0
        assert any("usage missing" in e for e in sample.partial_errors)
        backend.close()

    def test_junk_device_key_in_ici_response_is_dropped_not_enumerated(
        self, metric_server
    ):
        # A mis-parsed single-attribute ICI row (its value
        # a link id like "x+") must not fabricate a phantom chip nor flip
        # every real chip's id scheme to positional.
        service, addr = metric_server
        service.set(HBM_USAGE, [(0, GIB), (1, GIB)])
        service.set(HBM_TOTAL, [(0, 32 * GIB), (1, 32 * GIB)])
        service.set(DUTY_CYCLE, [(0, 1.0), (1, 2.0)])
        junk = pb.MetricResponse()
        m = junk.metric.metrics.add()
        a = m.attribute.add()
        a.key = "link-id"  # no device attribute at all
        a.value.string_attr = "x+"
        m.gauge.as_int = 123
        service.tables[ICI_TRANSFERRED] = junk
        backend = LibtpuMetricsBackend(
            addr=addr, device_paths={0: "/dev/accel0", 1: "/dev/accel1"}
        )
        sample = backend.sample()
        assert [c.info.chip_id for c in sample.chips] == [0, 1]
        assert sample.chips[0].info.device_path == "/dev/accel0"
        assert any("non-numeric device key" in e for e in sample.partial_errors)
        backend.close()

    def test_empty_device_key_dropped_with_partial_error(self, metric_server):
        # An attribute-less row has no identity to publish under; it is
        # dropped but must be ACCOUNTED (a silent drop is a
        # silent undercount).
        service, addr = metric_server
        resp = metric_response([(0, GIB)])
        m = resp.metric.metrics.add()  # row with no attributes at all
        m.gauge.as_int = 7
        service.tables[HBM_USAGE] = resp
        service.set(HBM_TOTAL, [(0, 32 * GIB)])
        service.set(DUTY_CYCLE, [(0, 1.0)])
        backend = LibtpuMetricsBackend(addr=addr, device_paths={})
        sample = backend.sample()
        assert [c.info.chip_id for c in sample.chips] == [0]
        assert any("empty device key" in e for e in sample.partial_errors)
        backend.close()

    def test_duty_only_device_still_enumerates(self, metric_server):
        service, addr = metric_server
        service.set(HBM_USAGE, [(0, GIB)])
        service.set(HBM_TOTAL, [(0, 32 * GIB)])
        service.set(DUTY_CYCLE, [(0, 1.0), (1, 2.0)])
        backend = LibtpuMetricsBackend(addr=addr, device_paths={})
        sample = backend.sample()
        assert len(sample.chips) == 2
        assert sample.chips[1].hbm_used_bytes is None
        assert sample.chips[1].tensorcore_duty_cycle_percent == 2.0
        backend.close()

    def test_hbm_failure_is_fatal_backend_error(self, metric_server):
        service, addr = metric_server
        service.set(HBM_TOTAL, [(0, 32 * GIB)])
        service.fail_metrics.add(HBM_USAGE)
        backend = LibtpuMetricsBackend(addr=addr, device_paths={})
        with pytest.raises(BackendError):
            backend.sample()
        backend.close()

    def test_no_service_raises_backend_error(self, tmp_path):
        backend = LibtpuMetricsBackend(
            addr=f"unix://{tmp_path}/absent.sock", timeout_s=0.2, device_paths={}
        )
        with pytest.raises(BackendError):
            backend.sample()
        backend.close()

    def test_recovers_after_service_restart(self, metric_server):
        service, addr = metric_server
        service.set(HBM_USAGE, [(0, GIB)])
        service.set(HBM_TOTAL, [(0, 32 * GIB)])
        service.set(DUTY_CYCLE, [(0, 1.0)])
        backend = LibtpuMetricsBackend(addr=addr, device_paths={})
        assert backend.sample().chips
        service.fail_metrics.update({HBM_USAGE})
        with pytest.raises(BackendError):
            backend.sample()
        service.fail_metrics.clear()
        assert backend.sample().chips
        backend.close()

    def test_ici_transient_failure_after_success_is_partial_not_latched(
        self, metric_server
    ):
        service, addr = metric_server
        service.set(HBM_USAGE, [(0, GIB)])
        service.set(HBM_TOTAL, [(0, 32 * GIB)])
        service.set(DUTY_CYCLE, [(0, 1.0)])
        service.set(ICI_TRANSFERRED, [(0, 100)])
        backend = LibtpuMetricsBackend(addr=addr, device_paths={})
        assert backend.sample().chips[0].ici_links  # supported
        service.fail_metrics.add(ICI_TRANSFERRED)
        sample = backend.sample()
        assert sample.chips[0].ici_links == ()
        assert any("ICI" in e for e in sample.partial_errors)
        service.fail_metrics.clear()
        assert backend.sample().chips[0].ici_links  # retried, not latched off
        backend.close()

    def test_ici_first_probe_transient_error_not_latched(self, metric_server):
        service, addr = metric_server
        service.set(HBM_USAGE, [(0, GIB)])
        service.set(HBM_TOTAL, [(0, 32 * GIB)])
        service.set(DUTY_CYCLE, [(0, 1.0)])
        service.set(ICI_TRANSFERRED, [(0, 100)])
        service.fail_metrics.add(ICI_TRANSFERRED)  # UNAVAILABLE ≠ unsupported
        backend = LibtpuMetricsBackend(addr=addr, device_paths={})
        sample = backend.sample()
        assert sample.chips[0].ici_links == ()
        assert any("ICI" in e for e in sample.partial_errors)
        service.fail_metrics.clear()
        assert backend.sample().chips[0].ici_links  # recovered on next poll
        backend.close()

    def test_mixed_device_ids_never_collide(self, metric_server):
        service, addr = metric_server
        resp = pb.MetricResponse()
        for dev in ("1", "x"):
            m = resp.metric.metrics.add()
            a = m.attribute.add()
            a.key = "device-id"
            a.value.string_attr = dev
            m.gauge.as_int = GIB
        service.tables[HBM_USAGE] = resp
        service.tables[HBM_TOTAL] = resp
        service.set(DUTY_CYCLE, [])
        backend = LibtpuMetricsBackend(addr=addr, device_paths={})
        sample = backend.sample()
        ids = [c.info.chip_id for c in sample.chips]
        assert len(set(ids)) == 2  # unique even with non-numeric device ids
        backend.close()

    def test_string_device_ids(self, metric_server):
        service, addr = metric_server
        resp = pb.MetricResponse()
        m = resp.metric.metrics.add()
        a = m.attribute.add()
        a.key = "device-id"
        a.value.string_attr = "7"
        m.gauge.as_int = 5 * GIB
        service.tables[HBM_USAGE] = resp
        service.set(HBM_TOTAL, [(7, 32 * GIB)])
        service.set(DUTY_CYCLE, [(7, 1.0)])
        backend = LibtpuMetricsBackend(addr=addr, device_paths={})
        sample = backend.sample()
        assert sample.chips[0].info.chip_id == 7
        assert sample.chips[0].hbm_total_bytes == 32 * GIB
        backend.close()


class TestDcnCounters:
    """DCN rides the same discovery ladder as ICI, independently."""

    def _base(self, service):
        service.set(HBM_USAGE, [(0, GIB)])
        service.set(HBM_TOTAL, [(0, 32 * GIB)])
        service.set(DUTY_CYCLE, [(0, 1.0)])

    def test_dcn_per_link_rows(self, metric_server):
        from tpu_pod_exporter_torch.backend.libtpu import DCN_TRANSFERRED

        service, addr = metric_server
        self._base(service)
        service.set(ICI_TRANSFERRED, [(0, 100)])
        service.tables[DCN_TRANSFERRED] = link_response(
            [(0, 0, 5000), (0, 1, 7000)]
        )
        backend = LibtpuMetricsBackend(addr=addr, device_paths={})
        (c0,) = backend.sample().chips
        assert [(l.link, l.transferred_bytes_total) for l in c0.dcn_links] == [
            ("0", 5000.0), ("1", 7000.0)
        ]
        assert c0.ici_links[0].transferred_bytes_total == 100.0
        backend.close()

    def test_dcn_unsupported_independently_of_ici(self, metric_server):
        from tpu_pod_exporter_torch.backend.libtpu import DCN_CANDIDATES

        service, addr = metric_server
        self._base(service)
        service.set(ICI_TRANSFERRED, [(0, 100)])  # ICI served, DCN not
        backend = LibtpuMetricsBackend(addr=addr, device_paths={})
        backend.sample()
        backend.sample()
        (c0,) = backend.sample().chips
        assert c0.ici_links and c0.dcn_links == ()
        # DCN candidates probed exactly once, then latched off.
        for name in DCN_CANDIDATES:
            assert service.calls.count(name) == 1
        backend.close()

    def test_enumeration_confirms_dcn(self, metric_server):
        from tpu_pod_exporter_torch.backend.libtpu import DCN_CANDIDATES

        service, addr = metric_server
        self._base(service)
        alt = DCN_CANDIDATES[1]
        service.supported = [HBM_USAGE, HBM_TOTAL, DUTY_CYCLE, alt]
        service.set(alt, [(0, 999)])
        backend = LibtpuMetricsBackend(addr=addr, device_paths={})
        (c0,) = backend.sample().chips
        assert c0.dcn_links[0].transferred_bytes_total == 999.0
        assert service.list_calls == 1  # shared with the ICI discovery
        backend.close()


class TestIciDiscovery:
    """ICI metric-name discovery: enumeration first, candidate probes as
    fallback (no hard-coded guessed name)."""

    def _base(self, service):
        service.set(HBM_USAGE, [(0, GIB)])
        service.set(HBM_TOTAL, [(0, 32 * GIB)])
        service.set(DUTY_CYCLE, [(0, 1.0)])

    def test_enumeration_confirms_candidate(self, metric_server):
        from tpu_pod_exporter_torch.backend.libtpu import ICI_CANDIDATES

        service, addr = metric_server
        self._base(service)
        alt = ICI_CANDIDATES[1]  # not the default guess
        service.supported = [HBM_USAGE, HBM_TOTAL, DUTY_CYCLE, alt]
        service.set(alt, [(0, 777)])
        backend = LibtpuMetricsBackend(addr=addr, device_paths={})
        sample = backend.sample()
        assert sample.chips[0].ici_links[0].transferred_bytes_total == 777
        # the wrong guesses were never queried
        assert ICI_TRANSFERRED not in service.calls
        backend.sample()
        assert service.list_calls == 1  # discovery ran once
        backend.close()

    def test_enumeration_without_ici_latches_off(self, metric_server):
        service, addr = metric_server
        self._base(service)
        service.supported = [HBM_USAGE, HBM_TOTAL, DUTY_CYCLE]
        backend = LibtpuMetricsBackend(addr=addr, device_paths={})
        backend.sample()
        backend.sample()
        assert service.list_calls == 1
        assert ICI_TRANSFERRED not in service.calls  # no blind probing
        assert backend.sample().chips[0].ici_links == ()
        backend.close()

    def test_probe_fallback_tries_candidates_in_order(self, metric_server):
        from tpu_pod_exporter_torch.backend.libtpu import ICI_CANDIDATES

        service, addr = metric_server
        self._base(service)
        alt = ICI_CANDIDATES[2]
        service.set(alt, [(0, 42)])  # enumeration UNIMPLEMENTED (default)
        backend = LibtpuMetricsBackend(addr=addr, device_paths={})
        sample = backend.sample()
        assert sample.chips[0].ici_links[0].transferred_bytes_total == 42
        # earlier candidates were each probed exactly once, then dropped
        assert service.calls.count(ICI_CANDIDATES[0]) == 1
        assert service.calls.count(ICI_CANDIDATES[1]) == 1
        backend.sample()
        assert service.calls.count(ICI_CANDIDATES[0]) == 1
        backend.close()

    def test_confirmed_name_vanishing_triggers_rediscovery(self, metric_server):
        service, addr = metric_server
        self._base(service)
        service.supported = [HBM_USAGE, HBM_TOTAL, DUTY_CYCLE, ICI_TRANSFERRED]
        service.set(ICI_TRANSFERRED, [(0, 5)])
        backend = LibtpuMetricsBackend(addr=addr, device_paths={})
        assert backend.sample().chips[0].ici_links
        del service.tables[ICI_TRANSFERRED]  # runtime swap: now NOT_FOUND
        service.supported = [HBM_USAGE, HBM_TOTAL, DUTY_CYCLE]
        assert backend.sample().chips[0].ici_links == ()
        backend.sample()
        assert service.list_calls == 2  # re-discovered once, then latched off
        backend.close()


    def test_inconsistent_runtime_does_not_flap(self, metric_server):
        # Enumeration lists the ICI name but GetRuntimeMetric NOT_FOUNDs it
        # (stale table): one vanish cycle, then latch off — no per-poll
        # rediscover/fail loop.
        service, addr = metric_server
        self._base(service)
        # Listed (alongside the really-served base metrics, so enumeration
        # passes the round-4 sanity check) but never served:
        service.supported = [HBM_USAGE, HBM_TOTAL, DUTY_CYCLE, ICI_TRANSFERRED]
        backend = LibtpuMetricsBackend(addr=addr, device_paths={})
        backend.sample()  # confirm -> query NOT_FOUND -> vanish
        backend.sample()  # rediscover without the vanished name -> latch off
        backend.sample()
        backend.sample()
        assert service.list_calls == 2  # no further discovery attempts
        assert backend.sample().chips[0].ici_links == ()
        backend.close()

    def test_probe_fallback_first_poll_queries_confirmed_name_once(
        self, metric_server
    ):
        service, addr = metric_server
        self._base(service)
        service.set(ICI_TRANSFERRED, [(0, 9)])  # enumeration UNIMPLEMENTED
        backend = LibtpuMetricsBackend(addr=addr, device_paths={})
        sample = backend.sample()
        assert sample.chips[0].ici_links[0].transferred_bytes_total == 9
        assert service.calls.count(ICI_TRANSFERRED) == 1  # probe rows reused
        backend.sample()
        assert service.calls.count(ICI_TRANSFERRED) == 2
        backend.close()


class TestProbeTool:
    def test_probe_with_enumeration(self, metric_server):
        from tpu_pod_exporter_torch.probe import probe

        service, addr = metric_server
        service.supported = [HBM_USAGE, "custom.metric"]
        service.set(HBM_USAGE, [(0, GIB), (1, 2 * GIB)])
        report = probe(addr, timeout_s=2.0)
        assert report["reachable"] is True
        assert report["supported"] == [HBM_USAGE, "custom.metric"]
        assert report["metrics"][HBM_USAGE]["rows"] == 2
        assert report["metrics"][HBM_USAGE]["attr_keys"] == ["device-id"]
        assert report["metrics"][HBM_USAGE]["gauge_types"] == ["as_int"]
        assert report["errors"]["custom.metric"].startswith("StatusCode.NOT_FOUND")

    def test_probe_without_enumeration_uses_known_names(self, metric_server):
        from tpu_pod_exporter_torch.probe import probe

        service, addr = metric_server
        service.set(HBM_USAGE, [(0, GIB)])
        report = probe(addr, timeout_s=2.0)
        assert report["reachable"] is True
        assert report["supported"] is None
        assert HBM_USAGE in report["metrics"]
        assert HBM_TOTAL in report["errors"]  # NOT_FOUND recorded, not fatal

    def test_probe_unreachable_exit_code(self, tmp_path):
        from tpu_pod_exporter_torch.probe import main

        rc = main(["--runtime", "libtpu", "--addr", f"unix://{tmp_path}/absent.sock",
                   "--timeout-s", "0.2"])
        assert rc == 2

    def test_probe_cli_writes_fixture(self, metric_server, tmp_path, capsys):
        from tpu_pod_exporter_torch.probe import main

        service, addr = metric_server
        service.supported = [HBM_USAGE]
        service.set(HBM_USAGE, [(0, GIB)])
        out = tmp_path / "fixture.json"
        rc = main(["--runtime", "libtpu", "--addr", addr, "--out", str(out)])
        assert rc == 0
        import json

        doc = json.loads(out.read_text())
        assert doc["supported"] == [HBM_USAGE]
        assert json.loads(capsys.readouterr().out) == doc

    def test_probe_string_gauge_stays_json_strict(self, metric_server):
        # A string/unset gauge must not become float NaN (json.dumps would
        # emit the non-RFC literal `NaN` into the committed fixture).
        import json

        from tpu_pod_exporter_torch.probe import probe

        service, addr = metric_server
        resp = pb.MetricResponse()
        m = resp.metric.metrics.add()
        a = m.attribute.add()
        a.key = "device-id"
        a.value.int_attr = 0
        m.gauge.as_string = "v5e"
        n = resp.metric.metrics.add()
        b = n.attribute.add()
        b.key = "device-id"
        b.value.int_attr = 1  # gauge left unset
        service.tables["chip.kind"] = resp
        service.supported = ["chip.kind"]
        report = probe(addr, timeout_s=2.0)
        text = json.dumps(report)  # strict parse must round-trip
        doc = json.loads(text)
        samples = doc["metrics"]["chip.kind"]["sample"]
        assert samples[0]["value"] == "v5e"
        assert samples[1]["value"] is None


class TestPerLinkIci:
    """Per-link ICI through the production proto path (BASELINE config 4's
    headline): two-attribute rows in either order become real
    `link` labels; single-attribute rows keep the degraded link="all"."""

    def _base(self, service):
        service.set(HBM_USAGE, [(0, GIB), (1, GIB)])
        service.set(HBM_TOTAL, [(0, 32 * GIB), (1, 32 * GIB)])
        service.set(DUTY_CYCLE, [(0, 1.0), (1, 1.0)])

    ROWS = [(0, 0, 100), (0, 1, 200), (1, 0, 300), (1, 1, 400)]

    @pytest.mark.parametrize("link_first", [False, True])
    def test_two_attribute_rows_either_order(self, metric_server, link_first):
        service, addr = metric_server
        self._base(service)
        service.tables[ICI_TRANSFERRED] = link_response(
            self.ROWS, link_first=link_first
        )
        backend = LibtpuMetricsBackend(addr=addr, device_paths={})
        sample = backend.sample()
        c0, c1 = sample.chips
        assert [(l.link, l.transferred_bytes_total) for l in c0.ici_links] == [
            ("0", 100.0), ("1", 200.0)
        ]
        assert [(l.link, l.transferred_bytes_total) for l in c1.ici_links] == [
            ("0", 300.0), ("1", 400.0)
        ]
        backend.close()

    def test_unrecognized_keys_fall_back_positionally(self, metric_server):
        service, addr = metric_server
        self._base(service)
        # Keys matching no hint: first attribute is the device, second the
        # link — the only sane default for an unknown runtime vocabulary.
        service.tables[ICI_TRANSFERRED] = link_response(
            [(0, 3, 50)], device_key="idx", link_key="lane"
        )
        backend = LibtpuMetricsBackend(addr=addr, device_paths={})
        (c0, _c1) = backend.sample().chips
        assert [(l.link, l.transferred_bytes_total) for l in c0.ici_links] == [
            ("3", 50.0)
        ]
        backend.close()

    def test_positional_fallback_logs_once(
        self, metric_server, monkeypatch, caplog
    ):
        # The silent positional assumption must leave
        # one diagnosable log line (and only one — it's the hot parse path).
        import logging

        from tpu_pod_exporter_torch.backend import libtpu as libtpu_mod

        monkeypatch.setattr(libtpu_mod, "_positional_fallback_logged", False)
        service, addr = metric_server
        self._base(service)
        service.tables[ICI_TRANSFERRED] = link_response(
            [(0, 3, 50), (1, 4, 60)], device_key="idx", link_key="lane"
        )
        backend = LibtpuMetricsBackend(addr=addr, device_paths={})
        with caplog.at_level(logging.WARNING, "tpu_pod_exporter_torch.backend.libtpu"):
            backend.sample()
            backend.sample()  # second poll: no second warning
        warnings = [
            r for r in caplog.records if "positional" in r.message
        ]
        assert len(warnings) == 1
        assert "idx" in warnings[0].message or "lane" in warnings[0].message
        backend.close()

    def test_string_link_ids(self, metric_server):
        service, addr = metric_server
        self._base(service)
        service.tables[ICI_TRANSFERRED] = link_response(
            [(0, "x+", 10), (0, "x-", 20)]
        )
        backend = LibtpuMetricsBackend(addr=addr, device_paths={})
        (c0, _c1) = backend.sample().chips
        assert {l.link for l in c0.ici_links} == {"x+", "x-"}
        backend.close()

    def test_end_to_end_link_labels_in_bandwidth_series(self, metric_server):
        """Fake gRPC server → libtpu backend → collector → per-link
        tpu_ici_link_bandwidth_bytes_per_second{link="..."}."""
        from tpu_pod_exporter_torch.attribution.fake import FakeAttribution
        from tpu_pod_exporter_torch.collector import Collector
        from tpu_pod_exporter_torch.metrics import SnapshotStore
        from tpu_pod_exporter_torch.topology import HostTopology

        service, addr = metric_server
        self._base(service)
        service.tables[ICI_TRANSFERRED] = link_response(self.ROWS)
        backend = LibtpuMetricsBackend(
            addr=addr, device_paths={0: "/dev/accel0", 1: "/dev/accel1"}
        )
        store = SnapshotStore()
        fake_now = [0.0]
        c = Collector(
            backend,
            FakeAttribution(),
            store,
            topology=HostTopology(
                accelerator="v5e-8", slice_name="s0", host="h0", worker_id="0"
            ),
            clock=lambda: fake_now[0],
        )
        c.poll_once()
        # Advance counters and the clock: 2 s, +200 bytes on dev0 link1.
        service.tables[ICI_TRANSFERRED] = link_response(
            [(0, 0, 100), (0, 1, 400), (1, 0, 300), (1, 1, 400)]
        )
        fake_now[0] += 2.0
        c.poll_once()
        snap = store.current()
        labels = {
            "chip_id": "0", "device_path": "/dev/accel0",
            "accelerator": "v5e-8", "slice_name": "s0", "host": "h0",
            "worker_id": "0", "pod": "", "namespace": "", "container": "",
            "link": "1",
        }
        assert snap.value("tpu_ici_transferred_bytes_total", labels) == 400.0
        assert snap.value("tpu_ici_link_bandwidth_bytes_per_second", labels) == 100.0
        # The degraded link="all" shape is NOT emitted when real links exist.
        assert snap.value(
            "tpu_ici_transferred_bytes_total", {**labels, "link": "all"}
        ) is None
        backend.close()


class TestEnumerationSanityCheck:
    """A wire-shape-mismatched ListSupportedMetrics parses as
    an empty/garbled list; trusting it would silently latch ICI off. The
    check: HBM_USAGE was served seconds ago, so any enumeration omitting it
    is unreliable and discovery must fall through to direct probes."""

    def _base(self, service):
        service.set(HBM_USAGE, [(0, GIB)])
        service.set(HBM_TOTAL, [(0, 32 * GIB)])
        service.set(DUTY_CYCLE, [(0, 1.0)])

    def test_empty_enumeration_falls_through_to_probe(self, metric_server):
        service, addr = metric_server
        self._base(service)
        service.supported = []  # mismatched schema parses to nothing
        service.set(ICI_TRANSFERRED, [(0, 123)])
        backend = LibtpuMetricsBackend(addr=addr, device_paths={})
        sample = backend.sample()
        # ICI survived: probe path found the metric enumeration "denied".
        assert sample.chips[0].ici_links[0].transferred_bytes_total == 123
        backend.close()

    def test_garbled_enumeration_falls_through_to_probe(self, metric_server):
        service, addr = metric_server
        self._base(service)
        service.supported = ["unrelated.metric.name"]  # omits HBM_USAGE
        service.set(ICI_TRANSFERRED, [(0, 7)])
        backend = LibtpuMetricsBackend(addr=addr, device_paths={})
        assert backend.sample().chips[0].ici_links[0].transferred_bytes_total == 7
        backend.close()

    def test_trusted_enumeration_still_avoids_blind_probes(self, metric_server):
        service, addr = metric_server
        self._base(service)
        service.supported = [HBM_USAGE, HBM_TOTAL, DUTY_CYCLE]
        backend = LibtpuMetricsBackend(addr=addr, device_paths={})
        backend.sample()
        assert ICI_TRANSFERRED not in service.calls  # enumeration trusted
        backend.close()


class TestProbeToolPerLink:
    def test_probe_records_link_attribute_in_fixture(self, metric_server):
        """A runtime serving two-attribute ICI rows must ground-truth the
        link axis into the committed fixture (attr_keys + per-row link),
        so a future real TPU VM probe captures the per-link shape."""
        import json

        from tpu_pod_exporter_torch.probe import probe

        service, addr = metric_server
        service.set(HBM_USAGE, [(0, GIB)])
        service.supported = [HBM_USAGE, ICI_TRANSFERRED]
        service.tables[ICI_TRANSFERRED] = link_response(
            [(0, 0, 11), (0, 1, 22)]
        )
        report = probe(addr, timeout_s=2.0)
        json.dumps(report)  # fixture must stay strict-JSON
        m = report["metrics"][ICI_TRANSFERRED]
        assert m["rows"] == 2
        assert m["attr_keys"] == ["device-id", "link-id"]
        assert m["sample"] == [
            {"attr": "0", "link": "0", "value": 11},
            {"attr": "0", "link": "1", "value": 22},
        ]
