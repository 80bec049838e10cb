"""libtpu runtime-metrics backend — the production telemetry path.

TPU-native replacement for the reference's NVML layer (``main.go:116-138``):
instead of cgo ioctls into a driver library, this reads the libtpu runtime's
local gRPC metrics service (the endpoint ``tpu-info`` uses, default
``localhost:8431``). Crucially it never opens ``/dev/accel*`` itself — the
TPU runtime lock stays with the workload pod, and the exporter stays a pure
observer.

Metric names queried (the public libtpu names):
  - ``tpu.runtime.hbm.memory.usage.bytes``    (per chip)
  - ``tpu.runtime.hbm.memory.total.bytes``    (per chip)
  - ``tpu.runtime.tensorcore.dutycycle.percent`` (per chip)

All three are fetched in one poll; each response row carries a device-id
attribute, and ICI counter rows may additionally carry a link attribute
(either attribute order) which becomes the per-link ``link`` label —
the degraded single-attribute shape exports ``link="all"``.
Any RPC failure, parse surprise, or shape mismatch raises
BackendError (total) or is reported via ``HostSample.partial_errors``
(per-metric) — the collector degrades instead of dying (contrast the
reference's ``log.Fatalf`` per query, ``main.go:119-137``).
"""

from __future__ import annotations

import logging
import threading

from tpu_pod_exporter_torch.backend import (
    BackendError,
    ChipInfo,
    ChipSample,
    DeviceBackend,
    HostSample,
    IciLinkSample,
)

log = logging.getLogger("tpu_pod_exporter_torch.backend.libtpu")

DEFAULT_ADDR = "localhost:8431"

HBM_USAGE = "tpu.runtime.hbm.memory.usage.bytes"
HBM_TOTAL = "tpu.runtime.hbm.memory.total.bytes"
DUTY_CYCLE = "tpu.runtime.tensorcore.dutycycle.percent"
# Optional — not all runtime versions export ICI counters, and the exact
# public name is unconfirmed until probed on real hardware.
# Candidates are tried in order: first via ListSupportedMetrics when the
# runtime implements it, else by direct GetRuntimeMetric probes; the first
# hit is remembered for the life of the backend.
ICI_TRANSFERRED = "tpu.runtime.ici.transferred.bytes"
ICI_CANDIDATES = (
    ICI_TRANSFERRED,
    "tpu.runtime.ici.traffic.bytes",
    "tpu.runtime.interconnect.transferred.bytes",
    "megascale.ici.transferred.bytes",
)
# DCN (data-center network — the cross-slice fabric of a GKE multi-slice
# deployment, BASELINE config 5) rides the same discovery ladder as ICI:
# the exact public name is unconfirmed until probed on real multi-slice
# hardware, so candidates are tried via enumeration, then direct probes.
DCN_TRANSFERRED = "tpu.runtime.dcn.transferred.bytes"
DCN_CANDIDATES = (
    DCN_TRANSFERRED,
    "tpu.runtime.dcn.traffic.bytes",
    "megascale.dcn.transferred.bytes",
)

GET_METRIC_METHOD = "/tpu.monitoring.runtime.RuntimeMetricService/GetRuntimeMetric"
LIST_METRICS_METHOD = (
    "/tpu.monitoring.runtime.RuntimeMetricService/ListSupportedMetrics"
)


def gauge_value(metric) -> float:
    which = metric.gauge.WhichOneof("value")
    if which == "as_int":
        return float(metric.gauge.as_int)
    if which == "as_double":
        return float(metric.gauge.as_double)
    if which == "as_string":
        try:
            return float(metric.gauge.as_string)
        except ValueError:
            return float("nan")
    return float("nan")


def attr_str(value) -> str:
    which = value.WhichOneof("attr")
    if which == "int_attr":
        return str(value.int_attr)
    if which == "string_attr":
        return value.string_attr
    return ""


# Attribute-key substrings that identify which attribute on a metric row is
# the device id vs the ICI link id. Matched case-insensitively so both
# "device-id" and "DeviceId" shapes resolve; per-link rows may carry the two
# attributes in either order.
DEVICE_ATTR_HINTS = ("device", "chip", "core", "accel")
LINK_ATTR_HINTS = ("link", "port", "direction", "neighbor", "axis")

# One-shot guard for the positional-fallback warning below: the fallback
# engaging on a real runtime means its attribute keys matched no hint, and
# a mis-labeled device/link axis would otherwise be undiagnosable from the
# exported series alone. Per-process, not per-row —
# the fallback runs on the hottest parse path.
_positional_fallback_logged = False


def split_attrs(metric) -> tuple[str, str | None]:
    """One metric row's attributes → (device_id, link_id-or-None).

    Historical rows carry exactly one attribute (the device id). Per-link
    ICI counters (BASELINE config 4's headline) carry a device attribute
    plus a link attribute — accepted in either order by matching attribute
    *keys*, with a positional fallback (first=device, second=link) for a
    runtime whose key names match no hint. Contrast the reference, which
    only ever walks one implicit device axis (main.go:123-138).
    """
    attrs = metric.attribute
    if len(attrs) == 1:
        return attr_str(attrs[0].value), None
    if not attrs:
        return "", None
    dev: str | None = None
    link: str | None = None
    rest = []
    for a in attrs:
        k = a.key.lower()
        if dev is None and any(h in k for h in DEVICE_ATTR_HINTS):
            dev = attr_str(a.value)
        elif link is None and any(h in k for h in LINK_ATTR_HINTS):
            link = attr_str(a.value)
        else:
            rest.append(a)
    if rest and (dev is None or link is None):
        global _positional_fallback_logged
        if not _positional_fallback_logged:
            _positional_fallback_logged = True
            log.warning(
                "metric attribute key(s) %s matched no device/link hint; "
                "assuming positional order (first=device, second=link) — "
                "verify labels against the runtime's real key names",
                [a.key for a in rest],
            )
    if dev is None and rest:
        dev = attr_str(rest.pop(0).value)
    if link is None and rest:
        link = attr_str(rest[0].value)
    return dev or "", link


def rows_by_device(resp) -> dict[str, float]:
    """MetricResponse → {device_id_attr: value} (per-device metrics)."""
    out: dict[str, float] = {}
    for m in resp.metric.metrics:
        dev, _ = split_attrs(m)
        out[dev] = gauge_value(m)
    return out


def ici_rows(resp) -> dict[str, dict[str, float]]:
    """MetricResponse → {device_id: {link_id: value}}.

    Rows without a link attribute land under link "all" — the degraded
    per-chip-aggregate shape older runtimes serve (and the only shape the
    shape a singular attribute field could carry).
    """
    out: dict[str, dict[str, float]] = {}
    for m in resp.metric.metrics:
        dev, link = split_attrs(m)
        out.setdefault(dev, {})[link if link is not None else "all"] = gauge_value(m)
    return out


class _CounterDiscovery:
    """Discovery-ladder state for one optional per-link counter family.

    ``metric``: None = unprobed; False = affirmatively unsupported; str =
    the confirmed metric name to query every poll. ``vanished``: names that
    were confirmed and then NOT_FOUND on query (stale enumeration table /
    runtime swap) — excluded from rediscovery so an inconsistent runtime
    can't flap discover→fail every poll.
    """

    __slots__ = ("kind", "candidates", "metric", "vanished")

    def __init__(self, kind: str, candidates: tuple[str, ...]) -> None:
        self.kind = kind
        self.candidates = candidates
        self.metric: str | None | bool = None
        self.vanished: set[str] = set()


class LibtpuMetricsBackend(DeviceBackend):
    name = "libtpu"

    def __init__(
        self,
        addr: str = DEFAULT_ADDR,
        timeout_s: float = 1.0,
        device_paths: dict[int, str] | None = None,
    ) -> None:
        import grpc

        from tpu_pod_exporter_torch.backend.proto import tpu_metric_service_pb2 as pb

        self._grpc = grpc
        self._pb = pb
        self._addr = addr
        self._timeout_s = timeout_s
        self._lock = threading.Lock()
        self._channel = None
        self._get = None
        self._list = None
        # One discovery-ladder state per optional per-link counter family
        # (ICI and DCN share the machinery; each confirms independently).
        self._ici_disc = _CounterDiscovery("ICI", ICI_CANDIDATES)
        self._dcn_disc = _CounterDiscovery("DCN", DCN_CANDIDATES)
        if device_paths is None:
            import re

            from tpu_pod_exporter_torch.backend.discovery import list_tpu_device_paths

            device_paths = {}
            for i, p in enumerate(list_tpu_device_paths()):
                if "/vfio/" in p:
                    # vfio group numbers are kernel-assigned and unrelated to
                    # runtime device ids — key positionally.
                    device_paths[i] = p
                else:
                    # accelN → N: runtime device ids follow the node
                    # numbering even when it is not 0-based contiguous.
                    m = re.search(r"(\d+)$", p)
                    device_paths[int(m.group(1)) if m else i] = p
        self._device_paths = device_paths

    def _ensure_channel(self) -> None:
        with self._lock:
            if self._channel is not None:
                return
            self._channel = self._grpc.insecure_channel(
                self._addr, options=[("grpc.enable_http_proxy", 0)]
            )
            self._get = self._channel.unary_unary(
                GET_METRIC_METHOD,
                request_serializer=self._pb.MetricRequest.SerializeToString,
                response_deserializer=self._pb.MetricResponse.FromString,
            )
            self._list = self._channel.unary_unary(
                LIST_METRICS_METHOD,
                request_serializer=(
                    self._pb.ListSupportedMetricsRequest.SerializeToString
                ),
                response_deserializer=(
                    self._pb.ListSupportedMetricsResponse.FromString
                ),
            )

    def query_raw(self, metric_name: str, timeout_s: float | None = None):
        """Public raw GetRuntimeMetric — returns the MetricResponse message.
        The probe tool builds on this so the RPC plumbing has one owner."""
        self._ensure_channel()
        return self._get(
            self._pb.MetricRequest(metric_name=metric_name),
            timeout=self._timeout_s if timeout_s is None else timeout_s,
        )

    def _query(self, metric_name: str) -> dict[str, float]:
        return rows_by_device(self.query_raw(metric_name))

    def _query_ici(self, metric_name: str) -> dict[str, dict[str, float]]:
        return ici_rows(self.query_raw(metric_name))

    def list_supported_metrics(self) -> list[str] | None:
        """Names the runtime serves, or None when the runtime does not
        implement the enumeration RPC (older libtpu)."""
        self._ensure_channel()
        try:
            resp = self._list(
                self._pb.ListSupportedMetricsRequest(), timeout=self._timeout_s
            )
        except self._grpc.RpcError as e:
            if e.code() in (
                self._grpc.StatusCode.UNIMPLEMENTED,
                self._grpc.StatusCode.NOT_FOUND,
            ):
                return None
            raise
        return [m.metric_name for m in resp.supported_metric]

    def _resolve_counter(self, disc: "_CounterDiscovery", get_supported):
        """One-time discovery of one counter family's real name. Sets
        ``disc.metric`` to the confirmed name, or False when the runtime
        affirmatively serves none of the candidates. Returns the metric
        rows when discovery already fetched them (the probe path), so the
        first poll doesn't issue the same RPC twice. Raises on transient
        errors (leaves the probe un-latched for the next poll). Names in
        ``disc.vanished`` are excluded — see _CounterDiscovery.
        ``get_supported`` memoizes the enumeration RPC so ICI and DCN
        resolving in the same poll share one ListSupportedMetrics call."""
        candidates = [n for n in disc.candidates if n not in disc.vanished]
        supported = get_supported()
        if supported is not None and HBM_USAGE not in supported:
            # Sanity check before trusting enumeration: sample() queried
            # HBM_USAGE successfully moments ago, so a list omitting it
            # means the RPC exists but its wire shape differs from our
            # guessed proto (proto3 parses a mismatched response as empty,
            # not as an error). Trusting it would silently latch the
            # counter off on a runtime that serves it — fall through to
            # direct probes.
            log.warning(
                "ListSupportedMetrics omitted %s (just served); treating "
                "enumeration as unreliable and probing candidates directly",
                HBM_USAGE,
            )
            supported = None
        if supported is not None:
            for name in candidates:
                if name in supported:
                    disc.metric = name
                    log.info(
                        "%s counter confirmed via enumeration: %s",
                        disc.kind, name,
                    )
                    return None
            # Nothing named like our candidates; surface what looked close
            # so an operator can extend the candidate list from the logs.
            needle = disc.kind.lower()
            kindish = [n for n in supported if needle in n.lower()]
            log.info(
                "no known %s counter in %d supported metrics%s",
                disc.kind, len(supported),
                f"; {needle}-like names: {kindish}" if kindish else "",
            )
            disc.metric = False
            return None
        # No enumeration RPC: probe candidates directly.
        for name in candidates:
            try:
                rows = self._query_ici(name)
                disc.metric = name
                log.info("%s counter confirmed by probe: %s", disc.kind, name)
                return rows
            except self._grpc.RpcError as e:
                if e.code() in (
                    self._grpc.StatusCode.NOT_FOUND,
                    self._grpc.StatusCode.UNIMPLEMENTED,
                    self._grpc.StatusCode.INVALID_ARGUMENT,
                ):
                    continue  # affirmatively not this name; try the next
                raise  # transient — retry the whole probe next poll
        log.info(
            "%s counters unsupported by this runtime (all candidates)",
            disc.kind,
        )
        disc.metric = False
        return None

    def _sample_counter(
        self, disc: "_CounterDiscovery", partial: list[str], get_supported
    ) -> dict[str, dict[str, float]]:
        """One poll's rows for one optional counter family: resolve on
        first contact, then query the confirmed name, handling vanish
        (re-probe without the liar) and transient errors (surface, keep)."""
        rows: dict[str, dict[str, float]] = {}
        discovered_rows = None
        if disc.metric is None:
            try:
                discovered_rows = self._resolve_counter(disc, get_supported)
            except Exception as e:  # noqa: BLE001 — transient: retry next poll
                partial.append(f"{disc.kind} discovery failed: {e}")
        if isinstance(disc.metric, str):
            if discovered_rows is not None:
                rows = discovered_rows  # probe already fetched this poll's rows
            else:
                try:
                    rows = self._query_ici(disc.metric)
                except Exception as e:  # noqa: BLE001
                    code = getattr(e, "code", lambda: None)()
                    if code in (
                        self._grpc.StatusCode.NOT_FOUND,
                        self._grpc.StatusCode.UNIMPLEMENTED,
                        self._grpc.StatusCode.INVALID_ARGUMENT,
                    ):
                        # The runtime stopped serving the confirmed name
                        # (runtime swap, or a stale enumeration table):
                        # rediscover next poll, excluding this name so an
                        # inconsistent runtime can't flap forever.
                        log.info(
                            "confirmed %s metric vanished; re-probing "
                            "without it: %s", disc.kind, e,
                        )
                        disc.vanished.add(disc.metric)
                        disc.metric = None
                    else:
                        # Transient (timeout/unavailable) — keep the
                        # confirmed name, surface the failure.
                        partial.append(f"{disc.kind} query failed: {e}")
        return rows

    def sample(self) -> HostSample:
        partial: list[str] = []
        try:
            usage = self._query(HBM_USAGE)
            total = self._query(HBM_TOTAL)
        except self._grpc.RpcError as e:
            self._reset_channel()
            raise BackendError(f"libtpu metrics RPC failed: {e.code()}") from e
        except Exception as e:  # noqa: BLE001
            self._reset_channel()
            raise BackendError(f"libtpu metrics query failed: {e}") from e

        try:
            duty = self._query(DUTY_CYCLE)
        except Exception as e:  # noqa: BLE001 — HBM without duty is degraded, not down
            duty = {}
            partial.append(f"duty-cycle query failed: {e}")

        enum_memo: list = []  # one ListSupportedMetrics shared per poll

        def get_supported():
            if not enum_memo:
                enum_memo.append(self.list_supported_metrics())
            return enum_memo[0]

        ici = self._sample_counter(self._ici_disc, partial, get_supported)
        dcn = self._sample_counter(self._dcn_disc, partial, get_supported)

        chips: list[ChipSample] = []
        # Enumerate the UNION of every response's device axis, not just the
        # usage response: a device the runtime omits from one metric but
        # serves in another must still exist (chip_info presence, the
        # series that WERE read) — vanishing silently would undercount
        # chips/hosts_reporting downstream. But the HBM
        # axes are authoritative: a junk key from the optional responses
        # (a mis-parsed link id, an empty attribute) must not fabricate a
        # phantom chip or flip every real chip's id scheme to positional,
        # so when the HBM devices are all-numeric, non-numeric duty/ICI
        # extras are dropped with a partial error instead of enumerated.
        devices = set(usage) | set(total)
        aux = (set(duty) | set(ici) | set(dcn)) - devices
        if "" in devices or "" in aux:
            # An attribute-less row has no device identity to publish under;
            # dropping it silently would be the same unaccounted undercount
            # as the non-numeric junk below — record it.
            partial.append("dropping metric row(s) with empty device key")
            devices.discard("")
            aux.discard("")
        if devices and all(d.isdigit() for d in devices):
            junk = sorted(d for d in aux if not d.isdigit())
            if junk:
                partial.append(
                    "ignoring non-numeric device key(s) in duty/ICI "
                    "responses: " + ",".join(junk)
                )
                aux.difference_update(junk)
        devices |= aux
        ordered = sorted(devices, key=_dev_sort_key)
        # A device absent from the usage (or total) response gets None for
        # that field (series omitted), NOT 0.0 — a zero we didn't read is a
        # lie (main.go:129-132 never exports an unread value), and a fake
        # value poisons used_percent. Both directions are partial errors.
        missing_total = [d for d in ordered if d in usage and d not in total]
        missing_usage = [d for d in ordered if d not in usage and d in total]
        if missing_total:
            partial.append(
                "HBM total missing for device(s) "
                + ",".join(missing_total)
                + " (present in usage response)"
            )
        if missing_usage:
            partial.append(
                "HBM usage missing for device(s) "
                + ",".join(missing_usage)
                + " (present in total response)"
            )
        # chip_id must be unique per chip: use the runtime's numeric device
        # ids when ALL ids are numeric (the normal case — they match the GKE
        # device-plugin ids and the /dev/accel index); otherwise fall back to
        # enumeration order for every chip so ids can never collide.
        all_numeric = all(d.isdigit() for d in ordered)
        for pos, dev_id in enumerate(ordered):
            idx = int(dev_id) if all_numeric else pos
            # Per-link rows when the runtime serves a link attribute (link
            # id order stabilized for the collector's layout fast-path); a
            # single aggregate row degrades to link="all".
            links = _links_from_rows(ici.get(dev_id))
            dcn_links = _links_from_rows(dcn.get(dev_id))
            chips.append(
                ChipSample(
                    info=ChipInfo(
                        chip_id=idx,
                        device_path=self._device_paths.get(idx, ""),
                        device_ids=(dev_id,),
                    ),
                    hbm_used_bytes=usage.get(dev_id),
                    hbm_total_bytes=total.get(dev_id),
                    tensorcore_duty_cycle_percent=duty.get(dev_id),
                    ici_links=links,
                    dcn_links=dcn_links,
                )
            )
        return HostSample(chips=tuple(chips), partial_errors=tuple(partial))

    def _reset_channel(self) -> None:
        with self._lock:
            if self._channel is not None:
                try:
                    self._channel.close()
                except Exception:  # noqa: BLE001
                    pass
            self._channel = None
            self._get = None
            self._list = None

    def close(self) -> None:
        self._reset_channel()


def _links_from_rows(rows: dict[str, float] | None) -> tuple:
    """{link id: counter} rows for one device → sorted IciLinkSample tuple
    (numeric-first order — shared by the ICI and DCN paths)."""
    if not rows:
        return ()
    return tuple(
        IciLinkSample(link=lk, transferred_bytes_total=v)
        for lk, v in sorted(rows.items(), key=_link_sort_key)
    )


def _dev_sort_key(dev_id: str):
    try:
        return (0, int(dev_id))
    except ValueError:
        return (1, dev_id)


def _link_sort_key(item: tuple[str, float]):
    return _dev_sort_key(item[0])
