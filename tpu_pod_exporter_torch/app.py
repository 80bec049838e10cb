"""Wiring: config → backend + attribution → collector loop → HTTP server.

The analog of the reference's ``main()`` (``main.go:38-72``) but with
dependency injection, backend auto-detection, SIGTERM drain, and no
``log.Fatal`` anywhere on the steady-state path.
"""

from __future__ import annotations

import logging
import os
import signal
import threading
import time
from typing import Any

from tpu_pod_exporter_torch import utils
from tpu_pod_exporter_torch.attribution import AttributionProvider
from tpu_pod_exporter_torch.attribution.fake import FakeAttribution
from tpu_pod_exporter_torch.backend import DeviceBackend
from tpu_pod_exporter_torch.backend.fake import FakeBackend
from tpu_pod_exporter_torch.collector import Collector, CollectorLoop
from tpu_pod_exporter_torch.config import ExporterConfig
from tpu_pod_exporter_torch.metrics import HistogramStore, SnapshotStore
from tpu_pod_exporter_torch.metrics import schema
from tpu_pod_exporter_torch.server import MetricsServer
from tpu_pod_exporter_torch.topology import detect_host_topology

log = logging.getLogger("tpu_pod_exporter_torch.app")


# Backends whose modules this package does not carry: selecting one fails
# at construction rather than being ignored.
UNPORTED_BACKENDS = ("jax",)


def build_backend(cfg: ExporterConfig) -> DeviceBackend:
    choice = cfg.backend
    if choice == "auto":
        # Production preference on a GPU node: NVML, which reads every
        # process's device memory without opening the card. The torch
        # backend is never auto-selected: it reads only its own process's
        # allocator.
        from tpu_pod_exporter_torch.backend.discovery import local_chip_count

        if local_chip_count() > 0:
            try:
                return _build_named_backend("nvml", cfg)
            except Exception as e:  # noqa: BLE001
                # Auto-detection must degrade, not crash-loop the DaemonSet:
                # a monitoring agent that dies on init monitors nothing.
                log.error("auto-selected nvml backend unavailable (%s); "
                          "serving 0-chip surface", e)
                return FakeBackend(chips=0)
        log.info("no local GPU devices found; using 0-chip fake backend")
        return FakeBackend(chips=0)
    # Explicit selection fails fast — a typo'd flag should be loud.
    return _build_named_backend(choice, cfg)


def _maybe_record(backend: DeviceBackend, cfg: ExporterConfig) -> DeviceBackend:
    if cfg.record_to:
        from tpu_pod_exporter_torch.backend.recorded import RecordingBackend

        return RecordingBackend(backend, cfg.record_to)
    return backend


def _build_named_backend(choice: str, cfg: ExporterConfig) -> DeviceBackend:
    if choice == "recorded":
        from tpu_pod_exporter_torch.backend.recorded import RecordedBackend

        return RecordedBackend(cfg.recording_path)
    if choice == "fake":
        return FakeBackend(chips=cfg.fake_chips)
    if choice == "torch":
        from tpu_pod_exporter_torch.backend.torchdev import TorchCudaBackend

        return TorchCudaBackend()
    if choice == "libtpu":
        from tpu_pod_exporter_torch.backend.libtpu import LibtpuMetricsBackend

        return LibtpuMetricsBackend(addr=cfg.libtpu_metrics_addr)
    if choice == "nvml":
        from tpu_pod_exporter_torch.backend.nvml import (
            NvmlBackend,
            SimulatedNvmlDriver,
            sim_driver_from_spec,
        )

        driver = None
        if cfg.nvml_sim_spec:
            import json

            with open(cfg.nvml_sim_spec, encoding="utf-8") as f:
                driver = sim_driver_from_spec(json.load(f))
        elif cfg.nvml_sim_gpus > 0:
            driver = SimulatedNvmlDriver(cfg.nvml_sim_gpus)
        # driver=None → the ctypes binding to libnvidia-ml.so.1
        # (BackendError naming the sim flags when the library does not
        # load — explicit selection is loud).
        return NvmlBackend(driver=driver)
    if choice in UNPORTED_BACKENDS:
        raise ValueError(f"backend {choice!r} is not yet ported to "
                         "tpu_pod_exporter_torch (use nvml, torch, libtpu or fake)")
    raise ValueError(f"unknown backend: {choice}")


def build_attribution(cfg: ExporterConfig,
                      resource_name: str | None = None) -> AttributionProvider:
    choice = cfg.attribution
    if resource_name is None:
        resource_name = cfg.resource_name
    if choice == "auto":
        if os.path.exists(cfg.podresources_socket):
            choice = "podresources"
        elif os.path.exists(cfg.checkpoint_path):
            choice = "checkpoint"
        else:
            log.info("no kubelet attribution source found; attribution disabled")
            return FakeAttribution()
        try:
            return _build_named_attribution(choice, cfg, resource_name)
        except Exception as e:  # noqa: BLE001
            log.error("auto-selected %s attribution unavailable (%s); "
                      "attribution disabled", choice, e)
            return FakeAttribution()
    return _build_named_attribution(choice, cfg, resource_name)


def _build_named_attribution(choice: str, cfg: ExporterConfig,
                             resource_name: str | None = None) -> AttributionProvider:
    if resource_name is None:
        resource_name = cfg.resource_name
    if choice in ("fake", "none"):
        return FakeAttribution()
    if choice == "podresources":
        from tpu_pod_exporter_torch.attribution.podresources import PodResourcesAttribution

        return PodResourcesAttribution(
            socket_path=cfg.podresources_socket, resource_name=resource_name
        )
    if choice == "checkpoint":
        from tpu_pod_exporter_torch.attribution.checkpoint import CheckpointAttribution

        return CheckpointAttribution(
            path=cfg.checkpoint_path, uid_source=_build_uid_source(cfg)
        )
    raise ValueError(f"unknown attribution: {choice}")


def _build_uid_source(cfg: ExporterConfig) -> Any:
    """UID→name resolver for the checkpoint path (None = uid-keyed series).
    A static file wins over the kubelet /pods endpoint when both are set."""
    if cfg.uid_map_file:
        from tpu_pod_exporter_torch.attribution.uidmap import StaticUidMap

        return StaticUidMap(cfg.uid_map_file)
    if cfg.kubelet_pods_url:
        from tpu_pod_exporter_torch.attribution.uidmap import (
            DEFAULT_CA_FILE,
            DEFAULT_TOKEN_FILE,
            KubeletPodsUidMap,
        )

        token_file = cfg.kubelet_token_file
        ca_file = cfg.kubelet_ca_file
        if cfg.kubelet_pods_url.startswith("https:"):
            if not ca_file and os.path.exists(DEFAULT_CA_FILE):
                ca_file = DEFAULT_CA_FILE
            # Auto-default the bearer token ONLY when TLS will actually be
            # verified (CA resolved, or the operator explicitly opted out):
            # a token over unverified TLS is a leaked cluster credential.
            # Explicitly-configured tokens are policed by KubeletPodsUidMap
            # itself, which refuses the combination at startup.
            if not token_file and os.path.exists(DEFAULT_TOKEN_FILE):
                if ca_file or cfg.kubelet_insecure_tls:
                    token_file = DEFAULT_TOKEN_FILE
                else:
                    log.warning(
                        "service-account token present but no CA bundle at "
                        "%s; fetching %s WITHOUT auth rather than sending "
                        "the token over unverified TLS (set "
                        "--kubelet-ca-file or --kubelet-insecure-tls)",
                        DEFAULT_CA_FILE, cfg.kubelet_pods_url,
                    )
        return KubeletPodsUidMap(
            cfg.kubelet_pods_url,
            token_file=token_file or None,
            ca_file=ca_file or None,
            refresh_s=cfg.kubelet_pods_refresh_s,
            insecure_tls=cfg.kubelet_insecure_tls,
        )
    return None


class ExporterApp:
    """Everything needed to run (and cleanly stop) one exporter instance.

    Also the harness object for multi-instance tests: N apps with distinct
    fakes model N hosts of a v5p slice (SURVEY.md §4.4).
    """

    def __init__(
        self,
        cfg: ExporterConfig,
        backend: DeviceBackend | None = None,
        attribution: AttributionProvider | None = None,
    ) -> None:
        self.cfg = cfg
        self.store = SnapshotStore()
        self.backend = _maybe_record(
            backend if backend is not None else build_backend(cfg), cfg
        )
        # GPU-family backends join attribution on the GPU resource name
        # (nvidia.com/gpu device-plugin UUIDs) — one DaemonSet codebase,
        # the node pool's backend flag selects the family end to end.
        self.resource_name = (
            cfg.gpu_resource_name
            if getattr(self.backend, "family", "tpu") == "gpu"
            else cfg.resource_name
        )
        self.attribution = (
            attribution if attribution is not None
            else build_attribution(cfg, self.resource_name)
        )
        topo = detect_host_topology(
            accelerator=cfg.accelerator,
            slice_name=cfg.slice_name,
            host=cfg.node_name,
            worker_id=cfg.worker_id,
            multislice_group=cfg.multislice_group,
        )
        self.topology = topo  # effective (detected) values, for /debug/vars
        scanner = None
        if cfg.process_metrics:
            from tpu_pod_exporter_torch.procscan import (
                DEFAULT_DEVICE_PREFIXES,
                GPU_DEVICE_PREFIXES,
                ProcScanner,
            )

            # A GPU node's cards are /dev/nvidia<minor>, never accel/vfio.
            scanner = ProcScanner(
                proc_root=cfg.proc_root,
                device_prefixes=(
                    GPU_DEVICE_PREFIXES
                    if getattr(self.backend, "family", "tpu") == "gpu"
                    else DEFAULT_DEVICE_PREFIXES
                ),
                full_scan_every=cfg.process_full_scan_every,
            )
        self.process_scanner = scanner
        # Deterministic fault injection (TEST ONLY, --chaos-spec): wraps the
        # sources BEFORE supervision so injected hangs/errors exercise the
        # real deadline/breaker/reconnect path.
        self.chaos = {}
        if cfg.chaos_spec:
            from tpu_pod_exporter_torch.chaos import apply_chaos

            log.warning("chaos injection active (spec=%r seed=%d) — "
                        "test-only configuration", cfg.chaos_spec, cfg.chaos_seed)
            self.backend, self.attribution, scanner, self.chaos = apply_chaos(
                cfg.chaos_spec, cfg.chaos_seed,
                self.backend, self.attribution, scanner,
            )
            self.process_scanner = scanner
        # Source supervision (tpu_pod_exporter_torch.supervisor): per-phase
        # deadlines + circuit breakers + breaker-gated reconnects.
        # --phase-deadline-s 0 disables (direct in-thread calls).
        self.supervisors = {}
        if cfg.phase_deadline_s > 0:
            from tpu_pod_exporter_torch.supervisor import (
                CircuitBreaker,
                SourceSupervisor,
            )

            def _breaker() -> CircuitBreaker:
                # --breaker-failures 0 disables the breaker (same contract
                # as the aggregator flag) while keeping phase deadlines: an
                # unreachable threshold means the state machine never
                # leaves closed. Backoffs are clamped sane rather than
                # crashing startup on a zero/inverted pair.
                threshold = (
                    cfg.breaker_failures if cfg.breaker_failures > 0
                    else (1 << 30)
                )
                base = (
                    cfg.breaker_backoff_s if cfg.breaker_backoff_s > 0 else 1.0
                )
                return CircuitBreaker(
                    failure_threshold=threshold,
                    backoff_base_s=base,
                    backoff_max_s=max(cfg.breaker_backoff_max_s, base),
                )

            # Late-bound fns (lambda: self.backend...) so tests that
            # monkeypatch .sample/.snapshot on the instances keep working;
            # reconnect = close(): both gRPC clients lazily rebuild their
            # channel on the next call, so close-then-call IS the reconnect.
            self.supervisors["device"] = SourceSupervisor(
                "device",
                lambda: self.backend.sample(),
                reconnect=lambda: self.backend.close(),
                deadline_s=cfg.phase_deadline_s,
                breaker=_breaker(),
            )
            self.supervisors["attribution"] = SourceSupervisor(
                "attribution",
                lambda: self.attribution.snapshot(),
                reconnect=lambda: self.attribution.close(),
                deadline_s=cfg.phase_deadline_s,
                breaker=_breaker(),
            )
            if self.process_scanner is not None:
                self.supervisors["process_scan"] = SourceSupervisor(
                    "process_scan",
                    lambda: self.process_scanner.scan(),
                    reconnect=None,  # procfs has no channel to replace
                    deadline_s=cfg.phase_deadline_s,
                    breaker=_breaker(),
                )
        # Flight-recorder history (--history-retention-s 0 disables): ring
        # capacity is one sample per poll over the retention window, capped
        # so a sub-second interval cannot balloon the preallocation. Hard
        # memory bound: max_series x capacity x 24 bytes, allocated only
        # for series actually present (~32 MB at 256 chips; ceiling ~59 MB
        # at the 300 s / 1 s / 8192-series defaults).
        self.history = None
        if cfg.history_retention_s > 0:
            from tpu_pod_exporter_torch.history import HistoryStore, parse_tier_spec

            capacity = max(
                2, min(int(cfg.history_retention_s / cfg.interval_s) + 1, 4096)
            )
            self.history = HistoryStore(
                capacity=capacity,
                max_series=cfg.history_max_series,
                retention_s=cfg.history_retention_s,
                # Downsample tiers (--history-tiers): a bad spec must fail
                # startup loudly, same as any other malformed flag.
                tiers=parse_tier_spec(cfg.history_tiers),
            )
        # End-to-end poll tracing (tpu_pod_exporter_torch.trace): per-phase spans
        # on every poll, a slow-poll stack profiler, and a bounded trace
        # ring exported at /debug/trace. On by default (--trace off
        # disables; the collector then runs the exact untraced code path).
        self.trace = None
        self.tracer = None
        if cfg.trace:
            from tpu_pod_exporter_torch.trace import StackSampler, Tracer, TraceStore

            self.trace = TraceStore(max_traces=cfg.trace_max_traces)
            self.tracer = Tracer(
                self.trace,
                slow_poll_s=cfg.trace_slow_poll_s,
                sampler=(
                    StackSampler() if cfg.trace_slow_poll_s > 0 else None
                ),
            )
        # Crash-safe state persistence (tpu_pod_exporter_torch.persist): periodic
        # checksummed checkpoint + WAL under --state-dir covering the
        # history rings, breaker states, and the last published exposition.
        # Restored state is applied HERE, before the first poll: breakers
        # resume their quarantine, history answers across the restart, and
        # the restored exposition serves immediately (warm start).
        # --state-dir "" (the default) cleanly disables the whole layer.
        self.persister = None
        self._warm_snapshot = None
        if cfg.state_dir:
            from tpu_pod_exporter_torch.persist import (
                RestoredSnapshot,
                StatePersister,
            )

            self.persister = StatePersister(
                cfg.state_dir,
                history=self.history,
                supervisors=self.supervisors,
                # Late-bound: whatever is being served when a checkpoint
                # rotates (live snapshot, or the restored one during warm).
                exposition_fn=lambda: self.store.current(),
                snapshot_interval_s=cfg.state_snapshot_interval_s,
                fsync_interval_s=cfg.state_fsync_interval_s,
            )
            restored = self.persister.load()
            if restored.exposition:
                self._warm_snapshot = RestoredSnapshot(
                    restored.exposition, restored.exposition_ts
                )
        # Remote-write egress (tpu_pod_exporter_torch.egress): WAL-buffered push
        # shipping of the tracked families to --egress-url. The durable
        # send buffer replays at construction (a backlog left by a crash
        # resumes delivery from the fsynced ack cursor — zero loss, no
        # acked re-send). --egress-url "" (the default) disables.
        self.shipper = None
        if cfg.egress_url:
            from tpu_pod_exporter_torch.egress import (
                RemoteWriteShipper,
                build_breaker,
            )

            egress_breaker = build_breaker(
                cfg.egress_breaker_failures,
                cfg.egress_breaker_backoff_s,
                cfg.egress_breaker_backoff_max_s,
            )
            t = topo.labels()
            self.shipper = RemoteWriteShipper(
                cfg.egress_url,
                cfg.egress_dir,
                interval_s=cfg.egress_interval_s,
                timeout_s=cfg.egress_timeout_s,
                max_backlog_mb=cfg.egress_max_backlog_mb,
                max_backlog_age_s=cfg.egress_max_backlog_age_s,
                breaker=egress_breaker,
                # Label-less self-series (tpu_exporter_up) must not collide
                # across hosts in the shared receiving TSDB; series that
                # already carry topology labels keep theirs.
                extra_labels={
                    "host": t["host"],
                    "slice_name": t["slice_name"],
                },
            )
            self.shipper.load()
        # Resource-pressure governor (tpu_pod_exporter_torch.pressure): explicit
        # degradation ladders for disk (--state-max-disk-mb + reported
        # ENOSPC over the persist WAL/checkpoint and egress send buffer)
        # and memory (--memory-budget-mb over trace ring + history rings).
        # None when nothing is governable; runs on its own thread so the
        # poll loop never pays the disk-usage walk.
        from tpu_pod_exporter_torch.pressure import build_exporter_governor

        self.governor = build_exporter_governor(
            cfg,
            persister=self.persister,
            shipper=self.shipper,
            history=self.history,
            trace_store=self.trace,
        )
        # Scrape-latency distribution: handler threads observe, the
        # collector emits it into each snapshot (one poll behind, which is
        # fine for a cumulative histogram).
        scrape_hist = HistogramStore(schema.TPU_EXPORTER_SCRAPE_DURATION_HIST)
        self.collector = Collector(
            backend=self.backend,
            attribution=self.attribution,
            store=self.store,
            topology=topo,
            resource_name=self.resource_name,
            attribution_max_stale_s=cfg.attribution_max_stale_s,
            legacy_metrics=cfg.legacy_metrics,
            process_scanner=scanner,
            # Deferred attribute read: self.server is constructed below;
            # the first poll (in start()) runs after __init__ completes.
            scrape_rejects_fn=lambda: dict(self.server.scrape_rejects),
            loop_overruns_fn=lambda: self.loop.overruns,
            scrape_duration_hist=scrape_hist,
            server_timings_fn=lambda b: self.server.emit_timings(b),
            history=self.history,
            supervisors=self.supervisors,
            tracer=self.tracer,
            persister=self.persister,
            shipper=self.shipper,
            governor=self.governor,
            client_write_timeouts_fn=lambda: self.server.write_timeouts["total"],
            render_splice=cfg.render_splice,
        )
        self.loop = CollectorLoop(self.collector, interval_s=cfg.interval_s)
        # Liveness trips when the poll thread stops swapping snapshots
        # (wedged device runtime): generous multiple of the interval so slow
        # polls don't flap, floored for sub-second intervals.
        self.server = MetricsServer(
            self.store,
            host=cfg.host,
            port=cfg.port,
            debug_vars=self._debug_vars,
            health_max_age_s=max(10.0 * cfg.interval_s, 10.0),
            max_concurrent_scrapes=cfg.max_concurrent_scrapes,
            max_scrapes_per_s=cfg.max_scrapes_per_s,
            scrape_observer=scrape_hist.observe,
            history=self.history,
            trace=self.trace,
            debug_addr=cfg.debug_addr,
            live_fn=self._live_check,
            ready_detail_fn=self._ready_detail,
            client_write_timeout_s=cfg.client_write_timeout_s,
            warm_fn=self._warm_state,
            max_open_connections=cfg.max_open_connections,
            max_requests_per_client=cfg.max_requests_per_client,
            max_workers=cfg.server_max_workers,
        )

    def _warm_state(self) -> dict | None:
        """Non-None while the restored pre-restart snapshot is still what
        /metrics serves (warm start, no live poll yet); the /readyz body
        then reports state="warm" with the restored data's age."""
        snap = self._warm_snapshot
        if snap is None:
            return None
        if self.store.current() is not snap:
            # Warm period over (first live poll swapped in): release the
            # restored body and its lazy gzip/OpenMetrics caches — low-MB
            # of dead memory otherwise held for the DaemonSet pod's life.
            self._warm_snapshot = None
            return None
        return {
            "restored_poll_age_s": round(time.time() - snap.poll_timestamp, 3),
            "snapshot_stale_s": round(snap.stale_s, 3),
        }

    def _live_check(self) -> str | None:
        """Immediate liveness failure when the poll loop is truly dead (its
        one supervised restart is spent) — /healthz must not wait out
        health_max_age_s to report a thread that will never poll again."""
        if self.loop.dead:
            return (
                f"poll loop dead (thread died twice; "
                f"{self.loop.restarts} restart(s) used)"
            )
        return None

    def _ready_detail(self) -> dict:
        """Degraded-source detail for the /readyz JSON body: any source
        whose breaker has (re-)opened across several probes, plus the
        egress shipper's receiver state once it is degraded the same way.
        Detail only — the HTTP status stays governed by first-poll
        completion (a down RECEIVER must never pull the exporter out of
        rotation; its scrapes are exactly the fallback)."""
        degraded = [
            {
                "source": source,
                "breaker_state": st["state"],
                "reopens": st["reopens"],
                "abandoned": st["abandoned"],
                "reconnects": st["reconnects"],
                "next_probe_in_s": round(st["seconds_until_probe"], 3),
            }
            for source, sup in self.supervisors.items()
            if (st := sup.stats())["degraded"]
        ]
        out: dict = {"degraded_sources": degraded} if degraded else {}
        if self.shipper is not None:
            try:
                detail = self.shipper.ready_detail()
                if detail["degraded"] or detail["backlog_batches"]:
                    out["egress"] = detail
            except Exception:  # noqa: BLE001 — detail must not break probes
                pass
        return out

    def _debug_vars(self) -> dict:
        """Introspection payload for /debug/vars (SURVEY.md §5: per-phase
        tracing beyond what fits in Prometheus gauges)."""
        stats = self.collector.last_stats
        snap = self.store.current()  # bind once: series + age must agree
        out = {
            "config": {
                "interval_s": self.cfg.interval_s,
                "backend": getattr(self.backend, "name", "?"),
                "attribution": getattr(self.attribution, "name", "?"),
                "resource_name": self.resource_name,
                "max_concurrent_scrapes": self.cfg.max_concurrent_scrapes,
                "max_scrapes_per_s": self.cfg.max_scrapes_per_s,
                # Effective (detected) membership, not the raw override —
                # the GKE auto-detected case would otherwise show "".
                "multislice_group": self.topology.multislice_group,
                "num_slices": self.topology.num_slices,
            },
            "last_poll": {
                "ok": stats.ok,
                "trace_id": stats.trace_id,  # join key into /debug/trace
                "errors": list(stats.errors),
                "skipped": list(stats.skipped),
                "device_read_s": stats.device_read_s,
                "attribution_s": stats.attribution_s,
                "process_scan_s": stats.process_scan_s,
                "join_s": stats.join_s,
                "publish_s": stats.publish_s,
                "total_s": stats.total_s,
            },
            "loop_overruns": self.loop.overruns,
            "loop_restarts": self.loop.restarts,
            "loop_dead": self.loop.dead,
            "series": snap.series_count,
            "snapshot_age_s": max(time.time() - snap.timestamp, 0.0),
            "scrape_rejects": dict(self.server.scrape_rejects),
            # Event-loop serving counters (slow-client drops, inline vs
            # worker split) — the RUNBOOK's first stop for scrape-path
            # triage.
            "server": self.server.stats(),
        }
        render = self.collector.render_stats()
        if render is not None:
            # Splice-render cache: generation bumps on layout churn,
            # revision on any byte change; spliced_cells vs rebuilt_blocks
            # shows whether the incremental path is actually incremental.
            out["render"] = render
        if self.process_scanner is not None:
            out["process_scanner"] = {
                "full_scans": self.process_scanner.full_scans,
                "verify_scans": self.process_scanner.verify_scans,
            }
        if self.history is not None:
            out["history"] = self.history.stats()
        if self.persister is not None:
            from tpu_pod_exporter_torch.persist import state_dir_summary

            out["persist"] = {
                **self.persister.stats(),
                # Nested, not splatted: restore-time counts (wal_records,
                # errors) would otherwise shadow the live writer counters
                # under the same names.
                "restore": dict(self.persister.restored_info),
                "dir": state_dir_summary(self.cfg.state_dir),
                "warm": self._warm_state() is not None,
            }
        if self.shipper is not None:
            from tpu_pod_exporter_torch.egress import egress_dir_summary

            out["egress"] = {
                **self.shipper.stats(),
                "dir": egress_dir_summary(self.cfg.egress_dir),
            }
        if self.governor is not None:
            out["pressure"] = {
                **self.governor.stats(),
                # The per-component byte breakdown the memory ladder's
                # shed decision sums — same numbers, one source.
                "memory_components": self.governor.memory_component_bytes(),
            }
        out["client_write_timeouts"] = self.server.write_timeouts["total"]
        out["connections"] = dict(self.server.conn_stats)
        if self.trace is not None:
            out["trace"] = self.trace.stats()
        if self.supervisors:
            out["supervisors"] = {
                source: sup.stats() for source, sup in self.supervisors.items()
            }
        if self.chaos:
            out["chaos"] = {
                source: {"calls": w.calls, "injected": w.injected[-50:]}
                for source, w in self.chaos.items()
            }
        return out

    @property
    def port(self) -> int:
        return self.server.port

    def start(self) -> None:
        if self.governor is not None:
            self.governor.start()
        if self.persister is not None:
            self.persister.start()
        if self.shipper is not None:
            # Before the first poll: a restart with a backlog starts
            # draining immediately, even while the first live poll runs.
            self.shipper.start()
        if self._warm_snapshot is not None:
            # Warm start: serve the restored exposition IMMEDIATELY and let
            # the first live poll run on the loop thread — blocking serving
            # on a first poll against a possibly-still-wedged source is
            # exactly the gap persistence exists to close. /readyz reports
            # "warm" until the loop's first snapshot swap replaces it.
            warm = self._warm_snapshot
            self.store.swap(warm)
            log.info(
                "warm start: serving restored exposition (%.1fs stale, "
                "%d series) while the first live poll runs",
                warm.stale_s, warm.series_count,
            )
            self.loop.start()
            self.server.start()

            # Release the restored body (plus its lazy gzip/OpenMetrics
            # caches — low-MB at 256 chips) as soon as the first live poll
            # swaps it out. A watcher thread, not an HTTP-path hook: with
            # no kubelet probing /readyz the memory would otherwise stay
            # pinned for the process lifetime. Exits after one live poll.
            def _release_warm() -> None:
                poll_s = min(max(self.cfg.interval_s, 0.05), 1.0)
                while self.store.current() is warm and not self.loop.dead:
                    time.sleep(poll_s)
                if self.store.current() is not warm:
                    self._warm_snapshot = None
                # else: the loop died while still warm — keep the warm
                # marker truthful (readyz stays "warm"); /healthz's dead-
                # loop 503 is already driving a pod restart.

            threading.Thread(
                target=_release_warm, name="tpu-exporter-warm-release",
                daemon=True,
            ).start()
        else:
            # Cold start: first poll synchronously so /readyz flips as soon
            # as we listen.
            self.collector.poll_once()
            self.loop.start()
            self.server.start()
        log.info("serving on :%d every %.3fs", self.port, self.cfg.interval_s)

    def stop(self) -> None:
        self.loop.stop()
        self.server.stop()
        self.collector.close()
        if self.persister is not None:
            # SIGTERM drain: final fsynced checkpoint (history + breakers +
            # the exposition being served), so a rolling update warm-starts
            # with zero staleness. After loop.stop() no poll can enqueue.
            self.persister.close()
        if self.shipper is not None:
            # Undelivered batches stay durably buffered; the restarted
            # process resumes them from the ack cursor (no drain wait — a
            # down receiver must not stall the SIGTERM grace period).
            self.shipper.close()
        if self.governor is not None:
            self.governor.close()
        if self.tracer is not None:
            self.tracer.close()


def main(argv: list[str] | None = None) -> int:
    cfg = ExporterConfig.from_args(argv)
    utils.setup_logging(cfg.log_level, cfg.log_format)
    app = ExporterApp(cfg)
    stop = threading.Event()

    def _on_signal(signum: int, frame: object) -> None:  # noqa: ARG001
        log.info("signal %d: draining", signum)
        stop.set()

    # Real SIGTERM drain for DaemonSet rolling updates (reference has none —
    # its only exits are log.Fatalf/panic, SURVEY.md §3.4).
    signal.signal(signal.SIGTERM, _on_signal)
    signal.signal(signal.SIGINT, _on_signal)

    app.start()
    stop.wait()
    app.stop()
    return 0
