"""Configuration — flags + environment, with sane defaults.

The reference hardcodes everything: port ``:8000`` (``main.go:71``), 30 s
interval (``main.go:156``), all-namespaces scope (``main.go:77``), metric
names (``main.go:24,31``). Here every knob is a flag with an ``TPE_*``
environment fallback, and backend/attribution sources are selectable at
startup — the fake backends must be reachable from the command line for the
0-device smoke config (SURVEY.md §5 "Config / flag system").
"""

from __future__ import annotations

import argparse
import os
from dataclasses import dataclass, fields
from typing import Any


@dataclass
class ExporterConfig:
    port: int = 8000
    host: str = "0.0.0.0"
    interval_s: float = 1.0
    backend: str = "auto"          # auto | fake | torch | libtpu | recorded | nvml
    attribution: str = "auto"      # auto | fake | podresources | checkpoint | none
    resource_name: str = "google.com/tpu"
    # Kubelet resource name GPU-family backends join attribution on (the
    # nvidia device plugin advertises GPUs by UUID under this name); used
    # in place of --resource-name when the backend family is "gpu".
    gpu_resource_name: str = "nvidia.com/gpu"
    fake_chips: int = 0            # chip count when backend=fake
    # Simulated NVML driver (backend=nvml without an NVIDIA driver): GPU
    # count for the default scripted tables. 0 = use the real NVML
    # binding (or --nvml-sim-spec).
    nvml_sim_gpus: int = 0
    # JSON spec for the simulated NVML driver (per-GPU memory/utilization/
    # process tables + injectable NVML error codes — see
    # backend/nvml.py:sim_driver_from_spec). Wins over --nvml-sim-gpus.
    nvml_sim_spec: str = ""
    recording_path: str = ""       # JSONL trace to replay when backend=recorded
    record_to: str = ""            # if set, record every poll's samples here
    podresources_socket: str = "/var/lib/kubelet/pod-resources/kubelet.sock"
    checkpoint_path: str = "/var/lib/kubelet/device-plugins/kubelet_internal_checkpoint"
    # UID→(name, namespace) source for the checkpoint fallback, so it can
    # emit real pod names instead of pod="uid:<uid>". File wins if both set.
    uid_map_file: str = ""         # static JSON {"<uid>": {"name","namespace"}}
    kubelet_pods_url: str = ""     # e.g. https://127.0.0.1:10250/pods
    kubelet_token_file: str = ""   # bearer token (default SA token if https)
    kubelet_ca_file: str = ""      # CA bundle; unset = skip verify (node-local)
    # Explicit opt-in to sending the bearer token over UNVERIFIED https —
    # without it, token+https+no-CA refuses at startup (credential safety).
    kubelet_insecure_tls: bool = False
    kubelet_pods_refresh_s: float = 30.0
    libtpu_metrics_addr: str = "localhost:8431"
    attribution_max_stale_s: float = 30.0
    # Source supervision (tpu_pod_exporter_torch.supervisor): hard per-phase
    # deadline for device/attribution/process-scan reads. A call that
    # exceeds it is ABANDONED (worker thread fenced off, phase degrades as
    # an error) instead of parking the poll loop inside a wedged gRPC
    # channel or hung /proc read. Default is 2x the longest source RPC
    # timeout (podresources timeout_s=2.0): a healthy-but-slow call gets
    # twice its own budget before being declared wedged. 0 disables
    # supervision entirely (direct in-thread calls, pre-supervision
    # behaviour).
    phase_deadline_s: float = 4.0
    # Circuit breaker per source: this many CONSECUTIVE failures (errors or
    # deadline abandonments) open the breaker; while open, the phase is
    # skipped (degrading as an error) until an exponential backoff+jitter
    # window elapses, then a single half-open probe runs close()+re-open()
    # on the source — a wedged channel is replaced, not retried into.
    # 0 disables the breaker (phase deadlines still apply), matching the
    # aggregator's --breaker-failures contract.
    breaker_failures: int = 3
    breaker_backoff_s: float = 1.0       # first open window; doubles per reopen
    breaker_backoff_max_s: float = 30.0  # backoff ceiling
    # Deterministic fault injection (tpu_pod_exporter_torch.chaos) — TEST ONLY.
    # e.g. "hang:device:0.01,err:attribution:0.05,slow:procscan:500ms";
    # empty = disabled. Injection schedules are reproducible per
    # (spec, chaos_seed).
    chaos_spec: str = ""
    chaos_seed: int = 0
    # End-to-end poll tracing (tpu_pod_exporter_torch.trace): every poll becomes
    # a trace with one span per phase, retained in a bounded in-memory ring
    # and exported as Chrome trace_event JSON via GET /debug/trace
    # (loopback-only by default, like every /debug/* route). On by default —
    # the measured poll-loop overhead budget is <5% (make trace-overhead);
    # --trace off restores the untraced poll path exactly.
    trace: bool = True
    # Slow-poll profiler: a poll running past this many seconds gets its
    # poll thread's (and any supervised worker's) Python stack sampled at
    # ~50 Hz for the remainder of the poll; the collapsed stacks attach to
    # the trace. 0 disables the profiler (spans still recorded).
    trace_slow_poll_s: float = 1.0
    # Bounded trace ring: oldest trace evicted past this many (same
    # hard-bound discipline as --history-max-series).
    trace_max_traces: int = 256
    # /metrics concurrency cap: excess scrapers queue briefly then get 429
    # (0 disables). Protects the TPU host's cores from scrape storms.
    max_concurrent_scrapes: int = 4
    # /metrics rate cap (token bucket, burst 2×; 0 disables): each full-body
    # scrape at 256 chips costs ~0.4 ms of pure kernel-copy CPU, so a storm
    # of them must be refused, not served. 100/s is ~20× any sane setup
    # (a few Prometheus replicas + an aggregator at 1 Hz).
    max_scrapes_per_s: float = 100.0
    # Flight-recorder history (tpu_pod_exporter_torch.history): how far back the
    # node-local /api/v1/* query endpoints can answer. 0 disables history
    # entirely (no store, endpoints 404). Per-series ring capacity is
    # retention / interval (capped at 4096 samples); worst-case memory is
    # history_max_series x capacity x 24 bytes (~59 MB at defaults, only
    # if the series cap is actually reached).
    history_retention_s: float = 300.0
    # Hard cap on stored series; the least-recently-updated series is
    # evicted beyond it (tpu_exporter_history_evicted_series_total). Sized
    # above a 256-chip host's tracked set (~4.4k: 5 per-chip gauges + 2
    # counters x 6 ICI links + pod rollups) so the worst supported shape
    # never thrashes; memory is allocated per series actually present
    # (~32 MB at 256 chips, ~0.6 MB on a v4-8 host).
    history_max_series: int = 8192
    # Multi-resolution downsample tiers behind the raw history ring:
    # comma-separated step:capacity pairs (seconds:buckets). Each bucket
    # folds counter-aware min/max/mean/first/last, so query_range answers
    # hours-old ranges at 10 s/60 s resolution from the same bounded store
    # (~48x the raw retention at the defaults, ~4x per-series memory —
    # still hard-bounded by --history-max-series). "off" disables tiering
    # (raw-ring-only, the pre-tier behaviour).
    history_tiers: str = "10:60,60:240"
    # Crash-safe state persistence (tpu_pod_exporter_torch.persist): directory
    # for the checksummed checkpoint + write-ahead log covering history
    # rings, breaker state, and the last published exposition. On boot the
    # exporter replays it (torn-write tolerant — a corrupt record truncates,
    # never refuses to start) and serves the restored exposition
    # immediately (warm start). Empty (the default) cleanly disables the
    # whole layer. In the DaemonSet, point it at a hostPath so state
    # survives pod replacement, e.g. /var/lib/tpu-pod-exporter.
    state_dir: str = ""
    # Checkpoint cadence: full state (history + breakers + exposition) is
    # rewritten atomically (write-temp, fsync, rename) this often; the WAL
    # resets after each checkpoint, bounding both restore time and WAL
    # growth.
    state_snapshot_interval_s: float = 60.0
    # WAL fsync cadence: a crash loses at most this much of the history
    # tail (plus the in-flight poll). 0 = fsync every record — the
    # strongest guarantee, affordable on local SSD (make
    # persist-fsync-check measures it).
    state_fsync_interval_s: float = 5.0
    # Remote-write egress (tpu_pod_exporter_torch.egress): push the tracked
    # metric families to a Prometheus remote-write receiver, batched per
    # snapshot swap (delta-aware), snappy-compressed, buffered through a
    # crash-safe on-disk WAL so a receiver outage or a restart drops
    # nothing. Empty (the default) disables the whole layer.
    egress_url: str = ""
    # Durable send-buffer directory (CRC-framed segments + fsynced ack
    # cursor). Required when --egress-url is set; in the DaemonSet point
    # it at a hostPath so the backlog survives pod replacement.
    egress_dir: str = "/var/lib/tpu-pod-exporter/egress"
    # Minimum seconds between egress batches: snapshots arriving faster
    # are skipped (not buffered). 0 ships every poll.
    egress_interval_s: float = 1.0
    # Backlog caps while the receiver is unreachable: oldest batches are
    # dropped (counted in tpu_exporter_egress_dropped_total{reason=
    # "backlog"}) past either bound — bounded loss by explicit policy,
    # never unbounded disk growth.
    egress_max_backlog_mb: float = 64.0
    egress_max_backlog_age_s: float = 3600.0
    # Per-send HTTP deadline: a hanging receiver costs the SENDER thread
    # at most this long per attempt; the poll path never waits on egress.
    egress_timeout_s: float = 5.0
    # Receiver circuit breaker (same contract as the source breakers):
    # this many consecutive send failures (timeout/connection/5xx/429)
    # open it; while open, batches buffer to disk and a half-open probe
    # sends a single batch after expo backoff + jitter. 0 disables the
    # breaker (every batch attempted immediately).
    egress_breaker_failures: int = 3
    egress_breaker_backoff_s: float = 1.0
    egress_breaker_backoff_max_s: float = 60.0
    # Resource-pressure governor (tpu_pod_exporter_torch.pressure): byte budget
    # across --state-dir + --egress-dir. Past it (or on any reported
    # ENOSPC/EDQUOT) the disk degradation ladder sheds by policy — WAL
    # thinning, egress compaction/backlog trim, checkpoint halving, WAL
    # off — and recovers rung by rung with hysteresis when space returns.
    # 0 = no byte budget (the ladder still reacts to reported ENOSPC).
    state_max_disk_mb: float = 0.0
    # Memory budget over the byte-accounted in-memory components (history
    # rings, trace ring, fleet query cache): past it the memory ladder
    # sheds coarse-tiers-last — fleet cache off, trace ring halved, raw
    # history rings cut. 0 disables the memory ladder entirely.
    memory_budget_mb: float = 0.0
    # Scrape-storm admission control: hard cap on concurrently OPEN
    # connections (each costs a file descriptor and loop bookkeeping,
    # even on the event loop); over-cap connections
    # get the pre-rendered 429 + Retry-After and are closed — except
    # /healthz + /readyz, which always answer. 0 disables.
    max_open_connections: int = 256
    # Per-client-IP concurrent-request cap (one aggressive scraper must
    # not monopolize the scrape/api fences for everyone else); same 429 +
    # probe-path exemption. 0 disables.
    max_requests_per_client: int = 32
    # Slow-client write defense: per-connection WRITE-PROGRESS deadline
    # on the event loop. A scraper that stalls mid-body (stuck TCP peer,
    # frozen pipe, trickle reader) makes zero write progress for this
    # many seconds and gets its connection dropped; counted in
    # tpu_exporter_client_write_timeouts_total. 0 disables. Write-only:
    # idle keep-alive connections between scrapes are unaffected, and a
    # slowly-draining client stays alive as long as bytes keep moving.
    client_write_timeout_s: float = 10.0
    # Event-loop server worker pool cap: requests that may block (an
    # uncached render, /api/v1 queries, /debug serialization) run on an
    # elastic pool of at most this many threads; the cached-bytes scrape
    # hot path never leaves the loop. The steady state is 0-1 workers —
    # this bounds the worst case (a storm of uncacheable requests), not
    # the common one.
    server_max_workers: int = 8
    # Incremental exposition render: keep a pre-rendered byte template
    # keyed by the series-layout generation and splice only changed value
    # cells per poll (plus per-encoding gzip/OpenMetrics caches invalidated
    # by splice). false restores the per-family full re-render.
    render_splice: bool = True
    # /debug/* exposure: by default debug endpoints only answer loopback
    # clients (run curl on the node). "0.0.0.0" serves them to any client
    # (the pre-round-5 behaviour); the metrics/health/api endpoints are
    # unaffected.
    debug_addr: str = "127.0.0.1"
    process_metrics: bool = False  # procfs scan: which host pids hold which chips
    proc_root: str = "/proc"       # injectable for tests / sidecar mounts
    process_full_scan_every: int = 10  # polls between full /proc walks
    legacy_metrics: bool = False   # also emit the reference's gpu_* metric names
    accelerator: str = ""          # override TPU_ACCELERATOR_TYPE
    slice_name: str = ""
    node_name: str = ""
    worker_id: str = ""
    # Multi-slice group identity override (else MEGASCALE_COORDINATOR_ADDRESS
    # from the GKE multi-slice environment); rides tpu_host_info, never
    # per-chip series.
    multislice_group: str = ""
    log_level: str = "info"
    # "text" (human console) or "json": one JSON object per line with a
    # `severity` field — the shape GKE's Cloud Logging agent parses
    # natively, so exporter WARNINGs become filterable log entries instead
    # of opaque text blobs.
    log_format: str = "text"

    @staticmethod
    def _env_default(name: str, fallback: Any) -> Any:
        raw = os.environ.get(f"TPE_{name.upper()}")
        if raw is None:
            return fallback
        if isinstance(fallback, bool):
            return raw.lower() in ("1", "true", "yes", "on")
        if isinstance(fallback, int):
            return int(raw)
        if isinstance(fallback, float):
            return float(raw)
        return raw

    @classmethod
    def from_args(cls, argv: list[str] | None = None) -> "ExporterConfig":
        defaults = cls()
        p = argparse.ArgumentParser(
            prog="tpu-pod-exporter",
            description="TPU-native per-pod device-metrics exporter for Kubernetes.",
        )
        for f in fields(cls):
            flag = "--" + f.name.replace("_", "-")
            base = getattr(defaults, f.name)
            default = cls._env_default(f.name, base)
            if isinstance(base, bool):
                # argparse type=bool is a trap: bool("false") is True. And a
                # typo ("--legacy-metrics on") must fail loudly, not parse
                # as False.
                def parse_bool(s: str) -> bool:
                    low = s.lower()
                    if low in ("1", "true", "yes", "on"):
                        return True
                    if low in ("0", "false", "no", "off"):
                        return False
                    raise argparse.ArgumentTypeError(
                        f"expected true/false, got {s!r}"
                    )

                p.add_argument(
                    flag, type=parse_bool, default=default, nargs="?", const=True
                )
            else:
                p.add_argument(flag, type=type(base), default=default)
        ns = p.parse_args(argv)
        return cls(**{f.name: getattr(ns, f.name) for f in fields(cls)})
