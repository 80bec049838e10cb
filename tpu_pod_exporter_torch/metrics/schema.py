"""The ``tpu_*`` metric schema — the exporter's public contract.

Replaces the reference's two inconsistently-named gauges
(``pod_gpu_memory_usage`` / ``docker_gpu_memory_perc_usage``,
``main.go:21-36``) with a consistent ``tpu_`` namespace, and fixes the
reference's label-schema defects:

- adds ``chip_id`` — the reference has no device label, so two processes of
  one pod on different devices collapse into one series
  (``main.go:123-155``);
- adds ``namespace`` — the reference keys only by pod name, so equal names
  in different namespaces collide (``main.go:113``);
- adds ``container`` — the reference harvests per-container but never
  attributes per-container (``main.go:92-110``);
- adds slice/host topology labels for multi-host aggregation in Prometheus
  (cross-host rollups are label joins, not exporter-to-exporter traffic).

Semantic shift, documented rather than faked: NVML reports *per-process*
device memory (``main.go:135,147``); TPU runtimes pin whole chips to one
container, so the honest TPU analog is per-chip metrics labeled with the
owning pod. Core chip metrics carry no ``pid`` label by design; the
per-process dimension lives in :data:`TPU_CHIP_PROCESS_INFO`, fed by the
procfs scanner with *correct* host PIDs (unlike the reference's broken
container-PID join, SURVEY.md §2.6).
"""

from __future__ import annotations

from tpu_pod_exporter_torch.metrics.registry import (
    COUNTER,
    GAUGE,
    HistogramSpec,
    MetricSpec,
)

# Labels identifying one chip on one host, plus its pod attribution and the
# slice topology it belongs to. Empty-string pod/namespace/container means
# "chip not allocated to any pod" — per-chip hardware series exist regardless
# of attribution.
CHIP_LABELS: tuple[str, ...] = (
    "chip_id",        # stable per-host chip index, e.g. "0".."3" on v4-8
    "device_path",    # e.g. /dev/accel0 (or vfio path); "" for fakes
    "accelerator",    # accelerator type, e.g. "v5p-64"
    "slice_name",     # GKE TPU slice / nodepool identity
    "host",           # node/host name
    "worker_id",      # worker index within a multi-host slice
    "pod",
    "namespace",
    "container",
)

ICI_LABELS: tuple[str, ...] = CHIP_LABELS + ("link",)

# --- Device metrics (analog of main.go:147-150, redesigned) -----------------

TPU_HBM_USED_BYTES = MetricSpec(
    name="tpu_hbm_used_bytes",
    help="High-bandwidth memory in use on this TPU chip, in bytes.",
    type=GAUGE,
    label_names=CHIP_LABELS,
)

TPU_HBM_TOTAL_BYTES = MetricSpec(
    name="tpu_hbm_total_bytes",
    help="Total high-bandwidth memory capacity of this TPU chip, in bytes.",
    type=GAUGE,
    label_names=CHIP_LABELS,
)

# Percent analog of docker_gpu_memory_perc_usage (main.go:149-150), per chip.
TPU_HBM_USED_PERCENT = MetricSpec(
    name="tpu_hbm_used_percent",
    help="Percent of this TPU chip's HBM capacity currently in use (0-100).",
    type=GAUGE,
    label_names=CHIP_LABELS,
)

TPU_HBM_PEAK_BYTES = MetricSpec(
    name="tpu_hbm_peak_bytes",
    help="Allocator high-water mark of HBM use on this chip since runtime start (absent when the backend cannot report it).",
    type=GAUGE,
    label_names=CHIP_LABELS,
)

# Hardware identity, emitted when the backend knows it (jaxdev reports
# device_kind and torus coords; the libtpu metrics service does not).
TPU_CHIP_INFO = MetricSpec(
    name="tpu_chip_info",
    help="Static chip identity; value is always 1. coords is the chip's torus position (x,y,z). Published for every chip each round (possibly with empty kind/coords) — the guaranteed per-chip presence series that slice rollups count chips from, since tpu_hbm_* may be absent on backends that cannot read HBM.",
    type=GAUGE,
    label_names=CHIP_LABELS + ("device_kind", "coords"),
)

TPU_TENSORCORE_DUTY_CYCLE_PERCENT = MetricSpec(
    name="tpu_tensorcore_duty_cycle_percent",
    help="Percent of time the chip's TensorCore was busy over the last sample window (0-100).",
    type=GAUGE,
    label_names=CHIP_LABELS,
)

# --- ICI (inter-chip interconnect) metrics ----------------------------------

TPU_ICI_LINK_BANDWIDTH_BYTES_PER_SECOND = MetricSpec(
    name="tpu_ici_link_bandwidth_bytes_per_second",
    help="Observed ICI traffic rate on one inter-chip link since the previous poll.",
    type=GAUGE,
    label_names=ICI_LABELS,
)

TPU_ICI_TRANSFERRED_BYTES_TOTAL = MetricSpec(
    name="tpu_ici_transferred_bytes_total",
    help="Cumulative bytes transferred over one inter-chip link.",
    type=COUNTER,
    label_names=ICI_LABELS,
)

# --- DCN (data-center network — cross-slice fabric, multi-slice) -------------
# Same per-link shape as ICI. Absent entirely (no series) on runtimes that
# serve no DCN counters — single-slice deployments never see these.

TPU_DCN_LINK_BANDWIDTH_BYTES_PER_SECOND = MetricSpec(
    name="tpu_dcn_link_bandwidth_bytes_per_second",
    help="Observed DCN (cross-slice network) traffic rate on one link since the previous poll.",
    type=GAUGE,
    label_names=ICI_LABELS,
)

TPU_DCN_TRANSFERRED_BYTES_TOTAL = MetricSpec(
    name="tpu_dcn_transferred_bytes_total",
    help="Cumulative bytes transferred over one DCN (cross-slice network) link.",
    type=COUNTER,
    label_names=ICI_LABELS,
)

# --- Per-process holders (procfs scanner; --process-metrics) -----------------

# pid/comm/pod_uid come from /proc: the process that holds the chip's device
# file open and its cgroup-derived pod UID. This is the honest TPU analog of
# the reference's per-process NVML dimension (main.go:135-154) — correct host
# PIDs with no exec and no PID-namespace confusion (SURVEY.md §2.6).
PROCESS_LABELS: tuple[str, ...] = CHIP_LABELS + ("pid", "comm", "pod_uid")

TPU_CHIP_PROCESS_INFO = MetricSpec(
    name="tpu_chip_process_info",
    help=(
        "One series per (process, chip): the process with this host pid holds "
        "the chip's device file open; value is always 1. pod/namespace/container "
        "come from the kubelet allocation, pod_uid from the process's cgroup."
    ),
    type=GAUGE,
    label_names=PROCESS_LABELS,
)

# --- GPU device family (backend/nvml.py) -------------------------------------
# Twins of the node surface for the second device family: the NVML-shaped
# backend publishes per-chip series under gpu_* instead of tpu_*, keyed by
# ChipInfo.family — a mixed GPU/TPU fleet must never sum across families.
# Same label schema as the TPU twins (chip_id is the NVML device index,
# main.go:123-124; device_kind carries DeviceGetName). Conditional surface:
# declared only on exporters whose backend (or any observed chip) is
# GPU-family, the same rule as TPU_CHIP_PROCESS_INFO.

GPU_HBM_USED_BYTES = MetricSpec(
    name="gpu_hbm_used_bytes",
    help="Device memory in use on this GPU, in bytes (NVML GetMemoryInfo.used).",
    type=GAUGE,
    label_names=CHIP_LABELS,
)

GPU_HBM_TOTAL_BYTES = MetricSpec(
    name="gpu_hbm_total_bytes",
    help="Total device memory capacity of this GPU, in bytes (NVML GetMemoryInfo.total).",
    type=GAUGE,
    label_names=CHIP_LABELS,
)

GPU_HBM_USED_PERCENT = MetricSpec(
    name="gpu_hbm_used_percent",
    help="Percent of this GPU's device memory currently in use (0-100) — the per-chip analog of the reference's docker_gpu_memory_perc_usage (main.go:149-150).",
    type=GAUGE,
    label_names=CHIP_LABELS,
)

GPU_UTILIZATION_PERCENT = MetricSpec(
    name="gpu_utilization_percent",
    help="GPU compute-unit utilization over the last sample window (0-100, NVML GetUtilizationRates.gpu) — the GPU twin of tpu_tensorcore_duty_cycle_percent. Absent on boards whose driver reports NOT_SUPPORTED.",
    type=GAUGE,
    label_names=CHIP_LABELS,
)

GPU_CHIP_INFO = MetricSpec(
    name="gpu_chip_info",
    help="Static GPU identity; value is always 1. device_kind is the NVML marketing name. The guaranteed per-chip presence series GPU slice rollups count chips from — same contract as tpu_chip_info.",
    type=GAUGE,
    label_names=CHIP_LABELS + ("device_kind", "coords"),
)

# The reference's headline dimension, honest on GPU: NVML reports true
# per-process device memory (main.go:135,147), so unlike the TPU path this
# is the runtime's own table, not a procfs holder scan. pod/namespace/
# container labels come from the same podresources device-ID join as every
# other chip series.
GPU_PROCESS_MEMORY_USED_BYTES = MetricSpec(
    name="gpu_process_memory_used_bytes",
    help="Device memory used by one process on this GPU, in bytes (NVML GetComputeRunningProcesses, main.go:134-155); pod attribution via the kubelet podresources join.",
    type=GAUGE,
    label_names=CHIP_LABELS + ("pid", "comm"),
)

GPU_BACKEND_UP = MetricSpec(
    name="gpu_backend_up",
    help="1 if the most recent poll read the GPU backend without fatal error, else 0 — the per-backend up twin of the device half of tpu_exporter_up, so mixed-fleet dashboards can alert per family.",
    type=GAUGE,
)

# --- Pod-level rollups -------------------------------------------------------

POD_LABELS: tuple[str, ...] = ("pod", "namespace", "accelerator", "slice_name", "host", "worker_id")

TPU_POD_CHIP_COUNT = MetricSpec(
    name="tpu_pod_chip_count",
    help="Number of TPU chips currently allocated to this pod on this host.",
    type=GAUGE,
    label_names=POD_LABELS,
)

TPU_POD_HBM_USED_BYTES = MetricSpec(
    name="tpu_pod_hbm_used_bytes",
    help="Sum of HBM bytes in use across all chips allocated to this pod on this host.",
    type=GAUGE,
    label_names=POD_LABELS,
)

# GPU twins of the pod rollups — the paper's headline metric
# (pod_gpu_memory_usage, main.go:21-28) with the label-schema defects
# fixed: namespace/host/slice labels, chip counts, and device memory from
# the podresources join instead of the broken container-PID scan.
GPU_POD_CHIP_COUNT = MetricSpec(
    name="gpu_pod_chip_count",
    help="Number of GPUs currently allocated to this pod on this host.",
    type=GAUGE,
    label_names=POD_LABELS,
)

GPU_POD_MEMORY_USED_BYTES = MetricSpec(
    name="gpu_pod_memory_used_bytes",
    help="Sum of device-memory bytes in use across all GPUs allocated to this pod on this host — the per-pod GPU memory headline (main.go:24,147), via the same kubelet device-ID join the TPU path uses.",
    type=GAUGE,
    label_names=POD_LABELS,
)

# The conditional GPU node surface, declared as a block once the exporter
# is (or observes) the GPU family — stable from that poll on.
GPU_NODE_SPECS: tuple[MetricSpec, ...] = (
    GPU_HBM_USED_BYTES,
    GPU_HBM_TOTAL_BYTES,
    GPU_HBM_USED_PERCENT,
    GPU_UTILIZATION_PERCENT,
    GPU_CHIP_INFO,
    GPU_PROCESS_MEMORY_USED_BYTES,
    GPU_POD_CHIP_COUNT,
    GPU_POD_MEMORY_USED_BYTES,
    GPU_BACKEND_UP,
)

# --- Kubelet inventory (podresources GetAllocatableResources) ----------------

# Derived, not restated: the collector's _topo_tuple is built positionally
# in this exact order, so divergence would publish values under wrong names.
TOPO_LABELS: tuple[str, ...] = CHIP_LABELS[2:6]

TPU_KUBELET_ALLOCATABLE_CHIPS = MetricSpec(
    name="tpu_kubelet_allocatable_chips",
    help="TPU devices the kubelet device plugin reports as allocatable on this node (absent when the kubelet cannot report it).",
    type=GAUGE,
    label_names=TOPO_LABELS,
)

TPU_KUBELET_ALLOCATED_CHIPS = MetricSpec(
    name="tpu_kubelet_allocated_chips",
    help="TPU devices currently allocated to pods on this node, per the kubelet.",
    type=GAUGE,
    label_names=TOPO_LABELS,
)

# --- Host identity (multi-slice membership join key) -------------------------

TPU_HOST_INFO = MetricSpec(
    name="tpu_host_info",
    help="Static host identity incl. multi-slice membership; value is always 1. multislice_group is the cross-slice rollup join key (empty outside multi-slice deployments).",
    type=GAUGE,
    label_names=TOPO_LABELS + ("multislice_group", "num_slices"),
)

# --- Exporter self-metrics (SURVEY.md §5: tracing/observability) -------------

TPU_EXPORTER_UP = MetricSpec(
    name="tpu_exporter_up",
    help="1 if the most recent poll completed without fatal error, else 0.",
    type=GAUGE,
)

TPU_EXPORTER_POLL_DURATION_SECONDS = MetricSpec(
    name="tpu_exporter_poll_duration_seconds",
    help="Duration of the most recent poll, by phase (device_read, attribution, join, publish, total).",
    type=GAUGE,
    label_names=("phase",),
)

# Distribution companions to the point-in-time gauges above (VERDICT r4
# "latency distributions"): a p99 of the exporter's own phases must be
# computable from its exposition alone (histogram_quantile over _bucket).
# Bounds span 100 µs (cheap phases at 4 chips) to 2.5 s (first poll against
# a cold runtime); the scrape set stops at 250 ms since the contract is
# p99 < 50 ms and everything past that is pathological anyway.
POLL_DURATION_BUCKETS = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5,
)
SCRAPE_DURATION_BUCKETS = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25,
)

TPU_EXPORTER_POLL_PHASE_DURATION_HIST = HistogramSpec(
    name="tpu_exporter_poll_phase_duration_seconds",
    help="Distribution of poll durations by phase since exporter start.",
    buckets=POLL_DURATION_BUCKETS,
    label_names=("phase",),
)

TPU_EXPORTER_SCRAPE_DURATION_HIST = HistogramSpec(
    name="tpu_exporter_scrape_duration_seconds",
    help="Distribution of /metrics request handling durations since exporter start (served scrapes only; rejects are counted in tpu_exporter_scrape_rejects_total).",
    buckets=SCRAPE_DURATION_BUCKETS,
)

# How late the server's event loop ran each due timer (a 100 ms probe timer
# keeps it sampled when nothing else is due): the loop thread's wait for
# the interpreter while other threads hold it.
TPU_EXPORTER_SERVER_LOOP_LAG_HIST = HistogramSpec(
    name="tpu_exporter_server_loop_lag_seconds",
    help="Distribution of how late the HTTP server's event loop ran each due timer, including a 100 ms probe timer.",
    buckets=SCRAPE_DURATION_BUCKETS,
)

TPU_EXPORTER_POLL_ERRORS_TOTAL = MetricSpec(
    name="tpu_exporter_poll_errors_total",
    help="Count of poll-phase errors since exporter start, by source.",
    type=COUNTER,
    label_names=("source",),
)

TPU_EXPORTER_POLLS_TOTAL = MetricSpec(
    name="tpu_exporter_polls_total",
    help="Count of completed poll iterations since exporter start.",
    type=COUNTER,
)

TPU_EXPORTER_POLL_OVERRUNS_TOTAL = MetricSpec(
    name="tpu_exporter_poll_overruns_total",
    help="Poll ticks skipped because the previous iteration overran the interval — rising means the interval is too tight for this host/backend.",
    type=COUNTER,
)

TPU_EXPORTER_SERIES = MetricSpec(
    name="tpu_exporter_series",
    help="Number of time series in the current snapshot.",
    type=GAUGE,
)

TPU_EXPORTER_LAST_POLL_TIMESTAMP_SECONDS = MetricSpec(
    name="tpu_exporter_last_poll_timestamp_seconds",
    help="Unix timestamp of the most recent completed poll.",
    type=GAUGE,
)

# Wall-clock instants just before and just after the device read of the
# poll whose stamp is tpu_exporter_last_poll_timestamp_seconds, published in
# the same snapshot: they place the served values among the card's states.
TPU_EXPORTER_LAST_DEVICE_READ_TIMESTAMP_SECONDS = MetricSpec(
    name="tpu_exporter_last_device_read_timestamp_seconds",
    help="Unix timestamps just before (edge=start) and just after (edge=end) the device read of the most recent completed poll.",
    type=GAUGE,
    label_names=("edge",),
)

# Self-resource accounting: the <1% node CPU budget (BASELINE.md) must be
# auditable in production, not just in bench.py.
TPU_EXPORTER_CPU_SECONDS_TOTAL = MetricSpec(
    name="tpu_exporter_cpu_seconds_total",
    help="Total user+system CPU time consumed by the exporter process.",
    type=COUNTER,
)

TPU_EXPORTER_RSS_BYTES = MetricSpec(
    name="tpu_exporter_rss_bytes",
    help="Resident set size of the exporter process (absent when /proc/self/statm is unreadable).",
    type=GAUGE,
)

TPU_EXPORTER_SCRAPE_REJECTS_TOTAL = MetricSpec(
    name="tpu_exporter_scrape_rejects_total",
    help="Scrapes rejected with 429 since start, by cause: 'concurrency' (too many in-flight renders: slow scrapers or too many of them) vs 'rate' (token bucket: scraping too often). The fixes differ, so the counter splits.",
    type=COUNTER,
    label_names=("cause",),
)

# --- Source supervision (tpu_pod_exporter_torch.supervisor) ------------------------
# One series set per supervised source (device / attribution / process_scan).
# Families are declared unconditionally (stable surface); samples appear
# only when supervision is enabled (--phase-deadline-s > 0, the default).

TPU_EXPORTER_SOURCE_BREAKER_STATE = MetricSpec(
    name="tpu_exporter_source_breaker_state",
    help="Circuit-breaker state of this poll source: 0=closed (healthy), 1=open (quarantined, backoff running), 2=half_open (single probe in flight).",
    type=GAUGE,
    label_names=("source",),
)

TPU_EXPORTER_SOURCE_BREAKER_TRANSITIONS_TOTAL = MetricSpec(
    name="tpu_exporter_source_breaker_transitions_total",
    help="Breaker state entries since exporter start, by source and entered state (state=closed counts recoveries; a never-failed source shows zero everywhere).",
    type=COUNTER,
    label_names=("source", "state"),
)

TPU_EXPORTER_SOURCE_CALLS_ABANDONED_TOTAL = MetricSpec(
    name="tpu_exporter_source_calls_abandoned_total",
    help="Supervised calls abandoned at the phase deadline (--phase-deadline-s): the worker thread was fenced off, the phase degraded as an error. Rising = the source HANGS rather than errors.",
    type=COUNTER,
    label_names=("source",),
)

TPU_EXPORTER_SOURCE_CALLS_SKIPPED_TOTAL = MetricSpec(
    name="tpu_exporter_source_calls_skipped_total",
    help="Poll-phase calls skipped because the source's breaker was open with backoff pending (the quarantine working as designed, not an extra fault).",
    type=COUNTER,
    label_names=("source",),
)

TPU_EXPORTER_SOURCE_RECONNECTS_TOTAL = MetricSpec(
    name="tpu_exporter_source_reconnects_total",
    help="close()+re-open() reconnects issued before half-open breaker probes — a wedged gRPC channel is replaced, not retried into. Compare with breaker transitions to closed to see whether reconnects actually recover the source.",
    type=COUNTER,
    label_names=("source",),
)

# --- Poll tracing (tpu_pod_exporter_torch.trace) -----------------------------------
# Declared unconditionally (stable surface); samples appear only while
# tracing is enabled (--trace, the default) — same conditional-sample rule
# as the supervision series above.

TPU_EXPORTER_SLOW_POLLS_TOTAL = MetricSpec(
    name="tpu_exporter_slow_polls_total",
    help="Polls whose total duration exceeded --trace-slow-poll-s; each carries a sampled stack profile in its trace (GET /debug/trace, loopback-only by default).",
    type=COUNTER,
)

TPU_EXPORTER_TRACES = MetricSpec(
    name="tpu_exporter_traces",
    help="Poll traces currently retained in the bounded in-memory trace ring (--trace-max-traces).",
    type=GAUGE,
)

TPU_EXPORTER_TRACE_SPANS = MetricSpec(
    name="tpu_exporter_trace_spans",
    help="Spans retained across all traces in the ring — the /debug/trace export size driver.",
    type=GAUGE,
)

# --- Restart survivability (tpu_pod_exporter_torch.persist) ------------------------
# warm_start / snapshot_stale live in ALL_SPECS (published 0 on every live
# poll) so the restored exposition can flip them by VALUE EDIT, never by
# header injection — a warm body stays a valid single-header exposition.

TPU_EXPORTER_WARM_START = MetricSpec(
    name="tpu_exporter_warm_start",
    help="1 while serving the restored pre-restart exposition snapshot (warm start: the process restarted and no live poll has completed yet); 0 on every live poll. Scrapes during warm start carry last-known data — check tpu_exporter_snapshot_stale_seconds for its age.",
    type=GAUGE,
)

TPU_EXPORTER_SNAPSHOT_STALE_SECONDS = MetricSpec(
    name="tpu_exporter_snapshot_stale_seconds",
    help="Age of the restored exposition at the moment serving resumed after a restart (0 on live polls). Combine with tpu_exporter_last_poll_timestamp_seconds for ongoing staleness while warm_start=1.",
    type=GAUGE,
)

TPU_EXPORTER_CLIENT_WRITE_TIMEOUTS_TOTAL = MetricSpec(
    name="tpu_exporter_client_write_timeouts_total",
    help="Connections dropped because a client stalled reading a response past --client-write-timeout-s (per-connection socket send timeout): a wedged scraper must not pin a handler thread forever.",
    type=COUNTER,
)

TPU_EXPORTER_INFO = MetricSpec(
    name="tpu_exporter_info",
    help="Static exporter build/runtime info; value is always 1.",
    type=GAUGE,
    label_names=("version", "backend", "attribution"),
)

# --- History flight recorder self-metrics (tpu_pod_exporter_torch.history) ---------
# Emitted only when history is enabled (--history-retention-s > 0), so they
# live outside ALL_SPECS — same conditional-surface rule as
# TPU_CHIP_PROCESS_INFO. Size/eviction/append-time must be auditable: the
# store is hard-bounded, and these say how close to the bound it runs.

TPU_EXPORTER_HISTORY_SERIES = MetricSpec(
    name="tpu_exporter_history_series",
    help="Series currently held in the in-memory history store (bounded by --history-max-series).",
    type=GAUGE,
)

TPU_EXPORTER_HISTORY_SAMPLES = MetricSpec(
    name="tpu_exporter_history_samples",
    help="Samples currently retained across all history ring buffers.",
    type=GAUGE,
)

TPU_EXPORTER_HISTORY_MEMORY_BYTES = MetricSpec(
    name="tpu_exporter_history_memory_bytes",
    help="Preallocated ring-buffer bytes held by the history store (series x capacity x 24).",
    type=GAUGE,
)

TPU_EXPORTER_HISTORY_EVICTED_SERIES_TOTAL = MetricSpec(
    name="tpu_exporter_history_evicted_series_total",
    help="History series dropped since start, by reason: 'capacity' (--history-max-series hit; raise it or expect churned series to age out) vs 'retention' (idle past --history-retention-s — normal pod churn).",
    type=COUNTER,
    label_names=("reason",),
)

TPU_EXPORTER_HISTORY_APPEND_SECONDS = MetricSpec(
    name="tpu_exporter_history_append_seconds",
    help="Duration of the most recent history append (runs after the snapshot swap, off the scrape path; one poll behind).",
    type=GAUGE,
)

# Multi-resolution downsample tiers (history.DEFAULT_TIER_SPEC): occupancy
# and answerable span per tier, labeled by bucket width in seconds. These
# are how an operator audits that long-range query_range answers actually
# have tier data behind them (the Grafana "tier occupancy" panel).
TPU_EXPORTER_HISTORY_TIER_BUCKETS = MetricSpec(
    name="tpu_exporter_history_tier_buckets",
    help="Downsample buckets currently retained across all series of this tier (open accumulator buckets included).",
    type=GAUGE,
    label_names=("tier",),
)

TPU_EXPORTER_HISTORY_TIER_SPAN_SECONDS = MetricSpec(
    name="tpu_exporter_history_tier_span_seconds",
    help="Wall-clock span this downsample tier can currently answer for (newest minus oldest retained bucket) — how far back a query_range at this tier's resolution reaches.",
    type=GAUGE,
    label_names=("tier",),
)

HISTORY_SPECS: tuple[MetricSpec, ...] = (
    TPU_EXPORTER_HISTORY_SERIES,
    TPU_EXPORTER_HISTORY_SAMPLES,
    TPU_EXPORTER_HISTORY_MEMORY_BYTES,
    TPU_EXPORTER_HISTORY_EVICTED_SERIES_TOTAL,
    TPU_EXPORTER_HISTORY_APPEND_SECONDS,
    TPU_EXPORTER_HISTORY_TIER_BUCKETS,
    TPU_EXPORTER_HISTORY_TIER_SPAN_SECONDS,
)

# --- Persistence self-metrics (tpu_pod_exporter_torch.persist) ----------------------
# Emitted only when persistence is enabled (--state-dir set) — the same
# conditional-surface rule as HISTORY_SPECS. The WAL/snapshot health must be
# auditable from the exposition: a silently-failing state dir would only be
# discovered at the NEXT restart, which is exactly too late.

TPU_EXPORTER_PERSIST_WAL_BYTES = MetricSpec(
    name="tpu_exporter_persist_wal_bytes",
    help="Current size of the write-ahead log under --state-dir (resets to near zero at each checkpoint rotation).",
    type=GAUGE,
)

TPU_EXPORTER_PERSIST_WAL_RECORDS_TOTAL = MetricSpec(
    name="tpu_exporter_persist_wal_records_total",
    help="WAL records written since exporter start (samples, layout, and breaker records).",
    type=COUNTER,
)

TPU_EXPORTER_PERSIST_SNAPSHOTS_TOTAL = MetricSpec(
    name="tpu_exporter_persist_snapshots_total",
    help="State checkpoints written since exporter start (write-temp, fsync, rename; cadence --state-snapshot-interval-s).",
    type=COUNTER,
)

TPU_EXPORTER_PERSIST_ERRORS_TOTAL = MetricSpec(
    name="tpu_exporter_persist_errors_total",
    help="Persistence I/O failures since start (WAL writes, fsyncs, checkpoint rotations), by reason: 'disk_full' (ENOSPC/EDQUOT — the disk is FULL, not flaky; the resource-pressure governor sheds on it) vs 'io' (every other filesystem fault). Rising = the state dir's filesystem is failing; the exporter keeps polling but the next restart will cold-start or restore stale state.",
    type=COUNTER,
    label_names=("reason",),
)

TPU_EXPORTER_PERSIST_DROPPED_TOTAL = MetricSpec(
    name="tpu_exporter_persist_dropped_total",
    help="Poll records dropped by persistence WITHOUT being written, by reason: 'queue' (writer queue full — stalled disk), 'disk_full' (the write itself hit ENOSPC/EDQUOT), 'io' (other write failure), 'shed' (deliberately thinned/skipped by the resource-pressure governor's WAL rungs). Polling is never blocked by persistence, so sustained drops mean history restored after a crash will have holes.",
    type=COUNTER,
    label_names=("reason",),
)

TPU_EXPORTER_PERSIST_FSYNC_SECONDS = MetricSpec(
    name="tpu_exporter_persist_fsync_seconds",
    help="Duration of the most recent WAL fsync (cadence --state-fsync-interval-s; 0 syncs every record). The persistence hot path's latency budget check (make persist-fsync-check) polices the same number in CI.",
    type=GAUGE,
)

TPU_EXPORTER_PERSIST_SNAPSHOT_AGE_SECONDS = MetricSpec(
    name="tpu_exporter_persist_snapshot_age_seconds",
    help="Seconds since the last on-disk state checkpoint was written (the worst-case exposition staleness a crash right now would restore). Absent until the first rotation of this process.",
    type=GAUGE,
)

PERSIST_SPECS: tuple[MetricSpec, ...] = (
    TPU_EXPORTER_PERSIST_WAL_BYTES,
    TPU_EXPORTER_PERSIST_WAL_RECORDS_TOTAL,
    TPU_EXPORTER_PERSIST_SNAPSHOTS_TOTAL,
    TPU_EXPORTER_PERSIST_ERRORS_TOTAL,
    TPU_EXPORTER_PERSIST_DROPPED_TOTAL,
    TPU_EXPORTER_PERSIST_FSYNC_SECONDS,
    TPU_EXPORTER_PERSIST_SNAPSHOT_AGE_SECONDS,
)

# --- Resource-pressure governor (tpu_pod_exporter_torch.pressure) ------------------
# Emitted only when a governor is attached (a disk or memory budget is
# configured) — the same conditional-surface rule as PERSIST_SPECS. The
# whole point of the governor is that degradation under ENOSPC/RSS
# pressure happens BY POLICY and is attributable from the exposition
# alone: the ladder rung is a gauge, every shed/recover a counted
# transition, and the bytes-vs-budget pair the decision was made on is
# published verbatim.

TPU_EXPORTER_PRESSURE_STATE = MetricSpec(
    name="tpu_exporter_pressure_state",
    help="Resource-pressure degradation ladder rung per resource ('disk', 'memory'): 0 = no shedding; each higher rung is one more deliberate degradation (disk: WAL thinning -> egress compaction/trim -> checkpoint halving -> WAL off; memory: fleet-cache off -> trace-ring halving -> raw history-ring cut). Recovery steps down rung by rung with hysteresis.",
    type=GAUGE,
    label_names=("resource",),
)

TPU_EXPORTER_PRESSURE_BYTES = MetricSpec(
    name="tpu_exporter_pressure_bytes",
    help="Accounted usage per governed resource: 'disk' = bytes on disk under --state-dir plus --egress-dir; 'memory' = byte-accounted total of the registered in-memory components (history rings, trace ring, fleet query cache, root stale-serve views).",
    type=GAUGE,
    label_names=("resource",),
)

TPU_EXPORTER_PRESSURE_BUDGET_BYTES = MetricSpec(
    name="tpu_exporter_pressure_budget_bytes",
    help="Configured budget per governed resource (--state-max-disk-mb / --memory-budget-mb); 0 = no byte budget (the disk ladder still sheds on reported ENOSPC).",
    type=GAUGE,
    label_names=("resource",),
)

TPU_EXPORTER_PRESSURE_TRANSITIONS_TOTAL = MetricSpec(
    name="tpu_exporter_pressure_transitions_total",
    help="Ladder transitions per resource and direction ('shed' = one rung up under pressure, 'recover' = one rung released after the hysteresis window). A sawtooth here means the budget sits exactly at the steady-state working set — raise it.",
    type=COUNTER,
    label_names=("resource", "direction"),
)

PRESSURE_SPECS: tuple[MetricSpec, ...] = (
    TPU_EXPORTER_PRESSURE_STATE,
    TPU_EXPORTER_PRESSURE_BYTES,
    TPU_EXPORTER_PRESSURE_BUDGET_BYTES,
    TPU_EXPORTER_PRESSURE_TRANSITIONS_TOTAL,
)

# --- Remote-write egress (tpu_pod_exporter_torch.egress) ---------------------------
# Emitted only when egress is enabled (--egress-url set) — the same
# conditional-surface rule as PERSIST_SPECS. Both the exporter and the
# aggregator attach a RemoteWriteShipper, so both expositions may carry
# these. The send buffer's health must be auditable from the exposition:
# a receiver outage shows as breaker_state=1 + growing backlog, and a
# silently-dropping backlog cap is exactly the loss the alert rules watch.

TPU_EXPORTER_EGRESS_SENT_BATCHES_TOTAL = MetricSpec(
    name="tpu_exporter_egress_sent_batches_total",
    help="Remote-write batches acknowledged by the receiver (2xx) since start. Each acked batch is durably marked in the send buffer's cursor, so a restart never re-sends it.",
    type=COUNTER,
)

TPU_EXPORTER_EGRESS_SENT_SAMPLES_TOTAL = MetricSpec(
    name="tpu_exporter_egress_sent_samples_total",
    help="Samples delivered inside acknowledged remote-write batches since start.",
    type=COUNTER,
)

TPU_EXPORTER_EGRESS_FAILED_SENDS_TOTAL = MetricSpec(
    name="tpu_exporter_egress_failed_sends_total",
    help="Remote-write send attempts that failed (timeout, connection error, 5xx, or 429 backpressure) since start. Failed batches stay in the durable send buffer and are retried breaker-gated; compare with dropped to tell 'retrying' from 'losing'.",
    type=COUNTER,
)

TPU_EXPORTER_EGRESS_DROPPED_TOTAL = MetricSpec(
    name="tpu_exporter_egress_dropped_total",
    help="Batches removed from the send buffer WITHOUT delivery, by reason: 'backlog' (bytes/age cap while the receiver was down), 'poison' (non-429 4xx — the receiver rejects the batch body, retrying would wedge the queue), 'queue' (poll-side handoff full: the egress writer stalled), 'corrupt' (torn/scrambled buffer records truncated at boot).",
    type=COUNTER,
    label_names=("reason",),
)

TPU_EXPORTER_EGRESS_BACKLOG_BATCHES = MetricSpec(
    name="tpu_exporter_egress_backlog_batches",
    help="Batches currently sitting in the durable send buffer awaiting acknowledgement (0 when the shipper is keeping up).",
    type=GAUGE,
)

TPU_EXPORTER_EGRESS_BACKLOG_BYTES = MetricSpec(
    name="tpu_exporter_egress_backlog_bytes",
    help="On-disk bytes of unacknowledged batches in the send buffer under --egress-dir (bounded by --egress-max-backlog-mb).",
    type=GAUGE,
)

TPU_EXPORTER_EGRESS_BACKLOG_AGE_SECONDS = MetricSpec(
    name="tpu_exporter_egress_backlog_age_seconds",
    help="Age of the OLDEST unacknowledged batch in the send buffer (0 when empty) — how far behind the receiver the shipped telemetry is; bounded by --egress-max-backlog-age-s.",
    type=GAUGE,
)

TPU_EXPORTER_EGRESS_BREAKER_STATE = MetricSpec(
    name="tpu_exporter_egress_breaker_state",
    help="Remote-write receiver circuit breaker: 0=closed (healthy), 1=open (receiver quarantined, backoff running, batches buffering to disk), 2=half_open (single probe batch in flight).",
    type=GAUGE,
)

TPU_EXPORTER_EGRESS_SEND_SECONDS_HIST = HistogramSpec(
    name="tpu_exporter_egress_send_seconds",
    help="Distribution of remote-write send round-trips since start (successful and failed attempts; breaker-skipped sends are not attempts).",
    buckets=POLL_DURATION_BUCKETS,
)

EGRESS_SPECS: tuple[MetricSpec, ...] = (
    TPU_EXPORTER_EGRESS_SENT_BATCHES_TOTAL,
    TPU_EXPORTER_EGRESS_SENT_SAMPLES_TOTAL,
    TPU_EXPORTER_EGRESS_FAILED_SENDS_TOTAL,
    TPU_EXPORTER_EGRESS_DROPPED_TOTAL,
    TPU_EXPORTER_EGRESS_BACKLOG_BATCHES,
    TPU_EXPORTER_EGRESS_BACKLOG_BYTES,
    TPU_EXPORTER_EGRESS_BACKLOG_AGE_SECONDS,
    TPU_EXPORTER_EGRESS_BREAKER_STATE,
)

# --- Legacy migration aliases (off by default; --legacy-metrics) ------------
# The reference's exact metric names (main.go:24,31) so its dashboards work
# unchanged during migration. Semantic shift, documented in the help text:
# the reference's value was per-process GPU memory keyed {pid, pod}
# (main.go:147-150); TPU runtimes pin whole chips to one container, so the
# honest equivalent is per-pod HBM totals. The pid label carries the chip's
# primary holder pid when the procfs scanner is on (--process-metrics),
# else "".
LEGACY_POD_MEMORY_USAGE = MetricSpec(
    name="pod_gpu_memory_usage",
    help="DEPRECATED migration alias: device memory used by this pod's chips, bytes (TPU: per-pod HBM; pid is the chip's holder pid when --process-metrics is on, else empty).",
    type=GAUGE,
    label_names=("pid", "pod"),
)

LEGACY_POD_MEMORY_PERC_USAGE = MetricSpec(
    name="docker_gpu_memory_perc_usage",
    help="DEPRECATED migration alias: percent of this pod's chips' total device memory in use (pid is the chip's holder pid when --process-metrics is on, else empty).",
    type=GAUGE,
    label_names=("pid", "pod"),
)

ALL_SPECS: tuple[MetricSpec, ...] = (
    TPU_HBM_USED_BYTES,
    TPU_HBM_TOTAL_BYTES,
    TPU_HBM_USED_PERCENT,
    TPU_HBM_PEAK_BYTES,
    TPU_CHIP_INFO,
    TPU_TENSORCORE_DUTY_CYCLE_PERCENT,
    TPU_ICI_LINK_BANDWIDTH_BYTES_PER_SECOND,
    TPU_ICI_TRANSFERRED_BYTES_TOTAL,
    TPU_DCN_LINK_BANDWIDTH_BYTES_PER_SECOND,
    TPU_DCN_TRANSFERRED_BYTES_TOTAL,
    TPU_HOST_INFO,
    TPU_POD_CHIP_COUNT,
    TPU_POD_HBM_USED_BYTES,
    TPU_KUBELET_ALLOCATABLE_CHIPS,
    TPU_KUBELET_ALLOCATED_CHIPS,
    TPU_EXPORTER_UP,
    TPU_EXPORTER_POLL_DURATION_SECONDS,
    TPU_EXPORTER_POLL_ERRORS_TOTAL,
    TPU_EXPORTER_POLLS_TOTAL,
    TPU_EXPORTER_POLL_OVERRUNS_TOTAL,
    TPU_EXPORTER_SERIES,
    TPU_EXPORTER_LAST_POLL_TIMESTAMP_SECONDS,
    TPU_EXPORTER_LAST_DEVICE_READ_TIMESTAMP_SECONDS,
    TPU_EXPORTER_CPU_SECONDS_TOTAL,
    TPU_EXPORTER_RSS_BYTES,
    TPU_EXPORTER_SCRAPE_REJECTS_TOTAL,
    TPU_EXPORTER_SOURCE_BREAKER_STATE,
    TPU_EXPORTER_SOURCE_BREAKER_TRANSITIONS_TOTAL,
    TPU_EXPORTER_SOURCE_CALLS_ABANDONED_TOTAL,
    TPU_EXPORTER_SOURCE_CALLS_SKIPPED_TOTAL,
    TPU_EXPORTER_SOURCE_RECONNECTS_TOTAL,
    TPU_EXPORTER_SLOW_POLLS_TOTAL,
    TPU_EXPORTER_TRACES,
    TPU_EXPORTER_TRACE_SPANS,
    TPU_EXPORTER_WARM_START,
    TPU_EXPORTER_SNAPSHOT_STALE_SECONDS,
    TPU_EXPORTER_CLIENT_WRITE_TIMEOUTS_TOTAL,
    TPU_EXPORTER_INFO,
)


# --- Slice-aggregator schema (tpu_pod_exporter_torch.aggregate) --------------------
# Served by the optional aggregator, NOT by per-host exporters (hence not in
# ALL_SPECS). Cross-host rollups normally live in Prometheus recording rules
# (SURVEY.md §2.8); the aggregator computes the same label joins for setups
# without one, scraping each host's /metrics and re-exporting slice sums.

# family is the accelerator-family rollup key ("tpu" | "gpu"): slices are
# homogeneous (a GKE node pool is one device family), but the label rides
# every slice rollup so fleet-level sums can stay family-correct and the
# FleetStore's recording rules can aggregate `by (family)`.
SLICE_LABELS: tuple[str, ...] = ("slice_name", "accelerator", "family")

TPU_SLICE_HOSTS_REPORTING = MetricSpec(
    name="tpu_slice_hosts_reporting",
    help="Hosts of this slice contributing chip samples this round (a scraped-but-chipless host counts in tpu_aggregator_target_up, not here).",
    type=GAUGE,
    label_names=SLICE_LABELS,
)

TPU_SLICE_CHIP_COUNT = MetricSpec(
    name="tpu_slice_chip_count",
    help="TPU chips reporting across all scraped hosts of this slice.",
    type=GAUGE,
    label_names=SLICE_LABELS,
)

TPU_SLICE_HBM_USED_BYTES = MetricSpec(
    name="tpu_slice_hbm_used_bytes",
    help="Sum of HBM bytes in use across all chips of this slice.",
    type=GAUGE,
    label_names=SLICE_LABELS,
)

TPU_SLICE_HBM_TOTAL_BYTES = MetricSpec(
    name="tpu_slice_hbm_total_bytes",
    help="Sum of HBM capacity across all chips of this slice.",
    type=GAUGE,
    label_names=SLICE_LABELS,
)

TPU_SLICE_HBM_USED_PERCENT = MetricSpec(
    name="tpu_slice_hbm_used_percent",
    help="Percent of the slice's total HBM capacity in use (0-100).",
    type=GAUGE,
    label_names=SLICE_LABELS,
)

TPU_SLICE_DUTY_CYCLE_AVG_PERCENT = MetricSpec(
    name="tpu_slice_tensorcore_duty_cycle_avg_percent",
    help="Mean TensorCore duty cycle across the slice's reporting chips (0-100).",
    type=GAUGE,
    label_names=SLICE_LABELS,
)

TPU_SLICE_ICI_BYTES_PER_SECOND = MetricSpec(
    name="tpu_slice_ici_bytes_per_second",
    help="Sum of per-link ICI traffic rates across the slice.",
    type=GAUGE,
    label_names=SLICE_LABELS,
)

TPU_SLICE_DCN_BYTES_PER_SECOND = MetricSpec(
    name="tpu_slice_dcn_bytes_per_second",
    help="Sum of per-link DCN (cross-slice network) traffic rates across the slice.",
    type=GAUGE,
    label_names=SLICE_LABELS,
)

# --- Per-family fleet rollups -------------------------------------------------
# Sums of the slice rollups grouped by accelerator family, emitted through
# the same emit_rollups path at every tier (flat aggregator, sharded root):
# the "how much GPU vs TPU is this fleet running" headline, and the series
# the mixed-fleet drills assert against a flat per-family oracle.

FAMILY_LABELS: tuple[str, ...] = ("family",)

TPU_FLEET_FAMILY_HOSTS_REPORTING = MetricSpec(
    name="tpu_fleet_family_hosts_reporting",
    help="Hosts contributing chip samples this round, per accelerator family (tpu/gpu).",
    type=GAUGE,
    label_names=FAMILY_LABELS,
)

TPU_FLEET_FAMILY_CHIP_COUNT = MetricSpec(
    name="tpu_fleet_family_chip_count",
    help="Chips reporting across all scraped slices of this accelerator family — mixed fleets must never sum chips across families, so the split is published, not derived.",
    type=GAUGE,
    label_names=FAMILY_LABELS,
)

TPU_FLEET_FAMILY_HBM_USED_BYTES = MetricSpec(
    name="tpu_fleet_family_hbm_used_bytes",
    help="Device-memory bytes in use across all chips of this accelerator family (absent until at least one chip of the family reports memory).",
    type=GAUGE,
    label_names=FAMILY_LABELS,
)

TPU_FLEET_FAMILY_HBM_TOTAL_BYTES = MetricSpec(
    name="tpu_fleet_family_hbm_total_bytes",
    help="Device-memory capacity across all chips of this accelerator family (absent until at least one chip of the family reports capacity).",
    type=GAUGE,
    label_names=FAMILY_LABELS,
)

FAMILY_SPECS: tuple[MetricSpec, ...] = (
    TPU_FLEET_FAMILY_HOSTS_REPORTING,
    TPU_FLEET_FAMILY_CHIP_COUNT,
    TPU_FLEET_FAMILY_HBM_USED_BYTES,
    TPU_FLEET_FAMILY_HBM_TOTAL_BYTES,
)

# Cross-SLICE (multi-slice group) rollups. Joined via tpu_host_info's
# multislice_group label (BASELINE config 5: 2x v5p-128 over DCN); a slice
# with an empty group contributes to no group series.
MULTISLICE_LABELS: tuple[str, ...] = ("multislice_group",)

TPU_MULTISLICE_SLICES_REPORTING = MetricSpec(
    name="tpu_multislice_slices_reporting",
    help="Slices of this multi-slice group contributing chip samples this round.",
    type=GAUGE,
    label_names=MULTISLICE_LABELS,
)

TPU_MULTISLICE_EXPECTED_SLICES = MetricSpec(
    name="tpu_multislice_expected_slices",
    help="Slices this group SHOULD have (MEGASCALE_NUM_SLICES); alert when reporting < expected.",
    type=GAUGE,
    label_names=MULTISLICE_LABELS,
)

TPU_MULTISLICE_HOSTS_REPORTING = MetricSpec(
    name="tpu_multislice_hosts_reporting",
    help="Hosts across all slices of this group contributing chip samples this round.",
    type=GAUGE,
    label_names=MULTISLICE_LABELS,
)

TPU_MULTISLICE_CHIP_COUNT = MetricSpec(
    name="tpu_multislice_chip_count",
    help="TPU chips reporting across all slices of this multi-slice group.",
    type=GAUGE,
    label_names=MULTISLICE_LABELS,
)

TPU_MULTISLICE_HBM_USED_BYTES = MetricSpec(
    name="tpu_multislice_hbm_used_bytes",
    help="Sum of HBM bytes in use across all chips of this multi-slice group.",
    type=GAUGE,
    label_names=MULTISLICE_LABELS,
)

TPU_MULTISLICE_ICI_BYTES_PER_SECOND = MetricSpec(
    name="tpu_multislice_ici_bytes_per_second",
    help="Sum of intra-slice ICI traffic rates across the group.",
    type=GAUGE,
    label_names=MULTISLICE_LABELS,
)

TPU_MULTISLICE_DCN_BYTES_PER_SECOND = MetricSpec(
    name="tpu_multislice_dcn_bytes_per_second",
    help="Sum of cross-slice DCN traffic rates across the group.",
    type=GAUGE,
    label_names=MULTISLICE_LABELS,
)

# Cross-host workload rollups: a multi-host JobSet replica appears as the
# same {pod, namespace} on several hosts; these sum over that.
WORKLOAD_LABELS: tuple[str, ...] = ("pod", "namespace", "slice_name")

TPU_WORKLOAD_CHIP_COUNT = MetricSpec(
    name="tpu_workload_chip_count",
    help="TPU chips allocated to this workload across all hosts of the slice.",
    type=GAUGE,
    label_names=WORKLOAD_LABELS,
)

TPU_WORKLOAD_HBM_USED_BYTES = MetricSpec(
    name="tpu_workload_hbm_used_bytes",
    help="HBM bytes in use across all chips allocated to this workload, slice-wide.",
    type=GAUGE,
    label_names=WORKLOAD_LABELS,
)

TPU_WORKLOAD_HOSTS = MetricSpec(
    name="tpu_workload_hosts",
    help="Hosts on which this workload currently holds TPU chips.",
    type=GAUGE,
    label_names=WORKLOAD_LABELS,
)

# Aggregator self-metrics.
TPU_AGG_TARGET_UP = MetricSpec(
    name="tpu_aggregator_target_up",
    help="1 if this per-host exporter target was scraped successfully in the last round.",
    type=GAUGE,
    label_names=("target",),
)

TPU_AGG_SCRAPE_DURATION_SECONDS = MetricSpec(
    name="tpu_aggregator_scrape_duration_seconds",
    help="Duration of the last scrape of this target.",
    type=GAUGE,
    label_names=("target",),
)

TPU_AGG_TARGET_BREAKER_STATE = MetricSpec(
    name="tpu_aggregator_target_breaker_state",
    help="Per-target scrape circuit breaker: 0=closed, 1=open (target quarantined with backoff — its scrape AND history fallback are skipped instead of burning timeout_s every round), 2=half_open (probe in flight).",
    type=GAUGE,
    label_names=("target",),
)

TPU_AGG_SCRAPE_ERRORS_TOTAL = MetricSpec(
    name="tpu_aggregator_scrape_errors_total",
    help="Count of failed scrapes since aggregator start, by target.",
    type=COUNTER,
    label_names=("target",),
)

TPU_AGG_HISTORY_FALLBACKS_TOTAL = MetricSpec(
    name="tpu_aggregator_history_fallbacks_total",
    help="Rounds in which a target's full scrape failed but its /api/v1/window_stats history answered, so the host's last-known chip data still contributed to slice rollups (target_up stays 0 for the round).",
    type=COUNTER,
    label_names=("target",),
)

TPU_AGG_LAST_ROUND_TIMESTAMP_SECONDS = MetricSpec(
    name="tpu_aggregator_last_round_timestamp_seconds",
    help="Unix timestamp of the most recent completed aggregation round.",
    type=GAUGE,
)

TPU_AGG_ROUND_DURATION_SECONDS = MetricSpec(
    name="tpu_aggregator_round_duration_seconds",
    help="Wall time of the last full aggregation round (all targets: scrape + parse + fold + publish); budgeted in BASELINE.md.",
    type=GAUGE,
)

# Same self-resource accounting contract as the exporter's
# tpu_exporter_cpu_seconds_total / _rss_bytes: the aggregator's own cost
# at slice scale (BASELINE.md 64x256 budget) must be auditable from its
# exposition alone.
TPU_AGG_POLL_OVERRUNS_TOTAL = MetricSpec(
    name="tpu_aggregator_poll_overruns_total",
    help="Aggregation rounds skipped because the previous round overran the interval (same contract as tpu_exporter_poll_overruns_total: nonzero rate means --interval-s is too tight for the target count/latency).",
    type=COUNTER,
)

TPU_AGG_CPU_SECONDS_TOTAL = MetricSpec(
    name="tpu_aggregator_cpu_seconds_total",
    help="Total user+system CPU time consumed by the aggregator process.",
    type=COUNTER,
)

TPU_AGG_RSS_BYTES = MetricSpec(
    name="tpu_aggregator_rss_bytes",
    help="Resident set size of the aggregator process (absent when /proc/self/statm is unreadable).",
    type=GAUGE,
)

# Distribution companions (same rationale as the exporter's histograms:
# a p99 must be computable from the exposition alone). Distinct base names
# from the point-in-time gauges above — one exposition name, one type.
TPU_AGG_ROUND_HIST = HistogramSpec(
    name="tpu_aggregator_round_seconds",
    help="Distribution of full aggregation round durations since start.",
    buckets=POLL_DURATION_BUCKETS,
)

TPU_AGG_TARGET_SCRAPE_HIST = HistogramSpec(
    name="tpu_aggregator_target_scrape_seconds",
    help="Distribution of SUCCESSFUL per-target scrape durations since start, pooled across targets (failures/timeouts are excluded — see tpu_aggregator_target_up and _scrape_errors_total).",
    buckets=POLL_DURATION_BUCKETS,
)

# A round's phases: the fan-out's wall time (fetch), the summed exposition
# parses (parse), the folds and rollup emits (fold) and the snapshot build
# and swap (publish). Observed after the swap, like the round histogram.
TPU_AGG_ROUND_PHASE_HIST = HistogramSpec(
    name="tpu_aggregator_round_phase_seconds",
    help="Distribution of aggregation round phase durations since start, by phase: fetch (the scrape fan-out's wall time), parse, fold and publish (snapshot build and swap).",
    buckets=POLL_DURATION_BUCKETS,
    label_names=("phase",),
)

# One successful fetch (default_fetch, or the round's selectors loop on
# its behalf) split into its stages: headers (connect, send, the target's
# serve and the first byte), body (the read), gunzip (0 for an
# identity-encoded body) and decode.
TPU_AGG_FETCH_STAGE_HIST = HistogramSpec(
    name="tpu_aggregator_fetch_stage_seconds",
    help="Distribution of SUCCESSFUL per-target fetch stage durations since start, pooled across targets, by stage: headers, body, gunzip and decode.",
    buckets=POLL_DURATION_BUCKETS,
    label_names=("stage",),
)

# Which way each round's fan-out went: "loop", one selectors loop in the
# round's thread (the aggregator's own client over plain http targets), or
# "pool", the scrape thread pool (an injected fetch, or an https target).
TPU_AGG_FETCH_ROUNDS_TOTAL = MetricSpec(
    name="tpu_aggregator_fetch_rounds_total",
    help="Aggregation rounds since start, by the transport their target fetches took: loop (one non-blocking selectors loop in the round's thread) or pool (the scrape thread pool).",
    type=COUNTER,
    label_names=("transport",),
)

# --- Fleet query plane (tpu_pod_exporter_torch.fleet) -------------------------------
# Served by the aggregator only while the federated /api/v1 fan-out is
# enabled — conditional surface, like HISTORY_SPECS on the exporter, hence a
# separate tuple from AGGREGATE_SPECS.

TPU_AGG_FLEET_QUERIES_TOTAL = MetricSpec(
    name="tpu_aggregator_fleet_queries_total",
    help="Federated /api/v1 queries served since aggregator start, by route (series / query_range / window_stats). Cache hits included — they are served queries.",
    type=COUNTER,
    label_names=("route",),
)

TPU_AGG_FLEET_QUERY_PARTIAL_TOTAL = MetricSpec(
    name="tpu_aggregator_fleet_query_partial_total",
    help="Federated queries answered with partial=true (at least one non-quarantined target errored or missed its deadline, or a quarantined target's data is absent from the merge). The partial-result RATE is the fleet forensics health signal.",
    type=COUNTER,
)

TPU_AGG_FLEET_QUERY_TARGET_ERRORS_TOTAL = MetricSpec(
    name="tpu_aggregator_fleet_query_target_errors_total",
    help="Per-target fan-out failures (connection error or per-target deadline missed) across all federated queries since start.",
    type=COUNTER,
    label_names=("target",),
)

TPU_AGG_FLEET_QUERY_CACHE_HITS_TOTAL = MetricSpec(
    name="tpu_aggregator_fleet_query_cache_hits_total",
    help="Federated queries answered from the result cache (same query, same grid, same generation — dashboard-refresh traffic costs one fan-out per generation, not one per panel).",
    type=COUNTER,
)

TPU_AGG_FLEET_QUERY_CACHE_MISSES_TOTAL = MetricSpec(
    name="tpu_aggregator_fleet_query_cache_misses_total",
    help="Federated queries that required a live fan-out (cache miss or bypass).",
    type=COUNTER,
)

TPU_AGG_FLEET_QUERY_HIST = HistogramSpec(
    name="tpu_aggregator_fleet_query_seconds",
    help="Distribution of federated /api/v1 query latencies since start (fan-out + merge; cache hits excluded). The CI fleet-query p99 budget reads this.",
    buckets=POLL_DURATION_BUCKETS,
)

FLEET_QUERY_SPECS: tuple[MetricSpec, ...] = (
    TPU_AGG_FLEET_QUERIES_TOTAL,
    TPU_AGG_FLEET_QUERY_PARTIAL_TOTAL,
    TPU_AGG_FLEET_QUERY_TARGET_ERRORS_TOTAL,
    TPU_AGG_FLEET_QUERY_CACHE_HITS_TOTAL,
    TPU_AGG_FLEET_QUERY_CACHE_MISSES_TOTAL,
)

# --- Sharded aggregation tree (tpu_pod_exporter_torch.shard) ------------------------
# Two conditional surfaces:
#
#   tpu_leaf_*  — served by LEAF aggregators (a SliceAggregator owning one
#     consistent-hash shard of node targets). These are the raw rollup
#     ACCUMULATOR COMPONENTS (sums, sample counts, coverage flags) the root
#     tier needs to merge partial per-shard rollups into exact fleet-wide
#     rollups: a mean or a used/total-coverage guard cannot be recomputed
#     from the published rollups alone, so the leaf exposes the parts.
#     Component fields ride a `field` label rather than one spec each —
#     they are an internal tier-to-tier contract, not operator surface.
#
#   tpu_root_*  — served by the ROOT aggregator that scrapes leaf
#     expositions, dedups HA pairs per series by freshest poll wall
#     timestamp, and re-exports the fleet-wide /metrics.

# Fields carried by tpu_leaf_slice_component, in emission order. The root
# rejects unknown fields rather than guessing (forward-compat: a newer
# leaf's extra fields are ignored by an older root only via this list).
LEAF_SLICE_FIELDS: tuple[str, ...] = (
    "hosts", "chips", "hbm_used", "hbm_total", "used_n", "total_n",
    "coverage_eq", "duty_sum", "duty_n", "ici_bw", "ici_n", "dcn_bw",
    "dcn_n",
)

LEAF_WORKLOAD_FIELDS: tuple[str, ...] = (
    "chips", "hbm_used", "hbm_used_n", "hosts",
)

TPU_LEAF_SLICE_COMPONENT = MetricSpec(
    name="tpu_leaf_slice_component",
    help="Raw slice-rollup accumulator component for this leaf's shard (see field label: sums, sample counts, and the used/total coverage-equality flag). Tier-to-tier contract consumed by the root aggregator; operators should read the tpu_slice_* rollups instead.",
    type=GAUGE,
    label_names=SLICE_LABELS + ("field",),
)

TPU_LEAF_WORKLOAD_COMPONENT = MetricSpec(
    name="tpu_leaf_workload_component",
    help="Raw workload-rollup accumulator component for this leaf's shard (see field label). Tier-to-tier contract consumed by the root aggregator.",
    type=GAUGE,
    label_names=WORKLOAD_LABELS + ("field",),
)

TPU_LEAF_SLICE_GROUP_INFO = MetricSpec(
    name="tpu_leaf_slice_group_info",
    help="Multi-slice membership observed by this leaf (slice -> group join key, from tpu_host_info); value is always 1. The root rebuilds multislice rollups fleet-wide from these. No family label: membership comes from tpu_host_info, which carries none (multi-slice is a TPU-fabric concept).",
    type=GAUGE,
    label_names=("slice_name", "accelerator", "multislice_group", "num_slices"),
)

TPU_LEAF_SHARD_INFO = MetricSpec(
    name="tpu_leaf_shard_info",
    help="Identity of this leaf aggregator: which consistent-hash shard it serves, its leaf id within the (optionally HA-paired) shard, and the ring it hashes with (num_shards/vnodes); value is always 1. The root refuses bodies whose shard OR ring disagrees with its own configuration — a leaf on a different ring covers a different target subset, and summing it would silently double-count the fleet rollups.",
    type=GAUGE,
    label_names=("shard", "leaf", "num_shards", "vnodes"),
)

TPU_LEAF_TARGETS = MetricSpec(
    name="tpu_leaf_targets",
    help="Node targets currently assigned to this leaf's shard by the consistent-hash map (tracks live resharding as targets join/leave).",
    type=GAUGE,
    label_names=("shard",),
)

TPU_LEAF_RESHARD_MOVES_TOTAL = MetricSpec(
    name="tpu_leaf_reshard_moves_total",
    help="Target assignment changes applied by this leaf since start (targets entering or leaving its shard on a targets-file reload). The root-side fleet view is tpu_root_reshard_moves_total.",
    type=COUNTER,
)

LEAF_SPECS: tuple[MetricSpec, ...] = (
    TPU_LEAF_SLICE_COMPONENT,
    TPU_LEAF_WORKLOAD_COMPONENT,
    TPU_LEAF_SLICE_GROUP_INFO,
    TPU_LEAF_SHARD_INFO,
    TPU_LEAF_TARGETS,
    TPU_LEAF_RESHARD_MOVES_TOTAL,
)

TPU_ROOT_LEAF_UP = MetricSpec(
    name="tpu_root_leaf_up",
    help="1 if this leaf aggregator was scraped successfully in the root's last round. An HA shard is healthy while at least one of its leaves is up; TpuRootLeafDown alerts on any leaf down.",
    type=GAUGE,
    label_names=("shard", "leaf"),
)

TPU_ROOT_LEAF_STALENESS_SECONDS = MetricSpec(
    name="tpu_root_leaf_staleness_seconds",
    help="Age of this leaf's last completed round at the root's merge time (root wall clock minus the leaf's tpu_aggregator_last_round_timestamp_seconds). The freshest leaf of each HA pair wins the per-series dedup; absent while the leaf has never answered.",
    type=GAUGE,
    label_names=("shard", "leaf"),
)

TPU_ROOT_SHARD_TARGETS = MetricSpec(
    name="tpu_root_shard_targets",
    help="Node targets served under this shard per its freshest answering leaf (tpu_leaf_targets passthrough).",
    type=GAUGE,
    label_names=("shard",),
)

TPU_ROOT_SHARD_QUARANTINED_TARGETS = MetricSpec(
    name="tpu_root_shard_quarantined_targets",
    help="Node targets of this shard whose leaf-side scrape breaker is currently open or half-open (quarantined by the shard's freshest answering leaf).",
    type=GAUGE,
    label_names=("shard",),
)

TPU_ROOT_SHARD_FAMILY_CHIPS = MetricSpec(
    name="tpu_root_shard_family_chips",
    help="Chips this shard's freshest merged view reports, per accelerator family — consistent hashing mixes node pools across shards, so the per-shard family split (status --tree's family column) is published here.",
    type=GAUGE,
    label_names=("shard", "family"),
)

TPU_ROOT_LEAF_STALE_SERVED = MetricSpec(
    name="tpu_root_leaf_stale_served",
    help="1 while the root is merging this leaf's LAST-KNOWN view because the leaf is currently unreachable (within --stale-serve-s). The fleet view stays populated through a root-leaf network partition — stale-but-labeled, never vanished; tpu_root_leaf_staleness_seconds says how stale.",
    type=GAUGE,
    label_names=("shard", "leaf"),
)

TPU_ROOT_LEAF_PARTITION_SUSPECTED = MetricSpec(
    name="tpu_root_leaf_partition_suspected",
    help="1 while this leaf is unreachable from the root but was healthy moments ago AND its HA twin still answers — the one-sided-unreachability shape of a network partition between root and leaf, as opposed to a dead leaf (whose liveness probe would be restarting it). TpuRootLeafPartitioned alerts on it.",
    type=GAUGE,
    label_names=("shard", "leaf"),
)

TPU_ROOT_DEDUP_STALE_WINS_TOTAL = MetricSpec(
    name="tpu_root_dedup_stale_wins_total",
    help="Series groups where the HA dedup had to take a STALER leaf's value because the shard's freshest answering leaf did not carry the series (e.g. a just-restarted leaf mid-warmup). Zero in steady state; a sustained rate means an HA pair disagrees about its shard.",
    type=COUNTER,
)

TPU_ROOT_RESHARD_MOVES_TOTAL = MetricSpec(
    name="tpu_root_reshard_moves_total",
    help="Target-to-shard assignment changes the root has observed across targets-file reloads since start (adds + removes + shard moves). A churn wave moves about (changed targets + targets/shards); TpuRootReshardStorm alerts on a sustained rate.",
    type=COUNTER,
)

TPU_ROOT_LAST_ROUND_TIMESTAMP_SECONDS = MetricSpec(
    name="tpu_root_last_round_timestamp_seconds",
    help="Unix timestamp of the root aggregator's most recent completed merge round.",
    type=GAUGE,
)

TPU_ROOT_ROUND_DURATION_SECONDS = MetricSpec(
    name="tpu_root_round_duration_seconds",
    help="Wall time of the root's last full round (scrape every leaf + merge + publish).",
    type=GAUGE,
)

TPU_ROOT_ROUND_HIST = HistogramSpec(
    name="tpu_root_round_seconds",
    help="Distribution of full root merge-round durations since start. The shard-demo round-time budget reads this.",
    buckets=POLL_DURATION_BUCKETS,
)

ROOT_SPECS: tuple[MetricSpec, ...] = (
    TPU_ROOT_LEAF_UP,
    TPU_ROOT_LEAF_STALENESS_SECONDS,
    TPU_ROOT_LEAF_STALE_SERVED,
    TPU_ROOT_LEAF_PARTITION_SUSPECTED,
    TPU_ROOT_SHARD_TARGETS,
    TPU_ROOT_SHARD_QUARANTINED_TARGETS,
    TPU_ROOT_SHARD_FAMILY_CHIPS,
    TPU_ROOT_DEDUP_STALE_WINS_TOTAL,
    TPU_ROOT_RESHARD_MOVES_TOTAL,
    TPU_ROOT_LAST_ROUND_TIMESTAMP_SECONDS,
    TPU_ROOT_ROUND_DURATION_SECONDS,
)

# --- Root fleet store (tpu_pod_exporter_torch.store) -------------------------------
# Emitted only while a FleetStore is attached to the root (--store-dir) —
# conditional surface, same rule as PERSIST/EGRESS_SPECS. The store's
# health must be auditable from the exposition alone: a full/refusing disk
# shows as append failures (TpuRootStoreAppendFailing), pressure shedding
# as thinned=1 + reason="shed" drops (TpuRootStoreDiskPressure), and a
# stalled store as a growing last-append age.

TPU_ROOT_STORE_APPENDED_SAMPLES_TOTAL = MetricSpec(
    name="tpu_root_store_appended_samples_total",
    help="Samples folded into the root fleet store's downsample tiers since start (merged rollups + per-target series + recording-rule outputs, once per root merge round).",
    type=COUNTER,
)

TPU_ROOT_STORE_APPEND_FAILURES_TOTAL = MetricSpec(
    name="tpu_root_store_append_failures_total",
    help="Store WAL appends that the filesystem refused (ENOSPC, I/O errors). The in-memory tiers keep serving; durability of the failed records is lost — TpuRootStoreAppendFailing alerts on a sustained rate.",
    type=COUNTER,
)

TPU_ROOT_STORE_SERIES = MetricSpec(
    name="tpu_root_store_series",
    help="Series currently held by the root fleet store across all downsample tiers.",
    type=GAUGE,
)

TPU_ROOT_STORE_TIER_BUCKETS = MetricSpec(
    name="tpu_root_store_tier_buckets",
    help="Finalized downsample buckets currently retained per store tier (open accumulator buckets included). 0 for a tier the disk ladder's store_thin rung has shed.",
    type=GAUGE,
    label_names=("tier",),
)

TPU_ROOT_STORE_SPAN_SECONDS = MetricSpec(
    name="tpu_root_store_span_seconds",
    help="Answerable retention span of the root fleet store — how far back a query can currently reach (the widest tier's newest-minus-oldest bucket wall time). Sized in days by --store-tiers.",
    type=GAUGE,
)

TPU_ROOT_STORE_DISK_BYTES = MetricSpec(
    name="tpu_root_store_disk_bytes",
    help="On-disk bytes of the store's pending WAL records across all tier buffers under --store-dir (what the disk ladder's budget measures).",
    type=GAUGE,
)

TPU_ROOT_STORE_MEMORY_BYTES = MetricSpec(
    name="tpu_root_store_memory_bytes",
    help="In-memory bytes of the store's tier rings (preallocated per series per enabled tier) — the number the store registers with the memory-pressure ladder.",
    type=GAUGE,
)

TPU_ROOT_STORE_DROPPED_RECORDS_TOTAL = MetricSpec(
    name="tpu_root_store_dropped_records_total",
    help="Store WAL records removed WITHOUT being replayable, by reason: 'shed' (the disk ladder's store_thin rung dropped the finest tier — policy, never silent), 'retention' (records past the tier's own span — the steady-state trim), 'corrupt' (torn/scrambled records truncated at boot).",
    type=COUNTER,
    label_names=("reason",),
)

TPU_ROOT_STORE_RULES = MetricSpec(
    name="tpu_root_store_rules",
    help="Recording rules loaded from --store-rules (each precomputes one per-slice/per-workload aggregate into its own stored series every root round).",
    type=GAUGE,
)

TPU_ROOT_STORE_RULE_FAILURES_TOTAL = MetricSpec(
    name="tpu_root_store_rule_failures_total",
    help="Recording-rule evaluations that raised (bad samples, arithmetic on absent families). The failing rule is skipped for that round; the others still evaluate.",
    type=COUNTER,
)

TPU_ROOT_STORE_LAST_APPEND_TIMESTAMP_SECONDS = MetricSpec(
    name="tpu_root_store_last_append_timestamp_seconds",
    help="Unix timestamp of the store's most recent successful round append. A growing age with the root up means the store stopped ingesting — see TpuRootStoreAppendFailing.",
    type=GAUGE,
)

TPU_ROOT_STORE_THINNED = MetricSpec(
    name="tpu_root_store_thinned",
    help="1 while the disk ladder's store_thin rung holds the store's finest tier shed (coarse tiers keep answering long windows); 0 when all tiers ingest.",
    type=GAUGE,
)

STORE_SPECS: tuple[MetricSpec, ...] = (
    TPU_ROOT_STORE_APPENDED_SAMPLES_TOTAL,
    TPU_ROOT_STORE_APPEND_FAILURES_TOTAL,
    TPU_ROOT_STORE_SERIES,
    TPU_ROOT_STORE_TIER_BUCKETS,
    TPU_ROOT_STORE_SPAN_SECONDS,
    TPU_ROOT_STORE_DISK_BYTES,
    TPU_ROOT_STORE_MEMORY_BYTES,
    TPU_ROOT_STORE_DROPPED_RECORDS_TOTAL,
    TPU_ROOT_STORE_RULES,
    TPU_ROOT_STORE_RULE_FAILURES_TOTAL,
    TPU_ROOT_STORE_LAST_APPEND_TIMESTAMP_SECONDS,
    TPU_ROOT_STORE_THINNED,
)

# --- Streaming dashboard plane (tpu_pod_exporter_torch.stream) ---------------------
# Emitted only while a StreamHub is attached to the serving tier
# (aggregator, root, or replica) — conditional surface, same rule as
# FLEET_QUERY_SPECS. The plane's health must be auditable from the
# exposition alone: subscriber churn, frames pushed by type, shed
# subscriptions by reason, and per-round push latency.

TPU_STREAM_SUBSCRIBERS = MetricSpec(
    name="tpu_stream_subscribers",
    help="Live dashboard stream subscriptions currently attached to this tier's /api/v1/stream endpoint (SSE connections; long-poll waiters are transient and not counted here).",
    type=GAUGE,
)

TPU_STREAM_QUERY_SHAPES = MetricSpec(
    name="tpu_stream_query_shapes",
    help="Distinct registered query shapes the stream hub computes per round. Each shape costs ONE delta computation per round regardless of how many subscribers share it — the fan-out inversion's whole point.",
    type=GAUGE,
)

TPU_STREAM_SUBSCRIBES_TOTAL = MetricSpec(
    name="tpu_stream_subscribes_total",
    help="Stream subscriptions accepted since start, by transport (sse | longpoll; long-poll counts one per held request).",
    type=COUNTER,
    label_names=("transport",),
)

TPU_STREAM_REJECTS_TOTAL = MetricSpec(
    name="tpu_stream_rejects_total",
    help="Stream subscriptions refused since start, by cause: 'cap' (subscriber cap reached — the admission half of the pressure story; clients get a 429 and should retry against a replica).",
    type=COUNTER,
    label_names=("cause",),
)

TPU_STREAM_FRAMES_TOTAL = MetricSpec(
    name="tpu_stream_frames_total",
    help="Frames pushed to subscribers since start, by type: snapshot (registration answer), delta (changed series only), full_sync (periodic anti-rot full answer), heartbeat.",
    type=COUNTER,
    label_names=("type",),
)

TPU_STREAM_FRAME_BYTES_TOTAL = MetricSpec(
    name="tpu_stream_frame_bytes_total",
    help="Wire bytes of frames pushed to subscribers since start (serialized once per shape per round, counted once per subscriber write).",
    type=COUNTER,
)

TPU_STREAM_SHEDS_TOTAL = MetricSpec(
    name="tpu_stream_sheds_total",
    help="Live subscriptions closed by the server since start, by reason: 'pressure' (the memory ladder's stream_shed rung dropped the oldest half), 'slow' (a subscriber's pending write buffer exceeded the cap), 'cap' (oldest shed to admit pressure-exempt work).",
    type=COUNTER,
    label_names=("reason",),
)

TPU_STREAM_PUSH_SECONDS = HistogramSpec(
    name="tpu_stream_push_seconds",
    help="Per-round push latency per query shape: delta computation plus handing every subscriber's frame to the event loop (socket flush is asynchronous and bounded by the write-progress deadline). The dashboard-storm drill's p99 budget reads this.",
    buckets=POLL_DURATION_BUCKETS,
)

STREAM_SPECS: tuple[MetricSpec, ...] = (
    TPU_STREAM_SUBSCRIBERS,
    TPU_STREAM_QUERY_SHAPES,
    TPU_STREAM_SUBSCRIBES_TOTAL,
    TPU_STREAM_REJECTS_TOTAL,
    TPU_STREAM_FRAMES_TOTAL,
    TPU_STREAM_FRAME_BYTES_TOTAL,
    TPU_STREAM_SHEDS_TOTAL,
)

# --- Stateless root read replicas (tpu-pod-exporter-shard --role replica) ----
# A replica scrapes the leaves read-only exactly like the root and serves
# /metrics + /api/v1 + /api/v1/stream, but owns no egress, no persistence
# and no store writes — viewer fan-out scales by adding replicas while
# exactly one root keeps the write-side duties.

TPU_REPLICA_INFO = MetricSpec(
    name="tpu_replica_info",
    help="Identity of this stateless read replica (value always 1). Present only on --role replica tiers; its absence from a /metrics body is how you know you are talking to the real root.",
    type=GAUGE,
    label_names=("replica",),
)

TPU_REPLICA_STORE_PROXIED_TOTAL = MetricSpec(
    name="tpu_replica_store_proxied_total",
    help="?source= store queries this replica forwarded to the root's store (--root-url), by result (ok | error). Replicas own no store; without --root-url these queries 400 honestly instead.",
    type=COUNTER,
    label_names=("result",),
)

REPLICA_SPECS: tuple[MetricSpec, ...] = (
    TPU_REPLICA_INFO,
    TPU_REPLICA_STORE_PROXIED_TOTAL,
)

# --- Native alerting plane (tpu_pod_exporter_torch.alerting) -----------------------
# Emitted only while an AlertEvaluator is attached to the root
# (--alert-rules) — conditional surface, same rule as STORE_SPECS. The
# plane's health must be auditable from the exposition alone: what is
# firing/pending right now, how states have been transitioning, whether
# partition suppression is holding false positives down, and whether the
# webhook notifier is delivering or backlogging.

TPU_ROOT_ALERTS_FIRING = MetricSpec(
    name="tpu_root_alerts_firing",
    help="Alert instances currently in the firing (or keep-firing) state across every loaded alert rule. The same instants land in the fleet store as ALERTS-shaped series for post-incident forensics.",
    type=GAUGE,
)

TPU_ROOT_ALERTS_PENDING = MetricSpec(
    name="tpu_root_alerts_pending",
    help="Alert instances currently pending: their expression is true but has not yet held for the rule's `for` duration.",
    type=GAUGE,
)

TPU_ROOT_ALERT_TRANSITIONS_TOTAL = MetricSpec(
    name="tpu_root_alert_transitions_total",
    help="Alert state-machine transitions since start, by alert name and destination state (to: pending | firing | resolved). Flap damping (`keep_firing`) absorbs brief recoveries, so a high rate here means genuinely flapping conditions.",
    type=COUNTER,
    label_names=("alert", "to"),
)

TPU_ROOT_ALERT_SUPPRESSED_TOTAL = MetricSpec(
    name="tpu_root_alert_suppressed_total",
    help="Alert-instance evaluations suppressed since start, by alert name: the rule's suppress() expression matched (e.g. the root's stale-serve partition suspicion covering the instance), so a would-be pending/firing state was held down as a presumed false positive.",
    type=COUNTER,
    label_names=("alert",),
)

TPU_ROOT_ALERT_RULES = MetricSpec(
    name="tpu_root_alert_rules",
    help="Alert rules loaded from --alert-rules and evaluated each root merge round.",
    type=GAUGE,
)

TPU_ROOT_ALERT_EVAL_FAILURES_TOTAL = MetricSpec(
    name="tpu_root_alert_eval_failures_total",
    help="Alert-rule evaluations that raised (absent families feeding arithmetic, bad samples). The failing rule is skipped for that round, the others still evaluate; a sustained rate flips /readyz's alerting detail to degraded.",
    type=COUNTER,
)

TPU_ROOT_ALERT_NOTIFICATIONS_SENT_TOTAL = MetricSpec(
    name="tpu_root_alert_notifications_sent_total",
    help="Webhook notifications acknowledged by the receiver since start (2xx — the exactly-once cursor advanced past them; they are never re-sent, even across a root restart).",
    type=COUNTER,
)

TPU_ROOT_ALERT_NOTIFICATIONS_FAILED_TOTAL = MetricSpec(
    name="tpu_root_alert_notifications_failed_total",
    help="Webhook notification attempts that failed since start (timeout, connection error, 5xx, 429). Failed notifications stay in the durable backlog and retry behind the notifier breaker.",
    type=COUNTER,
)

TPU_ROOT_ALERT_NOTIFIER_BACKLOG_BYTES = MetricSpec(
    name="tpu_root_alert_notifier_backlog_bytes",
    help="On-disk bytes of alert notifications buffered under --alert-dir awaiting webhook delivery (grows through a receiver outage, drains exactly-once on recovery).",
    type=GAUGE,
)

TPU_ROOT_ALERT_NOTIFIER_BACKLOG_AGE_SECONDS = MetricSpec(
    name="tpu_root_alert_notifier_backlog_age_seconds",
    help="Age of the oldest alert notification still awaiting webhook delivery. 0 with an empty backlog; a growing value means the webhook receiver has been down that long.",
    type=GAUGE,
)

TPU_ROOT_ALERT_NOTIFIER_BREAKER_STATE = MetricSpec(
    name="tpu_root_alert_notifier_breaker_state",
    help="Webhook notifier circuit-breaker state (0=closed 1=open 2=half_open). Open means notifications are WAL-buffered, not flowing; /readyz reports alerting degraded after repeated reopens but stays 200 — a down webhook must not pull the root from scrape rotation.",
    type=GAUGE,
)

ALERT_SPECS: tuple[MetricSpec, ...] = (
    TPU_ROOT_ALERTS_FIRING,
    TPU_ROOT_ALERTS_PENDING,
    TPU_ROOT_ALERT_TRANSITIONS_TOTAL,
    TPU_ROOT_ALERT_SUPPRESSED_TOTAL,
    TPU_ROOT_ALERT_RULES,
    TPU_ROOT_ALERT_EVAL_FAILURES_TOTAL,
    TPU_ROOT_ALERT_NOTIFICATIONS_SENT_TOTAL,
    TPU_ROOT_ALERT_NOTIFICATIONS_FAILED_TOTAL,
    TPU_ROOT_ALERT_NOTIFIER_BACKLOG_BYTES,
    TPU_ROOT_ALERT_NOTIFIER_BACKLOG_AGE_SECONDS,
    TPU_ROOT_ALERT_NOTIFIER_BREAKER_STATE,
)

# The rollup surface the aggregator's remote-write egress ships
# (tpu_pod_exporter_torch.egress): the slice/multislice/workload rollups plus
# per-target up — the "what is the fleet doing" set a central TSDB wants,
# not the aggregator's own plumbing counters.
AGGREGATE_EGRESS_SPECS: tuple[MetricSpec, ...] = (
    TPU_FLEET_FAMILY_HOSTS_REPORTING,
    TPU_FLEET_FAMILY_CHIP_COUNT,
    TPU_FLEET_FAMILY_HBM_USED_BYTES,
    TPU_FLEET_FAMILY_HBM_TOTAL_BYTES,
    TPU_SLICE_HOSTS_REPORTING,
    TPU_SLICE_CHIP_COUNT,
    TPU_SLICE_HBM_USED_BYTES,
    TPU_SLICE_HBM_TOTAL_BYTES,
    TPU_SLICE_HBM_USED_PERCENT,
    TPU_SLICE_DUTY_CYCLE_AVG_PERCENT,
    TPU_SLICE_ICI_BYTES_PER_SECOND,
    TPU_SLICE_DCN_BYTES_PER_SECOND,
    TPU_MULTISLICE_SLICES_REPORTING,
    TPU_MULTISLICE_EXPECTED_SLICES,
    TPU_MULTISLICE_HOSTS_REPORTING,
    TPU_MULTISLICE_CHIP_COUNT,
    TPU_MULTISLICE_HBM_USED_BYTES,
    TPU_MULTISLICE_ICI_BYTES_PER_SECOND,
    TPU_MULTISLICE_DCN_BYTES_PER_SECOND,
    TPU_WORKLOAD_CHIP_COUNT,
    TPU_WORKLOAD_HBM_USED_BYTES,
    TPU_WORKLOAD_HOSTS,
    TPU_AGG_TARGET_UP,
)

AGGREGATE_SPECS: tuple[MetricSpec, ...] = (
    TPU_SLICE_HOSTS_REPORTING,
    TPU_SLICE_CHIP_COUNT,
    TPU_SLICE_HBM_USED_BYTES,
    TPU_SLICE_HBM_TOTAL_BYTES,
    TPU_SLICE_HBM_USED_PERCENT,
    TPU_SLICE_DUTY_CYCLE_AVG_PERCENT,
    TPU_SLICE_ICI_BYTES_PER_SECOND,
    TPU_SLICE_DCN_BYTES_PER_SECOND,
    TPU_MULTISLICE_SLICES_REPORTING,
    TPU_MULTISLICE_EXPECTED_SLICES,
    TPU_MULTISLICE_HOSTS_REPORTING,
    TPU_MULTISLICE_CHIP_COUNT,
    TPU_MULTISLICE_HBM_USED_BYTES,
    TPU_MULTISLICE_ICI_BYTES_PER_SECOND,
    TPU_MULTISLICE_DCN_BYTES_PER_SECOND,
    TPU_FLEET_FAMILY_HOSTS_REPORTING,
    TPU_FLEET_FAMILY_CHIP_COUNT,
    TPU_FLEET_FAMILY_HBM_USED_BYTES,
    TPU_FLEET_FAMILY_HBM_TOTAL_BYTES,
    TPU_WORKLOAD_CHIP_COUNT,
    TPU_WORKLOAD_HBM_USED_BYTES,
    TPU_WORKLOAD_HOSTS,
    TPU_AGG_TARGET_UP,
    TPU_AGG_TARGET_BREAKER_STATE,
    TPU_AGG_SCRAPE_DURATION_SECONDS,
    TPU_AGG_SCRAPE_ERRORS_TOTAL,
    TPU_AGG_HISTORY_FALLBACKS_TOTAL,
    TPU_AGG_LAST_ROUND_TIMESTAMP_SECONDS,
    TPU_AGG_ROUND_DURATION_SECONDS,
    TPU_AGG_POLL_OVERRUNS_TOTAL,
    TPU_AGG_CPU_SECONDS_TOTAL,
    TPU_AGG_RSS_BYTES,
)


def hbm_used_percent(used_bytes: float, total_bytes: float) -> float:
    """Bytes → percent-of-device-total (analog of ``main.go:149-150``).

    Returns 0.0 when capacity is unknown/zero instead of dividing by zero.
    """
    if total_bytes <= 0:
        return 0.0
    return (float(used_bytes) / float(total_bytes)) * 100.0
