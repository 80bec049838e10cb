from tpu_pod_exporter_torch.metrics.registry import (
    COUNTER,
    GAUGE,
    HISTOGRAM,
    CounterStore,
    HistogramSpec,
    HistogramStore,
    MetricSpec,
    PrefixCache,
    Snapshot,
    SnapshotBuilder,
    SnapshotStore,
)

__all__ = [
    "COUNTER",
    "GAUGE",
    "HISTOGRAM",
    "CounterStore",
    "HistogramSpec",
    "HistogramStore",
    "MetricSpec",
    "PrefixCache",
    "Snapshot",
    "SnapshotBuilder",
    "SnapshotStore",
]
