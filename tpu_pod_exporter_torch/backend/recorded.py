"""Record/replay device backend — the third seam (SURVEY.md §7: "real
(libtpu), fake (tests), and a recorded mode for benchmarks").

``RecordingBackend`` wraps any backend and appends every HostSample to a
JSONL file; ``RecordedBackend`` replays such a file deterministically (loop
or hold-last). This turns one session against real hardware into a
repeatable benchmark/regression input with genuine value distributions —
something the reference has no equivalent for.

JSONL schema (one poll per line; optional keys are omitted when absent so
old recordings replay unchanged):
    {"chips": [{"chip_id": 0, "device_path": "...", "device_ids": ["0"],
                "hbm_used": N, "hbm_total": N, "duty": N|null,
                "ici": {"0": N, ...}, "dcn": {"0": N, ...}?,
                "peak": N?, "device_kind": "..."?, "coords": "..."?,
                "family": "gpu"?, "procs": [[pid, used_bytes, "comm"], ...]?},
               ...],
     "partial_errors": ["..."]}

GPU samples (the NVML-shaped backend) ride the same schema: ``family``
marks the chip's namespace (omitted = "tpu", so every pre-GPU recording
replays unchanged), ``duty`` carries the NVML utilization rate, and
``procs`` carries the per-process device-memory table — the committed
``tests/fixtures/gpu-recorded.jsonl`` runs the whole GPU path
deterministically without a driver.
"""

from __future__ import annotations

import json
import threading
from typing import IO

from tpu_pod_exporter_torch.backend import (
    BackendError,
    ChipInfo,
    ChipSample,
    DeviceBackend,
    DeviceProcessSample,
    HostSample,
    IciLinkSample,
)


# Same numeric-first link ordering the live libtpu backend emits: replay
# must be ORDER-faithful too, or numeric ids >= 10 come back
# lexicographically shuffled and the collector's layout fast path sees a
# different link sequence than the backend being reproduced. (Own copy of
# tpu_pod_exporter/backend/libtpu.py:_link_sort_key; libtpu is not ported.)
def _link_sort_key(item: tuple[str, float]):
    try:
        return (0, int(item[0]))
    except ValueError:
        return (1, item[0])


def sample_to_dict(sample: HostSample) -> dict:
    chips = []
    for c in sample.chips:
        doc = {
            "chip_id": c.info.chip_id,
            "device_path": c.info.device_path,
            "device_ids": list(c.info.device_ids),
            "hbm_used": c.hbm_used_bytes,
            "hbm_total": c.hbm_total_bytes,
            "duty": c.tensorcore_duty_cycle_percent,
            "ici": {l.link: l.transferred_bytes_total for l in c.ici_links},
        }
        if c.dcn_links:  # omitted when absent: old recordings replay unchanged
            doc["dcn"] = {
                l.link: l.transferred_bytes_total for l in c.dcn_links
            }
        if c.hbm_peak_bytes is not None:
            doc["peak"] = c.hbm_peak_bytes
        if c.info.device_kind:
            doc["device_kind"] = c.info.device_kind
        if c.info.coords:
            doc["coords"] = c.info.coords
        if c.info.family != "tpu":  # omitted = tpu: old recordings replay unchanged
            doc["family"] = c.info.family
        if c.processes:
            doc["procs"] = [
                [p.pid, p.used_bytes, p.comm] for p in c.processes
            ]
        chips.append(doc)
    return {
        "chips": chips,
        "partial_errors": list(sample.partial_errors),
    }


def sample_from_dict(doc: dict) -> HostSample:
    chips = []
    for c in doc.get("chips", []):
        chips.append(
            ChipSample(
                info=ChipInfo(
                    chip_id=int(c["chip_id"]),
                    device_path=c.get("device_path", ""),
                    device_ids=tuple(c.get("device_ids") or [str(c["chip_id"])]),
                    device_kind=c.get("device_kind", ""),
                    coords=c.get("coords", ""),
                    family=str(c.get("family", "tpu")),
                ),
                hbm_used_bytes=(
                    None if c["hbm_used"] is None else float(c["hbm_used"])
                ),
                hbm_total_bytes=(
                    None if c["hbm_total"] is None else float(c["hbm_total"])
                ),
                tensorcore_duty_cycle_percent=(
                    None if c.get("duty") is None else float(c["duty"])
                ),
                ici_links=tuple(
                    IciLinkSample(link=str(k), transferred_bytes_total=float(v))
                    for k, v in sorted(
                        (c.get("ici") or {}).items(), key=_link_sort_key
                    )
                ),
                hbm_peak_bytes=(
                    None if c.get("peak") is None else float(c["peak"])
                ),
                dcn_links=tuple(
                    IciLinkSample(link=str(k), transferred_bytes_total=float(v))
                    for k, v in sorted(
                        (c.get("dcn") or {}).items(), key=_link_sort_key
                    )
                ),
                processes=tuple(
                    DeviceProcessSample(
                        pid=int(p[0]), used_bytes=float(p[1]),
                        comm=str(p[2]) if len(p) > 2 else "",
                    )
                    for p in (c.get("procs") or ())
                ),
            )
        )
    return HostSample(
        chips=tuple(chips),
        partial_errors=tuple(doc.get("partial_errors", [])),
    )


class RecordingBackend(DeviceBackend):
    """Pass-through wrapper that records every sample to a JSONL stream."""

    name = "recording"

    def __init__(self, inner: DeviceBackend, sink: str | IO[str]) -> None:
        self._inner = inner
        self._own_file = isinstance(sink, str)
        self._sink: IO[str] = open(sink, "a") if isinstance(sink, str) else sink
        self._lock = threading.Lock()
        self.name = f"recording({inner.name})"
        self.family = getattr(inner, "family", "tpu")

    def sample(self) -> HostSample:
        sample = self._inner.sample()  # BackendError propagates untouched
        line = json.dumps(sample_to_dict(sample))
        with self._lock:
            self._sink.write(line + "\n")
            self._sink.flush()
        return sample

    def close(self) -> None:
        self._inner.close()
        if self._own_file:
            self._sink.close()


class RecordedBackend(DeviceBackend):
    """Deterministic replay of a recorded JSONL trace."""

    name = "recorded"

    def __init__(self, path: str, loop: bool = True) -> None:
        self._samples: list[HostSample] = []
        try:
            with open(path) as f:
                for ln, line in enumerate(f, 1):
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        self._samples.append(sample_from_dict(json.loads(line)))
                    except (
                        json.JSONDecodeError,
                        KeyError,
                        ValueError,
                        # float()/.items() on a structurally wrong value
                        # (e.g. "dcn": {"0": [1,2]} or "ici": 5) raise
                        # TypeError/AttributeError — a corrupt record must
                        # report path:line, not a raw traceback.
                        TypeError,
                        AttributeError,
                    ) as e:
                        raise BackendError(f"{path}:{ln}: bad record: {e}") from e
        except OSError as e:
            raise BackendError(f"cannot read recording {path}: {e}") from e
        if not self._samples:
            raise BackendError(f"recording {path} is empty")
        # A replayed GPU recording keeps its family: gpu_backend_up and the
        # gpu_* surface come up exactly as they would against the live
        # NVML backend the trace was captured from.
        first_chips = self._samples[0].chips
        if first_chips and all(c.info.family == "gpu" for c in first_chips):
            self.family = "gpu"
        self._loop = loop
        self._i = 0
        self._lock = threading.Lock()

    def __len__(self) -> int:
        return len(self._samples)

    def sample(self) -> HostSample:
        with self._lock:
            if self._i >= len(self._samples):
                if self._loop:
                    self._i = 0
                else:
                    return self._samples[-1]  # hold last frame
            s = self._samples[self._i]
            self._i += 1
        return s
