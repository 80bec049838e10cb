"""Scripted fake device backend — the test/bench seam (SURVEY.md §4.2).

Supports:
- static chip sets (N chips with fixed capacities),
- scripted time series (each call advances a script of samples),
- fault injection: raise on the next N calls, or per-chip partial errors,
- synthetic load shapes for benchmarks (deterministic pseudo-traffic).

Zero-device operation (``FakeBackend(chips=0)``) is baseline config 1: the
exporter must come up, serve ``/metrics``, and report itself healthy with no
devices present — something the reference cannot do at all (NVML init failure
is fatal, ``main.go:45-48``).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Callable, Iterable, Sequence

from tpu_pod_exporter_torch.backend import (
    BackendError,
    ChipInfo,
    ChipSample,
    DeviceBackend,
    HostSample,
    IciLinkSample,
)

DEFAULT_HBM_TOTAL = 96 * 1024**3  # v5p-class chip: 95-96 GiB HBM  [design]


@dataclass
class FakeChipScript:
    """Per-chip scripted telemetry. Values may be scalars (constant) or
    callables of the poll index."""

    hbm_total_bytes: float = DEFAULT_HBM_TOTAL
    hbm_used_bytes: float | Callable[[int], float] = 0.0
    hbm_peak_bytes: float | Callable[[int], float] | None = None
    duty_cycle_percent: float | Callable[[int], float] | None = 0.0
    ici_link_count: int = 6  # 3D torus: ±x, ±y, ±z  [design]
    # cumulative bytes per link per poll step
    ici_bytes_per_step: float | Callable[[int], float] = 0.0
    # DCN (cross-slice fabric) links — 0 outside multi-slice shapes.
    dcn_link_count: int = 0
    dcn_bytes_per_step: float | Callable[[int], float] = 0.0

    _LINK_IDS = tuple(str(i) for i in range(16))

    def _resolve(self, v, step: int) -> float:
        return float(v(step)) if callable(v) else float(v)

    def sample(
        self, info: ChipInfo, step: int, link_cache: dict | None = None
    ) -> ChipSample:
        duty = None
        if self.duty_cycle_percent is not None:
            duty = self._resolve(self.duty_cycle_percent, step)
        per_step = self._resolve(self.ici_bytes_per_step, step)
        links = None
        if link_cache is not None:
            # Link tuples are immutable and identical for every chip sharing
            # (per-step rate, link count) — share one tuple across the host
            # instead of allocating chips × links samples per poll (the
            # fake's own construction cost must stay out of the exporter's
            # CPU budget at 256-chip bench scale).
            links = link_cache.get((per_step, self.ici_link_count))
        if links is None:
            total = per_step * (step + 1)
            ids = self._LINK_IDS
            if self.ici_link_count > len(ids):
                ids = tuple(str(i) for i in range(self.ici_link_count))
            # tuple.__new__ bypasses the generated NamedTuple __new__
            # (a Python function).
            mk = tuple.__new__
            links = tuple(
                mk(IciLinkSample, (ids[li], total))
                for li in range(self.ici_link_count)
            )
            if link_cache is not None:
                link_cache[(per_step, self.ici_link_count)] = links
        dcn_links: tuple = ()
        if self.dcn_link_count:
            dcn_total = self._resolve(self.dcn_bytes_per_step, step) * (step + 1)
            mk = tuple.__new__
            dcn_links = tuple(
                mk(IciLinkSample, (f"dcn{li}", dcn_total))
                for li in range(self.dcn_link_count)
            )
        peak = None
        if self.hbm_peak_bytes is not None:
            peak = self._resolve(self.hbm_peak_bytes, step)
        return ChipSample(
            info=info,
            hbm_used_bytes=self._resolve(self.hbm_used_bytes, step),
            hbm_total_bytes=self.hbm_total_bytes,
            tensorcore_duty_cycle_percent=duty,
            ici_links=links,
            hbm_peak_bytes=peak,
            dcn_links=dcn_links,
        )


class FakeBackend(DeviceBackend):
    name = "fake"

    def __init__(
        self,
        chips: int | Sequence[ChipInfo] = 0,
        script: FakeChipScript | Sequence[FakeChipScript] | None = None,
        device_path_fmt: str = "/dev/accel{chip_id}",
        family: str = "tpu",
    ) -> None:
        # A GPU-family fake (family="gpu") models an NVML-backed node for
        # mixed-fleet tests without the nvml module: chips publish under
        # the gpu_* namespace via ChipInfo.family, exactly like NvmlBackend.
        self.family = family
        if isinstance(chips, int):
            self._infos = tuple(
                ChipInfo(chip_id=i, device_path=device_path_fmt.format(chip_id=i),
                         family=family)
                for i in range(chips)
            )
        else:
            self._infos = tuple(chips)
        if script is None:
            scripts: list[FakeChipScript] = [FakeChipScript() for _ in self._infos]
        elif isinstance(script, FakeChipScript):
            scripts = [script for _ in self._infos]
        else:
            scripts = list(script)
            if len(scripts) != len(self._infos):
                raise ValueError("one script per chip required")
        self._scripts = scripts
        self._step = 0
        self._lock = threading.Lock()
        self._fail_next = 0
        self._partial_errors: list[str] = []
        self.sample_calls = 0
        self.closed = False

    # -- fault injection (SURVEY.md §4.5) ------------------------------------

    def fail_next(self, n: int = 1) -> None:
        """Make the next n sample() calls raise BackendError."""
        with self._lock:
            self._fail_next += n

    def set_partial_errors(self, errors: Iterable[str]) -> None:
        with self._lock:
            self._partial_errors = list(errors)

    # -- DeviceBackend -------------------------------------------------------

    def sample(self) -> HostSample:
        with self._lock:
            self.sample_calls += 1
            if self._fail_next > 0:
                self._fail_next -= 1
                raise BackendError("fake backend: injected failure")
            step = self._step
            self._step += 1
            partial = tuple(self._partial_errors)
        link_cache: dict = {}  # per-poll: shared link tuples across chips
        chips = tuple(
            script.sample(info, step, link_cache)
            for info, script in zip(self._infos, self._scripts)
        )
        return HostSample(chips=chips, partial_errors=partial)

    def close(self) -> None:
        self.closed = True


def ramping_usage(base: float, step_bytes: float, cap: float) -> Callable[[int], float]:
    """Usage that climbs by step_bytes per poll up to cap — churn/stress shapes."""

    def fn(step: int) -> float:
        return min(base + step * step_bytes, cap)

    return fn


def bench_backend(chips: int, hbm_total: float = DEFAULT_HBM_TOTAL) -> FakeBackend:
    """Deterministic non-trivial load for benchmarks: distinct per-chip values
    so the encoder can't shortcut identical strings."""
    scripts = [
        FakeChipScript(
            hbm_total_bytes=hbm_total,
            hbm_used_bytes=(lambda c: (lambda step: (c * 7919 + step * 104729) % int(hbm_total)))(c),
            duty_cycle_percent=(lambda c: (lambda step: float((c * 13 + step * 29) % 101)))(c),
            ici_bytes_per_step=1_000_000.0,
        )
        for c in range(chips)
    ]
    infos = [ChipInfo(chip_id=i, device_path=f"/dev/accel{i}") for i in range(chips)]
    return FakeBackend(chips=infos, script=scripts)
