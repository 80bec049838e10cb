"""End-to-end hardware validation: live exporter + real load + assertions.

Ported from ``tpu_pod_exporter/hwcheck.py``. Run it on a machine with a
CUDA card and it produces an artifact showing that the exporter's values
respond to real load:

    python -m tpu_pod_exporter_torch.hwcheck --out HWCHECK.json

Three phases against a live exporter scraped over real HTTP:
  1. **idle** — baseline device-memory readings.
  2. **load** — hold a large device allocation and spin the bf16 matmul
     chain (``loadgen``, one hand-written kernel per layer) while scraping.
  3. **release** — free the allocation, scrape again.

Assertions: device memory used rises under load and falls after release;
utilization responds when the backend reports it (NVML does; the torch
backend does not, and the artifact says so). The JAX package also probes
the libtpu metrics service; that probe has no counterpart on a GPU, and the
artifact records ``"probe": "not ported"``.

``--backend nvml`` reads the whole card through NVML, as a DaemonSet does;
``--backend torch`` reads this process's allocator. For the gpu family each
phase also records the per-process, per-holder and per-pod series.
``--backend fake`` drives the identical orchestration against a scripted
backend — how the harness itself is tested with no card.
"""

from __future__ import annotations

import argparse
import json
import sys
import threading
import time
import urllib.request

# Per-chip series the check reads, by the backend family's namespace.
_SERIES = {
    "tpu": {
        "tpu_hbm_used_bytes": "used",
        "tpu_hbm_total_bytes": "total",
        "tpu_hbm_peak_bytes": "peak",
        "tpu_tensorcore_duty_cycle_percent": "duty",
    },
    "gpu": {
        "gpu_hbm_used_bytes": "used",
        "gpu_hbm_total_bytes": "total",
        "gpu_utilization_percent": "duty",
    },
}


def _scrape(base: str) -> list:
    """One /metrics scrape, parsed into samples."""
    from tpu_pod_exporter_torch.metrics.parse import parse_exposition

    with urllib.request.urlopen(base + "/metrics", timeout=5) as resp:
        return list(parse_exposition(resp.read().decode()))


def _sum_by(samples: list, name: str, *labels: str) -> dict:
    """{"label/label": summed value} over the samples of ``name``."""
    out: dict = {}
    for s in samples:
        if s.name == name:
            key = "/".join(s.labels.get(label, "") for label in labels)
            out[key] = out.get(key, 0.0) + s.value
    return out


def _totals(samples: list, family: str) -> dict:
    """Sum per role across chips; duty is max (any busy card counts). The
    gpu family adds the process table by pid, the procfs holders, the pod
    rollup by pod and the reference's {pid, pod} series."""
    names = _SERIES[family]
    series = {(names[s.name], s.labels.get("chip_id", "")): s.value
              for s in samples if s.name in names}

    def values(role: str) -> list:
        return [v for (r, _), v in series.items() if r == role]

    peaks = values("peak")
    duties = values("duty")
    # The exporter's own poll phases: ms of the last poll, and the mean
    # since it started (the first poll's includes the backend's init).
    last = _sum_by(samples, "tpu_exporter_poll_duration_seconds", "phase")
    sums = _sum_by(samples, "tpu_exporter_poll_phase_duration_seconds_sum", "phase")
    counts = _sum_by(samples, "tpu_exporter_poll_phase_duration_seconds_count", "phase")
    out = {
        "hbm_used_bytes": sum(values("used")),
        "hbm_total_bytes": sum(values("total")),
        "hbm_peak_bytes_max": max(peaks) if peaks else None,
        "duty_cycle_max_percent": max(duties) if duties else None,
        "series": len(series),
        "poll_phase_last_ms": {phase: t * 1e3 for phase, t in last.items()},
        "poll_phase_mean_ms": {phase: sums[phase] / n * 1e3
                               for phase, n in counts.items() if n},
    }
    if family == "gpu":
        out["process_memory_bytes"] = _sum_by(
            samples, "gpu_process_memory_used_bytes", "pid")
        out["holder_pids"] = sorted(
            {s.labels["pid"] for s in samples if s.name == "tpu_chip_process_info"})
        out["pod_memory_bytes"] = _sum_by(samples, "gpu_pod_memory_used_bytes", "pod")
        out["legacy_pod_memory_bytes"] = _sum_by(
            samples, "pod_gpu_memory_usage", "pid", "pod")
    return out


class FakeStimulus:
    """Flips the fake backend's script values — tests the orchestration."""

    def __init__(self, backend):
        self._scripts = backend._scripts

    def start(self) -> None:
        for s in self._scripts:
            s.hbm_used_bytes = 8 * 1024**3
            s.duty_cycle_percent = 85.0

    def stop(self) -> None:
        for s in self._scripts:
            s.hbm_used_bytes = 1 * 1024**3
            s.duty_cycle_percent = 0.0


class TorchStimulus:
    """Real load: hold a device allocation + spin the bf16 matmul chain.

    The defaults mirror the JAX package's stimulus (1 GiB held; width 1024,
    depth 4, batch 256; 20 forwards per burn step). ``stop()`` joins the
    burn thread, drops every tensor and hands the cached blocks back to
    the driver, so both the allocator's count (the torch backend's used)
    and the driver's (NVML's used) fall. An error in the burn thread is
    raised again from ``stop()``.
    """

    def __init__(self, hbm_bytes: int = 1 << 30, width: int = 1024,
                 depth: int = 4, batch: int = 256, iters: int = 20,
                 device=None):
        self._hbm_bytes = hbm_bytes
        self._width = width
        self._depth = depth
        self._batch = batch
        self._iters = iters
        self._device = device
        self._held = None
        self._burning = threading.Event()
        self._thread: threading.Thread | None = None
        self._error: Exception | None = None
        self.steps = 0

    def start(self) -> None:
        import torch

        from tpu_pod_exporter_torch.cudaenv import require_cuda
        from tpu_pod_exporter_torch.loadgen.workload import (
            burn_step,
            hbm_fill,
            init_params,
        )

        dev = require_cuda(self._device)
        self._held = hbm_fill(self._hbm_bytes, device=dev)
        params = init_params(width=self._width, depth=self._depth, device=dev)
        x = torch.ones((self._batch, self._width), dtype=torch.bfloat16,
                       device=dev)
        self._burning.set()

        def burn() -> None:
            try:
                while self._burning.is_set():
                    burn_step(params, x, iters=self._iters)
                    torch.cuda.synchronize(dev)
                    self.steps += 1
            except Exception as e:  # noqa: BLE001 — re-raised by stop()
                self._error = e

        self._thread = threading.Thread(
            target=burn, name="gpu-hwcheck-burn", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        import torch

        self._burning.clear()
        if self._thread is not None:
            self._thread.join(timeout=60)
            if self._thread.is_alive():
                raise RuntimeError("burn thread did not stop within 60 s")
        self._held = None  # drop the reference; the allocator reclaims it
        torch.cuda.empty_cache()  # NVML counts what the allocator caches
        if self._error is not None:
            raise RuntimeError("burn thread failed") from self._error


def run_check(
    backend: str = "torch",
    idle_s: float = 2.0,
    load_s: float = 8.0,
    stimulus=None,
    exporter_args: dict | None = None,
) -> dict:
    """Run the three-phase check; returns the artifact dict.

    ``backend`` is "nvml" or "torch" (the card, with a default
    :class:`TorchStimulus`) or "fake" (scripted chips,
    :class:`FakeStimulus`). ``stimulus`` replaces the default load: any
    object with ``start()`` and ``stop()``. ``exporter_args`` sets further
    :class:`ExporterConfig` fields (attribution, process metrics, …).
    """
    from tpu_pod_exporter_torch.app import ExporterApp
    from tpu_pod_exporter_torch.config import ExporterConfig

    if backend not in ("nvml", "torch", "fake"):
        raise ValueError(
            f"hwcheck backend must be nvml, torch or fake, not {backend!r}")
    cfg = ExporterConfig(**{
        "port": 0,
        "host": "127.0.0.1",
        "interval_s": 0.25,
        "backend": backend,
        "attribution": "none",
        "fake_chips": 2 if backend == "fake" else 0,
        **(exporter_args or {}),
    })
    app = ExporterApp(cfg)
    family = getattr(app.backend, "family", "tpu")
    report: dict = {"backend": backend, "family": family, "phases": {},
                    "checks": {}, "ok": False,
                    # The libtpu metrics-service probe has no GPU counterpart.
                    "probe": "not ported"}
    app.start()
    try:
        base = f"http://127.0.0.1:{app.port}"
        if stimulus is not None:
            stim = stimulus
        elif backend == "fake":
            stim = FakeStimulus(app.backend)
        else:
            stim = TorchStimulus()

        time.sleep(idle_s)
        idle = _totals(_scrape(base), family)
        report["phases"]["idle"] = idle

        stim.start()
        try:
            time.sleep(load_s)
            loaded = _totals(_scrape(base), family)
            report["phases"]["load"] = loaded
        finally:
            stim.stop()

        time.sleep(max(idle_s, 1.0))
        after = _totals(_scrape(base), family)
        report["phases"]["release"] = after

        checks = report["checks"]
        checks["hbm_rises_under_load"] = (
            loaded["hbm_used_bytes"] > idle["hbm_used_bytes"]
        )
        checks["hbm_falls_after_release"] = (
            after["hbm_used_bytes"] < loaded["hbm_used_bytes"]
        )
        if loaded["duty_cycle_max_percent"] is None:
            checks["duty_cycle_responds"] = None  # backend doesn't report it
            report["duty_cycle_note"] = (
                f"backend {backend!r} reports no utilization"
            )
        else:
            checks["duty_cycle_responds"] = (
                loaded["duty_cycle_max_percent"]
                > (idle["duty_cycle_max_percent"] or 0.0)
            )
        report["ok"] = all(v is not False for v in checks.values())
    finally:
        app.stop()
    return report


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--backend", default="torch", choices=["nvml", "torch", "fake"])
    p.add_argument("--idle-s", type=float, default=2.0)
    p.add_argument("--load-s", type=float, default=8.0)
    p.add_argument("--out", default="", help="write the artifact JSON here")
    args = p.parse_args(argv)
    report = run_check(
        backend=args.backend,
        idle_s=args.idle_s,
        load_s=args.load_s,
    )
    text = json.dumps(report, indent=2, sort_keys=True)
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
