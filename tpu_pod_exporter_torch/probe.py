"""Ground-truth probe of a device runtime's metrics surface.

Answers "what does this runtime actually serve?": the analog of the
reference live-querying every device (``main.go:129-138``).

``--runtime nvml`` (the default) asks the NVIDIA driver's NVML library
through the package's ctypes binding, never ``pynvml``:

    python -m tpu_pod_exporter_torch.probe [--runtime nvml] [--out report.json]

  {"runtime": "nvml", "library": "libnvidia-ml.so.1", "reachable": bool,
   "count": N | null,
   "devices": [{"index": i, "name": ..., "uuid": ..., "minor": ...,
                "memory_total_bytes": ..., "memory_used_bytes": ...,
                "utilization_percent": ..., "process_rows": N | <code>,
                "processes": [[pid, used_bytes], ...]}],
   "supported": [calls that answered],
   "errors": {"call(index)": "NVML_ERROR_<CODE> (<value>)"}}

A field whose call failed holds the NVML code's name (``NOT_SUPPORTED``);
a call the library does not export is ``FUNCTION_NOT_FOUND``.

``--runtime libtpu`` asks the libtpu runtime-metrics gRPC service, aimed at
the metric *schema* instead of values — run it once on a real TPU VM and
commit the JSON as the fixture that pins candidate metric names (e.g. the
ICI counter) to reality:

    python -m tpu_pod_exporter_torch.probe --runtime libtpu [--addr localhost:8431]

  {"addr": ..., "reachable": bool,
   "supported": [names] | null,          # null = no enumeration RPC
   "metrics": {name: {"rows": N, "attr_keys": [...], "gauge_types": [...],
                      "sample": [{"attr": ..., "value": ...}, ...]}},
   "errors": {name: "grpc code/message"}}

Exit code 0 if the runtime answered, 2 otherwise.
"""

from __future__ import annotations

import argparse
import json
import sys


def probe(addr: str, timeout_s: float = 3.0, max_rows: int = 8) -> dict:
    import grpc

    from tpu_pod_exporter_torch.backend.libtpu import (
        DCN_CANDIDATES,
        DUTY_CYCLE,
        HBM_TOTAL,
        HBM_USAGE,
        ICI_CANDIDATES,
        LibtpuMetricsBackend,
        split_attrs,
    )

    def raw_gauge(m):
        """JSON-safe raw gauge: keep strings as strings and unset as None
        (gauge_value would yield float NaN, which json.dumps emits as the
        non-RFC literal `NaN` — unusable in a committed fixture)."""
        which = m.gauge.WhichOneof("value")
        if which == "as_int":
            return int(m.gauge.as_int)
        if which == "as_double":
            return float(m.gauge.as_double)
        if which == "as_string":
            return m.gauge.as_string
        return None

    def sample_row(m):
        # split_attrs handles both one-attribute (device only) and
        # per-link two-attribute rows; link key omitted when absent.
        dev, link = split_attrs(m)
        row = {"attr": dev, "value": raw_gauge(m)}
        if link is not None:
            row["link"] = link
        return row

    backend = LibtpuMetricsBackend(addr=addr, timeout_s=timeout_s, device_paths={})
    report: dict = {
        "addr": addr,
        "reachable": False,
        "supported": None,
        "metrics": {},
        "errors": {},
    }
    # Transport-level failures (nothing answered); any *other* status code
    # is a real response from the service and proves reachability — a
    # runtime that NOT_FOUNDs every name is answering, not unreachable.
    transport_codes = (
        grpc.StatusCode.UNAVAILABLE,
        grpc.StatusCode.DEADLINE_EXCEEDED,
    )
    try:
        try:
            report["supported"] = backend.list_supported_metrics()
            report["reachable"] = True
        except grpc.RpcError as e:
            report["errors"]["<ListSupportedMetrics>"] = f"{e.code()}: {e.details()}"
            if e.code() not in transport_codes:
                report["reachable"] = True

        names = report["supported"]
        if names is None:
            # No enumeration RPC: probe the names the backend knows about.
            names = [
                HBM_USAGE, HBM_TOTAL, DUTY_CYCLE,
                *ICI_CANDIDATES, *DCN_CANDIDATES,
            ]
        for name in names:
            try:
                resp = backend.query_raw(name, timeout_s=timeout_s)
            except grpc.RpcError as e:
                report["errors"][name] = f"{e.code()}: {e.details()}"
                if e.code() not in transport_codes:
                    report["reachable"] = True
                continue
            report["reachable"] = True
            rows = resp.metric.metrics
            report["metrics"][name] = {
                "rows": len(rows),
                "attr_keys": sorted({a.key for m in rows for a in m.attribute}),
                "gauge_types": sorted(
                    {m.gauge.WhichOneof("value") or "none" for m in rows}
                ),
                "sample": [sample_row(m) for m in rows[:max_rows]],
            }
    finally:
        backend.close()
    return report


def probe_nvml(driver=None, max_rows: int = 8) -> dict:
    """What NVML serves for every device it counts. ``driver`` replaces the
    ctypes binding (a :class:`~tpu_pod_exporter_torch.backend.nvml.
    SimulatedNvmlDriver` in tests); a library that does not load gives
    ``"reachable": false`` and the reason under ``errors``."""
    from tpu_pod_exporter_torch.backend import BackendError
    from tpu_pod_exporter_torch.backend.nvml import (
        NVML_ERROR_CODES,
        _nvml_str,
        normalize_nvml_code,
    )
    from tpu_pod_exporter_torch.backend.nvml_ctypes import LIBRARY, CtypesNvmlDriver

    report: dict = {
        "runtime": "nvml",
        "library": LIBRARY,
        "reachable": False,
        "count": None,
        "devices": [],
        "supported": [],
        "errors": {},
    }
    if driver is None:
        try:
            driver = CtypesNvmlDriver()
        except BackendError as e:
            report["errors"]["<load>"] = str(e)
            return report
    supported: set[str] = set()

    def call(name: str, label: str, *args) -> tuple:
        """``(value, None)`` of the driver's ``nvml<name>(*args)``, or
        ``(None, code)`` with the failure recorded under ``label`` and
        ``code`` the NVML code's short name (``NOT_SUPPORTED``)."""
        fn = getattr(driver, "nvml" + name, None)
        if fn is None:
            code = "NVML_ERROR_FUNCTION_NOT_FOUND"
        else:
            try:
                value = fn(*args)
            except Exception as e:  # noqa: BLE001 — every failure is data
                try:
                    code = normalize_nvml_code(getattr(e, "value", None))[0]
                except ValueError:
                    code = "NVML_ERROR_UNKNOWN"
            else:
                supported.add(name)
                return value, None
        report["errors"][label] = f"{code} ({NVML_ERROR_CODES[code]})"
        return None, code[len("NVML_ERROR_"):]

    def field(name: str, i: int, handle, convert):
        value, code = call(name, f"{name}({i})", handle)
        return code if code else convert(value)

    if call("Init", "Init")[1]:
        return report
    try:
        count, code = call("DeviceGetCount", "DeviceGetCount")
        if code:
            return report
        report["reachable"] = True
        report["count"] = int(count)
        for i in range(int(count)):
            handle, code = call("DeviceGetHandleByIndex", f"DeviceGetHandleByIndex({i})", i)
            if code:
                report["devices"].append({"index": i, "handle": code})
                continue
            mem, mem_code = call("DeviceGetMemoryInfo", f"DeviceGetMemoryInfo({i})", handle)
            rows, rows_code = call("DeviceGetComputeRunningProcesses",
                                   f"DeviceGetComputeRunningProcesses({i})", handle)
            report["devices"].append({
                "index": i,
                "name": field("DeviceGetName", i, handle, _nvml_str),
                "uuid": field("DeviceGetUUID", i, handle, _nvml_str),
                "minor": field("DeviceGetMinorNumber", i, handle, int),
                "memory_total_bytes": mem_code or int(mem["total"]),
                "memory_used_bytes": mem_code or int(mem["used"]),
                "utilization_percent": field("DeviceGetUtilizationRates", i, handle,
                                             lambda r: float(r["gpu"])),
                "process_rows": rows_code or len(rows),
                "processes": [] if rows_code else [
                    [int(r["pid"]),
                     None if r["usedGpuMemory"] is None else int(r["usedGpuMemory"])]
                    for r in rows[:max_rows]
                ],
            })
    finally:
        call("Shutdown", "Shutdown")
        report["supported"] = sorted(supported)
    return report


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--runtime", choices=("nvml", "libtpu"), default="nvml")
    p.add_argument("--addr", default="localhost:8431",
                   help="the libtpu metrics service (--runtime libtpu)")
    p.add_argument("--timeout-s", type=float, default=3.0)
    p.add_argument("--out", default="", help="also write the JSON to this path")
    args = p.parse_args(argv)
    if args.runtime == "nvml":
        report = probe_nvml()
    else:
        report = probe(args.addr, timeout_s=args.timeout_s)
    text = json.dumps(report, indent=2, sort_keys=True)
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    return 0 if report["reachable"] else 2


if __name__ == "__main__":
    sys.exit(main())
