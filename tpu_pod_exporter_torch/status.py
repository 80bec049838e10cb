"""One-shot human-readable status — the ``tpu-info`` analog.

``python -m tpu_pod_exporter_torch.status`` samples the same backends the
exporter daemon uses (same flags/env) and prints a chip table plus per-pod
rollups. Exits non-zero if the device read fails. ``--process-metrics``
adds a holder column (host pid/comm per chip, from the procfs scanner);
``--watch N`` re-renders every N seconds until interrupted, feeding each
sample into a local :class:`~tpu_pod_exporter_torch.history.HistoryStore` so the
table shows per-chip HBM/duty deltas and trend arrows over the trailing
window instead of discarding prior samples.
"""

from __future__ import annotations

import argparse
import sys
import time

from tpu_pod_exporter_torch.app import build_attribution, build_backend
from tpu_pod_exporter_torch.attribution import AttributionError
from tpu_pod_exporter_torch.backend import BackendError
from tpu_pod_exporter_torch.config import ExporterConfig
from tpu_pod_exporter_torch.topology import detect_host_topology


def fmt_bytes(n: float) -> str:
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if abs(n) < 1024 or unit == "TiB":
            return f"{n:.1f}{unit}" if unit != "B" else f"{int(n)}B"
        n /= 1024
    return f"{n:.1f}TiB"


def render_table(rows: list[list[str]], header: list[str]) -> str:
    widths = [max(len(str(r[i])) for r in [header] + rows) for i in range(len(header))]
    def line(r):
        return "  ".join(str(c).ljust(w) for c, w in zip(r, widths)).rstrip()
    sep = "  ".join("-" * w for w in widths)
    return "\n".join([line(header), sep] + [line(r) for r in rows])


def main(argv=None) -> int:
    # --watch is status-only; everything else is the shared exporter flag set.
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--watch", type=float, default=0.0,
                     help="re-render every N seconds until interrupted")
    pre.add_argument("--json", action="store_true",
                     help="machine-readable output (one JSON object; with "
                          "--watch, one compact JSON line per interval)")
    pre.add_argument("--fleet", default="",
                     help="aggregator host:port — render a fleet-wide "
                          "window_stats answer (per-host table + per-target "
                          "partial/quarantine footer) instead of sampling "
                          "local backends")
    pre.add_argument("--fleet-window", type=float, default=60.0,
                     help="trailing window for the fleet view, seconds")
    pre.add_argument("--tree", default="",
                     help="root aggregator host:port — render the sharded "
                          "aggregation tree topology (leaves, HA pairs, "
                          "per-shard target counts, quarantines, freshness "
                          "winner) from the root's /metrics")
    pre.add_argument("--store-dir", default="",
                     help="with --tree on the root host: read the fleet "
                          "store's store-status.json sidecar from this "
                          "dir and append a store: footer (retention "
                          "span, disk vs budget, rules, last-append age)")
    pre.add_argument("--alert-dir", default="",
                     help="with --tree on the root host: read the "
                          "alerting plane's alert-status.json sidecar "
                          "from this dir and append an alerts: footer "
                          "(firing/pending counts, newest transition "
                          "age, notifier backlog + breaker)")
    ns, rest = pre.parse_known_args(argv)
    if ns.tree:
        try:
            if ns.watch <= 0:
                return _run_tree(ns.tree, as_json=ns.json,
                                 store_dir=ns.store_dir,
                                 alert_dir=ns.alert_dir)
            return _watch_tree(ns.tree, ns.watch, as_json=ns.json,
                               store_dir=ns.store_dir,
                               alert_dir=ns.alert_dir)
        except KeyboardInterrupt:
            return 0
    if ns.fleet:
        try:
            if ns.watch <= 0:
                return _run_fleet(ns.fleet, ns.fleet_window, as_json=ns.json)
            # Ride a stream subscription when the aggregator offers one:
            # the server pushes per-round deltas, so the watch stops
            # paying a full fleet fan-out per frame. None = no stream on
            # this tier (or it went away) — fall back to polling.
            rc = _watch_fleet_stream(
                ns.fleet, ns.fleet_window, ns.watch,
                as_json="line" if ns.json else False)
            if rc is not None:
                return rc
            while True:
                if not ns.json:
                    print("\x1b[H\x1b[2J", end="")
                rc = _run_fleet(ns.fleet, ns.fleet_window,
                                as_json="line" if ns.json else False)
                if rc != 0:
                    return rc
                time.sleep(ns.watch)
        except KeyboardInterrupt:
            return 0
    cfg = ExporterConfig.from_args(rest)
    topo = detect_host_topology(
        accelerator=cfg.accelerator, slice_name=cfg.slice_name,
        host=cfg.node_name, worker_id=cfg.worker_id,
    )
    backend = build_backend(cfg)
    # Same family→resource dispatch as ExporterApp: the doctor must join
    # attribution the way the exporter it diagnoses would (nvidia.com/gpu
    # device UUIDs for GPU-family backends).
    resource_name = (
        cfg.gpu_resource_name
        if getattr(backend, "family", "tpu") == "gpu"
        else cfg.resource_name
    )
    attribution = build_attribution(cfg, resource_name)
    scanner = None
    if cfg.process_metrics:
        from tpu_pod_exporter_torch.procscan import (
            DEFAULT_DEVICE_PREFIXES,
            GPU_DEVICE_PREFIXES,
            ProcScanner,
        )

        # A GPU node's cards are /dev/nvidia<minor>, as the exporter scans.
        scanner = ProcScanner(
            proc_root=cfg.proc_root,
            device_prefixes=(
                GPU_DEVICE_PREFIXES
                if getattr(backend, "family", "tpu") == "gpu"
                else DEFAULT_DEVICE_PREFIXES
            ),
            full_scan_every=cfg.process_full_scan_every,
        )
    try:
        if ns.watch <= 0:
            return _run(cfg, topo, backend, attribution, scanner, as_json=ns.json)
        # Watch mode keeps a local flight recorder so each render can show
        # where a value is HEADING, not just where it is. Bounded exactly
        # like the daemon's store, scaled to one screenful of history.
        from tpu_pod_exporter_torch.history import HistoryStore

        history = HistoryStore(capacity=256, max_series=2048, retention_s=0.0)
        trend_window_s = max(10.0 * ns.watch, 5.0)
        while True:
            if ns.json:
                # JSONL stream: no ANSI escapes, one object per line, so
                # `... --json --watch 5 | jq` works.
                rc = _run(cfg, topo, backend, attribution, scanner,
                          as_json="line")
            else:
                # ANSI home+clear keeps the table in place like `watch`.
                print("\x1b[H\x1b[2J", end="")
                rc = _run(cfg, topo, backend, attribution, scanner,
                          history=history, trend_window_s=trend_window_s)
            if rc != 0:
                return rc
            time.sleep(ns.watch)
    except KeyboardInterrupt:
        return 0
    finally:
        backend.close()
        attribution.close()


# Metric set the fleet view folds per host: the guaranteed presence series
# (chip counts), the HBM sum, and the duty mean — the "what is the slice
# doing" triple.
_FLEET_METRICS = (
    "tpu_chip_info",
    "tpu_hbm_used_bytes",
    "tpu_tensorcore_duty_cycle_percent",
)


def fetch_fleet_window(addr: str, metric: str, window_s: float,
                       timeout_s: float = 5.0) -> dict:
    """One fleet window_stats envelope from the aggregator (always a 200
    envelope — a metric with no samples anywhere is just an empty merge
    inside it; connection-level failures raise)."""
    import json as _json
    import urllib.request

    base = addr if addr.startswith(("http://", "https://")) else f"http://{addr}"
    url = f"{base}/api/v1/window_stats?metric={metric}&window={window_s:g}"
    with urllib.request.urlopen(url, timeout=timeout_s) as resp:  # noqa: S310 — operator-supplied address
        doc = _json.loads(resp.read())
    return doc


def render_fleet(envelopes: dict[str, dict], window_s: float) -> str:
    """Per-host table + per-target status footer from fleet envelopes."""
    hosts: dict[str, dict] = {}
    now = time.time()
    for metric, env in envelopes.items():
        for row in env.get("data", {}).get("result", []):
            host = (row.get("labels") or {}).get("host", "?")
            agg = hosts.setdefault(
                host, {"chips": 0, "hbm": 0.0, "hbm_n": 0,
                       "duty_sum": 0.0, "duty_n": 0, "newest": None})
            s = row.get("stats") or {}
            if metric == "tpu_chip_info":
                agg["chips"] += 1
            elif metric == "tpu_hbm_used_bytes":
                if s.get("last") is not None:
                    agg["hbm"] += s["last"]
                    agg["hbm_n"] += 1
            elif s.get("last") is not None:
                agg["duty_sum"] += s["last"]
                agg["duty_n"] += 1
            ts = row.get("last_sample_wall_ts")
            if isinstance(ts, (int, float)) and (
                    agg["newest"] is None or ts > agg["newest"]):
                agg["newest"] = ts
    rows = []
    for host in sorted(hosts):
        a = hosts[host]
        rows.append([
            host,
            a["chips"] or "-",
            fmt_bytes(a["hbm"]) if a["hbm_n"] else "-",
            f"{a['duty_sum'] / a['duty_n']:.1f}%" if a["duty_n"] else "-",
            f"{now - a['newest']:.1f}s" if a["newest"] is not None else "-",
        ])
    out = []
    if rows:
        out.append(render_table(
            rows, ["host", "chips", "hbm used", "duty avg", "stale"]))
    else:
        out.append("no fleet data in window")
    # Footer folds target status across the envelopes (identical target
    # sets; the worst state per target wins so a mid-render kill shows).
    order = {"ok": 0, "no_data": 1, "quarantined": 2, "timeout": 3, "error": 4}
    targets: dict[str, dict] = {}
    partial = False
    for env in envelopes.values():
        partial = partial or bool(env.get("partial"))
        for t, st in (env.get("targets") or {}).items():
            prev = targets.get(t)
            if prev is None or (
                    order.get(st.get("state"), 9)
                    > order.get(prev.get("state"), 9)):
                targets[t] = st
    n = len(targets)
    ok = sum(1 for st in targets.values()
             if st.get("state") in ("ok", "no_data"))
    bad = [
        f"{t} ({st.get('state')}"
        + (f": {st['error']}" if st.get("error") else "")
        + ")"
        for t, st in sorted(targets.items())
        if st.get("state") not in ("ok", "no_data")
    ]
    footer = f"targets: {ok}/{n} ok · window {window_s:g}s"
    if partial:
        footer += " · PARTIAL result"
    if bad:
        footer += "\n  degraded: " + ", ".join(bad)
    out.append("")
    out.append(footer)
    return "\n".join(out)


def fetch_tree(addr: str, timeout_s: float = 5.0) -> dict:
    """Scrape the root aggregator's /metrics and fold the shard-topology
    view out of it: per-shard target counts/quarantines, per-leaf up +
    staleness (the freshest leaf of each HA pair is the dedup winner),
    fleet rollup headlines, and the dedup/reshard counters. One HTTP GET —
    the tree view is exactly what the root already publishes."""
    import urllib.request

    from tpu_pod_exporter_torch.metrics import schema
    from tpu_pod_exporter_torch.metrics.parse import parse_families

    base = addr if addr.startswith(("http://", "https://")) else f"http://{addr}"
    with urllib.request.urlopen(f"{base}/metrics", timeout=timeout_s) as resp:  # noqa: S310 — operator-supplied address
        text = resp.read().decode("utf-8", errors="replace")
    fams = parse_families(text)

    def first_value(name: str, default=None):
        rows = fams.get(name)
        return rows[0].value if rows else default

    shards: dict[str, dict] = {}
    for s in fams.get(schema.TPU_ROOT_LEAF_UP.name, ()):
        shard = s.labels.get("shard", "?")
        leaf = s.labels.get("leaf", "?")
        entry = shards.setdefault(
            shard, {"targets": None, "quarantined": None, "leaves": {},
                    "families": {}})
        entry["leaves"][leaf] = {"up": s.value, "staleness_s": None}
    for s in fams.get(schema.TPU_ROOT_LEAF_STALENESS_SECONDS.name, ()):
        shard = s.labels.get("shard", "?")
        leaf = s.labels.get("leaf", "?")
        entry = shards.get(shard)
        if entry and leaf in entry["leaves"]:
            entry["leaves"][leaf]["staleness_s"] = s.value
    for s in fams.get(schema.TPU_ROOT_SHARD_TARGETS.name, ()):
        entry = shards.get(s.labels.get("shard", "?"))
        if entry is not None:
            entry["targets"] = s.value
    for s in fams.get(schema.TPU_ROOT_SHARD_QUARANTINED_TARGETS.name, ()):
        entry = shards.get(s.labels.get("shard", "?"))
        if entry is not None:
            entry["quarantined"] = s.value
    for s in fams.get(schema.TPU_ROOT_SHARD_FAMILY_CHIPS.name, ()):
        entry = shards.get(s.labels.get("shard", "?"))
        if entry is not None:
            entry.setdefault("families", {})[
                s.labels.get("family", "?")] = s.value
    for entry in shards.values():
        fresh = None
        for leaf, doc in entry["leaves"].items():
            st = doc["staleness_s"]
            if doc["up"] and st is not None and (
                    fresh is None or st < entry["leaves"][fresh]["staleness_s"]):
                fresh = leaf
        entry["freshest"] = fresh
    up_targets = sum(
        1 for s in fams.get(schema.TPU_AGG_TARGET_UP.name, ())
        if s.value == 1.0
    )
    # Per-family chip/memory split for the fleet footer — read from the
    # published tpu_fleet_family_* rollups, never re-derived by summing
    # (the whole point of publishing the split).
    family_chips = {
        s.labels.get("family", "?"): s.value
        for s in fams.get(schema.TPU_FLEET_FAMILY_CHIP_COUNT.name, ())
    }
    family_hbm = {
        s.labels.get("family", "?"): s.value
        for s in fams.get(schema.TPU_FLEET_FAMILY_HBM_USED_BYTES.name, ())
    }
    return {
        "root": addr,
        "shards": shards,
        "fleet": {
            "targets": len(fams.get(schema.TPU_AGG_TARGET_UP.name, ())),
            "targets_up": up_targets,
            "chips": sum(
                s.value for s in fams.get(schema.TPU_SLICE_CHIP_COUNT.name,
                                          ())),
            "family_chips": family_chips,
            "family_hbm_used_bytes": family_hbm,
            "dedup_stale_wins_total": first_value(
                schema.TPU_ROOT_DEDUP_STALE_WINS_TOTAL.name),
            "reshard_moves_total": first_value(
                schema.TPU_ROOT_RESHARD_MOVES_TOTAL.name),
            "last_round_ts": first_value(
                schema.TPU_ROOT_LAST_ROUND_TIMESTAMP_SECONDS.name),
            "round_duration_s": first_value(
                schema.TPU_ROOT_ROUND_DURATION_SECONDS.name),
        },
    }


def render_tree(doc: dict) -> str:
    """Shard-topology table + fleet footer, mirroring the --fleet view."""
    rows = []
    for shard in sorted(doc["shards"]):
        entry = doc["shards"][shard]
        leaf_cells = []
        for leaf in sorted(entry["leaves"]):
            ldoc = entry["leaves"][leaf]
            mark = "*" if leaf == entry.get("freshest") else ""
            if ldoc["up"]:
                st = ldoc["staleness_s"]
                age = f" {st:.1f}s" if st is not None else ""
                leaf_cells.append(f"{leaf}{mark} up{age}")
            else:
                leaf_cells.append(f"{leaf} DOWN")
        t = entry.get("targets")
        q = entry.get("quarantined")
        fams_cell = "-"
        families = entry.get("families") or {}
        if families:
            # e.g. "tpu:48+gpu:16" — which device families this shard's
            # consistent-hash cut happens to carry, and how many chips.
            fams_cell = "+".join(
                f"{fam}:{chips:g}"
                for fam, chips in sorted(families.items())
            )
        rows.append([
            shard,
            int(t) if t is not None else "-",
            int(q) if q is not None else "-",
            fams_cell,
            ", ".join(leaf_cells) or "-",
        ])
    out = []
    if rows:
        out.append(render_table(
            rows,
            ["shard", "targets", "quar", "family", "leaves (* = freshest)"]))
    else:
        out.append("no shard topology published (is this a root aggregator?)")
    f = doc["fleet"]
    footer = (f"fleet: {f['targets_up']}/{f['targets']} targets up · "
              f"{f['chips']:g} chips")
    family_chips = f.get("family_chips") or {}
    if family_chips:
        # Per-family split of the chip/memory totals (mixed fleets): e.g.
        # "tpu 96 chips 1.2TiB · gpu 16 chips 320GiB".
        family_hbm = f.get("family_hbm_used_bytes") or {}
        cells = []
        for fam in sorted(family_chips):
            cell = f"{fam} {family_chips[fam]:g} chips"
            if fam in family_hbm:
                cell += f" {fmt_bytes(family_hbm[fam])}"
            cells.append(cell)
        footer += " (" + " · ".join(cells) + ")"
    if f.get("dedup_stale_wins_total") is not None:
        footer += f" · stale wins {f['dedup_stale_wins_total']:g}"
    if f.get("reshard_moves_total") is not None:
        footer += f" · reshard moves {f['reshard_moves_total']:g}"
    if f.get("last_round_ts"):
        footer += f" · round {time.time() - f['last_round_ts']:.1f}s ago"
    down = [
        f"{leaf} ({shard})"
        for shard, entry in sorted(doc["shards"].items())
        for leaf, ldoc in sorted(entry["leaves"].items())
        if not ldoc["up"]
    ]
    if down:
        footer += "\n  leaves down: " + ", ".join(down)
    out.append("")
    out.append(footer)
    store = doc.get("store")
    if store is not None:
        out.append(store_line(store))
    elif doc.get("store_error"):
        # A typo'd --store-dir must look different from "no store
        # configured" — the forensics playbook starts here.
        out.append(f"store: {doc['store_error']}")
    alerts = doc.get("alerts")
    if alerts is not None:
        out.append(alert_line(alerts))
    elif doc.get("alerts_error"):
        # Same discipline as store_error: a typo'd --alert-dir must look
        # different from "no alerting configured".
        out.append(f"alerts: {doc['alerts_error']}")
    return "\n".join(out)


def store_line(doc: dict) -> str:
    """``store:`` footer from the fleet store's on-disk sidecar
    (tpu_pod_exporter_torch.store.store_status_summary): retention span, disk
    bytes vs budget, rules evaluated, last-append age — the four numbers
    the RUNBOOK's forensics playbook reads first."""
    span = doc.get("span_s") or 0.0
    span_txt = (f"{span / 86400.0:.1f}d" if span >= 86400.0
                else f"{span / 3600.0:.1f}h" if span >= 3600.0
                else f"{span:.0f}s")
    parts = [f"store: span {span_txt}"]
    disk = doc.get("disk_bytes")
    budget = doc.get("disk_budget_bytes") or 0
    if disk is not None:
        d = fmt_bytes(float(disk))
        if budget:
            over = " OVER" if disk > budget else ""
            parts.append(f"disk {d}/{fmt_bytes(float(budget))}{over}")
        else:
            parts.append(f"disk {d} (no budget)")
    if doc.get("thinned"):
        parts.append("THINNED (finest tier shed)")
    rules = doc.get("rules") or 0
    parts.append(f"rules {rules} "
                 f"(evaluated {doc.get('rules_evaluated_total', 0):g})")
    last = doc.get("last_append_wall")
    if last:
        parts.append(f"last append {max(time.time() - last, 0.0):.1f}s ago")
    failures = doc.get("append_failures") or 0
    if failures:
        parts.append(f"APPEND FAILURES {failures:g}")
    series = doc.get("series")
    if series is not None:
        parts.append(f"{series:g} series")
    return " · ".join(parts)


def alert_line(doc: dict) -> str:
    """``alerts:`` footer from the alerting plane's on-disk sidecar
    (tpu_pod_exporter_torch.alerting.alert_status_summary): firing/pending
    counts, newest transition age, suppression/evaluation health and the
    notifier's backlog + breaker — what the alerting triage playbook
    reads first."""
    firing = doc.get("firing") or 0
    pending = doc.get("pending") or 0
    parts = [f"alerts: {firing:g} firing · {pending:g} pending "
             f"· rules {doc.get('rules', 0):g}"]
    last = doc.get("last_transition_wall")
    if last:
        parts.append(
            f"last transition {max(time.time() - last, 0.0):.1f}s ago")
    if not doc.get("suppression", True):
        parts.append("SUPPRESSION OFF")
    suppressed = doc.get("suppressed_total") or 0
    if suppressed:
        parts.append(f"suppressed {suppressed:g}")
    failures = doc.get("eval_failures") or 0
    if failures:
        parts.append(f"EVAL FAILURES {failures:g}")
    notif = doc.get("notifier")
    if notif:
        backlog = notif.get("backlog_records") or 0
        cell = f"notify sent {notif.get('sent', 0):g}"
        if backlog:
            cell += (f" backlog {backlog:g} "
                     f"({notif.get('backlog_age_s', 0.0):.0f}s old)")
        breaker = notif.get("breaker")
        if breaker and breaker != "closed":
            cell += f" breaker {str(breaker).upper()}"
        parts.append(cell)
    return " · ".join(parts)


def render_tree_screen(addr: str, doc: dict | None, error=None,
                       unreachable_s: float = 0.0) -> str:
    """One watch-mode frame: the freshest tree we have, plus an explicit
    ``unreachable`` footer when the root is not answering right now.
    A briefly-unreachable root (it restarts, a partition blips) must not
    throw the operator out of watch mode mid-incident — the last-known
    state labeled stale beats a dead terminal."""
    out = [f"shard tree via {addr}", ""]
    if doc is not None:
        out.append(render_tree(doc))
    if error is not None:
        if doc is not None:
            out.append("")
            out.append(
                f"root unreachable ({unreachable_s:.0f}s): {error} — "
                f"showing last-known state"
            )
        else:
            out.append(f"root unreachable: {error} (no tree fetched yet)")
    return "\n".join(out)


def _attach_store(doc: dict, store_dir: str) -> dict:
    """Attach the fleet store's sidecar summary under ``doc["store"]``
    (rendered by render_tree and carried in the JSON stream). Absent or
    unreadable sidecars attach nothing — the tree view stays usable on
    roots without a store."""
    if store_dir:
        from tpu_pod_exporter_torch.store import store_status_summary

        summary = store_status_summary(store_dir)
        if summary is not None:
            doc["store"] = summary
        else:
            doc["store_error"] = (
                f"no store-status.json under {store_dir}")
    return doc


def _attach_alerts(doc: dict, alert_dir: str) -> dict:
    """Attach the alerting sidecar summary under ``doc["alerts"]`` (the
    store-footer discipline: absent dir attaches nothing, a configured
    but unreadable sidecar attaches an explicit error)."""
    if alert_dir:
        from tpu_pod_exporter_torch.alerting import alert_status_summary

        summary = alert_status_summary(alert_dir)
        if summary is not None:
            doc["alerts"] = summary
        else:
            doc["alerts_error"] = (
                f"no alert-status.json under {alert_dir}")
    return doc


def _watch_tree(addr: str, interval_s: float, as_json=False,
                store_dir: str = "", alert_dir: str = "") -> int:
    """``--tree --watch``: re-render until interrupted, surviving root
    outages with a last-known-state footer instead of exiting. The store
    sidecar is re-read every interval — a thinning or append-failing
    store shows up mid-watch."""
    import json as _json

    # Stream-ticked refresh when the root offers /api/v1/stream: renders
    # then track ROUNDS (a delta frame = the root published) instead of a
    # blind interval — no wasted refreshes between rounds, sub-interval
    # reaction when rounds are fast. A missing/never/dead stream falls
    # back to the plain interval sleep below.
    ticker = None
    hp = _split_addr(addr)
    if hp is not None:
        try:
            from tpu_pod_exporter_torch.stream import QueryShape, StreamClient

            ticker = StreamClient(
                hp[0], hp[1],
                QueryShape(route="window_stats",
                           metric="tpu_hbm_used_bytes",
                           window_s=max(interval_s * 4, 30.0)),
                timeout_s=5.0)
        except Exception:  # noqa: BLE001 — no stream = plain polling
            ticker = None
    last_doc: dict | None = None
    last_ok = time.monotonic()
    while True:
        error = None
        try:
            doc = _attach_alerts(
                _attach_store(fetch_tree(addr), store_dir), alert_dir)
            last_doc = doc
            last_ok = time.monotonic()
        except Exception as e:  # noqa: BLE001 — watch mode outlives outages
            error = e
        if as_json:
            # JSONL stream: one object per interval; outages are explicit
            # records (with the last-known doc attached), never an exit.
            if error is None:
                print(_json.dumps(doc, indent=None), flush=True)
            else:
                print(_json.dumps({
                    "root": addr,
                    "unreachable": True,
                    "unreachable_s": round(time.monotonic() - last_ok, 1),
                    "error": str(error),
                    "last_known": last_doc,
                }, indent=None), flush=True)
        else:
            print("\x1b[H\x1b[2J", end="")
            print(render_tree_screen(
                addr,
                last_doc,
                error=error,
                unreachable_s=time.monotonic() - last_ok,
            ))
        if ticker is not None and not ticker.eof:
            # Block until the next round's frame (or heartbeat/timeout —
            # either way, re-render no later than a slow poll would).
            for _frame in ticker.frames(max_frames=1,
                                        timeout_s=max(interval_s * 3, 5.0)):
                break
        else:
            if ticker is not None:
                ticker.close()
                ticker = None
            time.sleep(interval_s)


def _run_tree(addr: str, as_json=False, store_dir: str = "",
              alert_dir: str = "") -> int:
    import json as _json

    try:
        doc = _attach_alerts(
            _attach_store(fetch_tree(addr), store_dir), alert_dir)
    except Exception as e:  # noqa: BLE001 — a down root is the answer
        print(f"tree query against {addr} failed: {e}", file=sys.stderr)
        return 1
    if as_json:
        print(_json.dumps(doc, indent=None if as_json == "line" else 1),
              flush=True)
        return 0
    print(f"shard tree via {addr}")
    print()
    print(render_tree(doc))
    return 0


def _split_addr(addr: str) -> tuple[str, int] | None:
    a = addr
    if a.startswith(("http://", "https://")):
        a = a.split("//", 1)[1]
    a = a.split("/", 1)[0]
    host, _, port_s = a.partition(":")
    try:
        return host or "127.0.0.1", int(port_s or "80")
    except ValueError:
        return None


def _watch_fleet_stream(addr: str, window_s: float, interval_s: float,
                        as_json=False) -> int | None:
    """``--fleet --watch`` over /api/v1/stream: one subscription per
    fleet metric, each frame a per-round delta applied to a local replay
    — the aggregator evaluates each shape once per round however many
    watchers ride it, and this tool stops paying a fan-out per frame.
    Returns None when the server offers no stream endpoint (or the
    stream dies mid-watch): the caller falls back to polling."""
    import json as _json

    from tpu_pod_exporter_torch.stream import (
        DATA_FRAME_TYPES,
        QueryShape,
        StreamClient,
        StreamDisabled,
        StreamReplay,
    )

    hp = _split_addr(addr)
    if hp is None:
        return None
    host, port = hp
    subs: list[tuple[str, StreamClient, StreamReplay]] = []
    try:
        for metric in _FLEET_METRICS:
            shape = QueryShape(route="window_stats", metric=metric,
                               window_s=window_s)
            subs.append((metric, StreamClient(host, port, shape,
                                              timeout_s=5.0),
                         StreamReplay()))
    except StreamDisabled:
        for _m, c, _r in subs:
            c.close()
        return None
    except OSError as e:
        for _m, c, _r in subs:
            c.close()
        print(f"fleet stream against {addr} failed: {e}", file=sys.stderr)
        return 1
    try:
        while True:
            for _metric, client, replay in subs:
                for frame in client.frames(timeout_s=0.2):
                    if frame.get("type") in DATA_FRAME_TYPES \
                            or frame.get("type") == "shed":
                        replay.apply(frame)
            if any(client.eof for _m, client, _r in subs):
                # Shed / server restart: the polling fallback takes over
                # (and will retry the subscription on the next watch).
                return None
            envelopes = {}
            for metric, _client, replay in subs:
                envelopes[metric] = {
                    "data": {"result": [replay.rows[k]
                                        for k in sorted(replay.rows)]},
                    "partial": bool(replay.meta.get("partial")),
                    "fleet": replay.meta.get("fleet") or {},
                    # Per-target states ride snapshot/full_sync meta (at
                    # most --stream-full-sync-s stale) — the degraded-
                    # target footer must not vanish in stream mode.
                    "targets": replay.meta.get("targets") or {},
                    "source": "stream",
                }
            if as_json:
                print(_json.dumps(
                    {"aggregator": addr, "window_s": window_s,
                     "transport": "stream", "envelopes": envelopes},
                    indent=None), flush=True)
            else:
                print("\x1b[H\x1b[2J", end="")
                print(f"fleet view via {addr} (stream)")
                print()
                print(render_fleet(envelopes, window_s))
            time.sleep(interval_s)
    finally:
        for _m, c, _r in subs:
            c.close()


def _run_fleet(addr: str, window_s: float, as_json=False) -> int:
    import json as _json

    envelopes: dict[str, dict] = {}
    try:
        for metric in _FLEET_METRICS:
            envelopes[metric] = fetch_fleet_window(addr, metric, window_s)
    except Exception as e:  # noqa: BLE001 — a down aggregator is the answer
        print(f"fleet query against {addr} failed: {e}", file=sys.stderr)
        return 1
    if as_json:
        print(_json.dumps(
            {"aggregator": addr, "window_s": window_s,
             "envelopes": envelopes},
            indent=None if as_json == "line" else 1,
        ), flush=True)
        return 0
    print(f"fleet view via {addr}")
    print()
    print(render_fleet(envelopes, window_s))
    return 0


def trend_cell(history, metric: str, chip_id, window_s: float,
               fmt, eps: float) -> str:
    """Delta + direction arrow for one chip's series over the trailing
    window, from the watch-mode history store. "-" until two samples exist."""
    rows = history.window_stats(
        metric, {"chip_id": str(chip_id)}, window_s=window_s
    )
    if not rows or rows[0]["stats"]["samples"] < 2:
        return "-"
    s = rows[0]["stats"]
    delta = s["last"] - s["first"]
    arrow = "↑" if delta > eps else ("↓" if delta < -eps else "→")
    return f"{arrow}{fmt(delta)}"


def _fmt_delta_bytes(d: float) -> str:
    return ("+" if d >= 0 else "-") + fmt_bytes(abs(d))


def persist_line(state_dir: str) -> str | None:
    """``state-dir: …`` footer: on-disk size, checkpoint age, and whether a
    restart right now would warm-start (checkpoint present) or cold-start.
    The checkpoint age IS the worst-case staleness a crash-restore would
    serve — the operator-facing read of tpu_exporter_snapshot_stale_seconds
    before it happens."""
    from tpu_pod_exporter_torch.persist import state_dir_summary

    s = state_dir_summary(state_dir)
    if not s["exists"]:
        return f"state-dir: {state_dir} (missing — restart would cold-start)"
    if s["snapshot_bytes"]:
        age = s["snapshot_age_s"]
        warm = (f"warm restart ready, checkpoint {age:g}s stale"
                if age is not None else "warm restart ready")
    else:
        warm = "no checkpoint yet — restart would cold-start"
    return (f"state-dir: {state_dir} {fmt_bytes(s['total_bytes'])} "
            f"(checkpoint {fmt_bytes(s['snapshot_bytes'])}, "
            f"wal {fmt_bytes(s['wal_bytes'])}) · {warm}")


def pressure_line(state_dir: str) -> str | None:
    """``pressure: …`` footer: per-resource ladder rung, bytes vs budget,
    and last shed/recover instants — the operator-facing read of the
    ``tpu_exporter_pressure_*`` surface, from the governor's on-disk
    sidecar (mirrors the ``state-dir:``/``egress:`` footers). None when no
    governor has run against this state dir."""
    from tpu_pod_exporter_torch.pressure import pressure_status_summary

    doc = pressure_status_summary(state_dir)
    if doc is None:
        return None
    parts = ["pressure:"]
    now = time.time()
    for resource in ("disk", "memory"):
        ladder = doc.get(resource)
        if not isinstance(ladder, dict):
            continue
        level = ladder.get("level", 0)
        rung = ladder.get("rung") or "none"
        usage = ladder.get("usage_bytes", 0)
        budget = ladder.get("budget_bytes", 0)
        cell = (f"{resource} rung {level}"
                + (f" ({rung})" if level else "")
                + f" · {fmt_bytes(usage)}"
                + (f"/{fmt_bytes(budget)}" if budget else " (no budget)"))
        shed = ladder.get("last_shed_wall") or 0
        rec = ladder.get("last_recover_wall") or 0
        if shed:
            cell += f" · shed {max(now - shed, 0.0):.0f}s ago"
        if rec:
            cell += f" · recovered {max(now - rec, 0.0):.0f}s ago"
        parts.append(cell)
    if len(parts) == 1:
        return None
    return " ".join(parts[:1]) + " " + " | ".join(parts[1:])


def egress_line(egress_url: str, egress_dir: str) -> str | None:
    """``egress: …`` footer: receiver/breaker state, backlog bytes/age,
    last-send latency — the operator-facing read of the
    ``tpu_exporter_egress_*`` surface, mirroring the ``state-dir:`` footer.
    Reads the shipper's on-disk status sidecar plus segment sizes; a
    missing dir means egress has never run here."""
    from tpu_pod_exporter_torch.egress import egress_dir_summary

    s = egress_dir_summary(egress_dir)
    if not s["exists"]:
        return (f"egress: {egress_url} (dir {egress_dir} missing — "
                f"no batches shipped yet)")
    st = s["status"] or {}
    backlog = st.get("backlog_batches")
    parts = [f"egress: {egress_url}"]
    parts.append(f"breaker {st.get('breaker', '?')}")
    if backlog is not None:
        parts.append(
            f"backlog {backlog} batch(es) / {fmt_bytes(st.get('backlog_bytes', 0))}"
        )
    else:
        parts.append(f"buffer {fmt_bytes(s['segment_bytes'])} on disk")
    ok_wall = st.get("last_send_ok_wall") or 0
    if ok_wall:
        parts.append(
            f"last send ok {max(time.time() - ok_wall, 0.0):.1f}s ago "
            f"({1e3 * st.get('last_send_latency_s', 0.0):.1f}ms)"
        )
    else:
        parts.append("no send acknowledged yet")
    err = st.get("last_error")
    if err:
        parts.append(f"last error: {err}")
    return " · ".join(parts)


# Series name the watch-mode phase breakdown stores its timings under — the
# same family the exporter's per-phase histogram publishes, so the footer
# reads as a local preview of the daemon's phase heatmap.
PHASE_METRIC = "tpu_exporter_poll_phase_duration_seconds"


def phase_breakdown_line(history, phases, window_s: float) -> str | None:
    """``phases: device_read 1.2ms (p≈mean 1.1ms) · …`` footer for watch
    mode, computed from the locally-recorded phase series over the trailing
    window. None until at least one phase has a sample."""
    parts = []
    for phase in phases:
        rows = history.window_stats(PHASE_METRIC, {"phase": phase},
                                    window_s=window_s)
        if not rows:
            continue
        s = rows[0]["stats"]
        parts.append(
            f"{phase} {1e3 * s['last']:.1f}ms"
            f" (mean {1e3 * s['mean']:.1f}ms, max {1e3 * s['max']:.1f}ms)"
        )
    return "phases: " + " · ".join(parts) if parts else None


def _run(cfg, topo, backend, attribution, scanner=None, as_json=False,
         history=None, trend_window_s=0.0) -> int:
    t_phase0 = time.perf_counter()
    try:
        sample = backend.sample()
    except BackendError as e:
        print(f"device read failed: {e}", file=sys.stderr)
        return 1
    t_phase1 = time.perf_counter()
    # Per-chip read problems must be visible even when they leave 0 chips —
    # "no chips found" and "all chip reads failed" are different diagnoses.
    for err in sample.partial_errors:
        print(f"warning: {err}", file=sys.stderr)
    try:
        # The resource the provider was built for: nvidia.com/gpu device
        # UUIDs for a GPU-family backend, as ExporterApp joins them.
        owner_map = attribution.snapshot().by_device_id(
            cfg.gpu_resource_name if getattr(backend, "family", "tpu") == "gpu"
            else cfg.resource_name)
    except AttributionError as e:
        print(f"(attribution unavailable: {e})", file=sys.stderr)
        owner_map = {}
    t_phase2 = time.perf_counter()
    if history is not None:
        # Watch mode keeps a local per-phase latency record (the same
        # series name as the exporter's phase histogram) so the footer
        # shows where each refresh's time goes — a hung attribution source
        # is visible as a growing phase cell before it is visible anywhere
        # else on a box with no daemon running.
        history.append(PHASE_METRIC, {"phase": "device_read"},
                       t_phase1 - t_phase0)
        history.append(PHASE_METRIC, {"phase": "attribution"},
                       t_phase2 - t_phase1)

    if not as_json and topo.accelerator:
        st = topo.slice_topology
        extra = (
            f"  ({st.total_chips} chips / {st.num_hosts} hosts slice-wide)"
            if st.total_chips else ""
        )
        print(f"accelerator: {topo.accelerator}{extra}")
        if topo.worker_id or topo.slice_name:
            print(f"slice: {topo.slice_name or '-'}  worker: {topo.worker_id or '-'}  host: {topo.host}")
        print()

    if not sample.chips and not as_json:
        print("no TPU chips found on this host")
        return 0

    holders_by_path: dict[str, list] = {}
    if scanner is not None:
        t_scan0 = time.perf_counter()
        try:
            for h in scanner.scan():
                holders_by_path.setdefault(h.device_path, []).append(h)
        except Exception as e:  # noqa: BLE001 — status stays useful without it
            print(f"(process scan unavailable: {e})", file=sys.stderr)
        if history is not None:
            history.append(PHASE_METRIC, {"phase": "process_scan"},
                           time.perf_counter() - t_scan0)

    rows = []
    doc_chips = []
    pods: dict[tuple[str, str], list[float]] = {}
    for chip in sample.chips:
        owner = None
        for did in chip.info.device_ids:
            owner = owner_map.get(did)
            if owner:
                break
        if owner:
            agg = pods.setdefault((owner.namespace, owner.pod), [0, 0.0])
            agg[0] += 1
            agg[1] += chip.hbm_used_bytes or 0.0
        if as_json:
            chip_holders = holders_by_path.get(chip.info.device_path, [])
            doc_chips.append({
                "chip_id": chip.info.chip_id,
                "device_path": chip.info.device_path,
                "device_kind": chip.info.device_kind,
                "coords": chip.info.coords,
                "hbm_used_bytes": chip.hbm_used_bytes,
                "hbm_total_bytes": chip.hbm_total_bytes,
                "hbm_peak_bytes": chip.hbm_peak_bytes,
                "duty_cycle_percent": chip.tensorcore_duty_cycle_percent,
                # Per-link cumulative ICI counters (link="all" on backends
                # serving only a per-chip aggregate — see backend/libtpu.py).
                "ici": {
                    l.link: l.transferred_bytes_total for l in chip.ici_links
                },
                "dcn": {
                    l.link: l.transferred_bytes_total for l in chip.dcn_links
                },
                "pod": owner.pod if owner else None,
                "namespace": owner.namespace if owner else None,
                "container": owner.container if owner else None,
                "holders": [
                    {"pid": h.pid, "comm": h.comm, "pod_uid": h.pod_uid}
                    for h in chip_holders
                ],
            })
            continue
        duty = (
            f"{chip.tensorcore_duty_cycle_percent:.1f}%"
            if chip.tensorcore_duty_cycle_percent is not None
            else "-"
        )
        pct = (
            f"{100 * chip.hbm_used_bytes / chip.hbm_total_bytes:.1f}%"
            if chip.hbm_total_bytes and chip.hbm_used_bytes is not None
            else "-"
        )
        hbm_cell = (
            f"{fmt_bytes(chip.hbm_used_bytes)}/{fmt_bytes(chip.hbm_total_bytes)}"
            if chip.hbm_used_bytes is not None and chip.hbm_total_bytes is not None
            else "-"  # backend couldn't read HBM (e.g. tunnel, HARDWARE.md)
        )
        row = [
            chip.info.chip_id,
            chip.info.device_path or "-",
            hbm_cell,
            pct,
            duty,
        ]
        if history is not None:
            cid = chip.info.chip_id
            if chip.hbm_used_bytes is not None:
                history.append("tpu_hbm_used_bytes", {"chip_id": str(cid)},
                               chip.hbm_used_bytes)
            if chip.tensorcore_duty_cycle_percent is not None:
                history.append("tpu_tensorcore_duty_cycle_percent",
                               {"chip_id": str(cid)},
                               chip.tensorcore_duty_cycle_percent)
            # Direction over the trailing window: ±0.5% of capacity (or
            # 1 MiB) counts as movement for HBM, ±1 duty point for the core.
            hbm_eps = max((chip.hbm_total_bytes or 0) * 0.005, 1024.0**2)
            row.append(trend_cell(history, "tpu_hbm_used_bytes", cid,
                                  trend_window_s, _fmt_delta_bytes, hbm_eps))
            row.append(trend_cell(history, "tpu_tensorcore_duty_cycle_percent",
                                  cid, trend_window_s,
                                  lambda d: f"{d:+.1f}%", 1.0))
        row.append(f"{owner.namespace}/{owner.pod}" if owner else "-")
        if scanner is not None:
            chip_holders = holders_by_path.get(chip.info.device_path, [])
            row.append(
                ",".join(f"{h.pid}/{h.comm}" for h in chip_holders) or "-"
            )
        rows.append(row)
    if as_json:
        import json

        persist = None
        pressure = None
        if cfg.state_dir:
            from tpu_pod_exporter_torch.persist import state_dir_summary
            from tpu_pod_exporter_torch.pressure import pressure_status_summary

            persist = state_dir_summary(cfg.state_dir)
            pressure = pressure_status_summary(cfg.state_dir)
        egress = None
        if cfg.egress_url:
            from tpu_pod_exporter_torch.egress import egress_dir_summary

            egress = egress_dir_summary(cfg.egress_dir)
        print(json.dumps({
            "accelerator": topo.accelerator,
            "persist": persist,
            "pressure": pressure,
            "egress": egress,
            "slice_name": topo.slice_name,
            "host": topo.host,
            "worker_id": topo.worker_id,
            "multislice_group": topo.multislice_group,
            "num_slices": topo.num_slices,
            "chips": doc_chips,
            # Machine-readable too, not just the stderr warnings: an
            # hbm_used_bytes of null is only diagnosable with these.
            "partial_errors": list(sample.partial_errors),
            "pods": [
                {"namespace": ns_, "pod": pod, "chips": int(n),
                 "hbm_used_bytes": hbm}
                for (ns_, pod), (n, hbm) in sorted(pods.items())
            ],
        }, indent=None if as_json == "line" else 1), flush=True)
        return 0

    header = ["chip", "device", "hbm", "hbm%", "duty"]
    if history is not None:
        header += ["Δhbm", "Δduty"]
    header.append("pod")
    if scanner is not None:
        header.append("holder")
    print(render_table(rows, header))

    if pods:
        print()
        pod_rows = [
            [f"{ns}/{pod}", int(n), fmt_bytes(hbm)]
            for (ns, pod), (n, hbm) in sorted(pods.items())
        ]
        print(render_table(pod_rows, ["pod", "chips", "hbm used"]))

    if history is not None:
        phases = ["device_read", "attribution"]
        if scanner is not None:
            phases.append("process_scan")
        line = phase_breakdown_line(history, phases, trend_window_s)
        if line:
            print()
            print(line)
    if cfg.state_dir:
        line = persist_line(cfg.state_dir)
        if line:
            print()
            print(line)
        line = pressure_line(cfg.state_dir)
        if line:
            print()
            print(line)
    if cfg.egress_url:
        line = egress_line(cfg.egress_url, cfg.egress_dir)
        if line:
            print()
            print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
