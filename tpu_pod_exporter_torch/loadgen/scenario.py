"""Fleet scenario engine — invariant-checked end-to-end drills.

``python -m tpu_pod_exporter_torch.loadgen.scenario`` (``make scenario-demo``) is
the acceptance harness for the node, fleet and storage tiers together:
it stands up the FULL simulated stack —

    SynthTargetFarm (node tier, real HTTP)
      → real LeafAggregator HA pairs (per-shard breakers, state dirs)
        → real RootAggregator (+ /readyz HTTP server, RootQueryPlane)
          → RemoteWriteShipper egress → ChaosReceiver (exactly-once ledger)

— and drives the named scenario timelines from
:mod:`tpu_pod_exporter_torch.scenario` against it, with **invariants asserted at
every tick**, not just at checkpoints:

1. **zero acked-sample loss through egress** — the receiver's ledger must
   end contiguous and duplicate-free for every batch the shipper framed;
2. **bounded staleness per tier** — reachable leaves stay fresh; stale-
   served leaves age monotonically within the --stale-serve-s budget;
3. **root == oracle** rollup equality (flat single-aggregator oracle over
   the same targets file) on every quiet round outside injected windows;
4. **no series/RSS leaks** — the exposition returns to exactly the
   expected series set after churn, and RSS growth stays bounded;
5. **exposition-attributable faults** — every injected fault must be
   readable from the root's exposition alone: partitioned leaves show
   ``leaf_up 0`` + ``stale_served 1`` (+ ``partition_suspected 1`` when
   the HA twin still answers), preempted/restarting targets show
   ``target_up 0``, hotspots dominate the workload rollups, receiver
   outages open the egress breaker with a visible backlog.

Partitions are injected at the HTTP fetch seam via
``chaos.PartitionState``/``PartitionedFetch``/``PartitionedSend`` — the
same wrapper composes over leaf scrape, root scrape, the two-level query
fan-out, and egress send — so asymmetric and flapping cuts exercise every
tier with one mechanism. Deterministic under ``--seed``: event rounds are
fixed by the DSL, flap phases are seeded, and farm telemetry is a pure
function of (target, round).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time
import urllib.error
import urllib.request

from tpu_pod_exporter_torch import utils as _utils
from tpu_pod_exporter_torch.chaos import (
    ChaosReceiver,
    ClockStepper,
    PartitionState,
    PartitionedFetch,
    PartitionedSend,
    ScrapeStorm,
)
from tpu_pod_exporter_torch.pressure import PressureGovernor, dir_usage_bytes
from tpu_pod_exporter_torch.loadgen.fleet import (
    _ShardSim,
    _compare_oracle,
    _family_values,
)
from tpu_pod_exporter_torch.metrics import schema
from tpu_pod_exporter_torch.metrics.parse import parse_families
from tpu_pod_exporter_torch.scenario import (
    DEFAULT_SCENARIO_ORDER,
    INVARIANTS,
    SCENARIOS,
    Scenario,
    ScenarioEvent,
    total_rounds,
)

# Wall-clock staleness slack for "fresh" tiers: the drills run subsecond
# rounds, so anything beyond this means a tier silently stopped merging.
FRESH_STALENESS_BUDGET_S = 8.0

# INVARIANTS (imported above, re-exported here) names the engine's
# invariant families; _Run tracks which were actually ARMED per run — a
# fuzz trial only counts coverage for invariants that could have failed
# it.
__all__ = ["INVARIANTS", "run_one", "run_scenarios", "main"]

# The alert drills' rule set (tpu_pod_exporter_torch.alerting grammar). Both
# rules fire IMMEDIATELY (no `for` clause): engine rounds are subsecond
# and wall-time pendings would make the fired-set assertion timing-
# dependent. Determinism instead comes from the stack itself — partition
# suspicion latches in the SAME merge round a leaf drops with a
# reachable twin (shard.py stale-serve), so under suppression
# TpuRootLeafDown is held down from the first cut round and only the
# partition alert ever fires.
ALERT_DRILL_RULES = """\
alert TpuRootLeafPartitioned = tpu_root_leaf_partition_suspected == 1
    labels(severity="page", drill="scenario")
    annotations(summary="leaf {{ $labels.leaf }} one-sided-unreachable (twin vouches for the pods)")

alert TpuRootLeafDown = tpu_root_leaf_up == 0
    suppress(tpu_root_leaf_partition_suspected == 1)
    labels(severity="page", drill="scenario")
    annotations(summary="leaf {{ $labels.leaf }} unreachable and nothing vouches for it")
"""


def _get_json(url: str, timeout_s: float = 5.0) -> dict:
    with urllib.request.urlopen(url, timeout=timeout_s) as resp:  # noqa: S310 — loopback harness
        return json.loads(resp.read())


class _Run:
    """One scenario against one freshly-built stack."""

    # Admission caps on the root's serving tier while the governor is on
    # (the scrape_storm drill's bound; generous for every other scenario).
    STORM_CONN_CAP = 32
    STORM_CLIENT_CAP = 8
    # Store tiers scaled to paced drill rounds (scenario.round_pause_s
    # keeps one finest bucket finalizing per round).
    STORE_TIERS = "0.25:600,2.5:600"
    STORE_FINEST_STEP = 0.25

    # Per-round push-latency p99 budget for the dashboard_storm drill
    # (frame emission ts → in-process subscriber receipt; generous for
    # shared CI runners — the demo harness measures the real number).
    DASH_PUSH_P99_BUDGET_S = 2.5

    def __init__(self, scn: Scenario, n_targets: int, shards: int,
                 chips: int, state_root: str, seed: int,
                 stale_serve_s: float = 30.0,
                 governor: bool = True, store: bool = True,
                 stream: bool = True,
                 alert_suppression: bool = True) -> None:
        from tpu_pod_exporter_torch.egress import (
            RemoteWriteShipper,
            aggregator_egress_metrics,
            build_breaker,
            default_send,
        )
        from tpu_pod_exporter_torch.server import MetricsServer

        self.scn = scn
        self.events = scn.events()
        self.rounds = total_rounds(self.events, scn.settle_rounds)
        self.state_root = state_root
        os.makedirs(state_root, exist_ok=True)
        self.net = PartitionState(seed=seed)
        self.stale_serve_s = stale_serve_s
        # Fleet TSDB-lite under the root (store_continuity drill): tiers
        # scaled to subsecond drill rounds, one recording rule so the
        # rule-backed-query half of the invariant is exercised. --store
        # off is the drill's NEGATIVE CONTROL: the continuity invariant
        # still runs and must fail on the boundary gap.
        self.store = None
        self.store_on = store and scn.uses_store
        self.store_dir = os.path.join(state_root, "store")
        # Breaker backoffs scaled to subsecond drill rounds (production
        # defaults are tens of seconds): a healed partition's quarantined
        # targets must be re-admitted within the settle budget — the
        # quarantine-vs-partition disambiguation half of the drill.
        self.sim = _ShardSim(
            n_targets, shards, True, chips, state_root,
            timeout_s=3.0, net=self.net, stale_serve_s=stale_serve_s,
            leaf_breaker_backoff_s=0.4, leaf_breaker_backoff_max_s=0.8,
            root_breaker_backoff_s=0.4, root_breaker_backoff_max_s=0.8,
            n_slices=4, query_plane=True,
            store_factory=self._make_store if self.store_on else None,
            gpu_slices=scn.gpu_slices,
        )
        self.membership: list[str] = list(self.sim.farm.targets())
        # Root /readyz over real HTTP: partition-aware degradation is an
        # operator contract, so it is asserted through the wire. With the
        # governor on, the serving tier also carries the admission caps
        # the scrape_storm drill storms against. Hooks dereference
        # self.sim.root LATE (lambdas): a root_restart event swaps the
        # root instance mid-run.
        self.governor_on = governor
        # Streaming dashboard hub (dashboard_storm drill): answers
        # through self.plane via the late-deref poll below, so a
        # root_restart's plane rebuild is transparent to live streams.
        # --stream off is the drill's NEGATIVE CONTROL: subscriptions
        # 404 and the drill must fail.
        self.stream_on = stream
        self.hub = None
        if stream:
            from tpu_pod_exporter_torch.stream import StreamHub

            self.hub = StreamHub(
                self._stream_poll, lambda: self.sim.root.rounds,
                heartbeat_s=2.0, full_sync_s=6.0, max_subscribers=4096,
            )
        # Admission caps: the scrape_storm drill's tight bounds, EXCEPT
        # when this scenario holds a dashboard storm — viewers are the
        # workload there, and all its in-process subscribers share one
        # source IP (the hub's subscriber cap is their admission story).
        conn_cap = self.STORM_CONN_CAP if governor else 0
        client_cap = self.STORM_CLIENT_CAP if governor else 0
        dash_counts = [ev.count for ev in self.events
                       if ev.kind == "dashboard_storm"]
        if dash_counts and governor:
            conn_cap = max(conn_cap, 2 * max(dash_counts) + 16)
            client_cap = 0
        # The EFFECTIVE cap, saved for the storm invariant: a composed
        # dashboard storm raises it above STORM_CONN_CAP, and a generated
        # storm smaller than it legitimately draws zero 429s (the fuzzer's
        # sub-cap scrape_storm find — the old check hardcoded the class
        # constant and demanded rejections from ANY storm).
        self.conn_cap = conn_cap
        self.root_server = MetricsServer(
            self.sim.root_store, host="127.0.0.1", port=0,
            ready_detail_fn=lambda: self.sim.root.ready_detail(),
            max_open_connections=conn_cap,
            max_requests_per_client=client_cap,
            stream_hub=self.hub,
        )
        self.root_server.start()
        # Two-level query plane, partitioned at the root→leaf seam.
        port_to_leaf = dict(self.sim.leaf_addr_of)

        def _leaf_of_url(url: str) -> str:
            try:
                hostport = url.split("/", 3)[2]
            except IndexError:
                hostport = ""
            return port_to_leaf.get(hostport, "leaf:?")

        self._leaf_of_url = _leaf_of_url
        self.plane = None
        self._build_planes()
        # Egress: the root's rollups ship to a ChaosReceiver through a
        # partitionable sender; the ledger is the zero-loss oracle.
        self.receiver = None
        self.shipper = None
        self.egress_dir = os.path.join(state_root, "egress")
        # Wall clock the clock_step events step: the shipper ages its
        # backlog against it, so the fence (this-process batches age
        # monotonically) is exercised through a real component.
        self.clock = ClockStepper()
        if scn.uses_egress:
            self.receiver = ChaosReceiver([], seed=seed)
            self.receiver.start()
            self.shipper = RemoteWriteShipper(
                self.receiver.url,
                self.egress_dir,
                metrics=aggregator_egress_metrics(),
                interval_s=0.0,
                timeout_s=2.0,
                breaker=build_breaker(2, 0.3, 1.5),
                extra_labels={"host": "scenario-root"},
                send=PartitionedSend(self.net, "root", "recv", default_send),
                wallclock=self.clock,
            )
            self.shipper.load()
            self.shipper.start()
        # Native alerting plane (alert drills): an in-root AlertEvaluator
        # over the drill rule set, its webhook notifier backed by the
        # same WAL + breaker discipline as egress. The send callable IS
        # the ledger oracle (contiguous seqs = exactly-once), and a
        # recv_outage event wedges it alongside the remote-write
        # receiver so the backlog/drain path is exercised by a fault the
        # engine already injects. suppression=False is the fired-set
        # assertion's NEGATIVE CONTROL (--alert-suppression off).
        self.alert_eval = None
        self.alert_notifier = None
        self.alert_suppression = alert_suppression
        self._alert_outage = False
        self._alert_ledger_lock = threading.Lock()
        self.alert_ledger: list[int] = []
        self.alert_notes: list[dict] = []
        if scn.expected_alerts is not None:
            from tpu_pod_exporter_torch.alerting import (
                SEQ_HEADER,
                AlertEvaluator,
                AlertNotifier,
                parse_alert_rules,
            )

            alert_dir = os.path.join(state_root, "alerts")

            def _alert_send(url: str, body: bytes, headers: dict,
                            timeout_s: float) -> int:
                if self._alert_outage:
                    raise urllib.error.URLError(
                        "drill: alert receiver outage")
                seq = int(headers.get(SEQ_HEADER, "0") or 0)
                with self._alert_ledger_lock:
                    self.alert_ledger.append(seq)
                    self.alert_notes.append(json.loads(body))
                return 200

            self.alert_notifier = AlertNotifier(
                "http://alert-recv.invalid/hook", alert_dir,
                breaker=build_breaker(2, 0.1, 0.8),
                send=_alert_send,
            )
            self.alert_notifier.load()
            self.alert_notifier.start()
            self.alert_eval = AlertEvaluator(
                parse_alert_rules(ALERT_DRILL_RULES),
                alert_dir=alert_dir,
                notifier=self.alert_notifier,
                store=self.store,
                suppression=alert_suppression,
            )
        # Resource-pressure governor over the root-side stack: the disk
        # ladder watches the egress dir (segment compaction rung), the
        # memory ladder the byte-accounted caches (leaf fleet caches
        # first, root stale-serve views second — coarse data last).
        # Budgets start at 0 (no pressure); the disk_full / mem_pressure
        # events squeeze them mid-run. Ticked synchronously per round —
        # deterministic, no governor thread in the engine.
        self.gov: PressureGovernor | None = None
        if governor:
            self.gov = PressureGovernor(
                check_interval_s=0.05, hysteresis_s=0.3)
            if self.shipper is not None:
                self.gov.add_disk_path(self.egress_dir)
                self.gov.add_disk_rung(
                    "egress_compact",
                    lambda: self.shipper.set_disk_pressure(True),
                    lambda: self.shipper.set_disk_pressure(False),
                )
            if self.store is not None:
                # store_thin AFTER egress compaction (acked egress bytes
                # are free to reclaim; store buckets are answerable
                # history) — coarse store tiers shed never. The getter
                # dereferences self.store late: root_restart swaps the
                # instance (which re-applies the pressure hook, see
                # _make_store). One wiring path with production
                # (pressure.register_store_rungs), not a hand-rolled twin.
                from tpu_pod_exporter_torch.pressure import register_store_rungs

                register_store_rungs(self.gov, self.store,
                                     store_fn=lambda: self.store)
            self.gov.register_memory_component(
                "fleet_caches", self._leaf_cache_bytes)
            self.gov.register_memory_component(
                "stale_views",
                # Late deref, like every root hook: a root_restart swaps
                # the instance, and accounting a dead root's frozen views
                # would make the shed rung free nothing measurable.
                lambda: self.sim.root.stale_view_bytes())
            self.gov.add_memory_rung(
                "fleet_cache",
                lambda: self._set_leaf_caches(False),
                lambda: self._set_leaf_caches(True),
            )
            self.gov.add_memory_rung(
                "stale_views",
                lambda: self.sim.root.shed_stale_views(),
                lambda: None,
            )
            if self.hub is not None:
                # Viewers shed LAST among the cheap rungs: dropping a
                # cache costs a re-fan-out; dropping a subscription costs
                # a viewer (who must reconnect against a replica).
                from tpu_pod_exporter_torch.pressure import register_stream_rung

                register_stream_rung(self.gov, self.hub)
        # Pressure-drill state.
        self.disk_usage_at_squeeze = 0
        self.disk_budget_target = 0
        self.disk_batch_est = 4096
        self.mem_budget_target = 0
        # Accounted memory at the last verified quiet round: the WARM
        # steady state. A mem_pressure window that opens right after a
        # root restart would otherwise derive its budget from a cold
        # cache (fuzzer find: root_restart()@2; mem_pressure()@3+2 set
        # an unmeetable budget the legitimate warm-up then breached).
        self.mem_accounted_baseline = 0
        self.storm: ScrapeStorm | None = None
        self.storm_baseline_p99: float | None = None
        self.storm_p99s: list[float] = []
        # dashboard_storm state: the subscriber harness plus running
        # equality/latency tallies (verdict rendered in _finish).
        self.dash = None
        self.dash_eq_checks = 0
        self.dash_eq_failures = 0
        self.dash_push_p99s: list[float] = []
        self.dash_totals: dict = {}
        self._polite_conn = None  # lazy http.client keep-alive connection
        self.baseline_series: set | None = None
        self.baseline_workloads = 0
        self.rss_baseline: float | None = None
        # Targets healed from an injected outage but possibly still
        # quarantined leaf-side; they must come back before the run ends.
        self.recovering: set[str] = set()
        # Targets seen healthy ONCE since their fault ended; pruned from
        # `recovering` only on a second consecutive healthy check. The
        # HA freshest-wins merge can flap a just-revived target back to
        # down for one round under load — one healthy sighting is not
        # yet recovery (fuzzer find, load-dependent).
        self._recovered_once: set[str] = set()
        # Same for leaves after a root-leaf cut heals: the root's leaf
        # breaker holds its quarantine until the next half-open probe —
        # bounded by the settle loop, not an instant flip.
        self.recovering_leaves: set[str] = set()
        self.restart_batches: dict[int, tuple[int, ...]] = {}
        # mixed_wedge parity bookkeeping: per-wedge degradation signature
        # ({family, victims, down, chip drop, other-family drift,
        # quarantined}) captured at each preempt window's last round; the
        # finish asserts the TPU and GPU signatures are identical in kind.
        self.wedge_sigs: list[dict] = []
        self._wedge_chips_before: dict[str, float] = {}
        # store_continuity boundary stamps (root_restart event hooks).
        self.start_wall = 0.0
        self.kill_wall = 0.0
        self.restart_wall = 0.0
        self.round_end_walls: list[float] = []
        self.trace: list[dict] = []
        self.problems: list[str] = []
        # Which invariant families this run can actually fail on — the
        # fuzzer's coverage ledger records (seam × invariant) only for
        # armed invariants, so a store-off run never claims ledger
        # coverage it didn't buy. oracle_equality arms lazily, on the
        # first compare that actually executes.
        self.invariants_armed: set[str] = {
            "bounded_staleness", "fault_attribution", "series_rss_leaks",
        }
        if self.shipper is not None:
            self.invariants_armed.add("egress_ledger")
        if self.alert_eval is not None:
            self.invariants_armed.add("alerts_correctness")

    # --------------------------------------------------------- store helpers

    def _make_store(self):
        """FleetStore factory handed to _ShardSim: called at boot AND by
        restart_root — the fresh instance replays the same dir, which IS
        the continuity under test."""
        from tpu_pod_exporter_torch.store import FleetStore, parse_rules

        rules = parse_rules(
            "scenario:hbm:by_slice = sum("
            + schema.TPU_SLICE_HBM_USED_BYTES.name + ") by (slice_name)\n"
            # Per-family aggregation through the rule plane: mixed fleets
            # precompute the family split the same way the drills read it.
            "scenario:chips:by_family = sum("
            + schema.TPU_SLICE_CHIP_COUNT.name + ") by (family)\n")
        s = FleetStore(self.store_dir, tiers=self.STORE_TIERS, rules=rules)
        s.open()
        # Hooks and held rung state live on the instance: a restart-
        # swapped store must rejoin the governor's ENOSPC fault window
        # AND re-apply a held store_thin rung (register_store_rungs
        # wired the first instance; the getter covers the rung
        # callbacks, this covers per-instance state — the documented
        # store_fn contract).
        gov = getattr(self, "gov", None)
        if gov is not None:
            s.set_pressure_hook(gov.report_io_error)
            gs = gov.stats()["disk"]
            if "store_thin" in gs["rungs"][:gs["level"]]:
                s.set_thin(True)
        self.store = s
        return s

    def _build_planes(self) -> None:
        """(Re)build the two-level query plane — and its store-backed
        front when a store is attached. Called at boot and after a
        root_restart (the fresh root owns fresh leaf breakers and a fresh
        store instance)."""
        from tpu_pod_exporter_torch.shard import RootQueryPlane

        if self.plane is not None:
            try:
                self.plane.close()
            except Exception:  # noqa: BLE001 — rebuild must proceed
                pass
        from tpu_pod_exporter_torch.fleet import default_api_fetch

        def _plain_api(url: str, timeout_s: float) -> dict:
            return default_api_fetch(url, timeout_s)

        inner = RootQueryPlane(
            self.sim.topology, timeout_s=2.5,
            fetch=PartitionedFetch(self.net, "root", self._leaf_of_url,
                                   _plain_api),
            leaf_breakers=self.sim.root._breakers,
        )
        if self.store is not None:
            from tpu_pod_exporter_torch.store import StoreQueryPlane

            self.plane = StoreQueryPlane(inner, self.store)
        else:
            self.plane = inner
        if self.hub is not None and (
                self.hub.emit not in self.sim.root.emit_hooks):
            # The tpu_stream_* surface rides the root's publish; a
            # root_restart's fresh root needs the hook re-attached.
            self.sim.root.emit_hooks.append(self.hub.emit)

    # --------------------------------------------------------- stream helpers

    def _stream_poll(self, shape, generation):
        """The hub's poll_fn: answers through the CURRENT query plane
        (late deref — root_restart rebuilds self.plane mid-run and live
        streams must follow the fresh instance)."""
        from tpu_pod_exporter_torch.stream import plane_poll_fn

        ev = getattr(self, "alert_eval", None)
        return plane_poll_fn(
            self.plane,
            alerts_fn=ev.rows if ev is not None else None,
        )(shape, generation)

    def _dash_shapes(self):
        from tpu_pod_exporter_torch.stream import QueryShape

        # One panel per farm slice plus a fleet-wide one — a handful of
        # shapes shared by many subscribers, the dashboard's real shape.
        return [
            QueryShape(route="window_stats", metric="tpu_hbm_used_bytes",
                       match=(("slice_name", f"slice-{i}"),), window_s=30.0)
            for i in range(4)
        ] + [QueryShape(route="window_stats",
                        metric="tpu_hbm_used_bytes", window_s=30.0)]

    # ------------------------------------------------------- pressure helpers

    def _leaf_cache_bytes(self) -> int:
        """Summed leaf fleet-cache byte estimates — the memory ladder's
        first component (live dict walk: leaves restart/replace)."""
        total = 0
        for leaf in self.sim.leaves.values():
            if leaf.fleet is not None:
                total += leaf.fleet.cache_bytes()
        return total

    def _set_leaf_caches(self, enabled: bool) -> None:
        for leaf in self.sim.leaves.values():
            if leaf.fleet is not None:
                leaf.fleet.set_cache_enabled(enabled)

    def _accounted_memory(self) -> int:
        """The memory invariant's number, computed directly so the
        governor-off negative control measures the same thing."""
        return self._leaf_cache_bytes() + self.sim.root.stale_view_bytes()

    def _polite_p99(self, n: int) -> float:
        """Latency of a polite scraper against the root's /metrics: ONE
        long-lived keep-alive connection (established before any storm —
        the incumbent-scraper shape admission control protects; its
        source is 127.0.0.1, distinct from the storm's 127.0.0.N pool)."""
        import http.client

        if self._polite_conn is None:
            self._polite_conn = http.client.HTTPConnection(
                "127.0.0.1", self.root_server.port, timeout=10)
        lat: list[float] = []
        for _ in range(n):
            t0 = time.perf_counter()
            self._polite_conn.request("GET", "/metrics")
            resp = self._polite_conn.getresponse()
            resp.read()
            if resp.status != 200:
                raise RuntimeError(f"polite scrape got {resp.status}")
            lat.append(time.perf_counter() - t0)
        lat.sort()
        return lat[min(int(n * 0.99), n - 1)]

    # ------------------------------------------------------------ event hooks

    def _leaf_cut_edges(self, ev: ScenarioEvent) -> list[tuple[str, str]]:
        pair = frozenset(ev.edge or ())
        if pair == frozenset({"leaf", "root"}):
            if ev.mode == "asymmetric":
                return [("root", f"leaf:{name}")
                        for name in self.sim.leaves if name.endswith("a")]
            return [("root", "leaf")]
        if pair == frozenset({"node", "leaf"}):
            if ev.mode == "asymmetric":
                return [(f"leaf:{name}", "node")
                        for name in self.sim.leaves if name.endswith("a")]
            return [("leaf", "node")]
        return [("root", "recv")]

    def _member_indices(self) -> set[int]:
        return {self._idx_of(t) for t in self.membership}

    @staticmethod
    def _idx_of(target: str) -> int:
        try:
            parts = target.split("/")
            return int(parts[parts.index("t") + 1])
        except (ValueError, IndexError):
            return -1

    def _start_event(self, ev: ScenarioEvent) -> None:
        farm = self.sim.farm
        if ev.kind == "partition":
            for src, dst in self._leaf_cut_edges(ev):
                self.net.cut(src, dst, flapping=ev.mode == "flapping")
        elif ev.kind == "preempt":
            sl = int(ev.subject.rsplit("-", 1)[1])
            victims = [i for i in farm.slice_targets(sl)
                       if i in self._member_indices()]
            ev_state = set(victims)
            # Pre-wedge family chip counts, from the root's CURRENT body
            # (last round's publish — the wedge has not bitten yet): the
            # per-family drop baseline for the mixed-wedge parity check.
            self._wedge_chips_before = {
                s.labels.get("family", "?"): s.value
                for s in parse_families(self.sim.root_body()).get(
                    schema.TPU_FLEET_FAMILY_CHIP_COUNT.name, ())
            }
            farm.dead |= ev_state
            self._preempt_victims = ev_state
        elif ev.kind == "hotspot":
            self._resolve_hotspot(ev)
        elif ev.kind == "restart_wave":
            live = sorted(
                i for i in self._member_indices() if i not in farm.dead
            )[:ev.count]
            self.restart_batches = {
                ev.at_round + j: tuple(live[j * ev.stagger:(j + 1) * ev.stagger])
                for j in range(ev.duration)
            }
        elif ev.kind == "recv_outage":
            if self.receiver is not None:
                self.receiver.set_outage(True)
            # The alert webhook lives on the receiver tier too: its
            # notifier must wedge (breaker open, WAL backlog) alongside
            # the remote-write shipper and drain exactly-once after heal.
            self._alert_outage = True
        elif ev.kind == "disk_full":
            # Squeeze the disk budget to half the CURRENT usage: a breach
            # is guaranteed whatever the absolute batch sizes are, and the
            # per-batch estimate anchors the post-shed floor (steady state
            # after compaction is O(one segment + one batch), never an
            # arbitrary fraction of an arbitrary budget).
            usage = dir_usage_bytes(self.egress_dir)
            enq = 1
            if self.shipper is not None:
                enq = max(self.shipper.stats()["enqueued_batches"], 1)
            self.disk_usage_at_squeeze = usage
            self.disk_batch_est = max(usage // enq, 2048)
            self.disk_budget_target = max(usage // 2, 1024)
            if self.gov is not None:
                self.gov.set_disk_budget_bytes(self.disk_budget_target)
        elif ev.kind == "mem_pressure":
            # Budget = WARM accounted + one small delta: the query
            # traffic the window drives adds far more than the delta, so
            # governor-off breaches deterministically while governor-on
            # (caches cleared + disabled) stays under. The quiet-round
            # baseline floors the reference — sampling a cold cache
            # right after a root restart would set a budget the
            # legitimate warm-up alone breaches.
            self.mem_budget_target = max(
                self._accounted_memory(), self.mem_accounted_baseline
            ) + 2048
            if self.gov is not None:
                self.gov.set_memory_budget_bytes(self.mem_budget_target)
        elif ev.kind == "scrape_storm":
            try:
                self.storm_baseline_p99 = self._polite_p99(12)
            except (OSError, RuntimeError) as e:
                self.problems.append(
                    f"polite scraper failed BEFORE the storm: {e}")
                self.storm_baseline_p99 = None
            self.storm_p99s = []
            self.storm = ScrapeStorm(
                "127.0.0.1", self.root_server.port, conns=ev.count,
                pause_s=0.02)
            self.storm.start()
        elif ev.kind == "clock_step":
            self.clock.step(ev.step_s)
        elif ev.kind == "root_restart":
            # SIGKILL-shaped: the serving tier keeps answering the stale
            # snapshot (real kubelet gap), leaves keep polling, the store
            # stops appending — the dead window the store must later fill.
            self.kill_wall = time.time()
            self.sim.kill_root()
        elif ev.kind == "dashboard_storm":
            from tpu_pod_exporter_torch.loadgen.fleet import _StormSubscribers

            self.dash = _StormSubscribers(workers=2)
            self.dash.set_endpoints(
                [("root", ("127.0.0.1", self.root_server.port))])
            self.dash.open(ev.count, self._dash_shapes())
            # With --stream off this wait times out (every subscribe
            # 404s) and the tick invariant below fails the run — the
            # negative control's whole point.
            self.dash.wait_snapshots(ev.count, timeout_s=10.0)

    def _end_event(self, ev: ScenarioEvent) -> None:
        farm = self.sim.farm
        if ev.kind == "partition":
            for src, dst in self._leaf_cut_edges(ev):
                self.net.heal(src, dst)
                if src == "root" and dst.startswith("leaf"):
                    if dst == "leaf":
                        self.recovering_leaves.update(self.sim.leaves)
                    else:
                        self.recovering_leaves.add(dst.split(":", 1)[1])
                if dst == "node" or src == "node":
                    # A healed node-tier cut leaves every member target's
                    # scrape breaker open until its next probe; that
                    # post-heal darkness is attributable to THIS cut, not
                    # an unexplained outage (fuzzer find: a bare
                    # node<->leaf window flagged 18 targets "down without
                    # an injected fault" one round after heal). Over-
                    # marking is self-limiting — recovery pruning drops
                    # any target the moment it is seen healthy.
                    self.recovering |= {
                        farm.url(i) for i in self._member_indices()}
        elif ev.kind == "preempt":
            victims = getattr(self, "_preempt_victims", set())
            farm.dead -= victims
            self.recovering |= {farm.url(i) for i in victims}
        elif ev.kind == "restart_wave":
            # The final batch's hosts come back when the window closes
            # (earlier batches revive on the next wave tick).
            last = set(self.restart_batches.get(ev.end_round - 1, ()))
            farm.dead -= last
            self.recovering |= {farm.url(i) for i in last}
        elif ev.kind == "hotspot":
            farm.hot = set()
        elif ev.kind == "recv_outage":
            if self.receiver is not None:
                self.receiver.set_outage(False)
            self._alert_outage = False
        elif ev.kind == "disk_full":
            # The operator freed space / raised the budget: pressure off,
            # and the settle loop must see the ladder recover to 0.
            if self.gov is not None:
                self.gov.set_disk_budget_bytes(0)
        elif ev.kind == "mem_pressure":
            if self.gov is not None:
                self.gov.set_memory_budget_bytes(0)
        elif ev.kind == "scrape_storm":
            if self.storm is not None:
                self.storm.stop()
        elif ev.kind == "root_restart":
            # Fresh root; with a store factory the fresh FleetStore
            # replays the same dir — planes rebuild onto the new
            # instances (breakers + store identity changed).
            # The killed root's memory is gone before the fresh one
            # starts: drop this run's hold on its plane and store first.
            if self.plane is not None:
                self.plane.close()
            self.plane = self.store = None
            self.sim.restart_root()
            self.restart_wall = time.time()
            self._build_planes()
        elif ev.kind == "dashboard_storm":
            if self.dash is not None:
                self.dash_totals = self.dash.totals()
                self.dash.stop()
                self.dash = None

    def _excused_losses(self, lost: set) -> set:
        """The subset of lost series attributable to targets down or
        recovering from OTHER injected faults. The partition-retention
        invariant must not claim a preempted slice's rollups as
        partition damage (fuzzer find: preempt recovery overlapping a
        dead-root window and a flapping cut — the frozen body still
        lacked the victims' series, and only the partition was left
        standing to blame). Excusal keys on the down targets' slice,
        pod, and URL labels; series of healthy targets stay covered."""
        farm = self.sim.farm
        down = set(farm.dead)
        down |= {self._idx_of(u) for u in self.recovering}
        if not down:
            return set()
        slices = {f"slice-{i % farm.n_slices}" for i in down}
        pods = {farm.pod_of(i) for i in down}
        urls = {farm.url(i) for i in down}
        excused = set()
        for name, labels in lost:
            lab = dict(labels)
            if (lab.get("slice_name") in slices or lab.get("pod") in pods
                    or lab.get("target") in urls):
                excused.add((name, labels))
        return excused

    def _settle_disk(self, bound: int) -> int:
        """Give the async shed/compaction path a bounded window to reach
        steady state before the usage invariant reads it. A short drill
        window (the fuzzer generates one-round disk_full events) can end
        with the shed RECORDED but the segment rewrite still in flight —
        measuring mid-rewrite fails a governor that is working. Returns
        the final usage; gives up as soon as usage stops falling."""
        usage = dir_usage_bytes(self.egress_dir)
        for _ in range(40):
            if usage <= bound:
                break
            if self.gov is None:
                # Governor off (negative control): nothing will ever
                # shed — measure once, fail honestly.
                break
            self.gov.tick()
            if self.shipper is not None:
                # Re-assert the held rung through the public path: the
                # seal reclaims acked bytes the lazy rotation stranded.
                self.shipper.set_disk_pressure(True)
            time.sleep(0.05)
            usage = dir_usage_bytes(self.egress_dir)
        return usage

    def _resolve_hotspot(self, ev: ScenarioEvent) -> None:
        """Re-resolve the hot index set from the CURRENT pod mapping —
        at window start and again every tick. An index set pinned once at
        start silently stops mapping to ``ev.subject`` when a composed
        churn_storm bumps ``pod_gen`` mid-window: the HBM boost lands on
        indices whose pod label has rotated away, the subject rolls up to
        zero, and the attributability invariant trips (the fuzzer's
        hotspot x churn find — the old code admitted the composition was
        unsupported "only by convention")."""
        farm = self.sim.farm
        farm.hot = {
            i for i in self._member_indices()
            if farm.pod_of(i) == ev.subject
        }

    def _tick_event(self, ev: ScenarioEvent, r: int) -> None:
        """Per-round continuation for windowed events."""
        farm = self.sim.farm
        if ev.kind == "restart_wave":
            batch = self.restart_batches.get(r, ())
            prev = self.restart_batches.get(r - 1, ())
            farm.dead -= set(prev)
            self.recovering |= {farm.url(i) for i in prev}
            farm.dead |= set(batch)
        elif ev.kind == "churn_storm":
            k = ev.count // 2
            added = list(farm.add_targets(ev.count - k))
            self.membership = self.membership[k:] + added
            farm.pod_gen += 1  # the label-churn half of the storm
            self.sim.write_targets(self.membership)
            # Churn changes the TRUE series set (members retired, every
            # pod label rotated): the retention baseline is stale the
            # moment this ticks. Drop it — the next verified quiet round
            # re-arms it — so churn's legitimate deletions can't be
            # mis-attributed to a concurrent partition (fuzzer find:
            # churn_storm + root<->recv cut in one round reported the
            # rotated pods as "series lost during partition").
            self.baseline_series = None
        elif ev.kind == "disk_full" and self.shipper is not None:
            # Keep FRESH batches landing through the window (a full extra
            # round, never a re-push of the same snapshot — identical
            # sample timestamps would corrupt the exactly-once ledger this
            # very drill asserts): the negative control's usage growth
            # must be monotone.
            self.sim.run_round()
            self.shipper.on_snapshot(self.sim.root_store.current())
            time.sleep(0.05)  # let the writer thread land the append
        elif ev.kind == "mem_pressure":
            # Drive dashboard-shaped query traffic so the leaf fleet
            # caches actually grow: generation bumps per round make every
            # window a fresh cache key.
            for k in range(3):
                try:
                    self.plane.window_stats(
                        "tpu_hbm_used_bytes",
                        window_s=float(30 + 10 * r + k),
                    )
                except Exception:  # noqa: BLE001 — traffic, not an assertion
                    pass
        elif ev.kind == "scrape_storm" and self.storm is not None:
            try:
                self.storm_p99s.append(self._polite_p99(8))
            except (OSError, RuntimeError) as e:
                # The incumbent polite scraper being rejected/disconnected
                # mid-storm IS an invariant failure — recorded, never a
                # crash that aborts the whole suite.
                self._polite_conn = None  # reconnect on the next probe
                self.problems.append(
                    f"r{r}: polite scraper failed during the storm: {e}")

    # -------------------------------------------------------------- the drive

    def run(self) -> dict:
        result: dict = {"scenario": self.scn.name,
                        "timeline": self.scn.timeline, "ok": False}
        self._warm_query_pools()
        self.start_wall = time.time()
        try:
            for r in range(self.rounds):
                for ev in self.events:
                    if ev.end_round == r:
                        self._end_event(ev)
                for ev in self.events:
                    if ev.at_round == r:
                        self._start_event(ev)
                for ev in self.events:
                    if ev.at_round <= r < ev.end_round:
                        self._tick_event(ev, r)
                # Hotspot resolution LAST, after every event has mutated
                # membership/labels for this round: a churn_storm ticking
                # after the hotspot would bump pod_gen and orphan an
                # already-resolved hot set (event order within a round is
                # timeline order, so the fix cannot live in _tick_event).
                for ev in self.events:
                    if ev.kind == "hotspot" and ev.at_round <= r < ev.end_round:
                        self._resolve_hotspot(ev)
                self.sim.run_round()
                self.round_end_walls.append(time.time())
                if self.shipper is not None:
                    self.shipper.on_snapshot(self.sim.root_store.current())
                if self.alert_eval is not None:
                    # Ride the round exactly where the root CLI runs it:
                    # after the merge publish, before serving checks.
                    self.alert_eval.evaluate_round(
                        self.sim.root_store.current())
                if self.hub is not None:
                    # Deterministic engine: rounds drive the hub
                    # synchronously (the CLIs ride a StreamPump thread).
                    self.hub.on_round(self.sim.root.rounds)
                if self.gov is not None:
                    # Two synchronous ticks: at most one rung moves per
                    # tick, and the deeper ladders need to climb within a
                    # window measured in rounds.
                    time.sleep(0.06)  # past check_interval + writer drain
                    self.gov.tick()
                    self.gov.tick()
                self._check_tick(r)
                if self.problems:
                    result["failed_round"] = r
                    result["problems"] = self.problems[:8]
                    return result
                if self.scn.round_pause_s:
                    time.sleep(self.scn.round_pause_s)
            ok = self._finish(result)
            result["ok"] = ok and not self.problems
            if self.problems:
                result["problems"] = self.problems[:8]
            return result
        finally:
            result["trace_ticks"] = len(self.trace)
            result["invariants_armed"] = sorted(self.invariants_armed)
            self._close()

    def _warm_query_pools(self) -> None:
        """One two-level query before round 0, as a dashboard behind the
        root asks. The query pools (the root's, and one a leaf) start
        their workers on their first fan-out and keep them: a first
        fan-out after the RSS baseline (mem_pressure's dashboard traffic,
        store_continuity's boundary query) put 136 idle workers' stacks
        into the leak bound at 120 targets and 4 shards, and where a
        thread's stack costs up to 2 MiB of RSS (a gVisor host) they
        alone filled most of it."""
        try:
            self.plane.window_stats("tpu_hbm_used_bytes", window_s=30.0)
        except Exception:  # noqa: BLE001 — warm-up traffic, not an assertion
            pass

    # ---------------------------------------------------------- tick checks

    def _active(self, r: int) -> list[ScenarioEvent]:
        return [ev for ev in self.events if ev.at_round <= r < ev.end_round]

    def _expected_cut_leaves(self) -> set[str]:
        """Leaf names the root cannot reach under the currently-EFFECTIVE
        cuts (flapping cuts only on their cut half-rounds)."""
        out: set[str] = set()
        for src, dst, _flap in self.net.active():
            if src != "root":
                continue
            if dst == "leaf":
                out.update(self.sim.leaves)
            elif dst.startswith("leaf:"):
                out.add(dst.split(":", 1)[1])
        return out

    def _check_tick(self, r: int) -> None:
        farm = self.sim.farm
        active = self._active(r)
        # Warm high-water of accounted memory outside injected mem
        # windows: the reference a later mem_pressure budget is derived
        # from. Without it, a window opening right after a root restart
        # samples a cold cache and sets a budget the legitimate warm-up
        # alone breaches (fuzzer find: root_restart()@2;
        # mem_pressure()@3+2).
        if not any(ev.kind == "mem_pressure" for ev in active):
            self.mem_accounted_baseline = max(
                self.mem_accounted_baseline, self._accounted_memory())
        body = self.sim.root_body()
        fams = parse_families(body)
        series = set(_family_values(body))
        problems: list[str] = []

        leaf_up = {
            (s.labels["shard"], s.labels["leaf"]): s.value
            for s in fams.get(schema.TPU_ROOT_LEAF_UP.name, ())
        }
        stale_served = {
            (s.labels["shard"], s.labels["leaf"]): s.value
            for s in fams.get(schema.TPU_ROOT_LEAF_STALE_SERVED.name, ())
        }
        suspected = {
            (s.labels["shard"], s.labels["leaf"]): s.value
            for s in fams.get(
                schema.TPU_ROOT_LEAF_PARTITION_SUSPECTED.name, ())
        }
        staleness = {
            (s.labels["shard"], s.labels["leaf"]): s.value
            for s in fams.get(
                schema.TPU_ROOT_LEAF_STALENESS_SECONDS.name, ())
        }
        target_up = {
            s.labels["target"]: s.value
            for s in fams.get(schema.TPU_AGG_TARGET_UP.name, ())
        }

        # --- (5) attributability: injected leaf-tier cuts ----------------
        cut_leaves = self._expected_cut_leaves()
        for name, leaf in self.sim.leaves.items():
            shard = self.sim._leaf_meta[name][0]
            key = (shard, leaf.addr)
            if leaf_up.get(key) == 1.0:
                self.recovering_leaves.discard(name)
            if name in cut_leaves:
                if leaf_up.get(key) != 0.0:
                    problems.append(
                        f"r{r}: cut leaf {name} not attributable "
                        f"(leaf_up={leaf_up.get(key)})")
                if self.stale_serve_s > 0 and stale_served.get(key) != 1.0:
                    problems.append(
                        f"r{r}: cut leaf {name} not stale-served")
                twin_reachable = any(
                    n != name and n not in cut_leaves
                    for n in self.sim.leaves
                    if self.sim._leaf_meta[n][0] == shard
                )
                if twin_reachable and suspected.get(key) != 1.0:
                    problems.append(
                        f"r{r}: cut leaf {name} (twin reachable) not "
                        f"marked partition-suspected")
            elif (r >= 1 and leaf_up.get(key) != 1.0
                    and name not in self.recovering_leaves):
                problems.append(
                    f"r{r}: healthy leaf {name} reported down "
                    f"(leaf_up={leaf_up.get(key)})")

        # --- (5) attributability: injected target outages ----------------
        injected_down = {
            farm.url(i) for i in farm.dead if i in self._member_indices()
        }
        for t in injected_down:
            if target_up.get(t) != 0.0:
                problems.append(
                    f"r{r}: injected-down target {t} not attributable "
                    f"(up={target_up.get(t)})")
        reported_down = {t for t, v in target_up.items() if v == 0.0}
        unexplained = reported_down - injected_down - self.recovering
        if unexplained and not cut_leaves and not any(
                ev.kind == "partition" for ev in active):
            problems.append(
                f"r{r}: {len(unexplained)} target(s) down without an "
                f"injected fault: {sorted(unexplained)[:3]}")
        up_now = {t for t in self.recovering if target_up.get(t) == 1.0}
        self.recovering -= up_now & self._recovered_once
        self._recovered_once = up_now - self._recovered_once
        restart_active = [ev for ev in active if ev.kind == "restart_wave"]
        if restart_active:
            ev = restart_active[0]
            batch = set(self.restart_batches.get(r, ()))
            # The 2*stagger blast-radius cap is a claim about the WAVE
            # (current batch + previous batch still recovering) — down
            # targets attributable to a composed fault (active preempt,
            # healed-cut recovery lag) don't count against it, but the
            # wave's own hosts always do.
            wave_urls = {farm.url(i)
                         for b in self.restart_batches.values() for i in b}
            wave_down = (reported_down
                         - (self.recovering - wave_urls)
                         - (injected_down - wave_urls))
            if len(wave_down) > 2 * ev.stagger:
                problems.append(
                    f"r{r}: restart wave (stagger {ev.stagger}) has "
                    f"{len(wave_down)} targets down at once")
            stray = ({self._idx_of(t) for t in reported_down} - batch
                     - {self._idx_of(t) for t in self.recovering}
                     - {self._idx_of(t) for t in injected_down})
            if stray:
                problems.append(
                    f"r{r}: restart wave touched targets outside its "
                    f"batch: {sorted(stray)[:4]}")

        # --- (5) attributability: hotspot dominates the workload rollups -
        for ev in active:
            if ev.kind != "hotspot" or not (farm.hot - farm.dead):
                # All hot hosts are down this round (a composed restart
                # wave can take the hot pod's only host with it): the pod
                # is legitimately absent from the rollups.
                continue
            per_pod: dict[str, float] = {}
            for s in fams.get(schema.TPU_WORKLOAD_HBM_USED_BYTES.name, ()):
                pod = s.labels.get("pod", "?")
                per_pod[pod] = per_pod.get(pod, 0.0) + s.value
            hot = per_pod.get(ev.subject, 0.0)
            others = [v for p, v in per_pod.items() if p != ev.subject]
            if not others or hot <= 2.0 * max(others):
                problems.append(
                    f"r{r}: hotspot {ev.subject} not attributable from "
                    f"workload rollups (hot={hot:g}, "
                    f"max other={max(others) if others else 0:g})")

        # --- (2) bounded staleness per tier ------------------------------
        for key, up in leaf_up.items():
            st = staleness.get(key)
            if up == 1.0 and st is not None and st > FRESH_STALENESS_BUDGET_S:
                problems.append(
                    f"r{r}: reachable leaf {key} staleness {st:.1f}s "
                    f"exceeds {FRESH_STALENESS_BUDGET_S:g}s")
            if stale_served.get(key) == 1.0 and st is not None and (
                    st > self.stale_serve_s + FRESH_STALENESS_BUDGET_S):
                problems.append(
                    f"r{r}: stale-served leaf {key} staleness {st:.1f}s "
                    f"beyond the stale-serve budget")

        # --- (3)+(4) series retention / oracle equality ------------------
        # Retention under partition is a STALE-SERVE claim, so it scopes
        # to the edges stale-serve covers (leaf<->root, root<->recv). A
        # node<->leaf cut is indistinguishable from the targets dying —
        # series withdraw BY SPECIFICATION and the attribution checks
        # above own that contract (fuzzer find: a bare one-round
        # node-cut tripped this as "116 series lost").
        partition_active = any(
            ev.kind == "partition"
            and frozenset(ev.edge or ()) != frozenset({"node", "leaf"})
            for ev in active)
        node_cut_active = any(
            ev.kind == "partition"
            and frozenset(ev.edge or ()) == frozenset({"node", "leaf"})
            for ev in active)
        if (partition_active and not node_cut_active
                and self.baseline_series is not None):
            lost = self.baseline_series - series
            if lost:
                lost -= self._excused_losses(lost)
            if lost:
                problems.append(
                    f"r{r}: {len(lost)} series lost during partition: "
                    f"{sorted(lost)[:3]}")
        quiet = (
            not active
            and not self.net.any_cuts()
            and not farm.dead
            and not self.recovering
            and not self.recovering_leaves
            and r >= 2
        )
        if quiet and not reported_down:
            self.invariants_armed.add("oracle_equality")
            oracle_problems = _compare_oracle(
                _family_values(body), _family_values(self.sim.oracle_body())
            )
            if oracle_problems:
                problems.append(
                    f"r{r}: quiet round diverged from oracle: "
                    f"{oracle_problems[:2]}")
            else:
                self.baseline_series = series
                self.baseline_workloads = len(
                    fams.get(schema.TPU_WORKLOAD_HBM_USED_BYTES.name, ()))
                if self.rss_baseline is None:
                    self.rss_baseline = _utils.process_rss_bytes() or 0.0

        # --- scenario-specific spot checks -------------------------------
        if self.scn.name == "partition_symmetric" and any(
                ev.kind == "partition" and ev.end_round - 1 == r
                for ev in self.events):
            # Last cut round: /readyz over the wire must say degraded
            # while the stale view keeps serving (HTTP 200 either way).
            doc = _get_json(
                f"http://127.0.0.1:{self.root_server.port}/readyz")
            if doc.get("state") != "degraded":
                problems.append(
                    f"r{r}: /readyz state {doc.get('state')!r} during a "
                    f"total root-leaf partition (want degraded)")
        if self.scn.name == "partition_asymmetric" and cut_leaves and (
                r == max(ev.at_round for ev in self.events) + 1):
            env = self.plane.window_stats("tpu_hbm_used_bytes",
                                          window_s=60.0)
            rows = env["data"]["result"]
            if env["partial"]:
                problems.append(
                    f"r{r}: two-level query PARTIAL during asymmetric cut "
                    f"(twins should cover): {env['fleet']}")
            elif len(rows) != len(self.membership):
                problems.append(
                    f"r{r}: two-level query merged {len(rows)} rows, want "
                    f"{len(self.membership)}")
        if (self.scn.name == "alert_partition" and cut_leaves
                and self.alert_eval is not None):
            active_alerts = {
                (row["labels"]["alertname"], row["state"])
                for row in self.alert_eval.rows()
            }
            if ("TpuRootLeafPartitioned", "firing") not in active_alerts:
                problems.append(
                    f"r{r}: leaves cut one-sided but "
                    f"TpuRootLeafPartitioned not firing "
                    f"(active: {sorted(active_alerts)})")
            if self.stream_on:
                # The alerts route is a first-class stream shape: the
                # polled answer must be the evaluator's rows, verbatim.
                from tpu_pod_exporter_torch.stream import QueryShape

                env = self._stream_poll(QueryShape(route="alerts"), 0)
                rows = env.get("data", {}).get("result", [])
                if rows != self.alert_eval.rows():
                    problems.append(
                        f"r{r}: alerts stream route disagrees with the "
                        f"evaluator ({len(rows)} rows vs "
                        f"{len(self.alert_eval.rows())})")
        if self.scn.name == "recv_outage" and any(
                ev.kind == "recv_outage" and ev.end_round - 1 == r
                for ev in self.events):
            if not self._await_egress_wedged():
                problems.append(
                    f"r{r}: receiver outage not attributable from the "
                    f"egress exposition (breaker never opened / no "
                    f"backlog)")

        # --- resource-pressure drills: window-end invariants --------------
        for ev in active:
            if ev.end_round - 1 != r:
                continue
            if ev.kind == "preempt" and self.scn.gpu_slices:
                # mixed_wedge parity: capture this wedge's degradation
                # signature at its last injected round (breakers have had
                # the whole window to open). Asserted pairwise at finish.
                sl = int(ev.subject.rsplit("-", 1)[1])
                fam = farm.family_of_slice(sl)
                other = "gpu" if fam == "tpu" else "tpu"
                victims = getattr(self, "_preempt_victims", set())
                fam_chips = {
                    s.labels.get("family", "?"): s.value
                    for s in fams.get(
                        schema.TPU_FLEET_FAMILY_CHIP_COUNT.name, ())
                }
                quarantined = sum(
                    s.value for s in fams.get(
                        schema.TPU_ROOT_SHARD_QUARANTINED_TARGETS.name, ())
                )
                before = self._wedge_chips_before
                self.wedge_sigs.append({
                    "family": fam,
                    "slice": ev.subject,
                    "victims": len(victims),
                    "victims_down": sum(
                        1 for i in victims
                        if target_up.get(farm.url(i)) == 0.0
                    ),
                    "chips_dropped": (
                        before.get(fam, 0.0) - fam_chips.get(fam, 0.0)
                    ),
                    "other_family_drift": (
                        before.get(other, 0.0) - fam_chips.get(other, 0.0)
                    ),
                    "quarantined": quarantined,
                })
            if ev.kind == "disk_full":
                # Post-shed floor: compaction's steady state is one shed
                # segment plus ~a batch in flight — an absolute budget
                # below one batch is unmeetable BY ANY policy, so the
                # invariant is bounded by physics, not wishes.
                floor = 2 * self.disk_batch_est + (12 << 10)
                usage = self._settle_disk(
                    max(self.disk_budget_target, floor))
                if usage > max(self.disk_budget_target, floor):
                    problems.append(
                        f"r{r}: disk usage {usage}B still over the "
                        f"squeezed budget {self.disk_budget_target}B "
                        f"(floor {floor}B) at window end — nothing shed")
                if self.gov is not None:
                    gs = self.gov.stats()["disk"]
                    # A ladder that shed and already recovered (usage
                    # reclaimed, hysteresis elapsed) is the governor
                    # WORKING — the invariant is that shedding happened
                    # and was counted, not that a rung is still held.
                    if gs["sheds"] < 1:
                        problems.append(
                            f"r{r}: disk_full window ended with zero "
                            f"recorded sheds (ladder inert)")
            elif ev.kind == "mem_pressure":
                accounted = self._accounted_memory()
                if accounted > self.mem_budget_target:
                    problems.append(
                        f"r{r}: accounted memory {accounted}B over the "
                        f"squeezed budget {self.mem_budget_target}B at "
                        f"window end — nothing shed")
                if self.gov is not None:
                    if self.gov.stats()["memory"]["sheds"] < 1:
                        problems.append(
                            f"r{r}: mem_pressure window ended with zero "
                            f"recorded memory sheds (ladder inert)")
            elif ev.kind == "scrape_storm" and self.storm is not None:
                st = self.storm.stats()
                peak = self.root_server.conn_stats["peak"]
                if self.governor_on:
                    if st["rejected"] == 0 and self.storm.conns > self.conn_cap:
                        problems.append(
                            f"r{r}: a {self.storm.conns}-conn storm over "
                            f"the {self.conn_cap}-conn cap drew zero 429s "
                            f"(admission control inert)")
                    if peak > self.conn_cap:
                        problems.append(
                            f"r{r}: open connections peaked at {peak} "
                            f"over the {self.conn_cap} cap")
                base = self.storm_baseline_p99
                if self.storm_p99s and base:
                    worst = max(self.storm_p99s)
                    # Engine budget is generous (shared CI runners); the
                    # strict 5% contract lives in make pressure-demo.
                    if worst > max(3.0 * base, base + 0.25):
                        problems.append(
                            f"r{r}: polite scrape p99 {1e3 * worst:.1f}ms "
                            f"during the storm vs {1e3 * base:.1f}ms "
                            f"baseline — serving latency not protected")
            elif ev.kind == "dashboard_storm":
                problems.extend(self._check_dashboard_tick(ev, r, fams))

        self.problems.extend(problems)
        self.trace.append({
            "round": r,
            "active": [ev.raw for ev in active],
            "pressure": (
                {
                    "disk": self.gov.stats()["disk"]["level"],
                    "memory": self.gov.stats()["memory"]["level"],
                }
                if self.gov is not None else None
            ),
            "cuts": [list(c) for c in self.net.active()],
            "leaf_down": sorted(
                leaf for (_s, leaf), v in leaf_up.items() if v == 0.0),
            "targets_down": len(reported_down),
            "stale_served": sorted(
                leaf for (_s, leaf), v in stale_served.items() if v == 1.0),
            "series": len(series),
            "problems": problems,
        })

    def _check_dashboard_tick(self, ev, r: int, fams) -> list[str]:
        """dashboard_storm per-tick invariants: every subscriber live and
        caught up to this round's generation, delta replay == the polled
        answer at the SAME generation for sampled subscribers, zero seq
        gaps/dups, and the subscription load attributable from the
        tpu_stream_* exposition."""
        from tpu_pod_exporter_torch.stream import rows_map

        problems: list[str] = []
        dash = self.dash
        if dash is None:
            return problems
        live = dash.live()
        if live < ev.count:
            problems.append(
                f"r{r}: only {live}/{ev.count} dashboard subscriptions "
                f"live" + ("" if self.stream_on else
                           " (stream disabled — negative control)"))
            return problems
        lag = dash.wait_caught_up({"root": self.hub.shape_seqs()},
                                  timeout_s=10.0)
        if lag:
            problems.append(
                f"r{r}: {lag} subscribers never caught up to their "
                f"shape's seq this round")
        for label, shape, rows, sgen in dash.sample(10):
            self.dash_eq_checks += 1
            env = self._stream_poll(shape, sgen or 0)
            if rows != rows_map(shape.route, env):
                self.dash_eq_failures += 1
                problems.append(
                    f"r{r}: delta replay != polled answer for a {label} "
                    f"subscriber of {shape.metric} {dict(shape.match)}")
        tot = dash.totals()
        if tot["gaps"] or tot["dups"]:
            problems.append(
                f"r{r}: stream seq discontinuities — {tot['gaps']} gaps, "
                f"{tot['dups']} dups")
        if tot["latencies"]:
            lats = tot["latencies"]
            self.dash_push_p99s.append(lats[int(0.99 * (len(lats) - 1))])
        dash.drain_latencies()
        # Attributable from the exposition alone: the hub's surface rides
        # the root publish (tpu_stream_subscribers is the gauge the
        # RUNBOOK's storm playbook reads first).
        subs_series = fams.get(schema.TPU_STREAM_SUBSCRIBERS.name, ())
        gauge = subs_series[0].value if subs_series else None
        if r > ev.at_round and (gauge is None or gauge < 0.9 * ev.count):
            problems.append(
                f"r{r}: tpu_stream_subscribers reads {gauge!r} with "
                f"{live} live subscriptions — storm not attributable "
                f"from the exposition")
        return problems

    def _egress_exposition(self) -> dict[str, float]:
        """The shipper's self-metric surface AS EXPOSITION (the same
        bytes app.py would publish) — fault attribution reads metrics,
        not private state."""
        from tpu_pod_exporter_torch.metrics import SnapshotBuilder

        b = SnapshotBuilder()
        self.shipper.emit(b)
        text = b.build(timestamp=time.time()).encode().decode()
        out: dict[str, float] = {}
        for fam in parse_families(text).values():
            for s in fam:
                if not s.labels:
                    out[s.name] = s.value
        return out

    def _await_egress_wedged(self, timeout_s: float = 8.0) -> bool:
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            exp = self._egress_exposition()
            if (exp.get("tpu_exporter_egress_breaker_state", 0.0) != 0.0
                    and exp.get("tpu_exporter_egress_backlog_batches",
                                0.0) >= 1.0):
                return True
            # Keep FRESH batches flowing so the sender keeps probing the
            # outage (a re-pushed identical snapshot would re-frame the
            # same sample timestamps and corrupt the exactly-once ledger
            # the final check reads).
            self.sim.run_round()
            self.shipper.on_snapshot(self.sim.root_store.current())
            time.sleep(0.2)
        return False

    # ------------------------------------------------------------- the finish

    def _finish(self, result: dict) -> bool:
        # Settle: every injected fault healed; quarantined targets must be
        # re-admitted (half-open probes) and the tree must converge back
        # to oracle-equal — bounded, not open-ended.
        deadline = time.monotonic() + 15.0
        recovered = False
        while time.monotonic() < deadline:
            self.sim.run_round()
            if self.shipper is not None:
                self.shipper.on_snapshot(self.sim.root_store.current())
            if self.alert_eval is not None:
                # Keep evaluating through settle: resolution (and its
                # notifications) must happen for the alert verdict below.
                self.alert_eval.evaluate_round(
                    self.sim.root_store.current())
            if self.gov is not None:
                self.gov.tick()
                gs = self.gov.stats()
                if gs["disk"]["level"] or gs["memory"]["level"]:
                    # Ladders must step back to 0 (hysteresis) before the
                    # stack can count as recovered.
                    time.sleep(0.15)
                    continue
            body = self.sim.root_body()
            fams = parse_families(body)
            target_up = {
                s.labels["target"]: s.value
                for s in fams.get(schema.TPU_AGG_TARGET_UP.name, ())
            }
            leaf_up_ok = all(
                s.value == 1.0
                for s in fams.get(schema.TPU_ROOT_LEAF_UP.name, ())
            )
            members_up = (
                set(target_up) == set(self.membership)
                and all(v == 1.0 for v in target_up.values())
            )
            if leaf_up_ok and members_up:
                self.invariants_armed.add("oracle_equality")
                oracle_problems = _compare_oracle(
                    _family_values(body),
                    _family_values(self.sim.oracle_body()),
                )
                if not oracle_problems:
                    recovered = True
                    break
            time.sleep(0.15)
        result["recovered"] = recovered
        if self.gov is not None:
            gs = self.gov.stats()
            result["pressure"] = {
                "disk": {k: gs["disk"][k]
                         for k in ("level", "sheds", "recovers")},
                "memory": {k: gs["memory"][k]
                           for k in ("level", "sheds", "recovers")},
            }
        if any(ev.kind == "dashboard_storm" for ev in self.events):
            tot = self.dash_totals
            push_p99 = (max(self.dash_push_p99s)
                        if self.dash_push_p99s else None)
            result["dashboard"] = {
                "frames": tot.get("frames"),
                "gaps": tot.get("gaps"),
                "dups": tot.get("dups"),
                "push_p99_s": push_p99,
                "push_p99_budget_s": self.DASH_PUSH_P99_BUDGET_S,
                "eq_checks": self.dash_eq_checks,
                "eq_failures": self.dash_eq_failures,
            }
            if self.stream_on and self.dash_eq_checks == 0:
                self.problems.append(
                    "dashboard_storm window produced ZERO replay-equality "
                    "checks — the invariant never ran")
            if push_p99 is not None and (
                    push_p99 > self.DASH_PUSH_P99_BUDGET_S):
                self.problems.append(
                    f"dashboard push p99 {push_p99:.3f}s over the "
                    f"{self.DASH_PUSH_P99_BUDGET_S}s budget")

        if not recovered:
            self.problems.append(
                "stack did not converge back to healthy + oracle-equal "
                "within the settle budget (quarantine black-hole after "
                "heal, or a pressure ladder stuck above level 0?)")
            return False

        if self.scn.name == "store_continuity":
            self._check_store_continuity()

        if self.scn.name == "mixed_wedge":
            # The GPU parity verdict: a wedged GPU node pool must degrade
            # IDENTICALLY to a wedged TPU node pool — same victim
            # accounting, same breaker quarantine, same family-correct
            # chip drop, zero drift on the untouched family. (Zero
            # acked-sample loss rides the standard egress ledger check
            # below.)
            result["wedges"] = self.wedge_sigs
            by_family = {sig["family"]: sig for sig in self.wedge_sigs}
            if set(by_family) != {"tpu", "gpu"}:
                self.problems.append(
                    f"mixed_wedge recorded wedges for {sorted(by_family)}, "
                    f"want one TPU and one GPU")
            else:
                t, g = by_family["tpu"], by_family["gpu"]
                for sig in (t, g):
                    if sig["victims"] == 0:
                        self.problems.append(
                            f"mixed_wedge: {sig['family']} wedge had no "
                            f"victims (slice {sig['slice']} empty?)")
                    if sig["victims_down"] != sig["victims"]:
                        self.problems.append(
                            f"mixed_wedge: {sig['family']} wedge dropped "
                            f"up for {sig['victims_down']}/{sig['victims']} "
                            f"victims")
                    if sig["quarantined"] < 1:
                        self.problems.append(
                            f"mixed_wedge: {sig['family']} wedge opened no "
                            f"leaf breakers (quarantine semantics differ)")
                    if sig["other_family_drift"] > 0.0:
                        # Positive drift only: the violation is the OTHER
                        # family LOSING chips to this wedge. Negative
                        # drift is the other family still re-admitting its
                        # own earlier wedge's victims at window start
                        # (breaker half-open probes lag the heal) — that
                        # is recovery, not cross-family leakage.
                        self.problems.append(
                            f"mixed_wedge: {sig['family']} wedge dropped the "
                            f"OTHER family's chip count by "
                            f"{sig['other_family_drift']:g} (family sums "
                            f"not family-correct)")
                if t["victims"] == g["victims"] and (
                        t["chips_dropped"] != g["chips_dropped"]):
                    self.problems.append(
                        f"mixed_wedge: equal victim counts but unequal "
                        f"chip drops (tpu {t['chips_dropped']:g} vs gpu "
                        f"{g['chips_dropped']:g}) — degradation not "
                        f"identical")
                chips = self.sim.farm.chips
                for sig in (t, g):
                    if sig["chips_dropped"] != sig["victims"] * chips:
                        self.problems.append(
                            f"mixed_wedge: {sig['family']} chip drop "
                            f"{sig['chips_dropped']:g} != victims x chips "
                            f"({sig['victims']} x {chips})")

        # /readyz healthy again, over the wire.
        doc = _get_json(f"http://127.0.0.1:{self.root_server.port}/readyz")
        result["readyz_state"] = doc.get("state")
        if doc.get("state") != "ready":
            self.problems.append(
                f"/readyz stuck at {doc.get('state')!r} after recovery")

        # (4) series accounting after churn: per-target series must match
        # final membership EXACTLY (no ghosts from removed targets), and
        # the workload surface must not have accreted label-churn corpses.
        fams = parse_families(self.sim.root_body())
        target_series = {
            s.labels["target"]
            for s in fams.get(schema.TPU_AGG_TARGET_UP.name, ())
        }
        if target_series != set(self.membership):
            ghosts = target_series - set(self.membership)
            missing = set(self.membership) - target_series
            self.problems.append(
                f"series leak: {len(ghosts)} ghost target series "
                f"({sorted(ghosts)[:3]}), {len(missing)} missing")
        n_workloads = len(
            fams.get(schema.TPU_WORKLOAD_HBM_USED_BYTES.name, ()))
        if self.baseline_workloads and n_workloads > (
                self.baseline_workloads + 2 * len(self.sim.topology) + 8):
            self.problems.append(
                f"workload series grew {self.baseline_workloads} -> "
                f"{n_workloads} across churn (label-set leak)")
        rss = _utils.process_rss_bytes()
        if self.rss_baseline and rss and (
                rss - self.rss_baseline > 128 * 2**20):
            self.problems.append(
                f"RSS grew {(rss - self.rss_baseline) / 2**20:.0f} MiB "
                f"across the scenario (leak)")
        result["rss_growth_mb"] = (
            round((rss - self.rss_baseline) / 2**20, 1)
            if rss and self.rss_baseline else None
        )

        # (1) egress exactly-once: everything framed must have landed,
        # contiguous and duplicate-free, after the backlog drains.
        if self.shipper is not None:
            drained = self._await_drain()
            stats = self.shipper.stats()
            ledger = self.receiver.stats()
            seqs = ledger["accepted_seqs"]
            result["egress"] = {
                "batches": stats["enqueued_batches"],
                "accepted": len(seqs),
                "duplicate_seqs": len(ledger["duplicate_seqs"]),
                "duplicate_samples": ledger["duplicate_samples"],
                "breaker_reopens": stats["breaker_reopens"],
                "drained": drained,
            }
            if not drained:
                self.problems.append(
                    f"egress backlog failed to drain after heal "
                    f"({stats['backlog_batches']} batches stuck, breaker "
                    f"{stats['breaker_state']})")
            if sorted(seqs) != list(range(1, len(seqs) + 1)):
                self.problems.append(
                    f"acked-sample loss: accepted seqs not contiguous "
                    f"({sorted(seqs)[:5]}…)")
            if stats["enqueued_batches"] != len(seqs):
                self.problems.append(
                    f"acked-sample loss: {stats['enqueued_batches']} "
                    f"batches framed, {len(seqs)} delivered")
            if ledger["duplicate_seqs"] or ledger["duplicate_samples"]:
                self.problems.append(
                    f"egress re-sent acked data: "
                    f"{len(ledger['duplicate_seqs'])} duplicate batches, "
                    f"{ledger['duplicate_samples']} duplicate samples")

        if self.alert_eval is not None:
            self._finish_alerts(result)
        return not self.problems

    def _finish_alerts(self, result: dict) -> None:
        """The alerting verdict: exactly the expected alerts fired (and
        NO others), everything resolved after heal + settle, the webhook
        ledger is contiguous exactly-once after the backlog drains, and
        the firing window is answerable as ALERTS series from the store
        (source=store — honest tags, no live plane involved)."""
        from tpu_pod_exporter_torch.alerting import FIRING

        expected = set(self.scn.expected_alerts or ())
        tag = ("" if self.alert_suppression
               else " (suppression OFF — negative control)")
        fired = {
            str(t["alert"])
            for t in self.alert_eval.transitions(limit=10_000)
            if t["to"] == FIRING
        }
        if self.scn.allowed_alerts is not None:
            # Suppress-aware BOUND mode (generated timelines): required
            # alerts must fire, nothing outside the derived envelope may
            # fire, and nothing outside it may even have been SUPPRESSED
            # — a rule engaging silently where the generator's model says
            # it can't is the same disagreement as a stray firing.
            envelope = expected | set(self.scn.allowed_alerts)
            if not expected <= fired:
                self.problems.append(
                    f"alerts fired {sorted(fired)}, missing required "
                    f"{sorted(expected - fired)} (generated-timeline "
                    f"bound mode){tag}")
            elif not fired <= envelope:
                self.problems.append(
                    f"alerts fired {sorted(fired)} outside the derived "
                    f"envelope {sorted(envelope)} (generated-timeline "
                    f"bound mode){tag}")
            suppressed = set(self.alert_eval.suppressed_names())
            if not suppressed <= envelope:
                self.problems.append(
                    f"alerts suppressed {sorted(suppressed)} outside the "
                    f"derived envelope {sorted(envelope)} — the evaluator "
                    f"engaged where the timeline model says it cannot"
                    f"{tag}")
        elif fired != expected:
            self.problems.append(
                f"alerts fired {sorted(fired)}, want exactly "
                f"{sorted(expected)} — 'the right alerts, and no "
                f"others' broken{tag}")
        firing, pending = self.alert_eval.counts()
        if firing or pending:
            self.problems.append(
                f"{firing} firing / {pending} pending alert instances "
                f"left after heal + settle (resolution never came){tag}")
        drained = self._await_alert_drain()
        nstats = self.alert_notifier.stats()
        with self._alert_ledger_lock:
            seqs = sorted(self.alert_ledger)
        result["alerts"] = {
            "fired": sorted(fired),
            "expected": sorted(expected),
            "suppressed": self.alert_eval.stats()["suppressed_total"],
            "notifications": nstats["enqueued"],
            "delivered": len(seqs),
            "failed_sends": nstats["failed"],
            "breaker_reopens": nstats["breaker_reopens"],
            "drained": drained,
        }
        if not drained:
            self.problems.append(
                f"alert notification backlog failed to drain after heal "
                f"({nstats['backlog_records']} records stuck, breaker "
                f"{nstats['breaker_state']})")
        if self.scn.name == "alert_partition" and nstats["failed"] < 1:
            # The drill's outage window covers the partition onset: the
            # firing notifications MUST have hit the dead webhook and
            # buffered. `failed` is the monotonic witness (breaker
            # reopens reset once post-heal probation successes land); a
            # zero means the wedge never happened and the exactly-once
            # claim went untested.
            self.problems.append(
                "alert notifier never saw a failed send — the outage "
                "window missed every notification, backlog/drain "
                "untested")
        if seqs != list(range(1, len(seqs) + 1)):
            self.problems.append(
                f"alert ledger not contiguous exactly-once: {seqs[:6]}…")
        elif drained and nstats["enqueued"] != len(seqs):
            self.problems.append(
                f"alert notification loss: {nstats['enqueued']} framed, "
                f"{len(seqs)} delivered")
        if self.store is not None and expected:
            env = self.plane.query_range(
                "ALERTS", start=self.start_wall, end=time.time(),
                step=0.0, source="store")
            rows = env.get("data", {}).get("result", [])
            names = {
                (row.get("labels") or {}).get("alertname")
                for row in rows if isinstance(row, dict)
            }
            if not expected <= names:
                self.problems.append(
                    f"ALERTS series missing from the store: have "
                    f"{sorted(n for n in names if n)}, want at least "
                    f"{sorted(expected)}")

    def _await_alert_drain(self, timeout_s: float = 10.0) -> bool:
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            s = self.alert_notifier.stats()
            with self._alert_ledger_lock:
                delivered = len(self.alert_ledger)
            if s["backlog_records"] == 0 and delivered >= s["enqueued"]:
                return True
            time.sleep(0.1)
        return False

    def _check_store_continuity(self) -> None:
        """The store_continuity drill's boundary invariant, run with the
        store ON and OFF alike (off is the negative control: the same
        checks must then FAIL on the gap). A bucket-sample query (step=0 —
        no grid carry-forward masking holes) over [run start, now] must
        have real points on BOTH sides of the root's dead window, with no
        internal hole wider than the downtime itself, sources honest per
        row, and the recording-rule series answerable store-only."""
        problems: list[str] = []
        rollup = schema.TPU_SLICE_HBM_USED_BYTES.name
        end = time.time()
        try:
            env = self.plane.query_range(rollup, start=self.start_wall,
                                         end=end, step=0.0)
        except Exception as e:  # noqa: BLE001 — a broken plane IS the finding
            self.problems.append(f"store continuity: boundary query "
                                 f"failed: {e}")
            return
        rows = env.get("data", {}).get("result", [])
        pts = sorted(
            float(t) for row in rows if isinstance(row, dict)
            for t, _v in (row.get("values") or [])
        )
        downtime = max(self.restart_wall - self.kill_wall, 0.1)
        tag = "" if self.store is not None else " [store OFF]"
        if not any(t <= self.kill_wall for t in pts):
            problems.append(
                f"store continuity{tag}: no samples before the root kill "
                f"— the dead window is a gap, nothing fills it")
        if not any(t >= self.restart_wall for t in pts):
            problems.append(
                f"store continuity{tag}: no samples after the restart")
        # The hole may span from the last round whose bucket was durable
        # before the kill (the open bucket, the last round's, is the
        # documented SIGKILL loss) to the first round after the restart,
        # plus bucket alignment: measured from this run's rounds, since a
        # round and its checks take longer on a slower host.
        before = [t for t in self.round_end_walls if t <= self.kill_wall]
        after = [t for t in self.round_end_walls if t >= self.restart_wall]
        lost_from = before[-2] if len(before) >= 2 else self.kill_wall
        back_at = after[0] if after else self.restart_wall
        allowed = max(back_at - lost_from, downtime) + 2.0 * self.STORE_FINEST_STEP
        for a, b in zip(pts, pts[1:]):
            if b - a > allowed:
                problems.append(
                    f"store continuity{tag}: {b - a:.1f}s hole in the "
                    f"boundary query (allowed {allowed:.1f}s = the last "
                    f"durable round before the kill to the first after "
                    f"the restart + bucket slack)")
                break
        if self.store is not None:
            bad = [row for row in rows
                   if row.get("source") not in ("live", "store")]
            if bad:
                problems.append(
                    f"store continuity: {len(bad)} row(s) without honest "
                    f"source attribution")
            store_pts = [
                float(t) for row in rows if row.get("source") == "store"
                for t, _v in (row.get("values") or [])
            ]
            if not any(t <= self.kill_wall for t in store_pts):
                problems.append(
                    "store continuity: pre-kill coverage not attributed "
                    "source=store (who answered it?)")
            if env.get("source") not in ("merged", "store"):
                problems.append(
                    f"store continuity: envelope source "
                    f"{env.get('source')!r} despite store fills")
            # Store-only + recording-rule halves: ?source=store must
            # answer alone, and the rule series must live in the store.
            senv = self.plane.query_range(rollup, start=self.start_wall,
                                          end=end, step=0.0,
                                          source="store")
            srows = senv.get("data", {}).get("result", [])
            if not srows or any(
                    row.get("source") != "store" for row in srows):
                problems.append("store continuity: ?source=store did not "
                                "answer store-only")
            renv = self.plane.query_range("scenario:hbm:by_slice",
                                          start=self.start_wall, end=end,
                                          step=0.5, source="store")
            if not renv.get("data", {}).get("result"):
                problems.append("store continuity: recording-rule series "
                                "not served from the store")
        self.problems.extend(problems)

    def _await_drain(self, timeout_s: float = 20.0) -> bool:
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            stats = self.shipper.stats()
            if (stats["backlog_batches"] == 0
                    and self.receiver.accepted_batches()
                    >= stats["enqueued_batches"]):
                return True
            time.sleep(0.2)
        return False

    def _close(self) -> None:
        if self.storm is not None:
            self.storm.stop()
        if self.dash is not None:
            self.dash.stop()
        if self._polite_conn is not None:
            self._polite_conn.close()
        try:
            self.root_server.stop()
        except Exception:  # noqa: BLE001 — teardown must finish
            pass
        if self.hub is not None:
            self.hub.close()
        self.plane.close()
        if self.shipper is not None:
            self.shipper.close()
        if self.alert_eval is not None:
            self.alert_eval.close()  # closes the notifier + its WAL
        if self.receiver is not None:
            self.receiver.stop()
        self.sim.close()


def run_one(scn: Scenario, n_targets: int, shards: int, chips: int,
            state_root: str, seed: int,
            governor: bool = True, store: bool = True,
            stream: bool = True,
            alert_suppression: bool = True) -> tuple[dict, list[dict]]:
    """One scenario on one fresh stack, returning (result, per-tick
    trace). The fuzz harness's entrypoint: run_scenarios wraps the NAMED
    drill set, but a generated trial is an ad-hoc Scenario object and the
    minimizer needs the trace back for its failure artifacts — same _Run,
    same invariants, zero drift between fuzzed and hand-written drills."""
    run = _Run(scn, n_targets, shards, chips, state_root, seed,
               governor=governor, store=store, stream=stream,
               alert_suppression=alert_suppression)
    result = run.run()
    return result, run.trace


def run_scenarios(names: list[str], n_targets: int, shards: int,
                  chips: int, state_root: str, seed: int,
                  governor: bool = True, store: bool = True,
                  stream: bool = True,
                  alert_suppression: bool = True) -> dict:
    """Run the named scenarios back to back, each on a fresh stack (own
    state dir under ``state_root``); returns the summary dict the demo
    prints and writes as the CI artifact. ``governor=False`` is the
    pressure drills' negative control, ``store=False`` the
    store-continuity drill's, ``stream=False`` the dashboard-storm
    drill's, and ``alert_suppression=False`` the alert drills': the
    invariants still run, and the run is EXPECTED to fail them."""
    os.makedirs(state_root, exist_ok=True)
    summary: dict = {
        "ok": True, "targets": n_targets, "shards": shards,
        "seed": seed, "governor": governor, "store": store,
        "stream": stream, "alert_suppression": alert_suppression,
        "scenarios": {},
    }
    all_traces: dict[str, list] = {}
    for name in names:
        scn = SCENARIOS[name]
        t0 = time.monotonic()
        run = _Run(scn, n_targets, shards, chips,
                   os.path.join(state_root, name), seed,
                   governor=governor, store=store, stream=stream,
                   alert_suppression=alert_suppression)
        result = run.run()
        result["wall_s"] = round(time.monotonic() - t0, 2)
        all_traces[name] = run.trace
        summary["scenarios"][name] = result
        summary["ok"] = summary["ok"] and result["ok"]
        status = "ok" if result["ok"] else "FAILED"
        print(f"  {name:<22} {status:<7} {result['wall_s']:6.1f}s  "
              f"{'; '.join(result.get('problems', [])[:1])}",
              flush=True)
        if not result["ok"]:
            break  # later scenarios would only bury the first failure
    try:
        with open(os.path.join(state_root, "result.json"), "w",
                  encoding="utf-8") as f:
            json.dump(summary, f, indent=1)
        # The per-tick invariant record IS the forensics: which rounds
        # had which cuts, what the exposition said, what failed.
        with open(os.path.join(state_root, "scenario-trace.json"), "w",
                  encoding="utf-8") as f:
            json.dump(all_traces, f, indent=1)
    except OSError:
        pass
    return summary


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(
        prog="tpu-loadgen-scenario",
        description="Fleet scenario engine: declarative chaos timelines "
                    "with per-tick invariants against the full "
                    "node→leaf→root→egress stack (make scenario-demo).",
    )
    p.add_argument("--scenarios", default="all",
                   help="comma-separated scenario names, or 'all' "
                        f"(known: {', '.join(SCENARIOS)})")
    p.add_argument("--timeline", default="",
                   help="ad-hoc scenario: run this DSL timeline instead "
                        "of the named set (see tpu_pod_exporter_torch.scenario "
                        "for the grammar)")
    p.add_argument("--fuzz-replay", default="", metavar="SEED:TRIAL",
                   help="replay one generated fuzz trial deterministically "
                        "from its (seed, trial) coordinates alone — the "
                        "timeline is regenerated, the stack rebuilt, and "
                        "the same invariants asserted (delegates to "
                        "tpu_pod_exporter_torch.fuzz; see RUNBOOK 'Reproducing "
                        "a fuzzer failure')")
    p.add_argument("--targets", type=int, default=120)
    p.add_argument("--shards", type=int, default=4)
    p.add_argument("--chips", type=int, default=2)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--state-root", default="scenario-demo-state",
                   help="per-scenario state dirs + result.json + "
                        "scenario-trace.json (uploaded as a CI artifact "
                        "on failure)")
    p.add_argument("--governor", default="on", choices=("on", "off"),
                   help="off = the pressure drills' NEGATIVE CONTROL: no "
                        "governor, no admission caps — the invariants "
                        "still run and the drill is expected to FAIL "
                        "(CI asserts the non-zero exit)")
    p.add_argument("--store", default="on", choices=("on", "off"),
                   help="off = the store_continuity drill's NEGATIVE "
                        "CONTROL: no fleet store under the root — the "
                        "boundary-gap invariant still runs and the drill "
                        "is expected to FAIL (CI asserts the non-zero "
                        "exit)")
    p.add_argument("--stream", default="on", choices=("on", "off"),
                   help="off = the dashboard_storm drill's NEGATIVE "
                        "CONTROL: no stream hub on the root — the "
                        "subscriptions cannot register, the invariants "
                        "still run and the drill is expected to FAIL "
                        "(CI asserts the non-zero exit)")
    p.add_argument("--alert-suppression", default="on",
                   choices=("on", "off"),
                   help="off = the alert drills' NEGATIVE CONTROL: "
                        "deliberately broken suppression — "
                        "TpuRootLeafDown fires alongside "
                        "TpuRootLeafPartitioned during a one-sided cut, "
                        "the fired-set assertion ('exactly the right "
                        "alerts, and no others') still runs and the "
                        "drill is expected to FAIL (CI asserts the "
                        "non-zero exit)")
    p.add_argument("--log-level", default="warning")
    ns = p.parse_args(argv)
    _utils.setup_logging(ns.log_level)

    if ns.fuzz_replay:
        from tpu_pod_exporter_torch import fuzz

        try:
            seed_s, _, trial_s = ns.fuzz_replay.partition(":")
            seed, trial = int(seed_s), int(trial_s)
        except ValueError:
            p.error(f"--fuzz-replay wants SEED:TRIAL "
                    f"(got {ns.fuzz_replay!r})")
        return fuzz.replay(seed, trial, state_root=ns.state_root)

    if ns.timeline:
        adhoc = Scenario(name="adhoc", timeline=ns.timeline,
                         description="operator-supplied timeline")
        SCENARIOS["adhoc"] = adhoc
        names = ["adhoc"]
    elif ns.scenarios == "all":
        names = list(DEFAULT_SCENARIO_ORDER)
    else:
        names = [s.strip() for s in ns.scenarios.split(",") if s.strip()]
        unknown = [n for n in names if n not in SCENARIOS]
        if unknown:
            p.error(f"unknown scenario(s) {unknown}; "
                    f"known: {', '.join(SCENARIOS)}")
    print(f"scenario engine: {len(names)} scenario(s), {ns.targets} "
          f"targets / {ns.shards} HA shards, seed {ns.seed}"
          + (" — GOVERNOR OFF (negative control)"
             if ns.governor == "off" else "")
          + (" — STORE OFF (negative control)"
             if ns.store == "off" else "")
          + (" — ALERT SUPPRESSION OFF (negative control)"
             if ns.alert_suppression == "off" else ""))
    summary = run_scenarios(names, ns.targets, ns.shards, ns.chips,
                            ns.state_root, ns.seed,
                            governor=ns.governor == "on",
                            store=ns.store == "on",
                            stream=ns.stream == "on",
                            alert_suppression=ns.alert_suppression == "on")
    if not summary["ok"]:
        failed = [n for n, r in summary["scenarios"].items()
                  if not r["ok"]]
        print(f"SCENARIO DEMO FAILED: {failed} — see "
              f"{ns.state_root}/scenario-trace.json", file=sys.stderr)
        return 1
    total = sum(r["wall_s"] for r in summary["scenarios"].values())
    print(f"scenario-demo OK: {len(names)} scenario(s) in {total:.1f}s — "
          f"all per-tick invariants held (zero acked-sample loss, bounded "
          f"staleness, oracle-equal outside windows, no series leaks, "
          f"faults exposition-attributable)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
