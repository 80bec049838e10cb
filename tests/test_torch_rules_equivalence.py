"""The cases of tests/test_rules_equivalence.py against ``tpu_pod_exporter_torch``, with the
imports renamed.

Recording-rules ⇄ aggregator equivalence (VERDICT r3 #6).

``deploy/prometheus-rules.yaml`` promises that its recording rules compute
the *same* rollups the in-process aggregator serves (the file says "use one
or the other"). ``test_deploy.py`` only checks that referenced metric names
exist; this test actually **evaluates** every recording rule — via a tiny
PromQL-subset evaluator — against the same N-host exposition input the
aggregator consumes, and asserts numeric equality per label set. Editing a
rule expression (sum→avg, a dropped by-label, a renamed operand) now fails
CI instead of silently skewing dashboards.

Supported expression subset (everything the rules file uses):
  - ``sum by (l1, l2) (metric)`` / ``avg by (l1, l2) (metric)``
  - ``100 * <recorded> / <recorded>`` (label-joined on the shared by-set)
"""

from __future__ import annotations

import re
from pathlib import Path

import pytest
import yaml

from tpu_pod_exporter_torch.aggregate import SliceAggregator
from tpu_pod_exporter_torch.attribution.fake import FakeAttribution, simple_allocation
from tpu_pod_exporter_torch.backend.fake import FakeBackend, FakeChipScript
from tpu_pod_exporter_torch.collector import Collector
from tpu_pod_exporter_torch.metrics import SnapshotStore
from tpu_pod_exporter_torch.metrics.parse import parse_exposition
from tpu_pod_exporter_torch.topology import HostTopology

RULES = Path(__file__).resolve().parent.parent / "deploy" / "prometheus-rules.yaml"
GIB = 1024**3

# record name → the aggregator series it must equal (checked exhaustively:
# an unmapped new recording rule fails the test until a mapping is added).
RECORD_TO_AGG = {
    "slice:tpu_hbm_used_bytes:sum": "tpu_slice_hbm_used_bytes",
    "slice:tpu_hbm_total_bytes:sum": "tpu_slice_hbm_total_bytes",
    "slice:tpu_hbm_used_percent:ratio": "tpu_slice_hbm_used_percent",
    "slice:tpu_tensorcore_duty_cycle_percent:avg":
        "tpu_slice_tensorcore_duty_cycle_avg_percent",
    "slice:tpu_ici_link_bandwidth_bytes_per_second:sum":
        "tpu_slice_ici_bytes_per_second",
    "slice:tpu_dcn_link_bandwidth_bytes_per_second:sum":
        "tpu_slice_dcn_bytes_per_second",
    "multislice:tpu_chip_info:count": "tpu_multislice_chip_count",
    "multislice:tpu_hbm_used_bytes:sum": "tpu_multislice_hbm_used_bytes",
    "multislice:tpu_dcn_link_bandwidth_bytes_per_second:sum":
        "tpu_multislice_dcn_bytes_per_second",
    "multislice:slices_reporting:count": "tpu_multislice_slices_reporting",
    "workload:tpu_pod_chip_count:sum": "tpu_workload_chip_count",
    "workload:tpu_pod_hbm_used_bytes:sum": "tpu_workload_hbm_used_bytes",
}

_AGG_RE = re.compile(r"^(sum|avg)\s+by\s+\(([^)]*)\)\s+\((\S+)\)$")
_RATIO_RE = re.compile(r"^100\s*\*\s*(\S+)\s*/\s*(\S+)$")
# The multi-slice info-series join:
#   sum|count by (G) ( metric * on (J) group_left (K)
#                      max by (M) (tpu_host_info{multislice_group!=""}) )
_JOIN_RE = re.compile(
    r"^(sum|count)\s+by\s+\(([^)]*)\)\s+\(\s*(\S+)\s*\*\s*on\s+\(([^)]*)\)"
    r"\s+group_left\s+\(([^)]*)\)\s+max\s+by\s+\(([^)]*)\)"
    r'\s+\((\w+)\{multislice_group!=""\}\)\s*\)$'
)
# Nested slice count over the join (slices REPORTING CHIPS, not merely
# having a live exporter):
#   count by (O) ( count by (I) ( metric * on (J) group_left (K)
#                  max by (M) (tpu_host_info{multislice_group!=""}) ) )
_NESTED_COUNT_JOIN_RE = re.compile(
    r"^count\s+by\s+\(([^)]*)\)\s+\(\s*count\s+by\s+\(([^)]*)\)\s+"
    r"\(\s*(\S+)\s*\*\s*on\s+\(([^)]*)\)\s+group_left\s+\(([^)]*)\)"
    r"\s+max\s+by\s+\(([^)]*)\)"
    r'\s+\((\w+)\{multislice_group!=""\}\)\s*\)\s*\)$'
)


def _split(raw: str) -> tuple[str, ...]:
    return tuple(l.strip() for l in raw.split(","))


def eval_rule(expr: str, samples, recorded):
    """Evaluate one rule expression.

    Returns ``(by_labels, {label_values_tuple: value})``. ``samples`` is the
    flat parsed-sample list; ``recorded`` maps already-evaluated record
    names to their results (rules may reference earlier records).
    """
    expr = " ".join(expr.split())  # yaml `>` folds keep stray newlines
    m = _AGG_RE.match(expr)
    if m:
        op, by_raw, metric = m.groups()
        by = tuple(l.strip() for l in by_raw.split(","))
        groups: dict[tuple, list[float]] = {}
        for s in samples:
            if s.name == metric:
                key = tuple(s.labels.get(l, "") for l in by)
                groups.setdefault(key, []).append(s.value)
        out = {
            k: (sum(v) if op == "sum" else sum(v) / len(v))
            for k, v in groups.items()
        }
        return by, out
    m = _JOIN_RE.match(expr)
    if m:
        op, by_raw, metric, on_raw, gl_raw, _max_by, info_name = m.groups()
        by = _split(by_raw)
        on = _split(on_raw)
        gl = _split(gl_raw)
        # Membership map from the info series (max-by dedup is implicit:
        # the value is always 1 and hosts of one slice agree on the group).
        member: dict[tuple, dict[str, str]] = {}
        for s in samples:
            if s.name == info_name and s.labels.get("multislice_group", ""):
                member[tuple(s.labels.get(l, "") for l in on)] = {
                    l: s.labels.get(l, "") for l in gl
                }
        groups: dict[tuple, list[float]] = {}
        for s in samples:
            if s.name != metric:
                continue
            extra = member.get(tuple(s.labels.get(l, "") for l in on))
            if extra is None:
                continue  # unmatched join drops the sample, like PromQL
            joined = {**s.labels, **extra}
            key = tuple(joined.get(l, "") for l in by)
            groups.setdefault(key, []).append(s.value)
        out = {
            k: (float(len(v)) if op == "count" else sum(v))
            for k, v in groups.items()
        }
        return by, out
    m = _NESTED_COUNT_JOIN_RE.match(expr)
    if m:
        outer_raw, inner_raw, metric, on_raw, gl_raw, _max_by, info_name = (
            m.groups()
        )
        outer = _split(outer_raw)
        inner = _split(inner_raw)
        on = _split(on_raw)
        gl = _split(gl_raw)
        member: dict[tuple, dict[str, str]] = {}
        for s in samples:
            if s.name == info_name and s.labels.get("multislice_group", ""):
                member[tuple(s.labels.get(l, "") for l in on)] = {
                    l: s.labels.get(l, "") for l in gl
                }
        inner_keys = set()
        for s in samples:
            if s.name != metric:
                continue
            extra = member.get(tuple(s.labels.get(l, "") for l in on))
            if extra is None:
                continue
            joined = {**s.labels, **extra}
            inner_keys.add(tuple(joined.get(l, "") for l in inner))
        groups: dict[tuple, int] = {}
        for ik in inner_keys:
            labels = dict(zip(inner, ik))
            key = tuple(labels.get(l, "") for l in outer)
            groups[key] = groups.get(key, 0) + 1
        return outer, {k: float(v) for k, v in groups.items()}
    m = _RATIO_RE.match(expr)
    if m:
        a_name, b_name = m.groups()
        if a_name not in recorded or b_name not in recorded:
            raise AssertionError(
                f"ratio rule references unrecorded series: {expr}"
            )
        (by_a, a), (by_b, b) = recorded[a_name], recorded[b_name]
        assert by_a == by_b, f"ratio operands disagree on labels: {expr}"
        return by_a, {
            k: 100.0 * v / b[k] for k, v in a.items() if b.get(k)
        }
    raise AssertionError(f"rule expression outside the supported subset: {expr}")


def build_hosts():
    """Heterogeneous 2-slice fleet: per-host duty/HBM variation, multi-host
    pods, an unattributed chip, live ICI/DCN rates (needs two polls), and
    multi-slice membership (both slices share one group) so the multislice
    join rules evaluate against real host_info series."""
    texts = []
    for slice_name, accel, workers in (
        ("slice-a", "v5p-32", 4),
        ("slice-b", "v5e-16", 2),
    ):
        for w in range(workers):
            backend = FakeBackend(
                chips=4,
                script=FakeChipScript(
                    hbm_total_bytes=96 * GIB,
                    hbm_used_bytes=(w + 1) * 3 * GIB,
                    duty_cycle_percent=20.0 * (w + 1),
                    ici_link_count=3,
                    ici_bytes_per_step=1_000_000.0 * (w + 1),
                    dcn_link_count=1,
                    dcn_bytes_per_step=250_000.0 * (w + 1),
                ),
            )
            allocs = [
                simple_allocation(f"{slice_name}-train", ["0", "1"], namespace="ml")
            ]
            if w % 2 == 0:
                allocs.append(
                    simple_allocation(f"{slice_name}-eval", ["2"], namespace="research")
                )
            # chip 3 stays unattributed (pod="") on every host.
            store = SnapshotStore()
            fake_now = [0.0]
            c = Collector(
                backend,
                FakeAttribution(allocs),
                store,
                topology=HostTopology(
                    accelerator=accel, slice_name=slice_name,
                    host=f"{slice_name}-host-{w}", worker_id=str(w),
                    multislice_group="ms-rules-group", num_slices="2",
                ),
                clock=lambda: fake_now[0],
            )
            c.poll_once()
            fake_now[0] += 2.0
            c.poll_once()  # second poll: ICI bandwidth series exist
            texts.append(store.current().encode().decode())
    # One host of a THIRD slice whose device backend is dead: it publishes
    # tpu_host_info (live exporter, group member) but zero chip series.
    # Both the aggregator and the recording rule must treat slice-dead as
    # NOT reporting — counting it would hide exactly the whole-slice
    # telemetry loss the slices-missing alert exists for.
    dead_backend = FakeBackend(chips=4)
    dead_backend.fail_next(10)
    store = SnapshotStore()
    Collector(
        dead_backend, FakeAttribution(), store,
        topology=HostTopology(
            accelerator="v5p-32", slice_name="slice-dead",
            host="slice-dead-host-0", worker_id="0",
            multislice_group="ms-rules-group", num_slices="2",
        ),
    ).poll_once()
    text = store.current().encode().decode()
    assert "tpu_host_info{" in text and "tpu_chip_info{" not in text
    texts.append(text)
    return texts


class TestRecordingRulesEquivalence:
    @pytest.fixture(scope="class")
    def evaluated(self):
        texts = build_hosts()

        # Path 1: the aggregator over the host expositions.
        agg_store = SnapshotStore()
        targets = tuple(f"host://{i}" for i in range(len(texts)))
        by_target = dict(zip(targets, texts))
        agg = SliceAggregator(
            targets, agg_store, fetch=lambda t, timeout_s: by_target[t]
        )
        agg.poll_once()
        agg.close()

        # Path 2: the recording rules over the identical samples.
        samples = [s for text in texts for s in parse_exposition(text)]
        doc = yaml.safe_load(RULES.read_text())
        recorded: dict = {}
        for group in doc["groups"]:
            for rule in group.get("rules", []):
                if "record" in rule:
                    recorded[rule["record"]] = eval_rule(
                        rule["expr"], samples, recorded
                    )
        return agg_store.current(), recorded

    def test_every_recording_rule_has_a_mapping(self, evaluated):
        _, recorded = evaluated
        assert set(recorded) == set(RECORD_TO_AGG), (
            "recording rules and the equivalence map drifted: "
            f"{set(recorded) ^ set(RECORD_TO_AGG)}"
        )

    @pytest.mark.parametrize("record", sorted(RECORD_TO_AGG))
    def test_rule_equals_aggregator(self, evaluated, record):
        snap, recorded = evaluated
        by, values = recorded[record]
        agg_name = RECORD_TO_AGG[record]
        assert values, f"{record} evaluated to no series"
        for key, rule_value in values.items():
            labels = dict(zip(by, key))
            if agg_name.startswith("tpu_slice_"):
                # The aggregator's slice rollups carry the accelerator-
                # family key (SLICE_LABELS); the PromQL rules aggregate
                # tpu_* node series only, so their output is implicitly
                # the TPU family (a mixed fleet's gpu_* families need the
                # parallel rules sketched in prometheus-rules.yaml).
                labels["family"] = "tpu"
            if "pod" in by and labels.get("pod", "") == "":
                # The aggregator (like the exporter) never mints a
                # workload series for unattributed chips; the PromQL sum
                # can't produce one either because tpu_pod_* series only
                # exist for real pods. Seeing one here means the input
                # changed shape — fail loudly.
                raise AssertionError("workload input grew a pod=\"\" series")
            agg_value = snap.value(agg_name, labels)
            assert agg_value is not None, (
                f"{agg_name}{labels} missing from aggregator output"
            )
            assert agg_value == pytest.approx(rule_value, rel=1e-9), (
                f"{record}{labels}: rule={rule_value} aggregator={agg_value}"
            )

    def test_divergent_rule_edit_fails(self):
        """Meta-check: a rule silently changed to a different aggregation
        must produce a different result (the equality test would catch it)."""
        texts = build_hosts()
        samples = [s for text in texts for s in parse_exposition(text)]
        by, good = eval_rule(
            "sum by (slice_name, accelerator) (tpu_hbm_used_bytes)",
            samples, {},
        )
        _, bad = eval_rule(
            "avg by (slice_name, accelerator) (tpu_hbm_used_bytes)",
            samples, {},
        )
        assert good != bad


# --------------------------------------------- alert importer round-trip


class TestAlertImportEquivalence:
    """The OTHER half of the rules file: its alerting rules must import
    into the native grammar (``python -m tpu_pod_exporter_torch.alerting
    --import``) losslessly. Checked three ways: every YAML alert arrives
    with its for/labels/annotations intact, the canonical renderer is a
    parse fixpoint, and — the part that catches translation bugs the
    field checks can't — every imported rule EVALUATES identically to
    its render→re-parse twin on a recorded fixture round, non-vacuously
    (at least one alert must actually match instances on the fixture)."""

    @pytest.fixture(scope="class")
    def imported(self):
        from tpu_pod_exporter_torch.alerting import (
            import_prometheus_rules, parse_alert_rules)
        text = import_prometheus_rules(RULES.read_text())
        return parse_alert_rules(text), text

    @pytest.fixture(scope="class")
    def yaml_alerts(self):
        doc = yaml.safe_load(RULES.read_text())
        return {
            rule["alert"]: rule
            for group in doc["groups"]
            for rule in group.get("rules", [])
            if "alert" in rule
        }

    def test_every_yaml_alert_imports_with_its_clauses(
            self, imported, yaml_alerts):
        from tpu_pod_exporter_torch.alerting import parse_duration
        rules, _ = imported
        by_name = {r.name: r for r in rules}
        assert set(by_name) == set(yaml_alerts), (
            "importer dropped or invented alerts: "
            f"{set(by_name) ^ set(yaml_alerts)}"
        )
        for name, yrule in yaml_alerts.items():
            r = by_name[name]
            want_for = (parse_duration(str(yrule["for"]))
                        if yrule.get("for") else 0.0)
            assert r.for_s == want_for, name
            assert dict(r.labels) == {
                k: str(v) for k, v in (yrule.get("labels") or {}).items()
            }, name
            assert dict(r.annotations) == {
                k: str(v)
                for k, v in (yrule.get("annotations") or {}).items()
            }, name

    def test_render_is_a_parse_fixpoint(self, imported):
        from tpu_pod_exporter_torch.alerting import parse_alert_rules, render_rules
        rules, _ = imported
        rendered = render_rules(rules)
        assert render_rules(parse_alert_rules(rendered)) == rendered

    def test_suppression_injected_exactly_where_declared(self, imported):
        from tpu_pod_exporter_torch.alerting import DEFAULT_SUPPRESSIONS
        rules, _ = imported
        for r in rules:
            if r.name in DEFAULT_SUPPRESSIONS:
                assert r.suppress is not None, r.name
                assert r.suppress_text == DEFAULT_SUPPRESSIONS[r.name]
            else:
                assert r.suppress is None, (
                    f"{r.name} grew a suppression the table never declared"
                )

    def test_imported_rules_evaluate_like_their_roundtrip_twins(
            self, imported):
        from tpu_pod_exporter_torch.alerting import (
            _SPEC_BY_NAME, AlertEvaluator, EvalContext, parse_alert_rules,
            render_rules)
        from tpu_pod_exporter_torch.metrics.registry import SnapshotBuilder

        rules, _ = imported
        twins = parse_alert_rules(render_rules(rules))

        # One recorded fixture round: the same heterogeneous fleet the
        # recording-rule equivalence runs on (its dead-backend host makes
        # tpu_exporter_up == 0 style alerts match non-vacuously).
        b = SnapshotBuilder()
        for text in build_hosts():
            for s in parse_exposition(text):
                spec = _SPEC_BY_NAME.get(s.name)
                if spec is None:
                    continue
                b.add(spec, s.value,
                      tuple(s.labels.get(l, "") for l in spec.label_names))
        snap = b.build()

        ev = AlertEvaluator(rules)
        vectors = ev._ingest(snap, 0.0)
        ctx = EvalContext(0.0, lambda name: vectors.get(name, {}),
                          lambda name, w: {})
        matched = 0
        for r, twin in zip(rules, twins):
            assert r.name == twin.name
            got = r.expr.evaluate(ctx)
            again = twin.expr.evaluate(ctx)
            assert got == again, (
                f"{r.name}: imported and round-tripped expressions "
                f"diverge on the fixture round"
            )
            if isinstance(got, dict) and got:
                matched += 1
        assert matched >= 1, (
            "every alert evaluated empty — the fixture exercises nothing "
            "and the equivalence above is vacuous"
        )
