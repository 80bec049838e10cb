"""The cases of tests/test_alerting.py against ``tpu_pod_exporter_torch``, with the
imports renamed.

Native alerting plane (tpu_pod_exporter_torch.alerting).

The unit-level half of the acceptance story (the end-to-end half is the
scenario engine's ``alert_partition`` drill, ``make alert-demo``): the
rule grammar parses with actionable startup errors and round-trips
through the canonical renderer; the per-instance state machine walks
pending → firing → resolved with ``for`` debounce and ``keep_firing``
flap damping; suppression holds a presumed-false-positive down and
counts every withheld round; the notifier delivers each transition
exactly once across restarts, skips poison bodies, and sheds oldest
when the backlog cap trips; the sidecar, status footer, stream rows and
self-metric emission all agree with the evaluator's state.
"""

import json
import time
import urllib.error

import pytest

from tpu_pod_exporter_torch.alerting import (
    FIRING,
    PENDING,
    RESOLVED,
    SEQ_HEADER,
    AlertEvaluator,
    AlertNotifier,
    alert_status_summary,
    import_prometheus_rules,
    load_alert_rules_file,
    main,
    parse_alert_rules,
    parse_duration,
    parse_expr,
    render_rules,
    render_template,
)
from tpu_pod_exporter_torch.egress import build_breaker
from tpu_pod_exporter_torch.metrics import schema
from tpu_pod_exporter_torch.metrics.registry import SnapshotBuilder
from tpu_pod_exporter_torch.status import alert_line


def wait_for(predicate, timeout=10.0, interval=0.01):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(interval)
    return predicate()


# ---------------------------------------------------------------- grammar


RULES_TEXT = """\
# comments and blank lines are ignored
alert LeafDown = tpu_root_leaf_up == 0
    for 20s
    keep_firing 10s
    labels(severity="page", team="ml-infra")
    annotations(summary="leaf {{ $labels.leaf }} down (value {{ $value }})")
    suppress(tpu_root_leaf_partition_suspected == 1)

alert Partitioned = tpu_root_leaf_partition_suspected == 1
    labels(severity="page")
"""


class TestParseAlertRules:
    def test_parses_clauses(self):
        rules = parse_alert_rules(RULES_TEXT)
        assert [r.name for r in rules] == ["LeafDown", "Partitioned"]
        r = rules[0]
        assert r.for_s == 20.0
        assert r.keep_firing_s == 10.0
        assert dict(r.labels) == {"severity": "page", "team": "ml-infra"}
        assert "{{ $labels.leaf }}" in dict(r.annotations)["summary"]
        assert r.suppress is not None
        assert rules[1].for_s == 0.0 and rules[1].suppress is None

    def test_render_round_trip(self):
        rules = parse_alert_rules(RULES_TEXT)
        again = parse_alert_rules(render_rules(rules))
        def key(r):
            return (r.name, r.for_s, r.keep_firing_s, r.labels,
                    r.annotations, r.expr.render(),
                    r.suppress.render() if r.suppress else "")
        assert [key(r) for r in rules] == [key(r) for r in again]
        # Rendering is canonical: render(parse(render(x))) is a fixpoint.
        assert render_rules(again) == render_rules(rules)

    def test_duplicate_name_names_first_definition(self):
        text = ("alert A = tpu_root_leaf_up == 0\n"
                "alert A = tpu_root_leaf_up == 1\n")
        with pytest.raises(ValueError, match=r"line 2.*first defined on line 1"):
            parse_alert_rules(text)

    def test_unknown_metric_is_a_startup_error(self):
        with pytest.raises(ValueError, match=r"unknown metric 'tpu_nope'"):
            parse_alert_rules("alert A = tpu_nope == 0\n")

    def test_known_names_override_admits_drill_families(self):
        rules = parse_alert_rules("alert A = synth_gauge > 1\n",
                                  known_names=frozenset({"synth_gauge"}))
        assert rules[0].name == "A"

    def test_unknown_clause_lists_what_is_accepted(self):
        text = "alert A = tpu_root_leaf_up == 0\n    severity page\n"
        with pytest.raises(ValueError, match=r"for <dur> \| keep_firing"):
            parse_alert_rules(text)

    def test_clause_outside_block(self):
        with pytest.raises(ValueError, match="outside any alert block"):
            parse_alert_rules("    for 5s\n")

    def test_bad_label_kv(self):
        text = "alert A = tpu_root_leaf_up == 0\n    labels(severity=page)\n"
        with pytest.raises(ValueError, match='want \nkey="value"'.replace("\n", "")):
            parse_alert_rules(text)

    def test_colon_names_pass_as_recording_outputs(self):
        rules = parse_alert_rules("alert A = fleet:hbm:by_slice > 10\n")
        assert rules[0].expr_text.startswith("fleet:hbm:by_slice")

    def test_external_up_is_admitted(self):
        parse_alert_rules('alert A = up{job="tpu-pod-exporter"} == 0\n')

    def test_load_file_propagates_errors(self, tmp_path):
        p = tmp_path / "rules.txt"
        p.write_text("alert A = tpu_nope == 0\n")
        with pytest.raises(ValueError):
            load_alert_rules_file(str(p))
        with pytest.raises(OSError):
            load_alert_rules_file(str(tmp_path / "absent.txt"))

    @pytest.mark.parametrize("text,seconds", [
        ("30s", 30.0), ("5m", 300.0), ("2h", 7200.0), ("1d", 86400.0),
    ])
    def test_durations(self, text, seconds):
        assert parse_duration(text) == seconds

    def test_template_interpolation(self):
        out = render_template("leaf {{ $labels.leaf }} at {{ $value }}",
                              {"leaf": "b"}, 0.5)
        assert out == "leaf b at 0.5"


# ------------------------------------------------------------- evaluation


def leaf_snapshot(up, suspected=()):
    """Build a root-shaped snapshot: {(shard, leaf): value} per family."""
    b = SnapshotBuilder()
    for (shard, leaf), v in dict(up).items():
        b.add(schema.TPU_ROOT_LEAF_UP, v, (shard, leaf))
    for (shard, leaf), v in dict(suspected).items():
        b.add(schema.TPU_ROOT_LEAF_PARTITION_SUSPECTED, v, (shard, leaf))
    return b.build()


def eval_leaf_expr(text, up, suspected=()):
    from tpu_pod_exporter_torch.alerting import EvalContext
    ev = AlertEvaluator(parse_alert_rules(f"alert X = {text}\n"))
    snap = leaf_snapshot(up, suspected)
    vectors = ev._ingest(snap, 0.0)
    ctx = EvalContext(0.0, lambda name: vectors.get(name, {}),
                      lambda name, w: {})
    return ev.rules[0].expr.evaluate(ctx)


class TestExpressions:
    def test_comparison_filters_vector(self):
        out = eval_leaf_expr("tpu_root_leaf_up == 0",
                             {("0", "a"): 0.0, ("0", "b"): 1.0})
        assert set(out) == {(("leaf", "a"), ("shard", "0"))}

    def test_label_selector(self):
        out = eval_leaf_expr('tpu_root_leaf_up{shard="1"} == 0',
                             {("0", "a"): 0.0, ("1", "b"): 0.0})
        assert set(out) == {(("leaf", "b"), ("shard", "1"))}

    def test_aggregation(self):
        out = eval_leaf_expr("sum by (shard) (tpu_root_leaf_up) < 1",
                             {("0", "a"): 0.0, ("0", "b"): 0.0,
                              ("1", "c"): 1.0})
        assert set(out) == {(("shard", "0"),)}

    def test_arithmetic_against_scalar(self):
        out = eval_leaf_expr("tpu_root_leaf_up * 100 >= 100",
                             {("0", "a"): 1.0, ("0", "b"): 0.0})
        assert out == {(("leaf", "a"), ("shard", "0")): 100.0}


class TestStateMachine:
    RULES = parse_alert_rules(RULES_TEXT)

    def test_pending_then_firing_then_resolved(self, tmp_path):
        ev = AlertEvaluator(self.RULES, alert_dir=str(tmp_path))
        down = leaf_snapshot({("0", "a"): 0.0, ("0", "b"): 1.0})
        up = leaf_snapshot({("0", "a"): 1.0, ("0", "b"): 1.0})

        r = ev.evaluate_round(down, now_wall=0.0)
        assert (r["firing"], r["pending"]) == (0, 1)
        assert ev.counts() == (0, 1)
        assert [t["to"] for t in ev.transitions()] == [PENDING]

        ev.evaluate_round(down, now_wall=10.0)          # still pending
        assert ev.counts() == (0, 1)

        ev.evaluate_round(down, now_wall=20.0)          # for 20s elapsed
        assert ev.counts() == (1, 0)
        rows = ev.rows()
        assert [(row["labels"]["alertname"], row["labels"]["leaf"],
                 row["state"]) for row in rows] == [("LeafDown", "a", FIRING)]
        assert rows[0]["active_since"] == 0.0
        assert rows[0]["state_since"] == 20.0

        ev.evaluate_round(up, now_wall=25.0)            # keep_firing damps
        assert ev.counts() == (1, 0)

        ev.evaluate_round(up, now_wall=35.0)            # dip outlived 10s
        assert ev.counts() == (0, 0)
        assert [t["to"] for t in ev.transitions()] == \
               [PENDING, FIRING, RESOLVED]

    def test_pending_recovery_is_silent(self, tmp_path):
        ev = AlertEvaluator(self.RULES, alert_dir=str(tmp_path))
        ev.evaluate_round(leaf_snapshot({("0", "a"): 0.0}), now_wall=0.0)
        ev.evaluate_round(leaf_snapshot({("0", "a"): 1.0}), now_wall=5.0)
        # Prometheus convention: pending → inactive makes no noise.
        assert ev.counts() == (0, 0)
        assert [t["to"] for t in ev.transitions()] == [PENDING]

    def test_zero_for_fires_in_one_round(self):
        ev = AlertEvaluator(self.RULES)
        r = ev.evaluate_round(
            leaf_snapshot({}, suspected={("0", "a"): 1.0}), now_wall=0.0)
        assert r["firing"] == 1
        assert [t["to"] for t in ev.transitions()] == [PENDING, FIRING]

    def test_suppression_holds_and_counts(self):
        ev = AlertEvaluator(self.RULES)
        down_suspected = leaf_snapshot({("0", "a"): 0.0},
                                       suspected={("0", "a"): 1.0})
        for now in (0.0, 20.0, 40.0):
            ev.evaluate_round(down_suspected, now_wall=now)
        # Partitioned fires; LeafDown never even pends — and every
        # withheld round is counted, not silent.
        fired = {t["alert"] for t in ev.transitions() if t["to"] == FIRING}
        assert fired == {"Partitioned"}
        assert ev.stats()["suppressed_total"] == {"LeafDown": 3}

    def test_suppression_off_is_the_double_page(self):
        ev = AlertEvaluator(self.RULES, suppression=False)
        down_suspected = leaf_snapshot({("0", "a"): 0.0},
                                       suspected={("0", "a"): 1.0})
        for now in (0.0, 20.0):
            ev.evaluate_round(down_suspected, now_wall=now)
        fired = {t["alert"] for t in ev.transitions() if t["to"] == FIRING}
        assert fired == {"Partitioned", "LeafDown"}

    def test_suppression_is_label_scoped(self):
        ev = AlertEvaluator(self.RULES)
        # Leaf a is suspected-partitioned; leaf b is plain down.
        snap = leaf_snapshot({("0", "a"): 0.0, ("1", "b"): 0.0},
                             suspected={("0", "a"): 1.0})
        for now in (0.0, 20.0):
            ev.evaluate_round(snap, now_wall=now)
        down_rows = [row for row in ev.rows()
                     if row["labels"]["alertname"] == "LeafDown"]
        assert [(row["labels"]["leaf"], row["state"])
                for row in down_rows] == [("b", FIRING)]

    def test_bad_rule_degrades_not_crashes(self):
        rules = parse_alert_rules(
            "alert Scalar = 1 > 0\n"          # top-level scalar: eval error
            "alert Ok = tpu_root_leaf_up == 0\n")
        ev = AlertEvaluator(rules)
        r = ev.evaluate_round(leaf_snapshot({("0", "a"): 0.0}),
                              now_wall=0.0)
        assert r["eval_failures"] == 1
        assert ev.counts() == (1, 0)          # the healthy rule still ran
        assert ev.ready_detail()["status"] == "degraded"

    def test_store_receives_alerts_rows(self):
        appended = []

        class FakeStore:
            def append_samples(self, rows, now_wall):
                appended.append((list(rows), now_wall))

        ev = AlertEvaluator(self.RULES, store=FakeStore())
        ev.evaluate_round(leaf_snapshot({}, suspected={("0", "a"): 1.0}),
                          now_wall=7.0)
        (rows, wall), = appended
        assert wall == 7.0
        names = {(m, labels["alertname"], labels["alertstate"])
                 for m, labels, _v in rows}
        assert names == {("ALERTS", "Partitioned", FIRING)}

    def test_emit_publishes_self_metrics(self):
        ev = AlertEvaluator(self.RULES)
        ev.evaluate_round(leaf_snapshot({}, suspected={("0", "a"): 1.0}),
                          now_wall=0.0)
        b = SnapshotBuilder()
        ev.emit(b)
        snap = b.build()
        assert snap.value("tpu_root_alerts_firing", ()) == 1.0
        assert snap.value("tpu_root_alert_rules", ()) == 2.0
        assert snap.value("tpu_root_alert_transitions_total",
                          ("Partitioned", FIRING)) == 1.0


# ------------------------------------------------- sidecar + status footer


class TestSidecar:
    def test_sidecar_roundtrip_to_status_footer(self, tmp_path):
        ev = AlertEvaluator(parse_alert_rules(RULES_TEXT),
                            alert_dir=str(tmp_path))
        ev.evaluate_round(leaf_snapshot({}, suspected={("0", "a"): 1.0}),
                          now_wall=time.time())
        doc = alert_status_summary(str(tmp_path))
        assert doc is not None
        assert (doc["firing"], doc["pending"], doc["rules"]) == (1, 0, 2)
        line = alert_line(doc)
        assert line.startswith("alerts: 1 firing · 0 pending · rules 2")
        assert "last transition" in line

    def test_missing_sidecar_is_none(self, tmp_path):
        assert alert_status_summary(str(tmp_path)) is None

    def test_suppression_off_is_visible_in_the_footer(self, tmp_path):
        ev = AlertEvaluator(parse_alert_rules(RULES_TEXT),
                            alert_dir=str(tmp_path), suppression=False)
        ev.evaluate_round(leaf_snapshot({}), now_wall=time.time())
        line = alert_line(alert_status_summary(str(tmp_path)))
        assert "SUPPRESSION OFF" in line


# --------------------------------------------------------------- notifier


class Receiver:
    """In-process webhook endpoint for the notifier's `send` seam."""

    def __init__(self):
        self.got = []            # (seq, body-dict) in arrival order
        self.down = False
        self.poison_seqs = set()

    def __call__(self, url, body, headers, timeout_s):
        if self.down:
            raise urllib.error.URLError("receiver down")
        seq = int(headers[SEQ_HEADER])
        if seq in self.poison_seqs:
            return 400
        self.got.append((seq, json.loads(body)))
        return 200

    @property
    def seqs(self):
        return [s for s, _ in self.got]


def make_notifier(tmp_path, recv, **kw):
    kw.setdefault("breaker", build_breaker(2, 0.05, 0.2))
    n = AlertNotifier("http://alerts.invalid/hook", str(tmp_path),
                      send=recv, **kw)
    n.load()
    return n


class TestNotifier:
    def test_delivers_in_order_with_contiguous_seqs(self, tmp_path):
        recv = Receiver()
        n = make_notifier(tmp_path, recv)
        n.start()
        for i in range(5):
            n.enqueue({"alert": "A", "state": FIRING, "n": i})
        assert wait_for(lambda: len(recv.got) == 5)
        n.close()
        assert recv.seqs == [1, 2, 3, 4, 5]
        assert [b["n"] for _, b in recv.got] == list(range(5))
        assert n.stats()["backlog_records"] == 0

    def test_outage_buffers_then_drains_exactly_once(self, tmp_path):
        recv = Receiver()
        recv.down = True
        n = make_notifier(tmp_path, recv)
        n.start()
        for i in range(4):
            n.enqueue({"alert": "A", "i": i})
        assert wait_for(lambda: n.stats()["failed"] >= 2)
        assert n.stats()["backlog_records"] == 4
        assert n.stats()["breaker_state"] != "closed"
        recv.down = False
        assert wait_for(lambda: len(recv.got) == 4)
        n.close()
        assert recv.seqs == [1, 2, 3, 4]          # no duplicates, no gaps

    def test_restart_never_redelivers_acked(self, tmp_path):
        recv = Receiver()
        n = make_notifier(tmp_path, recv)
        n.start()
        n.enqueue({"alert": "A", "i": 0})
        n.enqueue({"alert": "A", "i": 1})
        assert wait_for(lambda: len(recv.got) == 2)
        recv.down = True
        n.enqueue({"alert": "A", "i": 2})
        assert wait_for(lambda: n.stats()["failed"] >= 1)
        n.close()                                  # "crash" mid-outage

        n2 = make_notifier(tmp_path, recv)
        assert n2.stats()["backlog_records"] == 1  # only the unacked one
        recv.down = False
        n2.start()
        n2.enqueue({"alert": "A", "i": 3})         # seq resumes, no reuse
        assert wait_for(lambda: len(recv.got) == 4)
        n2.close()
        assert recv.seqs == [1, 2, 3, 4]

    def test_drained_buffer_recovers_seq_from_sidecar(self, tmp_path):
        # Evaluator sidecar records the notifier high-water seq; a fully
        # drained buffer restart must resume from it, not from 1.
        recv = Receiver()
        n = make_notifier(tmp_path, recv)
        n.start()
        n.enqueue({"alert": "A"})
        assert wait_for(lambda: len(recv.got) == 1)
        ev = AlertEvaluator(parse_alert_rules(RULES_TEXT),
                            alert_dir=str(tmp_path), notifier=n)
        ev.evaluate_round(leaf_snapshot({}), now_wall=time.time())
        n.close()

        n2 = make_notifier(tmp_path, recv)
        n2.start()
        n2.enqueue({"alert": "B"})
        assert wait_for(lambda: len(recv.got) == 2)
        n2.close()
        assert recv.seqs == [1, 2]

    def test_poison_is_skipped_and_counted(self, tmp_path):
        recv = Receiver()
        recv.poison_seqs = {2}
        n = make_notifier(tmp_path, recv)
        n.start()
        for i in range(3):
            n.enqueue({"alert": "A", "i": i})
        assert wait_for(lambda: 3 in recv.seqs)
        n.close()
        assert recv.seqs == [1, 3]                 # 2 rejected, not retried
        s = n.stats()
        assert s["dropped"]["poison"] == 1
        assert s["backlog_records"] == 0

    def test_backlog_cap_sheds_oldest_counted(self, tmp_path):
        recv = Receiver()
        recv.down = True
        n = make_notifier(tmp_path, recv, max_backlog_mb=0.0002)  # ~200 B
        n.start()
        for i in range(50):
            n.enqueue({"alert": "A", "i": i})
        assert wait_for(lambda: n.stats()["dropped"]["backlog"] > 0)
        recv.down = False
        assert wait_for(lambda: n.stats()["backlog_records"] == 0)
        n.close()
        s = n.stats()
        # Bounded loss by policy: newest survive, loss is counted.
        assert s["dropped"]["backlog"] + len(recv.got) == 50
        assert recv.seqs == sorted(recv.seqs)
        assert recv.seqs[-1] == 50

    def test_evaluator_notifications_carry_rendered_annotations(
            self, tmp_path):
        recv = Receiver()
        n = make_notifier(tmp_path, recv)
        n.start()
        ev = AlertEvaluator(parse_alert_rules(RULES_TEXT), notifier=n,
                            suppression=False)
        ev.evaluate_round(leaf_snapshot({("0", "b"): 0.0}), now_wall=0.0)
        ev.evaluate_round(leaf_snapshot({("0", "b"): 0.0}), now_wall=20.0)
        assert wait_for(lambda: len(recv.got) == 1)
        ev.close()                                  # closes the notifier
        _, body = recv.got[0]
        assert body["alert"] == "LeafDown" and body["state"] == FIRING
        assert body["labels"]["severity"] == "page"
        assert body["labels"]["leaf"] == "b"
        assert body["annotations"]["summary"] == "leaf b down (value 0)"


# ------------------------------------------------------------------- CLI


class TestCli:
    def test_check_ok(self, tmp_path, capsys):
        p = tmp_path / "rules.txt"
        p.write_text(RULES_TEXT)
        assert main(["--check", str(p)]) == 0
        out = capsys.readouterr().out
        assert "ok: 2 alert rule(s)" in out
        assert "LeafDown [for 20s, keep_firing 10s, suppressed]" in out

    def test_check_fail_names_the_line(self, tmp_path, capsys):
        p = tmp_path / "rules.txt"
        p.write_text("alert A = tpu_nope == 0\n")
        assert main(["--check", str(p)]) == 1
        assert "line 1" in capsys.readouterr().err

    def test_import_emits_parseable_grammar(self, tmp_path, capsys):
        pytest.importorskip("yaml")
        yml = tmp_path / "rules.yaml"
        yml.write_text(
            "groups:\n"
            "- name: g\n"
            "  rules:\n"
            "  - record: slice:x:sum\n"          # recording rule: skipped
            "    expr: sum by (slice_name) (tpu_hbm_used_bytes)\n"
            "  - alert: TpuRootLeafDown\n"
            "    expr: tpu_root_leaf_up == 0\n"
            "    for: 2m\n"
            "    labels: {severity: page}\n"
            "    annotations: {summary: 'leaf {{ $labels.leaf }} down'}\n")
        assert main(["--import", str(yml)]) == 0
        text = capsys.readouterr().out
        rules = parse_alert_rules(text)
        assert [r.name for r in rules] == ["TpuRootLeafDown"]
        assert rules[0].for_s == 120.0
        # The importer injects the stale-serve suspicion suppression for
        # the alerts that have a native partition-false-positive twin.
        assert rules[0].suppress_text == \
            "tpu_root_leaf_partition_suspected == 1"


class TestImporter:
    def test_unsuppressed_alerts_stay_unsuppressed(self):
        pytest.importorskip("yaml")
        text = import_prometheus_rules(
            "groups:\n- name: g\n  rules:\n"
            "  - alert: TpuExporterDown\n"
            "    expr: up{job=\"tpu-pod-exporter\"} == 0\n")
        (rule,) = parse_alert_rules(text)
        assert rule.suppress is None
