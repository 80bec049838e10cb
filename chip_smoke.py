#!/usr/bin/env python3
"""Drive tpu_pod_exporter_torch on one CUDA card and check every phase.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure exits non-zero:

1. device    — the card's name, and nvidia-smi's name and power limit;
2. build     — one nvcc call builds every kernel (the tanh_matmul kernels,
               wgmma with its aligned and strided entries and wmma, the
               staging copy, the SGD update, the running softmax) from this
               checkout, and g++ the native library (``libtpumon``) from
               the port's ``native/tpumon.cc``;
3. kernel    — each route against tanh_matmul_plain on the card at the
               shapes that pick it (ragged M, N, K edges on wgmma; K or N
               not a multiple of 8, a misaligned h on the staged route),
               checking which route each launched; then, at the main-path
               shape and in turns, the times of the wgmma route, the wmma
               kernel (through ``launch``), the plain version and one
               cuBLAS call (``torch.tanh(h @ w)``, a yardstick the package
               never calls); then at two shapes the staged route takes
               (4096 x 8190 x 8190, both operands staged; the main shape
               with h one element off alignment, h staged) the staged
               route, the wmma kernel, cuBLAS and the plain version in
               turns, and the staging copy of each staged operand against
               stage_rows_plain (bit for bit) and its byte bound, in turns
               with the plain copy and ``F.pad``;
4. workload  — a burn at width 8192, depth 8, batch 4096 (10 forwards per
               step), its TFLOP/s, the chain checked against the plain
               chain, and every launch on the wgmma kernel;
5. closed    — the main path: hwcheck's live exporter on the torch backend,
   loop       scraped over HTTP while a 16 GiB fill and the full-size burn
               load the card; memory must rise under load and fall after,
               and every launch is on the wgmma kernel;
6. sgd       — sgd_update_ against sgd_update_plain on the card, bit for
               bit, at 1, 7, 8 and 4097 elements, misaligned views and the
               full stacked layers (8 x 8192 x 8192); then, in turns, the
               kernel, the plain version and ``p.add_(g, alpha=-lr)`` (the
               nearest one-call update, not the same rounding) at full size
               beside the bound;
7. grad      — the gradient of the loss through the wgmma chain against the
               gradient through the plain chain at width 8192, depth 2,
               batch 4096;
8. train     — the training path: sharded_train_step on a mesh of one card,
               first 5 steps at width 64 that must descend, then the full
               size (width 8192, depth 8, batch 4096) for 10 s: step time,
               TFLOP/s, one step split into forward, backward and update,
               every forward launch on wgmma and one sgd launch a step;
9. cli       — the load CLI's burn, hbm and sharded modes as subprocesses
               (each exits 0 and prints its line), and ``entry()``'s output
               on the card;
10. online    — ring attention's running-softmax kernel against
    softmax     online_softmax_update_plain at its edge cases (the first
               step, Tq = 1, Tkv = 1, ragged Tkv, scores scaled 30x30, a row
               past 48 KiB) and at the ring's shape at --scale 1024; then,
               in turns, the kernel and the plain version beside the bound;
11. parallel  — the collective programs on a world of one card at
               --scale 1024: one step of ring, Ulysses, pipeline, MoE and
               FSDP each against its reference (f32, TF32 off), and a ring
               step with q, k, v drawn apart; each step's time, one ring
               step split into its products and the kernel,
               one kernel launch a ring step; then the numeric selftest
               (``--n 1 --checks all``) as a subprocess, ``entry.
               dryrun_multichip(1)``, and the CLI's ``--mode parallel`` for
               every program (multislice refused: one card is not an even
               count);
12. nvml      — the GPU node path: the ctypes NVML binding against torch and
               nvidia-smi (count, UUID, memory total, and the minor number
               against the /dev/nvidia<N> this process holds); hwcheck's
               live exporter on the NVML backend with --process-metrics,
               --legacy-metrics and checkpoint attribution through a UID map
               (a synthetic kubelet checkpoint gives this card to one pod),
               scraped while the 16 GiB fill and the full-size burn load the
               card: the card's memory rises by the fill and falls, its
               utilization rises, the process table sums to the fill, this
               process holds the card's node, the pod's memory rises by the
               fill, the reference's {pid, pod} series is there, and every
               launch is on the wgmma kernel (the exporter records every
               sample it serves to the capture's h100-trace.jsonl);
               ``--backend auto`` picks NVML;
               then NvmlBackend.sample() times over 200 calls idle and under
               the burn, and NVML's used beside the allocator's count; then
               each NVML call of one sample() timed, the binding's library
               loaded through ctypes.CDLL and ctypes.PyDLL in turns, 200
               samples each, idle and under the burn, alone and beside one
               thread that runs Python: each symbol's and the whole
               sample's median and p99; and the card's process table read
               both ways in turns, the order alternating each round (the
               pair: a sizing call with no table, then the table; the
               binding's single call), 200 rounds idle and under the burn,
               alone and beside the Python thread: each way's median, p99
               and max ms and its NVML calls; then the C probe
               (NVML_PROBE_SOURCE, built with gcc into chiprun_out/): the 8
               calls of a sample from a process with no Python, at the node
               exporter's 0.5 s period for 20 s beside itself at 10 ms for
               10 s, idle and under the burn: four JSON lines, each call's
               and each sample's wall and CPU ms, the samples over the 10 ms
               limit and every call over 2 ms with its CLOCK_MONOTONIC start.
13. node      — the node's native fast path and durable state under the
    state       16 GiB fill and the full-size burn: nativelib.load() gives the
               libtpumon just built from the port's native/tpumon.cc; the live
               exposition renders the same bytes natively and in Python; the
               native and Python /proc walks give the same holders (this
               process holds the card's node alone); the exporter's poll-phase
               p50/p99 with the library on and off in turns; then the exporter
               as a subprocess with --state-dir and --egress-url to an
               in-process receiver, SIGKILLed mid-poll by chaos and restarted:
               the history holds the filled level from before the kill, the
               receiver's ledger has no gap and no re-sent batch and agrees
               with that history, and three injected NVML errors are counted
               and recovered from. Prints the live exporter's device_read
               p99 beside the 10 ms limit.
14. fleet     — the fleet plane over the card's node under the 16 GiB fill and
               the full-size burn: the port's exporter on the card (NVML,
               process scan, checkpoint attribution) and fifteen simulated
               8-card nodes (16 hosts, 121 cards in two pools) scraped by a
               flat aggregator (stream on, rounds recorded) and by two shard
               leaves under a root (store with a recording rule, one alert
               rule, a webhook to an in-process receiver) and a replica, all
               subprocesses of the port; the pool's slice HBM rises by the
               node's rise and falls, chip and host counts, fleet sums and the
               pod's workload rollup hold, no TPU-family series appears; the
               root's rollups equal the flat aggregator's, both leaves up, the
               replica serves them; the root's stream sends a snapshot, then
               deltas with consecutive seqs, one at the filled level; the
               store holds the idle, filled and released levels; the alert
               goes pending, firing, resolved, with webhook seqs 1 and 2;
               ``status --tree`` and ``status`` on the node exit 0 and show
               121 cards, the firing alert and the card; every tier exits 0
               on SIGTERM. The node's /metrics body with the smoke pod at the
               fill and that ``status`` document are captured
               (h100-metrics.txt, h100-status.json). Prints the round times,
               the stream's lag, the alert's latency, each process's CPU and
               RSS, and the node exporter's poll phases, device_read p99
               beside the 10 ms limit and scrape p99, each NVML call's and
               each sample's wall and CPU ms inside that exporter (it runs
               under NVML_TIMING_BOOTSTRAP; the samples over the limit with
               their calls; the process-table calls a sample, which must be
               one beside those NVML answered with a grown table) and its
               threads' run-queue waits from
               /proc/<pid>/task/*/schedstat, idle, under load and after.
               The C probe runs at 0.5 s and at 10 ms, as two processes, for
               as long as the node exporter is polled, while /proc/stat,
               /proc/loadavg and every process's CPU ticks are read every
               100 ms: the exporter's and the probes' slow samples on one
               CLOCK_MONOTONIC time line, each with the probe calls over 2 ms
               that overlap it and the host's CPU around it.
15. drills    — the NVML probe (``probe --runtime nvml``) on the card: one
               device, nvidia-smi's UUID, the minor of the node this
               process holds, used memory up by the 16 GiB fill and down
               after its release (the filled report is captured,
               h100-probe.json); phase 12's hwcheck artifact carries it;
               the liveness watch writes one record with the card's nodes.
               ``--backend libtpu``: without grpc the exporter exits
               non-zero naming it; with grpc, the committed probe fixture's
               unreachable service replays as unreachable and a fake
               service of its metric names comes out as 4 chips of tpu_*
               series. Then the port's drills as subprocesses (the card
               idle), each with its state in a temporary directory: the 16
               named scenarios at 120 targets and 4 shards, alone; then
               side by side the 4 negative controls (each must fail on its
               invariant), the fuzzer and the store demo, the shard demo
               and the pressure negative control; then alone the pressure
               demo, the dashboard demo (at the CI workflow's scale) and
               its negative control. Beside the second group, the three
               drills that grow RSS most (mem_pressure, store_continuity,
               partition_asymmetric) each alone in a process whose wrapper
               prints RSS beside glibc's mallinfo2() and pymalloc's arenas
               at its start and exit, and the threads and RSS at the
               scenario's two leak-bound reads. Prints each drill's
               seconds and verdict, and the resident cost of an idle
               thread on the host.
16. lint      — the port's exporter-lint on its own tree: ``python -m
               tpu_pod_exporter_torch.analysis --format json`` finds
               nothing (counts by rule, seconds), ``--demo`` catches all
               seven seeded families, ``--lock-graph``/``--fork-inventory``
               regenerate the committed ``analysis/reviewed/`` artifacts
               byte for byte, and the port's graph holds every edge of the
               JAX package's ``deploy/lock-graph.json``. Then a child
               process installs the port's lock and loop witnesses before
               it imports the rest of the port and runs hwcheck's closed
               loop at phase 5's full size on the torch backend and at
               phase 12's on the NVML backend (the same checks, every
               launch on wgmma); ``--check-witness`` and
               ``--check-loop-witness`` on its dumps exit 0, and the card's
               own locks (the kernel library's, the NVML init lock) are
               among the witnessed sites. Prints the sites, acquisitions,
               edges, longest hold, loop callbacks and slowest callback.
17. deploy    — the port as deploy/gpu/ ships it, on the card's host: the
               image's build stage as deploy/gpu/Dockerfile writes it (the
               wheel built offline from a copy of what it copies, libtpumon
               with its g++ line), the runtime stage as the wheel unpacked
               read-only with TPE_NATIVE_LIB on that library; then the
               DaemonSet's container (deploy/gpu/daemonset.yaml: its
               entrypoint, args and env, with only host paths, the port
               and the node name rewritten) and the aggregator manifest's
               container (its command, with --targets on that exporter)
               started from there under a finder that refuses torch, jax
               and triton. While this process holds the 16 GiB fill and the
               full-size burn: both probe paths answer 200, the card's
               gpu_hbm_used_bytes rises by the fill and falls after, the
               aggregator's pool rollup rises with it, the native renderer
               is the library TPE_NATIVE_LIB names, the exporter's peak RSS
               stays under the manifest's memory limit (its CPU seconds a
               second printed beside the CPU limit), both drain on SIGTERM
               with exit 0 inside terminationGracePeriodSeconds, and the
               unpacked wheel is unchanged. The aggregator's /metrics body
               with the pool at the fill is captured (h100-aggregate.txt).
               Prints the exporter's poll phases, device_read p99 beside the
               10 ms limit, scrape p99 and its threads' run-queue waits
               under load and after (schedstat, read from outside).
18. capture   — the manifest of chiprun_out/h100-capture/ (nvidia-smi's
               name and power limit, driver version and memory total; the
               torch and CUDA versions; the UTC time; each file's phase,
               size and sha256), then every file replayed through the port
               (``check_capture``: the recording through RecordedBackend and
               a Collector, the bodies through the parsers and a
               SliceAggregator, the status document, the probe's answers
               through a simulated driver) and ``trace --replay`` and
               ``history --replay`` on the recording, each exiting 0.
19. budgets   — the JAX package's Makefile host checks that no other phase
               runs, each at its Makefile command with the package renamed,
               the card idle, its state in a temporary directory:
               restart-demo, gpu-demo (the committed NVML recording) and
               chaos-demo must exit 0 and print their OK line; the timing
               checks (trace-overhead, persist-fsync-check,
               persist-overhead, egress-demo and egress-drain-check up to
               three times each, as long as the script stays inside
               SCRIPT_TARGET_S; fleet-query-demo once) print each run's
               value beside the Makefile's budget and CI's, and whether the
               median meets each. A run that fails only on its own budget
               line is a timing miss, printed; any other failure fails the
               phase.

Then the script's own seconds, one JSON line with every kernel's numbers,
nvidia-smi's line, and last
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}``.
Without a CUDA device, or without the package beside it, it exits non-zero
and prints no result.
"""

from __future__ import annotations

import faulthandler
import functools
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

# The whole script stays under 1200 s; past this many seconds it dumps
# every thread's stack and exits. It aims to end inside SCRIPT_TARGET_S:
# the budgets phase gives its timing checks their repeats only while they
# fit before that, less SCRIPT_TAIL_S for what its clock (STARTED, after
# the imports) does not see: the interpreter's start and torch's import
# before it, the kernels line and the exit after the phase (14 s in all on
# the card's host).
WATCHDOG_S = 1140
SCRIPT_TARGET_S = 900.0
SCRIPT_TAIL_S = 30.0
STARTED = time.monotonic()
# Published dense peaks of one H100 SXM (NVIDIA's data sheet).
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES_PER_S = 3.35e12

# Main-path shape: the burn the JAX package ran, width 8192, depth 8,
# batch 4096 (HARDWARE.md), and a 16 GiB fill held beside it.
WIDTH, DEPTH, BATCH, ITERS = 8192, 8, 4096, 10
FILL_BYTES = 16 << 30
MAIN_SHAPE = (BATCH, WIDTH, WIDTH)
# (m, k, n, elements h is shifted off 16-byte alignment, kernel it picks).
KERNEL_CASES = (
    (32, 128, 128, 0, "wgmma"),
    (257, 1000, 4096, 0, "wgmma"),   # ragged M and K tiles
    (1, 64, 8, 0, "wgmma"),          # one row; N and K inside one tile
    (300, 136, 264, 0, "wgmma"),     # ragged M, N and K; a W box wholly past N
    (*MAIN_SHAPE, 0, "wgmma"),
    (257, 1000, 4095, 0, "staged"),  # N not a multiple of 8
    (300, 136, 264, 1, "staged"),    # h off 16-byte alignment
)
# The staged route timed beside the wmma kernel, cuBLAS and the plain
# version: ((m, k, n), elements h is shifted off 16-byte alignment).
STAGED_SHAPES = (
    ((BATCH, WIDTH - 2, WIDTH - 2), 0),  # K and N not multiples of 8: both staged
    (MAIN_SHAPE, 1),                     # h one element off alignment: h staged
)
# tanh_matmul's routes and the file of the kernel each launches; the
# staging copy the staged route launches first.
SOURCES = {"wgmma": "tanh_matmul_sm90.cu", "staged": "tanh_matmul_sm90.cu",
           "wmma": "tanh_matmul.cu"}
STAGE_SOURCE = "stage_rows.cu"
# One layer: the kernel and the plain version both sum bf16 products in f32,
# in different orders, and take tanh in f32 (tanhf against torch.tanh); the
# two f32 results may then round to neighbouring bf16 values. One bf16 step
# in [0.5, 1) is 2**-8; allow two.
LAYER_ATOL = 2.0**-7
# The depth-8 chain: each layer may round differently, and later layers
# carry an earlier difference on (tanh and the sqrt(2/width) weights keep
# its size about the same per layer).
CHAIN_ATOL = 2.0**-4
BURN_SECONDS = 10.0
# Training: SGD at the JAX step's learning rate; the gradient checked at
# depth 2 against the plain chain (f32 products and tanh, as in JAX). The
# kernels' backward takes 1 - y**2 from the bf16 y, which puts the two
# gradients under 1% of max|grad| apart on the CPU at small widths.
LR = 1e-2
GRAD_DEPTH = 2
GRAD_RTOL = 2.0**-6
TRAIN_SECONDS = 10.0
# (elements, p offset, g offset): vector body and scalar tail, misaligned
# views (element by element), and the full stacked layers.
SGD_CASES = (
    (1, 0, 0), (7, 0, 0), (8, 0, 0), (4097, 0, 0),
    (4097, 1, 0), (4097, 3, 3), (1 << 20, 0, 1),
    (DEPTH * WIDTH * WIDTH, 0, 0),
)
# Ring attention's running softmax: (Tq, Tkv, D, d, first step, score
# scale). The ring's shape at --scale 1024 on one card is T = 4096, d = 8192.
RING_T, RING_D = 4096, 8192
SOFTMAX_CASES = (
    (64, 256, 64, 64, True, 1.0),        # the first step: m = -inf, l = 0
    (1, 4096, 8192, 8192, False, 1.0),   # Tq = 1
    (33, 1, 16, 16, True, 1.0),          # Tkv = 1
    (17, 1000, 48, 16, False, 1.0),      # Tkv not a multiple of the block
    (40, 4097, 24, 4, True, 900.0),      # q and k scaled 30x: scores 900x
    (8, 20000, 32, 64, False, 1.0),      # a row past 48 KiB of shared memory
    (RING_T, RING_T, RING_D, RING_D, True, RING_D**0.5),
    (RING_T, RING_T, RING_D, RING_D, False, RING_D**0.5),
)
# m is a max of the same f32 quotients (true division by the same correctly
# rounded sqrt): equal. p and l differ by expf against torch.exp and the
# order of the row sum, a few f32 ulps; o is scaled by the same corr. The
# absolute floor lies far below any p that matters (p underflows near 1e-38).
SOFTMAX_RTOL, SOFTMAX_ATOL = 1e-5, 1e-30
# The collective programs on one card, at the scale that gives the
# pipeline the flagship's width 8192 and batch 4096; each is held against
# its reference in f32 (TF32 off) at the numeric selftest's tolerances
# (rtol = atol), the FSDP loss in absolute terms.
PAR_SCALE = 1024
PAR_TOL = {"ring": 2e-5, "ulysses": 2e-5, "pipeline": 2e-4, "moe": 2e-4, "fsdp": 2e-5}
FSDP_LOSS_ATOL = 1e-5
# The programs draw q = k = v, as the JAX package does, which makes each
# row's softmax one-hot at d = 8192; one more ring step at the same shape
# draws them apart (scores of unit spread), at the ring's tolerance.
REPO = Path(__file__).resolve().parent
# The NVML phase: NvmlBackend.sample() timed over this many calls, and the
# pod a synthetic kubelet checkpoint gives the card to.
NVML_SAMPLES = 200
# The loaders whose NVML calls phase 12 times in turns (the binding's own,
# CDLL, first); PERF.md's device_read limit.
NVML_LOADERS = ("CDLL", "PyDLL")
DEVICE_READ_LIMIT_MS = 10.0
SMOKE_POD, SMOKE_POD_UID = "burn-0", "8a1d3f50-0c4e-4b6e-9f21-5d7c2b9e4a10"
# The node state phase: the live exporter's poll phases in segments of this
# length, with the native library on and off in turns; then a subprocess
# exporter that chaos SIGKILLs on this device call, restarted on the same
# state with three NVML errors from this call on.
NODE_STATE_MODES = ("native", "python", "python", "native")
NODE_STATE_SEGMENT_S = 4.0
NODE_STATE_INTERVAL_S = 0.1
NODE_STATE_RUN_INTERVAL_S = 0.25
NODE_STATE_KILL_AT = 16
NODE_STATE_ERRORS_AT = 12
POLL_PHASES = ("device_read", "process_scan", "attribution", "publish", "total")
# The fleet phase: the real node and FLEET_HOSTS_PER_POOL * 2 - 1 simulated
# ones (FLEET_SIM_GPUS cards each) in two pools, every tier at this interval;
# at least FLEET_IDLE_ROUNDS idle root rounds, FLEET_LOAD_S under the fill
# and the burn, FLEET_RELEASE_S after; the tiers scraped every
# FLEET_OBSERVE_S. The store keeps 0.5 s buckets, so the run's levels stay
# apart in it.
FLEET_INTERVAL_S = 0.5
FLEET_POOLS = ("h100-pool-a", "h100-pool-b")
FLEET_REAL_NODE = ("node-00", "h100-pool-a")
FLEET_HOSTS_PER_POOL = 8
FLEET_SIM_GPUS = 8
FLEET_ACCELERATOR = "nvidia-h100-80gb"
FLEET_IDLE_ROUNDS = 3
FLEET_LOAD_S = 10.0
FLEET_RELEASE_S = 5.0
FLEET_OBSERVE_S = 0.1
FLEET_STORE_TIERS = "0.5:720,10:360"
FLEET_STORE_METRIC = "h100:hbm:by_slice"
FLEET_STORE_RULE = (f"{FLEET_STORE_METRIC} = "
                    'sum(tpu_slice_hbm_used_bytes{family="gpu"}) by (slice_name)')
FLEET_ALERT = "H100PoolHbmFilled"
FLEET_ALERT_RULE = (
    f"alert {FLEET_ALERT} = "
    'tpu_slice_hbm_used_bytes{{family="gpu",slice_name="{pool}"}} > {threshold}\n'
    "    for 1s\n"
    '    labels(severity="info")\n'
    '    annotations(summary="{{{{ $labels.slice_name }}}} HBM above {threshold} B")\n')
FLEET_STREAM = ("tpu_slice_hbm_used_bytes", 30.0)  # metric, window (s)
# The drills phase: the port's drill CLIs at the Makefile's scale, each a
# subprocess with its state under a temporary directory: (name, module,
# arguments, whether it must exit 0, text its output must hold[, run under
# DRILL_MEMORY_BOOTSTRAP]). The negative controls must fail, and fail on
# the invariant they disable.
# Groups run one after another; the lanes of a group side by side, each
# lane's drills in turn. The drills whose checks are timings (the
# scenarios' staleness and continuity windows, the scrape storm's polite
# p99, the dashboard's push p99) run alone. The dashboard demo runs at the
# CI workflow's scale (48 targets, 600 subscriptions) with the Makefile's
# 1 s push budget: at the Makefile's 5000 subscriptions the push p99 took
# 2.2-3.5 s in both packages on 8-core hosts (PERF.md).
DRILL_SCENARIOS = 16
DRILL_GROUPS = (
    ((("scenario_suite", "loadgen.scenario", ("--targets", "120", "--shards", "4"),
       True, "scenario-demo OK"),),),
    ((("negative_alert_suppression", "loadgen.scenario",
       ("--scenarios", "alert_partition", "--alert-suppression", "off",
        "--targets", "24", "--shards", "2"), False, "suppression OFF"),
      ("negative_store", "loadgen.scenario", ("--scenarios", "store_continuity",
                                              "--store", "off"), False, "store OFF"),
      ("negative_governor", "loadgen.scenario", ("--scenarios", "disk_full",
                                                 "--governor", "off"), False, "nothing shed"),
      ("negative_stream", "loadgen.scenario", ("--scenarios", "dashboard_storm",
                                               "--stream", "off"), False, "stream disabled")),
     (("fuzz", "fuzz", ("--seeds", "5,11", "--trials", "4"), True, "0 failure(s)"),
      ("store_demo", "store", ("--demo", "--targets", "1000", "--days", "7",
                               "--query-targets", "200"), True, "store-demo OK")),
     (("shard_demo", "loadgen.fleet", ("--mode", "shard", "--targets", "1000", "--shards", "8",
                                       "--chips", "2", "--churn", "32", "--round-budget-s",
                                       "15", "--gpu-slices", "2"), True, "shard-demo OK"),
      ("pressure_negative_control", "pressure", ("--negative-control",), True,
       "negative control OK")),
     tuple((f"memory_{name}", "loadgen.scenario",
            ("--scenarios", name, "--targets", "120", "--shards", "4"), True,
            "scenario-demo OK", True)
           for name in ("mem_pressure", "store_continuity", "partition_asymmetric"))),
    ((("pressure_demo", "pressure", ("--demo",), True, "storm drill OK"),
      ("dashboard_demo", "loadgen.fleet", ("--mode", "dashboard", "--targets", "48",
                                           "--shards", "2", "--chips", "2", "--subs", "600",
                                           "--rounds", "6", "--replicas", "2"),
       True, "dashboard-demo OK"),
      ("dashboard_negative", "loadgen.fleet", ("--mode", "dashboard", "--targets", "24",
                                               "--shards", "2", "--chips", "2", "--subs", "48",
                                               "--rounds", "4", "--replicas", "1",
                                               "--negative"),
       True, "dashboard-demo OK (negative control)")),),
)
# The state flag of each drill module.
DRILL_STATE_FLAG = {"loadgen.scenario": "--state-root", "loadgen.fleet": "--state-root",
                    "fuzz": "--state-root", "store": "--state-dir"}
DRILL_TIMEOUT_S = 420
# The libtpu service the exporter reads in the drills phase: the metric
# names the committed probe fixture asked a TPU VM for, served for this
# many chips (used, total) and duty cycle.
LIBTPU_FIXTURE = REPO / "tests" / "fixtures" / "libtpu-metrics.json"
LIBTPU_CHIPS = 4
# The lint phase: the port's exporter-lint, its reviewed artifacts, and the
# JAX package's committed lock graph whose every edge (renamed) the port's
# static graph must hold.
LINT_REVIEWED = REPO / "tpu_pod_exporter_torch" / "analysis" / "reviewed"
LINT_REFERENCE_GRAPH = REPO / "deploy" / "lock-graph.json"
LINT_TIMEOUT_S = 240
# Locks only the card's path takes, by (file, statement that creates it):
# the kernel library's build-and-load lock and the NVML backend's init lock
# (held around every call into the ctypes driver).
LINT_CARD_LOCKS = (("tpu_pod_exporter_torch/kernels/tanh_matmul.py", "_lock = threading.Lock()"),
                   ("tpu_pod_exporter_torch/backend/nvml.py",
                    "lock: threading.Lock = field(default_factory=threading.Lock)"))
# The witnessed child: installs the port's lock and loop witnesses before it
# imports any other module of the port, runs hwcheck's closed loop once per
# run of the spec (argv[1], JSON), dumps both witnesses into the spec's
# directory and prints one JSON line with its pid, the reports and its
# tanh_matmul launches by route (and the staging copies').
LINT_CHILD = """
import json, os, sys
from tpu_pod_exporter_torch.analysis import witness

locks = witness.LockWitness().install()
loop = witness.LoopWitness().install()
from tpu_pod_exporter_torch import hwcheck
from tpu_pod_exporter_torch.kernels import tanh_matmul as tm

spec = json.loads(sys.argv[1])
reports = []
for run in spec["runs"]:
    stim = None if run["stimulus"] is None else hwcheck.TorchStimulus(**run["stimulus"])
    report = hwcheck.run_check(backend=run["backend"], idle_s=2.0, load_s=8.0,
                               stimulus=stim, exporter_args=run["exporter_args"])
    report["burn_steps"] = 0 if stim is None else stim.steps
    reports.append(report)
locks.dump(os.path.join(spec["out"], "lock-witness.json"))
loop.dump(os.path.join(spec["out"], "loop-witness.json"))
print(json.dumps({"pid": os.getpid(), "reports": reports, "launches": tm.tanh_matmul.launches,
                  "launches_by_kernel": {**tm.tanh_matmul.launches_by_kernel,
                                         "stage_rows": tm.stage_rows.launches}}))
"""
# The budgets phase: the JAX package's Makefile host checks that no other
# phase runs, each as its Makefile target runs it with the package renamed,
# the card idle, one at a time, each run's state (its state flag's value,
# and TMPDIR) in a temporary directory of its own. The functional checks
# gate: (Makefile target, module, arguments, text of the line that says OK).
BUDGET_STATE_FLAGS = ("--state-dir", "--trace-out", "--egress-dir")
BUDGET_FUNCTIONAL = (
    ("restart-demo", "persist", ("--restart-demo", "--state-dir", "restart-demo-state"),
     "restart-demo: OK"),
    ("gpu-demo", "backend.nvml", ("--demo", "--recording", "tests/fixtures/gpu-recorded.jsonl"),
     "gpu-demo: replayed"),
    ("chaos-demo", "chaos", ("--trace-out", "chaos-incident-trace.json"),
     "recovered: breaker closed"),
)
# The timing checks run up to ``runs`` times at the Makefile's budget: each
# once, then the repeats, the most expensive check's first, each only while
# it fits before the phase's deadline (so the cheapest checks' repeats are
# cut first). Each run's value is read from its own output (``value``: the
# pattern of the number, in ``unit``; the egress demo's by
# ``egress_overhead``) and printed beside the Makefile's budget and CI's
# (.github/workflows/ci.yml), in that unit, with whether the median meets
# each: printed, not gated. A run whose only failure is the check's own
# budget line is a timing miss; any other failure, a traceback or a
# missing value fails the phase.
BUDGET_TIMING = (
    {"target": "trace-overhead", "module": "trace", "runs": 3,
     "args": ("--overhead-check", "--polls", "200", "--chips", "256", "--budget", "0.05"),
     "value": r"overhead ([+-]?[\d.]+)% \(budget", "unit": "%",
     "budgets": {"makefile": 5.0, "ci": 15.0}},
    {"target": "persist-fsync-check", "module": "persist", "runs": 3,
     "args": ("--fsync-check", "--records", "100", "--budget-ms", "50"),
     "value": r"p99 ([\d.]+)ms", "unit": "ms",
     "budgets": {"makefile": 50.0, "ci": 50.0}},
    {"target": "persist-overhead", "module": "persist", "runs": 3,
     "args": ("--overhead-check", "--polls", "200", "--chips", "256", "--budget", "0.02"),
     "value": r"overhead ([+-]?[\d.]+)% \(budget", "unit": "%",
     "budgets": {"makefile": 2.0, "ci": 5.0}},
    {"target": "fleet-query-demo", "module": "loadgen.fleet", "runs": 1,
     "args": ("--targets", "64", "--budget-ms", "1500"),
     "value": r'"query_p99_ms": ([\d.]+)', "unit": "ms",
     "budgets": {"makefile": 1500.0, "ci": 4500.0}},
    {"target": "egress-demo", "module": "egress", "runs": 3,
     "args": ("--demo", "--egress-dir", "egress-demo-state"),
     "value": None, "unit": "%", "budgets": {"makefile": 5.0, "ci": 50.0}},
    {"target": "egress-drain-check", "module": "egress", "runs": 3,
     "args": ("--drain-check", "--outage-s", "180", "--budget-s", "20"),
     "value": r"drained in ([\d.]+)s", "unit": "s",
     "budgets": {"makefile": 20.0, "ci": 60.0}},
)
BUDGET_MISS = re.compile(r"(over|exceeds|exceeded) budget")
BUDGET_TIMEOUT_S = 180  # a run that takes longer fails the phase
# The memory drills (ROADMAP.md fault B), each alone in a process: the
# ``main()`` of ``tpu_pod_exporter_torch.<argv[1]>`` on ``argv[2:]``, with
# one JSON line after the imports and one at exit (after a gc pass) of the
# process's RSS beside glibc's mallinfo2() over all arenas (bytes in use,
# free but held by the allocator, mmapped, the arenas' size) and
# pymalloc's arenas and the bytes in their allocated blocks
# (``sys._debugmallocstats``, read off fd 2). For a scenario, one more line
# at exit: the process's threads and RSS at the leak bound's baseline read
# and at its end read.
DRILL_MEMORY_BOOTSTRAP = """
import atexit, ctypes, gc, importlib, json, os, re, sys, tempfile, threading


class Mallinfo2(ctypes.Structure):
    _fields_ = [(f, ctypes.c_size_t) for f in (
        "arena", "ordblks", "smblks", "hblks", "hblkhd", "usmblks", "fsmblks",
        "uordblks", "fordblks", "keepcost")]


libc = ctypes.CDLL(None)
libc.mallinfo2.restype = Mallinfo2


def pymalloc():
    with tempfile.TemporaryFile() as f:
        sys.stderr.flush()
        saved = os.dup(2)
        os.dup2(f.fileno(), 2)
        try:
            sys._debugmallocstats()
        finally:
            os.dup2(saved, 2)
            os.close(saved)
        f.seek(0)
        text = f.read().decode(errors="replace")
    number = lambda pattern: int(re.search(pattern, text).group(1).replace(",", ""))
    return {"pymalloc_arena_bytes": number(r"arenas \\* \\d+ bytes/arena\\s*=\\s*([\\d,]+)"),
            "pymalloc_block_bytes": number(r"# bytes in allocated blocks\\s*=\\s*([\\d,]+)")}


def snapshot(when):
    gc.collect()  # unreachable cycles are not the drill's live data
    info = libc.mallinfo2()
    with open("/proc/self/status") as status:
        rss = next(int(ln.split()[1]) * 1024 for ln in status if ln.startswith("VmRSS:"))
    print(json.dumps({"memory": when, "glibc": os.confstr("CS_GNU_LIBC_VERSION"),
                      "rss_bytes": rss, "malloc_in_use_bytes": info.uordblks,
                      "malloc_free_held_bytes": info.fordblks,
                      "malloc_mmapped_bytes": info.hblkhd, "malloc_arena_bytes": info.arena,
                      **pymalloc()}), flush=True)


reads = []


def leak_reads():
    print(json.dumps({"memory": "leak_reads", "reads": [
        {"threads": n, "rss_bytes": rss} for n, rss in reads[:1] + reads[-1:]]}), flush=True)


if sys.argv[1] == "loadgen.scenario":
    from tpu_pod_exporter_torch import utils

    rss_bytes = utils.process_rss_bytes

    def read_rss():
        value = rss_bytes()
        if sys._getframe(1).f_code.co_name in ("_check_tick", "_finish"):
            reads.append((threading.active_count(), value))
        return value

    utils.process_rss_bytes = read_rss
    atexit.register(leak_reads)
module = importlib.import_module("tpu_pod_exporter_torch." + sys.argv[1])
sys.argv = [module.__name__, *sys.argv[2:]]
snapshot("start")
atexit.register(snapshot, "exit")
sys.exit(module.main())
"""
# The resident cost of a thread on the host: this many idle threads started
# in a fresh process, its RSS before and after them.
THREAD_RSS_THREADS = 64
THREAD_RSS_BOOTSTRAP = """
import json, sys, threading, time


def rss():
    with open("/proc/self/status") as status:
        return next(int(ln.split()[1]) * 1024 for ln in status if ln.startswith("VmRSS:"))


n = int(sys.argv[1])
done = threading.Event()
before = rss()
threads = [threading.Thread(target=done.wait, daemon=True) for _ in range(n)]
for t in threads:
    t.start()
time.sleep(0.5)
after = rss()
done.set()
print(json.dumps({"threads": n, "rss_bytes_before": before, "rss_bytes_after": after,
                  "bytes_a_thread": (after - before) / n}))
"""
# The deploy phase: the GPU image, DaemonSet and fleet manifests, and what
# the emulation refuses to import (the image installs the wheel without the
# torch extra). The exporter and the aggregator each get this long to serve.
DEPLOY_DIR = REPO / "deploy" / "gpu"
DEPLOY_REFUSED = ("torch", "jax", "triton")
DEPLOY_START_S = 60
# The exporter's resident set is sampled this often: gVisor's /proc has no
# VmHWM, and a child's ru_maxrss keeps the forking parent's peak across exec.
DEPLOY_RSS_EVERY_S = 0.02
# A container started from the unpacked wheel (argv: site, "script" or
# "module", the console script or module, its arguments): the finder goes
# first, so a refused import raises. Prints one JSON line with the
# package's file and the library nativelib loaded, runs the entry point as
# the image would, and at exit one JSON line with every refused import it
# was asked for and any refused module found loaded.
DEPLOY_BOOTSTRAP = """
import configparser, glob, importlib, importlib.abc, json, os, runpy, sys

REFUSED = %r
attempts = []


class NotInImage(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in REFUSED:
            attempts.append(name)
            raise ImportError(f"{name} is not in the image")
        return None


sys.meta_path.insert(0, NotInImage())
site, kind, entry, *args = sys.argv[1:]
sys.path.insert(0, site)
import tpu_pod_exporter_torch
from tpu_pod_exporter_torch import nativelib

lib = nativelib.load()
print(json.dumps({"package": tpu_pod_exporter_torch.__file__,
                  "native_lib": lib._name if lib else None}), flush=True)
try:
    sys.argv = [entry, *args]
    if kind == "script":
        scripts = configparser.ConfigParser()
        scripts.read(glob.glob(os.path.join(site, "*.dist-info", "entry_points.txt")))
        module, func = scripts["console_scripts"][entry].split(":")
        sys.exit(getattr(importlib.import_module(module), func)())
    runpy.run_module(entry, run_name="__main__", alter_sys=True)
finally:
    print(json.dumps({
        "refused_attempts": attempts,
        "refused_loaded": sorted(m for m in sys.modules if m.split(".")[0] in REFUSED)}),
        flush=True)
""" % (DEPLOY_REFUSED,)
# The fleet phase's node exporter runs under this (argv: the exporter's
# arguments): each NVML call of the port's ctypes binding and each
# NvmlBackend.sample() is timed on the thread that makes it, in wall ms and
# the CPU ms charged to that thread (none while it waits for the
# interpreter lock or sleeps in a futex). At exit it prints one JSON line:
# per symbol the calls, median, p99 and largest of each, and the native ids
# of the calling threads; and each sample over the device-read limit with
# its start and the calls made inside it, each with its start (starts are
# time.monotonic(), CLOCK_MONOTONIC, the clock NVML_PROBE_SOURCE stamps its
# calls with); and how many samples made how many process-table
# calls, and how many of those had room for rows and were answered that the
# table grew past it (a sizing call, with no room, is not one of them).
NVML_TIMING_BOOTSTRAP = """
import atexit, collections, json, math, runpy, sys, threading, time
from tpu_pod_exporter_torch.backend import nvml, nvml_ctypes

LIMIT_MS = %r
calls, slow, local = {}, [], threading.local()
tables = collections.Counter()  # (table calls, grown) -> samples


def timed(name, fn):
    def call(*args):
        inside = getattr(local, "inside", None)
        if name == "sample":
            local.inside, local.tables = [], [0, 0]
        table = name.startswith("nvmlDeviceGetComputeRunningProcesses")
        room = args[1].value if table else 0
        start = time.monotonic()
        t0, c0 = time.perf_counter(), time.thread_time()
        ret = None
        try:
            ret = fn(*args)
            return ret
        finally:
            wall = (time.perf_counter() - t0) * 1e3
            cpu = (time.thread_time() - c0) * 1e3
            calls.setdefault(name, []).append((wall, cpu, threading.get_native_id()))
            if name == "sample":
                if wall > LIMIT_MS:
                    slow.append({"start_s": start, "wall_ms": wall, "cpu_ms": cpu,
                                 "calls": local.inside})
                tables[tuple(local.tables)] += 1
                local.inside = None
            elif inside is not None:
                inside.append([name, wall, cpu, start])
                if table:
                    local.tables[0] += 1
                    local.tables[1] += room > 0 and ret == nvml_ctypes.NVML_ERROR_INSUFFICIENT_SIZE
    return call


init = nvml_ctypes.CtypesNvmlDriver.__init__


def timed_init(self, *args, **kwargs):
    init(self, *args, **kwargs)
    self._fns = {name: timed(name, fn) for name, fn in self._fns.items()}
    self._procs = timed(self.process_symbol, self._procs)


def quantiles(values):
    ordered = sorted(values)
    return {"median": ordered[len(ordered) // 2],
            "p99": ordered[math.ceil(0.99 * len(ordered)) - 1], "max": ordered[-1]}


def report():
    print(json.dumps({"nvml_call_times": {
        name: {"calls": len(rows), "wall_ms": quantiles([r[0] for r in rows]),
               "cpu_ms": quantiles([r[1] for r in rows]),
               "tids": sorted({r[2] for r in rows})}
        for name, rows in calls.items()}, "slow_samples": slow,
        "process_table_calls": [[n, grown, samples]
                                for (n, grown), samples in sorted(tables.items())]}),
        flush=True)


nvml_ctypes.CtypesNvmlDriver.__init__ = timed_init
nvml.NvmlBackend.sample = timed("sample", nvml.NvmlBackend.sample)
atexit.register(report)
sys.argv = ["tpu_pod_exporter_torch", *sys.argv[1:]]
runpy.run_module("tpu_pod_exporter_torch", run_name="__main__", alter_sys=True)
""" % (DEVICE_READ_LIMIT_MS,)
# Fault A's probe: NVML's device read timed from a process with no Python.
# It makes the calls of one NvmlBackend.sample() in its order (the count,
# then each card's handle, name, UUID, minor, memory, utilization and one
# process-table read sized as the port's binding sizes it), each timed on
# CLOCK_MONOTONIC and CLOCK_THREAD_CPUTIME_ID, at a fixed period for a fixed
# time (argv: period ms, seconds, the device-read limit ms, the slow-call
# ms, the library), and stops early on SIGTERM. At exit it prints one JSON
# line: per call and for the whole sample the median, p99 and largest wall
# and CPU ms; the first sample's calls in order; the samples over the limit
# and every call over the slow-call ms, each with its CLOCK_MONOTONIC start.
# An NVML error exits 1. Built with gcc by ``build_nvml_probe``.
NVML_PROBE_SOURCE = r"""/* NVML's device read timed from a process with no interpreter: the calls
 * one NvmlBackend.sample() makes, in its order, at a fixed period. */
#define _GNU_SOURCE
#include <dlfcn.h>
#include <errno.h>
#include <math.h>
#include <signal.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <time.h>

#ifndef PROCESS_TABLE_SLACK
#define PROCESS_TABLE_SLACK 8
#endif
#ifndef PROCESS_TABLE_TRIES
#define PROCESS_TABLE_TRIES 4
#endif
#define BUFFER_SIZE 96
#define INSUFFICIENT_SIZE 7
#define MAX_DEVICES 64
#define MAX_SLOW 4096

typedef struct { unsigned long long total, free, used; } nvml_memory;
typedef struct { unsigned int gpu, memory; } nvml_utilization;
typedef struct {
  unsigned int pid;
  unsigned long long used;
  unsigned int gpu_instance, compute_instance;
} nvml_process;

enum { COUNT, HANDLE, NAME, UUID, MINOR, MEMORY, UTILIZATION, PROCESSES, KINDS };
static const char *symbol[KINDS] = {
    "nvmlDeviceGetCount_v2", "nvmlDeviceGetHandleByIndex_v2", "nvmlDeviceGetName",
    "nvmlDeviceGetUUID", "nvmlDeviceGetMinorNumber", "nvmlDeviceGetMemoryInfo",
    "nvmlDeviceGetUtilizationRates", "nvmlDeviceGetComputeRunningProcesses_v3"};

typedef struct { double *wall, *cpu; size_t n, cap; } series;
typedef struct { int kind; double start, wall, cpu; } slow_call;
typedef struct { double start, wall, cpu; } slow_sample;

static series calls[KINDS], samples;
static slow_call slow_calls[MAX_SLOW];
static slow_sample slow_samples[MAX_SLOW];
static size_t n_slow_calls, slow_calls_total, n_slow_samples, n_over_limit, n_calls, n_grown;
static int order[8 * MAX_DEVICES], n_order, recording_order;
static double slow_call_ms;
static volatile sig_atomic_t stopping;

static void on_signal(int sig) { (void)sig; stopping = 1; }

static double now_s(clockid_t clock) {
  struct timespec ts;
  clock_gettime(clock, &ts);
  return ts.tv_sec + ts.tv_nsec * 1e-9;
}

static void push(series *s, double wall, double cpu) {
  if (s->n == s->cap) {
    s->cap = s->cap ? 2 * s->cap : 1024;
    s->wall = realloc(s->wall, s->cap * sizeof *s->wall);
    s->cpu = realloc(s->cpu, s->cap * sizeof *s->cpu);
    if (!s->wall || !s->cpu) { perror("nvml_probe"); exit(3); }
  }
  s->wall[s->n] = wall;
  s->cpu[s->n++] = cpu;
}

static void *load(void *lib, const char *name) {
  void *fn = dlsym(lib, name);
  if (!fn) { fprintf(stderr, "nvml_probe: no symbol %s\n", name); exit(2); }
  return fn;
}

static void check(const char *name, int ret) {
  if (ret != 0) {
    fprintf(stderr, "nvml_probe: %s returned %d\n", name, ret);
    exit(1);
  }
}

/* One call, timed on both clocks; its ms kept under its kind. */
#define TIMED(kind, call)                                                  \
  ({                                                                       \
    double w0_ = now_s(CLOCK_MONOTONIC), c0_ = now_s(CLOCK_THREAD_CPUTIME_ID); \
    int ret_ = (call);                                                     \
    double wall_ = (now_s(CLOCK_MONOTONIC) - w0_) * 1e3;                   \
    double cpu_ = (now_s(CLOCK_THREAD_CPUTIME_ID) - c0_) * 1e3;            \
    push(&calls[kind], wall_, cpu_);                                       \
    if (recording_order && n_order < (int)(sizeof order / sizeof *order))  \
      order[n_order++] = kind;                                             \
    n_calls++;                                                             \
    if (wall_ > slow_call_ms && slow_calls_total++ < MAX_SLOW)             \
      slow_calls[n_slow_calls++] = (slow_call){kind, w0_, wall_, cpu_};    \
    ret_;                                                                  \
  })

static int (*get_count)(unsigned int *);
static int (*get_handle)(unsigned int, void **);
static int (*get_name)(void *, char *, unsigned int);
static int (*get_uuid)(void *, char *, unsigned int);
static int (*get_minor)(void *, unsigned int *);
static int (*get_memory)(void *, nvml_memory *);
static int (*get_utilization)(void *, nvml_utilization *);
static int (*get_processes)(void *, unsigned int *, nvml_process *);
static unsigned int process_rows[MAX_DEVICES];

/* One sample: the count, then each card's handle, name, UUID, minor,
 * memory, utilization and process table, as NvmlBackend.sample() reads. */
static void sample(void) {
  unsigned int count = 0;
  check(symbol[COUNT], TIMED(COUNT, get_count(&count)));
  for (unsigned int i = 0; i < count && i < MAX_DEVICES; i++) {
    void *handle = NULL;
    char text[BUFFER_SIZE];
    unsigned int minor = 0;
    nvml_memory memory;
    nvml_utilization rates;
    check(symbol[HANDLE], TIMED(HANDLE, get_handle(i, &handle)));
    check(symbol[NAME], TIMED(NAME, get_name(handle, text, BUFFER_SIZE)));
    check(symbol[UUID], TIMED(UUID, get_uuid(handle, text, BUFFER_SIZE)));
    check(symbol[MINOR], TIMED(MINOR, get_minor(handle, &minor)));
    check(symbol[MEMORY], TIMED(MEMORY, get_memory(handle, &memory)));
    check(symbol[UTILIZATION], TIMED(UTILIZATION, get_utilization(handle, &rates)));
    /* The binding's read: room for the rows seen last time plus slack, a
     * fresh table every call, larger only while NVML says it grew. */
    unsigned int size = process_rows[i] + PROCESS_TABLE_SLACK, rows = 0;
    int ret = 0;
    for (int tries = 0; tries < PROCESS_TABLE_TRIES; tries++) {
      nvml_process *table = calloc(size, sizeof *table);
      if (!table) { perror("nvml_probe"); exit(3); }
      rows = size;
      ret = TIMED(PROCESSES, get_processes(handle, &rows, table));
      free(table);
      if (ret != INSUFFICIENT_SIZE) break;
      n_grown++;
      size = rows + PROCESS_TABLE_SLACK;
    }
    check(symbol[PROCESSES], ret);
    process_rows[i] = rows;
  }
}

static int by_value(const void *a, const void *b) {
  double x = *(const double *)a, y = *(const double *)b;
  return (x > y) - (x < y);
}

/* {"median", "p99" (nearest rank), "max"} of n values, as the bootstrap's. */
static void print_quantiles(const double *values, size_t n) {
  if (n == 0) { printf("null"); return; }
  double *sorted = malloc(n * sizeof *sorted);
  if (!sorted) { perror("nvml_probe"); exit(3); }
  memcpy(sorted, values, n * sizeof *sorted);
  qsort(sorted, n, sizeof *sorted, by_value);
  printf("{\"median\": %.6f, \"p99\": %.6f, \"max\": %.6f}", sorted[n / 2],
         sorted[(size_t)ceil(0.99 * n) - 1], sorted[n - 1]);
  free(sorted);
}

static void print_series(const series *s) {
  printf("{\"calls\": %zu, \"wall_ms\": ", s->n);
  print_quantiles(s->wall, s->n);
  printf(", \"cpu_ms\": ");
  print_quantiles(s->cpu, s->n);
  printf("}");
}

int main(int argc, char **argv) {
  if (argc < 5) {
    fprintf(stderr, "usage: %s PERIOD_MS SECONDS LIMIT_MS SLOW_CALL_MS [LIBRARY]\n", argv[0]);
    return 2;
  }
  double period_s = atof(argv[1]) / 1e3, seconds = atof(argv[2]);
  double limit_ms = atof(argv[3]);
  const char *library = argc > 5 ? argv[5] : "libnvidia-ml.so.1";
  slow_call_ms = atof(argv[4]);
  if (period_s <= 0 || seconds <= 0) {
    fprintf(stderr, "nvml_probe: the period and the time must be positive\n");
    return 2;
  }
  struct sigaction stop = {.sa_handler = on_signal};
  sigaction(SIGTERM, &stop, NULL);
  sigaction(SIGINT, &stop, NULL);

  void *lib = dlopen(library, RTLD_NOW);
  if (!lib) { fprintf(stderr, "nvml_probe: %s\n", dlerror()); return 2; }
  int (*init)(void) = load(lib, "nvmlInit_v2");
  int (*shutdown)(void) = load(lib, "nvmlShutdown");
  get_count = load(lib, symbol[COUNT]);
  get_handle = load(lib, symbol[HANDLE]);
  get_name = load(lib, symbol[NAME]);
  get_uuid = load(lib, symbol[UUID]);
  get_minor = load(lib, symbol[MINOR]);
  get_memory = load(lib, symbol[MEMORY]);
  get_utilization = load(lib, symbol[UTILIZATION]);
  get_processes = dlsym(lib, symbol[PROCESSES]);
  if (!get_processes) {
    symbol[PROCESSES] = "nvmlDeviceGetComputeRunningProcesses_v2";
    get_processes = load(lib, symbol[PROCESSES]);
  }

  double t_init = now_s(CLOCK_MONOTONIC);
  check("nvmlInit_v2", init());
  double init_ms = (now_s(CLOCK_MONOTONIC) - t_init) * 1e3;

  /* Samples on a fixed grid from the first: a sample that overruns its
   * period skips the slots it covered, and those due before the end are
   * counted as late. */
  double first = now_s(CLOCK_MONOTONIC), end = first + seconds, last = first;
  size_t late = 0;
  for (long k = 0; !stopping; k++) {
    double due = first + k * period_s, t = now_s(CLOCK_MONOTONIC);
    if (k > 0 && due < t) {
      for (long skipped = (long)ceil((t - due) / period_s); skipped > 0; skipped--, k++)
        if (first + k * period_s < end) late++;
      due = first + k * period_s;
    }
    if (due >= end) break;
    struct timespec at = {.tv_sec = (time_t)due};
    at.tv_nsec = (long)((due - (double)at.tv_sec) * 1e9);
    while (clock_nanosleep(CLOCK_MONOTONIC, TIMER_ABSTIME, &at, NULL) == EINTR && !stopping) {
    }
    if (stopping) break;
    recording_order = k == 0;
    double w0 = now_s(CLOCK_MONOTONIC), c0 = now_s(CLOCK_THREAD_CPUTIME_ID);
    sample();
    double wall = (now_s(CLOCK_MONOTONIC) - w0) * 1e3;
    double cpu = (now_s(CLOCK_THREAD_CPUTIME_ID) - c0) * 1e3;
    push(&samples, wall, cpu);
    last = w0 + wall / 1e3;
    if (wall > limit_ms && n_over_limit++ < MAX_SLOW)
      slow_samples[n_slow_samples++] = (slow_sample){w0, wall, cpu};
  }
  check("nvmlShutdown", shutdown());

  printf("{\"probe\": \"nvml\", \"library\": \"%s\", \"period_ms\": %.3f, \"seconds\": %.6f, "
         "\"limit_ms\": %.3f, \"slow_call_ms\": %.3f, \"first_s\": %.6f, \"last_s\": %.6f, "
         "\"init_ms\": %.6f, \"samples\": %zu, \"late\": %zu, \"calls_per_sample\": %.6f, "
         "\"grown\": %zu, \"order\": [",
         library, period_s * 1e3, last - first, limit_ms, slow_call_ms, first, last, init_ms,
         samples.n, late, samples.n ? (double)n_calls / samples.n : 0.0, n_grown);
  for (int i = 0; i < n_order; i++) printf("%s\"%s\"", i ? ", " : "", symbol[order[i]]);
  printf("], \"sample\": ");
  print_series(&samples);
  printf(", \"calls\": {");
  for (int kind = 0; kind < KINDS; kind++) {
    printf("%s\"%s\": ", kind ? ", " : "", symbol[kind]);
    print_series(&calls[kind]);
  }
  printf("}, \"over_limit\": %zu, \"slow_samples\": [", n_over_limit);
  for (size_t i = 0; i < n_slow_samples; i++)
    printf("%s{\"start_s\": %.6f, \"wall_ms\": %.6f, \"cpu_ms\": %.6f}", i ? ", " : "",
           slow_samples[i].start, slow_samples[i].wall, slow_samples[i].cpu);
  printf("], \"slow_calls_total\": %zu, \"slow_calls\": [", slow_calls_total);
  for (size_t i = 0; i < n_slow_calls; i++)
    printf("%s{\"call\": \"%s\", \"start_s\": %.6f, \"wall_ms\": %.6f, \"cpu_ms\": %.6f}",
           i ? ", " : "", symbol[slow_calls[i].kind], slow_calls[i].start, slow_calls[i].wall,
           slow_calls[i].cpu);
  printf("]}\n");
  return 0;
}
"""
# The probe runs at the node exporter's period and at 10 ms, side by side:
# period ms -> seconds (phase 12; phase 14 stops both when its node exporter
# stops). Calls over PROBE_SLOW_CALL_MS are listed with their start. Phase
# 14 reads the host's CPU every HOST_READ_S over the same window.
PROBE_SECONDS = {FLEET_INTERVAL_S * 1e3: 20.0, 10.0: 10.0}
PROBE_DIR = REPO / "chiprun_out" / "nvml-probe"
PROBE_SLOW_CALL_MS = 2.0
PROBE_MAX_SECONDS = 300.0
HOST_READ_S = 0.1
# What the card serves along the GPU node path, written as it came by the
# phase that takes it into chiprun_out/h100-capture/, then listed with its
# size and sha256 in a manifest and replayed through the port (phase 18). They are committed unchanged as
# tests/fixtures/h100-*, which the CPU tests replay through both packages.
CAPTURE_DIR = REPO / "chiprun_out" / "h100-capture"
CAPTURE_MANIFEST = "h100-capture.json"
CAPTURES = {"h100-trace.jsonl": "nvml", "h100-metrics.txt": "fleet",
            "h100-status.json": "fleet", "h100-probe.json": "drills",
            "h100-aggregate.txt": "deploy"}
CAPTURE_MAX_BYTES = 512 << 10


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields, "at_s": time.monotonic() - STARTED}),
          flush=True)


def nvidia_smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=30,
    ).stdout.strip().splitlines()[0]


@functools.lru_cache(maxsize=None)
def card_line() -> str:
    """nvidia-smi's name and power limit, read once at the start, before
    any load: phases print it beside their numbers without running
    nvidia-smi while this process holds the card busy."""
    return nvidia_smi("name,power.limit")


def time_in_turns(fns: dict, reps: int = 20, calls: int = 5) -> dict:
    """Median ms a call of each function, timed in turns: every round times
    each function once, as CUDA events around ``calls`` back-to-back calls
    (so the host's launch cost of the first hides behind the others)."""
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    times: dict = {name: [] for name in fns}
    for _ in range(reps):
        for name, fn in fns.items():
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(calls):
                fn()
            end.record()
            end.synchronize()
            times[name].append(start.elapsed_time(end) / calls)
    return {name: statistics.median(t) for name, t in times.items()}


def reset_counts(tm, sgd=None, osm=None) -> None:
    tm.tanh_matmul.launches = 0
    for kernel in tm.tanh_matmul.launches_by_kernel:
        tm.tanh_matmul.launches_by_kernel[kernel] = 0
    tm.stage_rows.launches = 0
    if sgd is not None:
        sgd.sgd_update_.launches = 0
    if osm is not None:
        osm.online_softmax_update_.launches = 0


def launch_counts(tm) -> dict:
    """tanh_matmul's launches by route, and the staging copies'."""
    return {**tm.tanh_matmul.launches_by_kernel, "stage_rows": tm.stage_rows.launches}


def layer_bound_ms(m: int, k: int, n: int) -> tuple[float, str]:
    """Least time for one layer: operations at the bf16 tensor-core peak or
    bytes (h and w read once, y written once) at the memory rate."""
    ops_ms = 2.0 * m * n * k / PEAK_BF16_FLOPS * 1e3
    bytes_ms = 2.0 * (m * k + k * n + m * n) / PEAK_HBM_BYTES_PER_S * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def operands(dev, gen, m, k, n, offset=0):
    """h (m,k) and w (k,n) bf16; ``offset`` elements shift h off 16-byte
    alignment while keeping it contiguous."""
    h = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
    if offset:
        buf = torch.empty((m * k + offset,), dtype=torch.bfloat16, device=dev)
        h = buf[offset:].view(m, k).copy_(h)
    w = (torch.randn((k, n), generator=gen, device=dev) * k**-0.5).to(torch.bfloat16)
    return h, w


def phase_kernel(dev, tm) -> dict:
    """Each route against the plain version; then the times at the main
    shape and at the staged shapes, and the staging copy's. Returns {route,
    or "stage_rows": its numbers for the kernels line}."""
    import torch.nn.functional as F

    gen = torch.Generator(device=dev).manual_seed(0)
    errs: dict = {}
    for m, k, n, offset, kernel in KERNEL_CASES:
        h, w = operands(dev, gen, m, k, n, offset)
        before = dict(tm.tanh_matmul.launches_by_kernel)
        y = tm.tanh_matmul(h, w)
        ref = tm.tanh_matmul_plain(h, w)
        torch.cuda.synchronize()
        moved = {name: tm.tanh_matmul.launches_by_kernel[name] - before[name]
                 for name in before}
        err = (y.float() - ref.float()).abs().max().item()
        emit("kernel", kernel=kernel, shape=[m, k, n], h_offset=offset,
             launched=moved, max_abs_err=err, atol=LAYER_ATOL)
        if moved != {name: int(name == kernel) for name in moved}:
            raise AssertionError(f"{m}x{k}x{n} offset {offset}: expected one "
                                 f"{kernel} launch, counted {moved}")
        if not (torch.isfinite(y.float()).all() and err <= LAYER_ATOL):
            raise AssertionError(f"{kernel} {m}x{k}x{n}: max_abs_err {err} > {LAYER_ATOL}")
        if (m, k, n) == MAIN_SHAPE:
            errs[kernel] = err
        del h, w, y, ref

    def max_err(y, ref, what: str) -> float:
        err = (y.float() - ref.float()).abs().max().item()
        if not (torch.isfinite(y.float()).all() and err <= LAYER_ATOL):
            raise AssertionError(f"{what}: max_abs_err {err} > {LAYER_ATOL}")
        return err

    m, k, n = MAIN_SHAPE
    h, w = operands(dev, gen, m, k, n)
    errs["wmma"] = max_err(tm.launch("wmma", h, w), tm.tanh_matmul_plain(h, w),
                           f"wmma {m}x{k}x{n}")
    ms = time_in_turns({
        "wgmma": lambda: tm.tanh_matmul(h, w),
        "library": lambda: torch.tanh(h @ w),
        "wmma": lambda: tm.launch("wmma", h, w),
        "plain": lambda: tm.tanh_matmul_plain(h, w),
    })
    bound, bound_by = layer_bound_ms(m, k, n)
    flops = 2.0 * m * n * k
    emit("kernel_time", shape=[m, k, n], ms=ms, bound_ms=bound, bound_by=bound_by,
         tflops={name: flops / t / 1e9 for name, t in ms.items()},
         share_of_bound={name: bound / t for name, t in ms.items()})
    del h, w
    records = {kernel: {
        "max_abs_err": errs[kernel], "ms": ms[kernel], "plain_ms": ms["plain"],
        "bound_ms": bound, "bound_by": bound_by, "library_ms": ms["library"],
    } for kernel in ("wgmma", "wmma")}

    # The staged route at its two shapes, with the wmma kernel it replaces,
    # cuBLAS and the plain version in turns; the first shape's numbers go
    # on the kernels line. Then the staging copy of each staged operand.
    for (m, k, n), offset in STAGED_SHAPES:
        h, w = operands(dev, gen, m, k, n, offset)
        plan = tm.staging(n, k, h.data_ptr(), w.data_ptr())
        ref = tm.tanh_matmul_plain(h, w)
        before = launch_counts(tm)
        err = max_err(tm.tanh_matmul(h, w), ref, f"staged {m}x{k}x{n} offset {offset}")
        moved = {name: count - before[name] for name, count in launch_counts(tm).items()}
        if moved != {**{name: 0 for name in moved}, "staged": 1, "stage_rows": len(plan)}:
            raise AssertionError(f"staged {m}x{k}x{n}: launches {moved}, staging {plan}")
        wmma_err = max_err(tm.launch("wmma", h, w), ref, f"wmma {m}x{k}x{n}")
        del ref
        ms = time_in_turns({
            "staged": lambda: tm.tanh_matmul(h, w),
            "wmma": lambda: tm.launch("wmma", h, w),
            "library": lambda: torch.tanh(h @ w),
            "plain": lambda: tm.tanh_matmul_plain(h, w),
        })
        bound, bound_by = layer_bound_ms(m, k, n)
        flops = 2.0 * m * n * k
        emit("kernel_time", shape=[m, k, n], h_offset=offset, staged=plan, ms=ms,
             max_abs_err={"staged": err, "wmma": wmma_err}, bound_ms=bound,
             bound_by=bound_by, tflops={name: flops / t / 1e9 for name, t in ms.items()},
             share_of_bound={name: bound / t for name, t in ms.items()})
        if "staged" not in records:
            records["staged"] = {"shape": [m, k, n], "max_abs_err": err, "ms": ms["staged"],
                                 "plain_ms": ms["plain"], "bound_ms": bound,
                                 "bound_by": bound_by, "library_ms": ms["library"]}
        for name, x in (("h", h), ("w", w)):
            if name not in plan:
                continue
            ld = plan[name]
            rows, cols = x.shape
            staged = tm.stage_rows(x, ld)
            equal = torch.equal(staged.view(torch.int16),
                                tm.stage_rows_plain(x, ld).view(torch.int16))
            if not equal:
                raise AssertionError(f"stage_rows {rows}x{cols} -> ld {ld}: differs from "
                                     "stage_rows_plain")
            del staged
            copy_ms = time_in_turns({
                "kernel": lambda: tm.stage_rows(x, ld),
                "plain": lambda: tm.stage_rows_plain(x, ld),
                "library": lambda: F.pad(x, (0, ld - cols)),
            })
            moved_bytes = 2.0 * rows * (cols + ld)
            copy_bound = moved_bytes / PEAK_HBM_BYTES_PER_S * 1e3
            emit("stage_rows_time", operand=name, shape=[rows, cols], ld=ld,
                 offset_bytes=x.data_ptr() % 16, bit_equal=equal, ms=copy_ms,
                 bytes=moved_bytes, bound_ms=copy_bound, bound_by="bytes",
                 share_of_bound={k_: copy_bound / t for k_, t in copy_ms.items()})
            if "stage_rows" not in records:
                records["stage_rows"] = {"shape": [rows, cols, ld], "max_abs_err": 0.0,
                                         "ms": copy_ms["kernel"], "plain_ms": copy_ms["plain"],
                                         "bound_ms": copy_bound, "bound_by": "bytes",
                                         "library_ms": copy_ms["library"]}
        del h, w
    return records


def check_all_wgmma(tm, phase: str, launches: int) -> None:
    """Every launch of a main path on the wgmma route: none staged, none on
    wmma, no staging copy."""
    counts = launch_counts(tm)
    if counts != {**{name: 0 for name in counts}, "wgmma": launches}:
        raise AssertionError(f"{phase}: {launches} launches, by kernel {counts}")


def phase_workload(dev, tm, wl) -> None:
    params = wl.init_params(width=WIDTH, depth=DEPTH, seed=0, device=dev)
    x = torch.ones((BATCH, WIDTH), dtype=torch.bfloat16, device=dev)
    out = wl.forward(params, x)
    plain = x
    for w in params["layers"]:
        plain = tm.tanh_matmul_plain(plain, w)
    torch.cuda.synchronize()
    chain_err = (out.float() - plain.float()).abs().max().item()
    if not (out.shape == (BATCH, WIDTH) and torch.isfinite(out.float()).all()
            and chain_err <= CHAIN_ATOL):
        raise AssertionError(f"forward chain: shape {tuple(out.shape)}, "
                             f"max_abs_err {chain_err} > {CHAIN_ATOL}")
    del out, plain
    reset_counts(tm)
    steps = 0
    t0 = time.monotonic()
    while time.monotonic() - t0 < BURN_SECONDS:
        x = wl.burn_step(params, x, iters=ITERS)
        torch.cuda.synchronize()
        steps += 1
    dt = time.monotonic() - t0
    # The card's clock and draw just after 10 s of load: under its power
    # limit the clock falls below what a short timing sees.
    clocks_power = nvidia_smi("clocks.sm,power.draw")
    launches = tm.tanh_matmul.launches
    if launches != steps * ITERS * DEPTH or not torch.isfinite(x.float()).all():
        raise AssertionError(f"burn: {launches} launches for {steps} steps")
    check_all_wgmma(tm, "burn", launches)
    flops = 2 * BATCH * WIDTH * WIDTH * DEPTH * ITERS * steps
    emit("workload", width=WIDTH, depth=DEPTH, batch=BATCH, iters=ITERS,
         steps=steps, seconds=dt, tflops=flops / dt / 1e12,
         launches=launches, launches_by_kernel=launch_counts(tm),
         chain_max_abs_err=chain_err, chain_atol=CHAIN_ATOL,
         clocks_sm_power_draw=clocks_power)


def check_torch_loop(report: dict, label: str) -> None:
    """hwcheck's artifact on the torch backend under the fill and the burn:
    memory rises by at least the fill and falls after."""
    checks = report["checks"]
    if not (report["ok"] and checks["hbm_rises_under_load"]
            and checks["hbm_falls_after_release"]):
        raise AssertionError(f"{label} failed: {checks}")
    if report["family"] != "gpu" or report["phases"]["load"]["hbm_total_bytes"] <= 0:
        raise AssertionError(f"{label} did not read gpu_hbm_* series")
    rise = (report["phases"]["load"]["hbm_used_bytes"]
            - report["phases"]["idle"]["hbm_used_bytes"])
    if rise < FILL_BYTES:
        raise AssertionError(f"{label}: gpu_hbm_used_bytes rose {rise} B, less than the fill")


def phase_closed_loop(dev, tm, hwcheck, uuid: str) -> dict:
    stim = hwcheck.TorchStimulus(hbm_bytes=FILL_BYTES, width=WIDTH, depth=DEPTH,
                                 batch=BATCH, iters=ITERS, device=dev)
    reset_counts(tm)
    report = hwcheck.run_check(backend="torch", idle_s=2.0, load_s=8.0,
                               stimulus=stim)
    launches = tm.tanh_matmul.launches
    by_kernel = launch_counts(tm)
    emit("closed_loop", report=report, launches=launches,
         launches_by_kernel=by_kernel, burn_steps=stim.steps)
    check_torch_loop(report, "closed loop")
    if launches <= 0:
        raise AssertionError("no tanh_matmul launch during the load phase")
    check_all_wgmma(tm, "closed loop", launches)
    from tpu_pod_exporter_torch.backend.torchdev import TorchCudaBackend

    (chip,) = TorchCudaBackend().sample().chips
    if chip.info.device_ids[0] != uuid:
        raise AssertionError(f"device id {chip.info.device_ids} != nvidia-smi {uuid}")
    return by_kernel


def misaligned(t, offset: int):
    """A contiguous copy of 1-D ``t`` starting ``offset`` elements into a buffer."""
    buf = torch.empty((t.numel() + offset,), dtype=t.dtype, device=t.device)
    return buf[offset:].copy_(t)


def phase_sgd(dev, sgd) -> dict:
    """sgd_update_ against the plain version, bit for bit; then the times at
    full size. Returns its numbers for the kernels line."""
    gen = torch.Generator(device=dev).manual_seed(5)
    for n, p_offset, g_offset in SGD_CASES:
        p = torch.randn((n,), generator=gen, device=dev).to(torch.bfloat16)
        g = (0.05 * torch.randn((n,), generator=gen, device=dev)).to(torch.bfloat16)
        want = sgd.sgd_update_plain(p.clone(), g, LR)
        p, g = misaligned(p, p_offset), misaligned(g, g_offset)
        before = sgd.sgd_update_.launches
        sgd.sgd_update_(p, g, LR)
        torch.cuda.synchronize()
        launched = sgd.sgd_update_.launches - before
        equal = bool(torch.equal(p, want))
        err = (p.float() - want.float()).abs().max().item()
        emit("sgd", n=n, p_offset=p_offset, g_offset=g_offset, launched=launched,
             bit_equal=equal, max_abs_err=err)
        if launched != 1 or not equal:
            raise AssertionError(f"sgd n={n} offsets {p_offset},{g_offset}: "
                                 f"{launched} launches, bit_equal={equal}")
        del p, g, want
    p = torch.randn((DEPTH, WIDTH, WIDTH), generator=gen, device=dev).to(torch.bfloat16)
    g = (0.05 * torch.randn((DEPTH, WIDTH, WIDTH), generator=gen, device=dev)).to(torch.bfloat16)
    ms = time_in_turns({
        "kernel": lambda: sgd.sgd_update_(p, g, LR),
        "plain": lambda: sgd.sgd_update_plain(p, g, LR),
        "yardstick": lambda: p.add_(g, alpha=-LR),
    })
    # p read and written, g read, each once.
    moved = 3 * p.numel() * p.element_size()
    bound = moved / PEAK_HBM_BYTES_PER_S * 1e3
    emit("sgd_time", shape=list(p.shape), ms=ms, bound_ms=bound, bound_by="bytes",
         bytes=moved, share_of_bound={name: bound / t for name, t in ms.items()},
         yardstick="p.add_(g, alpha=-lr): the nearest one-call update, not the same rounding")
    del p, g
    return {"max_abs_err": 0.0, "ms": ms["kernel"], "plain_ms": ms["plain"],
            "bound_ms": bound, "bound_by": "bytes",
            # No one PyTorch call computes this update (the yardstick rounds
            # neither lr nor lr * g to bf16).
            "library_ms": None}


def chain_grad(layers, x, y, layer_fn):
    """(loss, gradient of the stacked layers) of the f32 MSE through
    ``layer_fn`` applied layer by layer."""
    layers = layers.detach().clone().requires_grad_()
    h = x
    for w in layers.unbind(0):
        h = layer_fn(h, w)
    loss = torch.mean((h.float() - y.float()) ** 2)
    loss.backward()
    return loss.detach(), layers.grad


def phase_grad(dev, tm, wl) -> None:
    params = wl.init_params(width=WIDTH, depth=GRAD_DEPTH, seed=1, device=dev)
    gen = torch.Generator(device=dev).manual_seed(6)
    x = torch.randn((BATCH, WIDTH), generator=gen, device=dev).to(torch.bfloat16)
    y = torch.zeros_like(x)
    reset_counts(tm)
    loss, grad = chain_grad(params["layers"], x, y, tm.tanh_matmul)
    check_all_wgmma(tm, "grad", GRAD_DEPTH)
    ref_loss, ref = chain_grad(params["layers"], x, y, tm.tanh_matmul_plain)
    torch.cuda.synchronize()
    scale = ref.float().abs().max().item()
    rel = (grad.float() - ref.float()).abs().max().item() / scale
    per_layer = [((a.float() - b.float()).abs().max() / b.float().abs().max()).item()
                 for a, b in zip(grad, ref)]
    emit("grad", width=WIDTH, depth=GRAD_DEPTH, batch=BATCH, loss=loss.item(),
         plain_loss=ref_loss.item(), rel_err=rel, rel_err_by_layer=per_layer,
         rtol=GRAD_RTOL, max_abs_grad=scale)
    if not (torch.isfinite(grad.float()).all() and rel <= GRAD_RTOL):
        raise AssertionError(f"grad: max|dgrad| / max|grad| = {rel} > {GRAD_RTOL}")


def phase_train(dev, tm, sgd, sharded) -> dict:
    """The training path on a mesh of one card. Returns the launches by
    kernel of the full-size run."""
    import torch.distributed as dist

    mesh = sharded.make_mesh(1)
    step, params, (x, y) = sharded.sharded_train_step(mesh, width=64, depth=2, batch=16,
                                                       lr=LR)
    losses = []
    for _ in range(5):
        params, loss = step(params, x, y)
        losses.append(loss.item())
    descends = all(b < a for a, b in zip(losses, losses[1:]))
    emit("train_descent", width=64, depth=2, batch=16, losses=losses, descends=descends)
    if not (all(map(math.isfinite, losses)) and descends):
        raise AssertionError(f"losses do not descend: {losses}")

    torch.cuda.reset_peak_memory_stats(dev)
    step, params, (x, y) = sharded.sharded_train_step(mesh, WIDTH, DEPTH, BATCH, LR)
    params, loss = step(params, x, y)
    torch.cuda.synchronize()
    # One step split into its phases by CUDA events.
    events = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    layers = params["layers"].detach().requires_grad_()
    events[0].record()
    share = step.forward(layers, x, y)
    events[1].record()
    share.backward()
    events[2].record()
    step.update(params, layers.grad)
    events[3].record()
    events[3].synchronize()
    split = {name: events[i].elapsed_time(events[i + 1])
             for i, name in enumerate(("forward", "backward", "update"))}
    del layers, share

    reset_counts(tm, sgd)
    losses, steps = [], 0
    t0 = time.monotonic()
    while time.monotonic() - t0 < TRAIN_SECONDS:
        params, loss = step(params, x, y)
        losses.append(loss.item())
        steps += 1
    dt = time.monotonic() - t0
    clocks_power = nvidia_smi("clocks.sm,power.draw")
    by_kernel = {**launch_counts(tm), "sgd": sgd.sgd_update_.launches}
    flops_per_step = 2 * BATCH * WIDTH * WIDTH * (3 * DEPTH - 1)
    emit("train", width=WIDTH, depth=DEPTH, batch=BATCH, lr=LR, steps=steps, seconds=dt,
         step_ms=dt / steps * 1e3, tflops=flops_per_step * steps / dt / 1e12,
         flops_per_step="2*B*W^2*(3D-1): D forward and 2D-1 backward products",
         split_ms=split, first_loss=losses[0], last_loss=losses[-1],
         peak_memory_bytes=torch.cuda.max_memory_allocated(dev),
         launches_by_kernel=by_kernel, clocks_sm_power_draw=clocks_power)
    if not all(map(math.isfinite, losses)):
        raise AssertionError("train: a loss is not finite")
    check_all_wgmma(tm, "train", steps * DEPTH)
    if by_kernel["sgd"] != steps:
        raise AssertionError(f"train: {by_kernel['sgd']} sgd launches for {steps} steps")
    del step, params, x, y
    dist.destroy_process_group()
    return by_kernel


def run_cli(*args: str) -> str:
    """The load CLI as a subprocess; returns its output, raising unless it
    exits 0."""
    proc = subprocess.run([sys.executable, "-m", "tpu_pod_exporter_torch.loadgen", *args],
                          capture_output=True, text=True, timeout=180, cwd=REPO)
    if proc.returncode != 0:
        raise AssertionError(f"loadgen {' '.join(args)}: rc={proc.returncode}\n"
                             f"{proc.stderr[-2000:]}")
    return proc.stdout.strip()


def phase_cli(dev) -> None:
    from tpu_pod_exporter_torch.entry import entry

    width, batch, depth = str(WIDTH), str(BATCH), str(DEPTH)
    lines = {
        "burn": run_cli("--mode", "burn", "--width", width, "--batch", batch,
                        "--iters", str(ITERS), "--seconds", "3"),
        "hbm": run_cli("--mode", "hbm", "--gib", "1", "--seconds", "1"),
        "sharded": run_cli("--mode", "sharded", "--devices", "1", "--width", width,
                           "--depth", depth, "--batch", batch, "--seconds", "3"),
    }
    fn, args = entry()
    out = fn(*args)
    torch.cuda.synchronize()
    emit("cli", lines=lines, entry_shape=list(out.shape), entry_device=str(out.device))
    patterns = {
        "burn": r"^\d+ steps in [\d.]+s → [\d.]+ TFLOP/s$",
        "hbm": r"^holding 1\.00 GiB on cuda:0$",
        "sharded": r"^mesh \{'data': 1, 'model': 1\} \| \d+ steps in [\d.]+s \| loss [\d.]+$",
    }
    for mode, pattern in patterns.items():
        if not re.match(pattern, lines[mode].splitlines()[-1]):
            raise AssertionError(f"loadgen --mode {mode} printed {lines[mode]!r}")
    if out.shape != (32, 128) or out.device.type != "cuda" or not torch.isfinite(out.float()).all():
        raise AssertionError(f"entry(): {tuple(out.shape)} on {out.device}")


def softmax_bound_ms(tq: int, tkv: int, dv: int) -> float:
    """Least time for one running-softmax step: r, o, m and l each read
    once and written once, f32, at the memory rate."""
    return 2 * 4 * (tq * tkv + tq * dv + 2 * tq) / PEAK_HBM_BYTES_PER_S * 1e3


def softmax_operands(dev, gen, tq, tkv, dv, first, scale):
    """r, m, l, o for one step; ``first`` starts from m = -inf, l = 0."""
    r = scale * torch.randn((tq, tkv), generator=gen, device=dev)
    o = torch.randn((tq, dv), generator=gen, device=dev)
    if first:
        m = torch.full((tq,), -math.inf, device=dev)
        l = torch.zeros((tq,), device=dev)
    else:
        m = scale * torch.randn((tq,), generator=gen, device=dev)
        l = torch.rand((tq,), generator=gen, device=dev) + 0.5
    return r, m, l, o


def phase_online_softmax(dev, osm) -> dict:
    """The running-softmax kernel against the plain version at every case;
    then the times at the ring's shape. Returns its numbers for the
    kernels line."""
    gen = torch.Generator(device=dev).manual_seed(8)
    main_err = None
    for tq, tkv, dv, d, first, scale in SOFTMAX_CASES:
        got = softmax_operands(dev, gen, tq, tkv, dv, first, scale)
        want = [t.clone() for t in got]
        osm.online_softmax_update_plain(*want, d)
        before = osm.online_softmax_update_.launches
        osm.online_softmax_update_(*got, d)
        torch.cuda.synchronize()
        launched = osm.online_softmax_update_.launches - before
        errs = {name: (a - b).abs().max().item()
                for name, a, b in zip(("p", "m", "l", "o"), got, want)}
        close = all(torch.allclose(a, b, rtol=SOFTMAX_RTOL, atol=SOFTMAX_ATOL)
                    and bool(torch.isfinite(a).all()) for a, b in zip(got, want))
        m_equal = bool(torch.equal(got[1], want[1]))
        emit("online_softmax", shape={"Tq": tq, "Tkv": tkv, "D": dv, "d": d},
             first_step=first, score_scale=scale, launched=launched, m_equal=m_equal,
             max_abs_err=errs, rtol=SOFTMAX_RTOL, atol=SOFTMAX_ATOL)
        if launched != 1 or not (close and m_equal):
            raise AssertionError(f"online_softmax {tq}x{tkv}x{dv}: {launched} launches, "
                                 f"m_equal={m_equal}, errors {errs}")
        if (tq, tkv, dv) == (RING_T, RING_T, RING_D):
            main_err = max(errs.values())
        del got, want
    r, m, l, o = softmax_operands(dev, gen, RING_T, RING_T, RING_D, False, RING_D**0.5)
    ms = time_in_turns({
        "kernel": lambda: osm.online_softmax_update_(r, m, l, o, RING_D),
        "plain": lambda: osm.online_softmax_update_plain(r, m, l, o, RING_D),
    })
    bound = softmax_bound_ms(RING_T, RING_T, RING_D)
    emit("online_softmax_time", shape={"Tq": RING_T, "Tkv": RING_T, "D": RING_D},
         ms=ms, bound_ms=bound, bound_by="bytes",
         share_of_bound={name: bound / t for name, t in ms.items()})
    del r, m, l, o
    return {"max_abs_err": main_err, "ms": ms["kernel"], "plain_ms": ms["plain"],
            "bound_ms": bound, "bound_by": "bytes",
            # No one PyTorch call computes this step.
            "library_ms": None}


def reference_of(par, name: str, args):
    return {"ring": par.reference_attention, "ulysses": par.reference_mha,
            "pipeline": par.reference_pipeline, "moe": par.reference_moe,
            "fsdp": par.reference_fsdp}[name](*args)


def phase_parallel(dev, tm, sgd, osm, par) -> dict:
    """The five programs that run on one card at --scale 1024, each held
    against its reference; then the selftest, the dry run and the CLI.
    Returns the launches by kernel of the programs' run."""
    import torch.distributed as dist

    from tpu_pod_exporter_torch.entry import dryrun_multichip

    reset_counts(tm, sgd, osm)
    ring_steps = 0
    results: dict = {}
    for name in PAR_TOL:
        step, args, _feed = par.build_parallel_program(name, 1, scale=PAR_SCALE)
        out = step(*args)
        ref = reference_of(par, name, args)
        if name == "fsdp":
            (out, loss), (ref, ref_loss) = out, ref
            loss_err = abs(loss.item() - ref_loss.item())
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        ok = bool(torch.isfinite(out).all()) and torch.allclose(
            out, ref, rtol=PAR_TOL[name], atol=PAR_TOL[name])
        ms = time_in_turns({name: lambda: step(*args)}, reps=5, calls=1)[name]
        ring_steps += 7 if name == "ring" else 0  # the step, time_in_turns' 1 + 5
        results[name] = {"shape": {a: list(t.shape) for a, t in zip(par.ARGS[name], args)},
                         "max_abs_err": err, "tol": PAR_TOL[name], "step_ms": ms}
        if name == "fsdp":
            results[name]["loss_abs_err"] = loss_err
            ok = ok and loss_err < FSDP_LOSS_ATOL
        if not ok:
            raise AssertionError(f"parallel {name} x{PAR_SCALE}: {results[name]}")
        del step, args, out, ref
        torch.cuda.empty_cache()
    gen = torch.Generator(device=dev).manual_seed(9)
    q, k, v = (torch.randn((RING_T, RING_D), generator=gen, device=dev) for _ in range(3))
    fn, _shard = par.ring_attention_fn(par.make_1d_mesh(1, "seq"))
    out, ref = fn(q, k, v), par.reference_attention(q, k, v)
    ring_steps += 1
    err = (out - ref).abs().max().item()
    results["ring_apart"] = {"max_abs_err": err, "tol": PAR_TOL["ring"]}
    if not (bool(torch.isfinite(out).all())
            and torch.allclose(out, ref, rtol=PAR_TOL["ring"], atol=PAR_TOL["ring"])):
        raise AssertionError(f"ring with q, k, v drawn apart: max_abs_err {err}")
    del q, k, v, out, ref
    by_kernel = {**launch_counts(tm), "sgd": sgd.sgd_update_.launches,
                 "online_softmax": osm.online_softmax_update_.launches}
    if by_kernel["online_softmax"] != ring_steps:
        raise AssertionError(f"parallel: {by_kernel['online_softmax']} online_softmax "
                             f"launches for {ring_steps} ring steps")

    # One ring step on one card, split by CUDA events: r = q @ k.T, the
    # kernel, o += p @ v (the program's body, n = 1).
    step, (q, k, v), _feed = par.build_parallel_program("ring", 1, scale=PAR_SCALE)
    step(q, k, v)
    o = torch.zeros_like(q)
    m = torch.full((q.shape[0],), -math.inf, device=dev)
    l = torch.zeros_like(m)
    events = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    events[0].record()
    p = torch.mm(q, k.t())
    events[1].record()
    osm.online_softmax_update_(p, m, l, o, q.shape[1])
    events[2].record()
    o.addmm_(p, v)
    events[3].record()
    events[3].synchronize()
    split = {part: events[i].elapsed_time(events[i + 1])
             for i, part in enumerate(("qk_product", "online_softmax", "pv_product"))}
    flops = 4.0 * q.shape[0] * k.shape[0] * q.shape[1]
    del step, q, k, v, o, m, l, p
    dist.destroy_process_group()
    torch.cuda.empty_cache()
    emit("parallel", scale=PAR_SCALE, devices=1, programs=results,
         ring_split_ms=split, ring_product_tflops=flops / (split["qk_product"]
                                                            + split["pv_product"]) / 1e9,
         launches_by_kernel=by_kernel, ring_steps=ring_steps)

    selftest = subprocess.run(
        [sys.executable, "-m", "tpu_pod_exporter_torch.loadgen.selftest", "--n", "1",
         "--checks", "all"], capture_output=True, text=True, timeout=300, cwd=REPO)
    report = json.loads(selftest.stdout.strip().splitlines()[-1]) if selftest.stdout else {}
    emit("selftest", rc=selftest.returncode,
         checks={k: {f: x for f, x in v.items() if f != "traceback"}
                 for k, v in report.get("checks", {}).items()},
         stderr=selftest.stderr[-1000:] if selftest.returncode else "")
    if selftest.returncode != 0:
        raise AssertionError(f"selftest --n 1 --checks all exited {selftest.returncode}")
    dryrun = dryrun_multichip(1)
    emit("dryrun_multichip", n_devices=1, report=dryrun)

    lines = {name: run_cli("--mode", "parallel", "--program", name,
                           "--scale", str(PAR_SCALE), "--seconds", "2")
             for name in PAR_TOL}
    refused = subprocess.run(
        [sys.executable, "-m", "tpu_pod_exporter_torch.loadgen", "--mode", "parallel",
         "--program", "multislice", "--scale", str(PAR_SCALE), "--seconds", "2"],
        capture_output=True, text=True, timeout=180, cwd=REPO)
    emit("parallel_cli", lines=lines, multislice_rc=refused.returncode,
         multislice_stderr=refused.stderr.strip()[-200:])
    for name, line in lines.items():
        pattern = rf"^{name} x{PAR_SCALE} on 1 devices: \d+ steps in [\d.]+s → [\d.]+ steps/s$"
        if not re.match(pattern, line.splitlines()[-1]):
            raise AssertionError(f"loadgen --mode parallel --program {name} printed {line!r}")
    if refused.returncode == 0 or "even device count" not in refused.stderr:
        raise AssertionError(f"multislice on one card: rc={refused.returncode}")
    return by_kernel


def held_card_nodes() -> set:
    """The /dev/nvidia<N> card nodes among this process's open files."""
    nodes = set()
    for fd in os.listdir("/proc/self/fd"):
        try:
            target = os.readlink(f"/proc/self/fd/{fd}")
        except OSError:
            continue
        if re.fullmatch(r"/dev/nvidia[0-9]+", target):
            nodes.add(target)
    return nodes


class _Timed:
    """A callable's wall ms, one entry a call."""

    def __init__(self, fn):
        self.fn, self.ms = fn, []

    def __call__(self, *args, **kwargs):
        t0 = time.perf_counter()
        try:
            return self.fn(*args, **kwargs)
        finally:
            self.ms.append((time.perf_counter() - t0) * 1e3)


def quantiles_ms(times: list) -> dict:
    """Median and nearest-rank p99 of ``times`` (ms), and their count."""
    ordered = sorted(times)
    return {"median": statistics.median(ordered),
            "p99": ordered[math.ceil(0.99 * len(ordered)) - 1], "calls": len(ordered)}


def sample_ms(backend, calls: int = NVML_SAMPLES) -> dict:
    """Median and p99 ms of ``backend.sample()`` over ``calls`` calls."""
    sample = _Timed(backend.sample)
    for _ in range(calls):
        sample()
    return quantiles_ms(sample.ms)


class BusyPython:
    """With ``on``, one thread that runs Python for as long as the block."""

    def __init__(self, on: bool) -> None:
        import threading

        self.stop = threading.Event()
        self.thread = threading.Thread(target=self.spin, name="busy-python", daemon=True)
        self.on = on

    def spin(self) -> None:
        x = 0
        while not self.stop.is_set():
            x += 1

    def __enter__(self):
        if self.on:
            self.thread.start()
        return self

    def __exit__(self, *exc) -> None:
        self.stop.set()
        if self.on:
            self.thread.join(timeout=10)


def nvml_call_times(beside_python: bool, calls: int = NVML_SAMPLES) -> dict:
    """Each NVML call of ``NvmlBackend.sample()``, timed through the port's
    ctypes binding with its library loaded by each of NVML_LOADERS: the
    loaders in turns, one sample each a round, ``calls`` rounds; with
    ``beside_python``, beside one thread that runs Python throughout.
    Returns {loader: {symbol or "sample": median and p99 ms}}; a symbol's
    time is wall time from the call to its return to Python, the wait for
    the interpreter lock included."""
    import ctypes

    from tpu_pod_exporter_torch.backend import nvml_ctypes
    from tpu_pod_exporter_torch.backend.nvml import NvmlBackend

    timers: dict = {}
    backends = {}
    for loader in NVML_LOADERS:
        driver = nvml_ctypes.CtypesNvmlDriver(
            lib=getattr(ctypes, loader)(nvml_ctypes.LIBRARY))
        driver._fns = {name: _Timed(fn) for name, fn in driver._fns.items()}
        driver._procs = _Timed(driver._procs)
        backend = NvmlBackend(driver=driver)
        backend.sample()  # nvmlInit outside the timed rounds
        timers[loader] = {**driver._fns, driver.process_symbol: driver._procs,
                          "sample": _Timed(backend.sample)}
        for timer in timers[loader].values():
            timer.ms.clear()
        backends[loader] = backend
    try:
        with BusyPython(beside_python):
            for _ in range(calls):
                for by_name in timers.values():
                    by_name["sample"]()
    finally:
        for backend in backends.values():
            backend.close()
    return {loader: {name: quantiles_ms(t.ms) for name, t in by_name.items() if t.ms}
            for loader, by_name in timers.items()}


def process_table_times(uuid: str, beside_python: bool, rounds: int = NVML_SAMPLES) -> dict:
    """The process table of the card ``uuid`` read both ways through the
    port's binding, in turns, the order alternating each round: "pair", the
    sizing call with no table and then a table of the reported size plus
    PROCESS_TABLE_SLACK (the two calls pynvml makes); "single", the
    binding's own read, one call where the table fits. With
    ``beside_python``, beside one thread that runs Python throughout.
    Returns each way's median, p99 and max wall ms, its NVML calls and the
    pids of its last read; raises if the two ways read different pids."""
    import ctypes

    from tpu_pod_exporter_torch.backend import nvml_ctypes

    driver = nvml_ctypes.CtypesNvmlDriver()
    driver.nvmlInit()
    try:
        handle = next(h for h in map(driver.nvmlDeviceGetHandleByIndex,
                                     range(driver.nvmlDeviceGetCount()))
                      if driver.nvmlDeviceGetUUID(h) == uuid)
        procs = driver._procs = _Timed(driver._procs)

        def pair() -> list:
            count = ctypes.c_uint(0)
            ret = procs(handle, count, None)
            table = (nvml_ctypes.NvmlProcessInfo * 0)()
            if ret == nvml_ctypes.NVML_ERROR_INSUFFICIENT_SIZE:
                table = (nvml_ctypes.NvmlProcessInfo
                         * (count.value + nvml_ctypes.PROCESS_TABLE_SLACK))()
                count = ctypes.c_uint(len(table))
                ret = procs(handle, count, table)
            nvml_ctypes._check(ret)
            return sorted(row.pid for row in table[:count.value])

        def single() -> list:
            return sorted(row["pid"] for row in driver.nvmlDeviceGetComputeRunningProcesses(handle))

        ways = {"pair": pair, "single": single}
        wall = {name: [] for name in ways}
        calls = dict.fromkeys(ways, 0)
        pids = {}
        driver.nvmlDeviceGetComputeRunningProcesses(handle)  # sizes the single read
        with BusyPython(beside_python):
            for i in range(rounds):
                for name in (list(ways) if i % 2 == 0 else list(ways)[::-1]):
                    before = len(procs.ms)
                    t0 = time.perf_counter()
                    pids[name] = ways[name]()
                    wall[name].append((time.perf_counter() - t0) * 1e3)
                    calls[name] += len(procs.ms) - before
    finally:
        driver.nvmlShutdown()
    if pids["pair"] != pids["single"]:
        raise AssertionError(f"the process table's pair read pids {pids['pair']}, "
                             f"its single call {pids['single']}")
    return {name: {**quantiles_ms(wall[name]), "max": max(wall[name]),
                   "nvml_calls": calls[name], "pids": pids[name]} for name in ways}


def build_nvml_probe(out_dir: Path) -> Path:
    """NVML_PROBE_SOURCE written into ``out_dir`` and built there with gcc,
    its process-table slack and tries the port's binding's."""
    from tpu_pod_exporter_torch.backend import nvml_ctypes

    out_dir.mkdir(parents=True, exist_ok=True)
    src, binary = out_dir / "nvml_probe.c", out_dir / "nvml_probe"
    src.write_text(NVML_PROBE_SOURCE)
    proc = subprocess.run(
        ["gcc", "-O2", "-Wall", f"-DPROCESS_TABLE_SLACK={nvml_ctypes.PROCESS_TABLE_SLACK}",
         f"-DPROCESS_TABLE_TRIES={nvml_ctypes.PROCESS_TABLE_TRIES}", "-o", str(binary),
         str(src), "-ldl", "-lm"], capture_output=True, text=True, timeout=120)
    if proc.returncode != 0:
        raise AssertionError(f"the NVML probe did not build:\n{proc.stderr[-3000:]}")
    return binary


def probe_argv(binary: Path, period_ms: float, seconds: float,
               library: str | None = None) -> list:
    """The probe at ``period_ms`` for ``seconds``, on ``library`` (default
    libnvidia-ml.so.1)."""
    return [str(binary), f"{period_ms:g}", f"{seconds:g}", f"{DEVICE_READ_LIMIT_MS:g}",
            f"{PROBE_SLOW_CALL_MS:g}", *([library] if library else [])]


def probe_line(rc: int, out: str, err: str = "") -> dict:
    """The probe's JSON line from its output; raises unless it exited 0."""
    lines = [json.loads(ln) for ln in out.splitlines() if ln.startswith('{"probe"')]
    if rc != 0 or len(lines) != 1:
        raise AssertionError(f"the NVML probe exited {rc}:\n{out[-1500:]}\n{err[-1500:]}")
    return lines[0]


def run_probes(binary: Path, library: str | None = None) -> dict:
    """The probe at each period of PROBE_SECONDS, side by side, each for its
    time: {period ms: its JSON line}."""
    procs = {period: subprocess.Popen(probe_argv(binary, period, seconds, library),
                                      stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                      text=True)
             for period, seconds in PROBE_SECONDS.items()}
    lines = {}
    try:
        for period, proc in procs.items():
            out, err = proc.communicate(timeout=PROBE_SECONDS[period] + 30)
            lines[period] = probe_line(proc.returncode, out, err)
        return lines
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=10)


def kubelet_fixture(tmp: str, uuid: str) -> dict:
    """A synthetic kubelet checkpoint that gives the card ``uuid`` to the
    smoke pod, and the pod's UID map, written under ``tmp``; returns the
    exporter settings that read them."""
    ckpt, uids = Path(tmp, "kubelet_internal_checkpoint"), Path(tmp, "uids.json")
    ckpt.write_text(json.dumps({"Data": {"PodDeviceEntries": [
        {"PodUID": SMOKE_POD_UID, "ContainerName": "burn",
         "ResourceName": "nvidia.com/gpu", "DeviceIDs": {"-1": [uuid]}}]}}))
    uids.write_text(json.dumps({SMOKE_POD_UID: {"name": SMOKE_POD, "namespace": "smoke"}}))
    return {"attribution": "checkpoint", "checkpoint_path": str(ckpt),
            "uid_map_file": str(uids)}


def check_nvml_loop(report: dict, pid: int, label: str) -> None:
    """hwcheck's artifact on the NVML backend (process metrics, legacy
    metrics, the kubelet fixture's pod) under the fill and the burn: the
    card's memory rises by the fill and falls, its utilization rises, the
    process rows sum to the fill, ``pid`` holds the card, the pod's memory
    rises by the fill and the reference's {pid, pod} series is there."""
    idle, load = report["phases"]["idle"], report["phases"]["load"]
    checks = report["checks"]
    if not (report["ok"] and report["family"] == "gpu" and checks["hbm_rises_under_load"]
            and checks["hbm_falls_after_release"] and checks["duty_cycle_responds"]):
        raise AssertionError(f"{label} failed: {checks}")
    rise = load["hbm_used_bytes"] - idle["hbm_used_bytes"]
    if rise < FILL_BYTES:
        raise AssertionError(f"{label}: gpu_hbm_used_bytes rose {rise} B, less than the fill")
    if sum(load["process_memory_bytes"].values()) < FILL_BYTES:
        raise AssertionError(f"{label}: process rows {load['process_memory_bytes']} "
                             "sum under the fill")
    if str(pid) not in load["holder_pids"]:
        raise AssertionError(f"{label}: pid {pid} not among holders {load['holder_pids']}")
    pod_rise = (load["pod_memory_bytes"].get(SMOKE_POD, 0.0)
                - idle["pod_memory_bytes"].get(SMOKE_POD, 0.0))
    if pod_rise < FILL_BYTES:
        raise AssertionError(f"{label}: gpu_pod_memory_used_bytes{{pod={SMOKE_POD}}} "
                             f"rose {pod_rise} B")
    if not any(key.endswith("/" + SMOKE_POD) for key in load["legacy_pod_memory_bytes"]):
        raise AssertionError(f"{label}: no pod_gpu_memory_usage for {SMOKE_POD}: "
                             f"{load['legacy_pod_memory_bytes']}")


def phase_nvml(dev, tm, hwcheck, uuid: str) -> tuple:
    """The GPU node path on the card. Returns the launches by kernel of its
    closed loop and the NVML probe its hwcheck artifact carries."""
    import tempfile

    from tpu_pod_exporter_torch.app import build_backend
    from tpu_pod_exporter_torch.backend.nvml import NvmlBackend
    from tpu_pod_exporter_torch.backend.nvml_ctypes import CtypesNvmlDriver
    from tpu_pod_exporter_torch.backend.torchdev import _nvml_uuid
    from tpu_pod_exporter_torch.config import ExporterConfig

    driver = CtypesNvmlDriver()
    driver.nvmlInit()
    count = driver.nvmlDeviceGetCount()
    torch_uuid = _nvml_uuid(torch.cuda.get_device_properties(dev).uuid)
    handles = {driver.nvmlDeviceGetUUID(h): h
               for h in map(driver.nvmlDeviceGetHandleByIndex, range(count))}
    handle = handles.get(torch_uuid)
    minor = None if handle is None else driver.nvmlDeviceGetMinorNumber(handle)
    total_mib = None if handle is None else driver.nvmlDeviceGetMemoryInfo(handle)["total"] / 2**20
    driver.nvmlShutdown()
    smi_total = nvidia_smi("memory.total")
    held = held_card_nodes()
    emit("nvml_binding", count=count, uuid=torch_uuid, nvidia_smi_uuid=uuid,
         minor=minor, held_nodes=sorted(held), memory_total_mib=total_mib,
         nvidia_smi_memory_total=smi_total, process_symbol=driver.process_symbol)
    if not (count >= 1 and handle is not None and torch_uuid == uuid):
        raise AssertionError(f"NVML: {count} devices, none with torch's UUID {torch_uuid} "
                             f"(nvidia-smi {uuid})")
    if int(smi_total.split()[0]) != int(total_mib):
        raise AssertionError(f"NVML total {total_mib} MiB, nvidia-smi {smi_total}")
    node = f"/dev/nvidia{minor}"
    if held != {node}:
        raise AssertionError(f"minor {minor}, but this process holds {sorted(held)}")

    reset_counts(tm)
    with tempfile.TemporaryDirectory() as tmp:
        stim = hwcheck.TorchStimulus(hbm_bytes=FILL_BYTES, width=WIDTH, depth=DEPTH,
                                     batch=BATCH, iters=ITERS, device=dev)
        report = hwcheck.run_check(
            backend="nvml", idle_s=2.0, load_s=8.0, stimulus=stim,
            exporter_args={"process_metrics": True, "legacy_metrics": True,
                           "record_to": str(CAPTURE_DIR / "h100-trace.jsonl"),
                           **kubelet_fixture(tmp, torch_uuid)})
    by_kernel = launch_counts(tm)
    emit("nvml_closed_loop", report=report, pid=os.getpid(), launches_by_kernel=by_kernel,
         burn_steps=stim.steps)
    check_nvml_loop(report, os.getpid(), "nvml closed loop")
    if tm.tanh_matmul.launches <= 0:
        raise AssertionError("no tanh_matmul launch during the nvml load phase")
    check_all_wgmma(tm, "nvml closed loop", tm.tanh_matmul.launches)

    auto = build_backend(ExporterConfig(backend="auto"))
    auto_chips = auto.sample().chips if auto.name == "nvml" else ()
    auto.close()
    if len(auto_chips) < 1:
        raise AssertionError(f"--backend auto built {auto.name} with {len(auto_chips)} chips")

    backend = NvmlBackend()
    idle_sample = backend.sample().chips
    idle_ms = sample_ms(backend)
    calls = {"idle": nvml_call_times(False), "idle_beside_python": nvml_call_times(True)}
    tables = {"idle": process_table_times(torch_uuid, False),
              "idle_beside_python": process_table_times(torch_uuid, True)}
    probe = build_nvml_probe(PROBE_DIR)
    probes = {"idle": run_probes(probe)}
    stim = hwcheck.TorchStimulus(hbm_bytes=FILL_BYTES, width=WIDTH, depth=DEPTH,
                                 batch=BATCH, iters=ITERS, device=dev)
    stim.start()
    try:
        time.sleep(2.0)
        burn_ms = sample_ms(backend)
        (chip,) = [c for c in backend.sample().chips if c.info.device_ids[0] == torch_uuid]
        allocated, reserved = torch.cuda.memory_allocated(dev), torch.cuda.memory_reserved(dev)
        calls["burn"] = nvml_call_times(False)
        calls["burn_beside_python"] = nvml_call_times(True)
        tables["burn"] = process_table_times(torch_uuid, False)
        tables["burn_beside_python"] = process_table_times(torch_uuid, True)
        probes["burn"] = run_probes(probe)
    finally:
        stim.stop()
        backend.close()
    emit("nvml_calls", samples=NVML_SAMPLES, loaders=list(NVML_LOADERS),
         runs=calls, process_table=tables, card=card_line())
    for run, lines in probes.items():
        for line in lines.values():
            emit("nvml_probe", run=run, card=card_line(), **line)
    (idle_chip,) = [c for c in idle_sample if c.info.device_ids[0] == torch_uuid]
    emit("nvml_numbers", sample_ms_idle=idle_ms, sample_ms_burn=burn_ms,
         poll_phase_last_ms={phase: report["phases"][phase]["poll_phase_last_ms"]
                             for phase in ("idle", "load")},
         poll_phase_mean_ms=report["phases"]["release"]["poll_phase_mean_ms"],
         nvml_used_bytes=chip.hbm_used_bytes, allocator_allocated_bytes=allocated,
         allocator_reserved_bytes=reserved,
         nvml_minus_reserved_bytes=chip.hbm_used_bytes - reserved,
         utilization_idle=idle_chip.tensorcore_duty_cycle_percent,
         utilization_burn=chip.tensorcore_duty_cycle_percent,
         process_rows_burn={str(p.pid): p.used_bytes for p in chip.processes},
         auto=auto.name, auto_chips=len(auto_chips), device_path=chip.info.device_path)
    return by_kernel, report["probe"]


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def http_get(url: str, timeout: float = 5.0) -> tuple[int, bytes]:
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(url, timeout=timeout) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def wait_for(predicate, timeout_s: float, what: str, interval_s: float = 0.05,
             phase: str = "node state"):
    """Poll ``predicate`` until it returns a true value; raise naming
    ``phase`` and ``what`` when ``timeout_s`` passes first."""
    deadline = time.monotonic() + timeout_s
    while True:
        try:
            got = predicate()
        except OSError:  # the exporter is not listening yet
            got = None
        if got:
            return got
        if time.monotonic() > deadline:
            raise AssertionError(f"{phase}: {what} within {timeout_s:g} s")
        time.sleep(interval_s)


def samples_of(body: bytes, name: str) -> list:
    from tpu_pod_exporter_torch.metrics.parse import parse_exposition

    return [s for s in parse_exposition(body.decode()) if s.name == name]


def phase_buckets(body: bytes) -> dict:
    """{phase: {le: cumulative count}} of the exporter's poll-phase histogram."""
    out: dict = {}
    for s in samples_of(body, "tpu_exporter_poll_phase_duration_seconds_bucket"):
        out.setdefault(s.labels["phase"], {})[float(s.labels["le"])] = s.value
    return out


def bucket_quantile(q: float, buckets: dict) -> float | None:
    """Prometheus' histogram_quantile: linear inside the bucket that holds
    rank q of the count; the highest finite bound past the last one."""
    total = buckets.get(math.inf, 0.0)
    if total <= 0:
        return None
    rank = q * total
    prev_le, prev_count = 0.0, 0.0
    for le in sorted(buckets):
        count = buckets[le]
        if count >= rank:
            if le == math.inf:
                return prev_le
            return prev_le + (le - prev_le) * (rank - prev_count) / (count - prev_count)
        prev_le, prev_count = le, count
    return prev_le


def quantile_ms(q: float, buckets: dict) -> float | None:
    value = bucket_quantile(q, buckets)
    return None if value is None else 1e3 * value


def exporter_latency(body: bytes) -> dict:
    """An exporter's poll phases and served scrapes from its own histograms
    in ``body``: p50/p99 ms of each phase and of a scrape, the poll and
    scrape counts, and device_read's cumulative polls by bucket bound (ms)."""
    phases = phase_buckets(body)
    out: dict = {phase: {f"p{round(q * 100)}_ms": quantile_ms(q, phases[phase])
                         for q in (0.5, 0.99)}
                 for phase in POLL_PHASES if phase in phases}
    out["polls"] = phases.get("total", {}).get(math.inf)
    scrape = {float(s.labels["le"]): s.value
              for s in samples_of(body, "tpu_exporter_scrape_duration_seconds_bucket")}
    out["scrape"] = {"p50_ms": quantile_ms(0.5, scrape), "p99_ms": quantile_ms(0.99, scrape),
                     "scrapes": scrape.get(math.inf)}
    out["device_read_buckets_ms"] = {str(1e3 * le): n
                                     for le, n in sorted(phases.get("device_read", {}).items())}
    return out


def emit_device_read(where: str, p99_ms: dict, **fields) -> None:
    """One line of phase ``where``'s device_read p99 (by exporter) beside
    PERF.md's limit. Printed, not gated: a phase over the limit names its
    cause in ROADMAP.md."""
    emit("device_read", where=where, p99_ms=p99_ms,
         limit_ms=DEVICE_READ_LIMIT_MS,
         within_limit={k: v is not None and v <= DEVICE_READ_LIMIT_MS
                       for k, v in p99_ms.items()},
         card=card_line(), **fields)


def host_ms_in_turns(fns: dict, reps: int = 20) -> dict:
    """Median host ms a call of each function, called in turns."""
    times: dict = {name: [] for name in fns}
    for _ in range(reps):
        for name, fn in fns.items():
            t0 = time.perf_counter()
            fn()
            times[name].append((time.perf_counter() - t0) * 1e3)
    return {name: statistics.median(t) for name, t in times.items()}


def render_parity(body: bytes) -> tuple[int, dict]:
    """The served sample lines, rendered again natively through
    ``render_layout`` and in Python through ``format_value``: all three must
    be the same bytes. Returns the number of lines and each render's
    median host ms."""
    from array import array

    from tpu_pod_exporter_torch.metrics import native
    from tpu_pod_exporter_torch.metrics.registry import FamilyLayout, format_value

    lines = [ln + b"\n" for ln in body.splitlines() if ln and not ln.startswith(b"#")]
    prefixes, texts = zip(*(ln[:-1].rsplit(b" ", 1) for ln in lines))
    values = array("d", map(float, texts))
    layout = FamilyLayout(tuple((str(i),) for i in range(len(lines))), list(prefixes))

    def python_render() -> bytes:
        return b"".join(p + b" " + format_value(v).encode() + b"\n"
                        for p, v in zip(prefixes, values))

    native_bytes = native.render_layout(layout, values)
    served = b"".join(lines)
    if native_bytes is None or not native_bytes == python_render() == served:
        raise AssertionError("node state: the native render, the Python render and the "
                             "served exposition differ")
    return len(lines), host_ms_in_turns({"native": lambda: native.render_layout(layout, values),
                                         "python": python_render}, reps=200)


class _Counted:
    """Counts a bound method's calls and its non-None results."""

    def __init__(self, fn):
        self.fn, self.calls, self.results = fn, 0, 0

    def __call__(self, *args, **kwargs):
        self.calls += 1
        out = self.fn(*args, **kwargs)
        self.results += out is not None
        return out


def poll_phase_segments(app, base: str, nativelib) -> dict:
    """The live exporter under the burn, in alternating segments of equal
    length with the native library on and off (``nativelib.load`` answering
    None makes every caller take its Python path, as on a node without the
    library). Returns per mode the poll-phase p50/p99 from the exporter's
    own histogram (bucket counts added over the mode's segments; the first
    poll is before every segment), polls, full walks by path, and the
    device read's own time on the supervisor's worker (the device_read
    phase less that is the handoff to and from the worker)."""
    scanner = app.process_scanner
    native_walk = scanner._native_full_scan = _Counted(scanner._native_full_scan)
    python_walk = scanner._python_full_scan = _Counted(scanner._python_full_scan)
    device = app.supervisors["device"]
    in_worker = device._fn = _Timed(device._fn)
    load = nativelib.load
    sums = {mode: {} for mode in ("native", "python")}
    walks = {mode: {"native": 0, "python": 0, "full_scans": 0} for mode in sums}
    worker_ms: dict = {mode: [] for mode in sums}
    try:
        for mode in NODE_STATE_MODES:
            nativelib.load = load if mode == "native" else (lambda: None)
            time.sleep(2 * NODE_STATE_INTERVAL_S)  # the poll in flight ends
            before = phase_buckets(http_get(base + "/metrics")[1])
            counts = (native_walk.results, python_walk.calls, scanner.full_scans)
            first = len(in_worker.ms)
            time.sleep(NODE_STATE_SEGMENT_S)
            worker_ms[mode] += in_worker.ms[first:]
            after = phase_buckets(http_get(base + "/metrics")[1])
            walks[mode]["native"] += native_walk.results - counts[0]
            walks[mode]["python"] += python_walk.calls - counts[1]
            walks[mode]["full_scans"] += scanner.full_scans - counts[2]
            for phase in POLL_PHASES:
                acc = sums[mode].setdefault(phase, {})
                for le, n in after[phase].items():
                    acc[le] = acc.get(le, 0.0) + n - before.get(phase, {}).get(le, 0.0)
    finally:
        nativelib.load = load
    out = {}
    for mode, by_phase in sums.items():
        out[mode] = {"polls": by_phase["total"][math.inf], **walks[mode]}
        for phase, buckets in by_phase.items():
            out[mode][phase] = {f"p{round(q * 100)}_ms": 1e3 * bucket_quantile(q, buckets)
                                for q in (0.5, 0.99)}
        out[mode]["device_read_buckets_ms"] = {
            str(1e3 * le): n for le, n in sorted(by_phase["device_read"].items())}
        out[mode]["device_sample_in_worker_ms"] = quantiles_ms(worker_ms[mode])
    if walks["native"]["python"] or not walks["native"]["native"]:
        raise AssertionError(f"node state: the native segments walked /proc {walks['native']}")
    if walks["python"]["native"] or not walks["python"]["python"]:
        raise AssertionError(f"node state: the Python segments walked /proc {walks['python']}")
    return out


def ledger_receiver():
    """A ChaosReceiver with no fault rules whose ledger also keeps each
    acked sample's value by (labels, timestamp ms): the ledger the egress
    demo reads, plus the values to hold against the exporter's history."""
    from tpu_pod_exporter_torch.chaos import ChaosReceiver
    from tpu_pod_exporter_torch.egress import parse_write_request, snappy_decompress

    class LedgerReceiver(ChaosReceiver):
        def __init__(self) -> None:
            super().__init__([])
            self.values: dict = {}

        def _accept(self, h, body: bytes) -> None:
            before = self.stats()["requests"]
            super()._accept(h, body)
            if self.stats()["requests"] > before:  # acked and in the ledger
                for labels, samples in parse_write_request(snappy_decompress(body)):
                    for value, ts_ms in samples:
                        self.values[(tuple(sorted(labels.items())), ts_ms)] = value

    return LedgerReceiver()


def phase_node_state(dev, tm, hwcheck, uuid: str, libtpumon: Path) -> dict:
    """Phase 13 under the full-size load held by this process: the native
    path taken and equal to the Python one; history continuous across a
    SIGKILL; egress with no loss and no acked re-send; recovery after three
    injected NVML errors. Returns the launches by kernel of its load."""
    import signal
    import tempfile

    from tpu_pod_exporter_torch import nativelib
    from tpu_pod_exporter_torch.app import ExporterApp
    from tpu_pod_exporter_torch.backend.torchdev import nvml_minors
    from tpu_pod_exporter_torch.config import ExporterConfig
    from tpu_pod_exporter_torch.procscan import GPU_DEVICE_PREFIXES, ProcScanner

    t_phase = time.monotonic()
    nativelib.reset_for_tests()
    lib = nativelib.load()
    loaded = None if lib is None else Path(lib._name)
    if loaded != libtpumon:
        raise AssertionError(f"node state: nativelib.load() gave {loaded}, not {libtpumon}")
    node = f"/dev/nvidia{nvml_minors()[uuid]}"

    reset_counts(tm)
    stim = hwcheck.TorchStimulus(hbm_bytes=FILL_BYTES, width=WIDTH, depth=DEPTH,
                                 batch=BATCH, iters=ITERS, device=dev)
    procs: list = []
    recv = ledger_receiver()
    recv.start()  # before the try: its stop() waits for a started server
    tmp = tempfile.TemporaryDirectory()
    stim.start()
    try:
        kubelet = kubelet_fixture(tmp.name, uuid)

        # (a) native: the walks over this machine's /proc, then the live
        # exporter's exposition and its poll phases by path.
        scanner = ProcScanner(device_prefixes=GPU_DEVICE_PREFIXES)
        walk_native, walk_python = scanner._native_full_scan(), scanner._python_full_scan()
        mine = walk_native.get(os.getpid(), ()) if walk_native is not None else ()
        if walk_native is None or walk_native != walk_python:
            raise AssertionError(f"node state: /proc walks differ: native {walk_native}, "
                                 f"Python {walk_python}")
        if [h.device_path for h in mine] != [node]:
            raise AssertionError(f"node state: this process holds {mine}, not {node} alone")
        walk_ms = host_ms_in_turns({"native": scanner._native_full_scan,
                                    "python": scanner._python_full_scan})
        app = ExporterApp(ExporterConfig(port=0, host="127.0.0.1", backend="nvml",
                                         process_metrics=True,
                                         interval_s=NODE_STATE_INTERVAL_S, **kubelet))
        app.start()
        try:
            base = f"http://127.0.0.1:{app.port}"
            body = http_get(base + "/metrics")[1]
            lines, render_ms = render_parity(body)
            segments = poll_phase_segments(app, base, nativelib)
        finally:
            app.stop()
        emit("node_state_native", library=str(loaded.relative_to(REPO)), node=node,
             holders={str(pid): [h.device_path for h in hs] for pid, hs in walk_native.items()},
             proc_entries=sum(e.isdigit() for e in os.listdir("/proc")),
             full_walk_ms=walk_ms, render_lines=lines, render_ms=render_ms,
             segment_s=NODE_STATE_SEGMENT_S, interval_s=NODE_STATE_INTERVAL_S,
             modes=list(NODE_STATE_MODES), poll_phase_ms=segments)
        emit_device_read("node_state", {mode: segments[mode]["device_read"]["p99_ms"]
                                        for mode in segments},
                         polls={mode: segments[mode]["polls"] for mode in segments},
                         sample_in_worker_ms={mode: segments[mode]["device_sample_in_worker_ms"]
                                              for mode in segments},
                         device_read_buckets_ms={mode: segments[mode]["device_read_buckets_ms"]
                                                 for mode in segments})

        # (b) and (c): a subprocess exporter on a state dir and egress,
        # SIGKILLed mid-poll by chaos, then restarted on the same dirs.
        port = free_port()
        url = f"http://127.0.0.1:{port}"
        state_dir, egress_dir = Path(tmp.name, "state"), Path(tmp.name, "egress")
        log_path = Path(tmp.name, "exporter.log")
        args = [sys.executable, "-m", "tpu_pod_exporter_torch", "--host", "127.0.0.1",
                "--port", str(port), "--interval-s", str(NODE_STATE_RUN_INTERVAL_S),
                "--log-level", "warning", "--backend", "nvml", "--process-metrics",
                "--attribution", "checkpoint", "--checkpoint-path", kubelet["checkpoint_path"],
                "--uid-map-file", kubelet["uid_map_file"], "--state-dir", str(state_dir),
                "--state-fsync-interval-s", "0", "--egress-url", recv.url,
                "--egress-dir", str(egress_dir), "--egress-interval-s", "0"]

        def start(spec: str):
            log = open(log_path, "ab")
            procs.append(subprocess.Popen(args + ["--chaos-spec", spec], cwd=REPO,
                                          stdout=log, stderr=subprocess.STDOUT))
            log.close()
            return procs[-1]

        def ready():
            status, body = http_get(url + "/readyz")
            return status == 200 and json.loads(body).get("ready") is True

        def used() -> float | None:
            rows = samples_of(http_get(url + "/metrics")[1], "gpu_hbm_used_bytes")
            return rows[0].value if len(rows) == 1 else None

        t_start = time.time()
        first = start(f"kill:device:1:@{NODE_STATE_KILL_AT}:x1")
        wait_for(ready, 30, "the first run ready")
        used_before = wait_for(used, 10, "gpu_hbm_used_bytes in the first run")
        first.wait(timeout=60)
        t_killed = time.time()
        if first.returncode != -signal.SIGKILL:
            raise AssertionError(f"node state: the first run exited {first.returncode}, "
                                 "not by SIGKILL\n" + log_path.read_text()[-2000:])

        # (d) in the second run: three NVML errors on the device source.
        second = start(f"err:device:1:nvml=gpu_is_lost:@{NODE_STATE_ERRORS_AT}:x3")
        wait_for(ready, 30, "the restarted run ready")
        t_ready = time.time()
        restore = json.loads(http_get(url + "/debug/vars")[1]).get("persist", {}).get("restore")
        history = json.loads(http_get(
            url + f"/api/v1/query_range?metric=gpu_hbm_used_bytes"
                  f"&start={t_start - 5:.3f}&end={time.time() + 1:.3f}")[1])["data"]["result"]
        points = [(t, v) for row in history for t, v in row["values"]]
        before_kill = [v for t, v in points if t <= t_killed]
        if not (len(history) == 1 and before_kill and max(before_kill) >= FILL_BYTES):
            raise AssertionError(f"node state: the history across the kill: {len(history)} "
                                 f"series, pre-kill values {before_kill[-5:]}")

        def injected():
            doc = json.loads(http_get(url + "/debug/vars")[1])
            return len(doc.get("chaos", {}).get("device", {}).get("injected", [])) == 3

        wait_for(injected, 30, "three injected NVML errors")
        t_errors = time.time()

        def device_errors() -> list:
            return [s.value for s in samples_of(http_get(url + "/metrics")[1],
                                                "tpu_exporter_poll_errors_total")
                    if s.labels.get("source") == "device_read"]

        wait_for(lambda: sum(device_errors()) >= 3, 10, "three device errors counted")
        errors = device_errors()
        wait_for(lambda: (used() or 0.0) >= FILL_BYTES and samples_of(
            http_get(url + "/metrics")[1], "tpu_exporter_up")[0].value == 1.0,
            30, "the card's used memory after the errors")
        t_recovered = time.time()
        used_after = used()
        breaker = json.loads(http_get(url + "/debug/vars")[1])["supervisors"]["device"]
        wait_for(lambda: samples_of(http_get(url + "/metrics")[1],
                                    "tpu_exporter_egress_backlog_batches")[0].value == 0.0,
                 30, "the egress backlog drained")
        history = json.loads(http_get(
            url + f"/api/v1/query_range?metric=gpu_hbm_used_bytes"
                  f"&start={t_start - 5:.3f}&end={time.time() + 1:.3f}")[1])["data"]["result"]
        second.send_signal(signal.SIGTERM)
        second.wait(timeout=30)
        seen = {int(t * 1000): v for row in history for t, v in row["values"]}
        shipped = {ts: v for (labels, ts), v in recv.values.items()
                   if dict(labels).get("__name__") == "gpu_hbm_used_bytes"}
        matched = [ts for ts in shipped if ts in seen]
        stats = recv.stats()
        seqs = stats["accepted_seqs"]
        missing = sorted(set(range(min(seqs), max(seqs) + 1)) - set(seqs)) if seqs else None
        ledger = {"batches": len(seqs), "seq_first": min(seqs, default=None),
                  "seq_last": max(seqs, default=None), "missing_seqs": missing,
                  "duplicate_seqs": stats["duplicate_seqs"],
                  "duplicate_samples": stats["duplicate_samples"],
                  "accepted_samples": stats["accepted_samples"],
                  "gpu_hbm_used_bytes_samples": len(shipped),
                  "matched_in_history": len(matched),
                  "shipped_before_kill": sum(ts <= t_killed * 1000 for ts in shipped)}
        emit("node_state_restart", used_before_kill=used_before, kill_at_call=NODE_STATE_KILL_AT,
             killed_after_s=t_killed - t_start, restart_ready_after_s=t_ready - t_killed,
             restore=restore, history_points=len(points), before_kill_points=len(before_kill),
             before_kill_max=max(before_kill), second_rc=second.returncode)
        emit("node_state_egress", ledger=ledger)
        emit("node_state_chaos", spec=f"err:device:1:nvml=gpu_is_lost:@{NODE_STATE_ERRORS_AT}:x3",
             device_errors=errors, recovered_after_s=t_recovered - t_errors,
             used_after=used_after, breaker_transitions=breaker["transitions"],
             reconnects=breaker["reconnects"])
        if missing or stats["duplicate_seqs"] or stats["duplicate_samples"]:
            raise AssertionError(f"node state: egress lost or re-sent batches: {ledger}")
        if not ledger["shipped_before_kill"] or not matched or any(
                shipped[ts] != seen[ts] for ts in matched):
            raise AssertionError(f"node state: the ledger's gpu_hbm_used_bytes against the "
                                 f"exporter's history: {ledger}")
        if max(shipped.values()) < FILL_BYTES:
            raise AssertionError("node state: no shipped sample at the filled level")
        if errors != [3.0]:
            raise AssertionError(f"node state: device errors counted {errors}, not [3]")
        if second.returncode != 0:
            raise AssertionError(f"node state: the restarted run exited {second.returncode}")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=10)
        recv.stop()
        stim.stop()
        tmp.cleanup()
    launches = tm.tanh_matmul.launches
    by_kernel = launch_counts(tm)
    emit("node_state", seconds=time.monotonic() - t_phase, burn_steps=stim.steps,
         launches_by_kernel=by_kernel)
    if launches <= 0:
        raise AssertionError("no tanh_matmul launch during the node state phase")
    check_all_wgmma(tm, "node state", launches)
    return by_kernel


class WebhookReceiver:
    """An in-process alert webhook: keeps each POST's receipt time,
    ``X-Tpe-Alert-Seq`` header and JSON body, and answers 200."""

    def __init__(self) -> None:
        import http.server
        import threading

        received = self.received = []
        lock = self.lock = threading.Lock()

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_POST(self) -> None:  # noqa: N802 — http.server's casing
                body = self.rfile.read(int(self.headers.get("Content-Length", 0)))
                with lock:
                    received.append({"wall": time.time(),
                                     "seq": self.headers.get("X-Tpe-Alert-Seq"),
                                     "body": json.loads(body or b"{}")})
                self.send_response(200)
                self.send_header("Content-Length", "0")
                self.end_headers()

            def log_message(self, *args) -> None:
                pass

        self.server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.url = f"http://127.0.0.1:{self.server.server_address[1]}/alerts"
        self.thread = threading.Thread(target=self.server.serve_forever, daemon=True)

    def start(self) -> None:
        self.thread.start()

    def stop(self) -> None:
        self.server.shutdown()
        self.server.server_close()

    def posts(self) -> list:
        with self.lock:
            return list(self.received)


class SseReader:
    """The port's stream client read on a thread: each frame with its
    receipt time. ``stop`` ends the read and closes the stream."""

    def __init__(self, port: int, metric: str, window_s: float) -> None:
        import threading

        from tpu_pod_exporter_torch.stream import QueryShape, StreamClient

        self.frames: list = []
        self.client = StreamClient("127.0.0.1", port, QueryShape(
            route="window_stats", metric=metric, window_s=window_s))
        self.done = threading.Event()
        self.thread = threading.Thread(target=self._read, daemon=True)
        self.thread.start()

    def _read(self) -> None:
        while not self.done.is_set() and not self.client.eof:
            for frame in self.client.frames(timeout_s=0.2):
                self.frames.append((time.time(), frame))

    def stop(self) -> list:
        self.done.set()
        self.thread.join(timeout=10)
        self.client.close()
        return self.frames


def thread_schedstat(pid: int) -> dict:
    """{tid: [on-CPU ns, run-queue wait ns, timeslices]} of each thread of a
    live process, from /proc/<pid>/task/<tid>/schedstat; {} where the
    kernel keeps no such file."""
    out = {}
    try:
        tids = os.listdir(f"/proc/{pid}/task")
    except OSError:
        return out
    for tid in tids:
        try:
            with open(f"/proc/{pid}/task/{tid}/schedstat") as f:
                out[int(tid)] = [int(x) for x in f.read().split()[:3]]
        except (OSError, ValueError):  # the thread has exited, or no schedstat
            continue
    return out


def run_queue_wait(before: dict, after: dict, seconds: float, tids=()) -> dict:
    """What a process's threads waited on the run queue between two
    ``thread_schedstat`` reads ``seconds`` apart: in all, a second, the
    threads', the largest thread's, a timeslice on average, and the
    threads ``tids`` (those that called NVML) each."""
    if not after:
        return {"schedstat": False}
    zero = [0, 0, 0]
    delta = {tid: [a - b for a, b in zip(now, before.get(tid, zero))]
             for tid, now in after.items()}
    wait = sum(d[1] for d in delta.values()) / 1e6
    slices = sum(d[2] for d in delta.values())
    return {"schedstat": True, "seconds": seconds, "threads": len(delta),
            "wait_ms": wait, "wait_ms_per_s": wait / seconds,
            "on_cpu_ms": sum(d[0] for d in delta.values()) / 1e6, "timeslices": slices,
            "wait_ms_per_timeslice": wait / slices if slices else None,
            "largest_thread_wait_ms": max(d[1] for d in delta.values()) / 1e6,
            "nvml_threads_wait_ms": {str(t): delta[t][1] / 1e6 for t in tids if t in delta}}


def proc_usage(pid: int) -> tuple[float, float]:
    """(user + system CPU seconds, resident bytes) of a live process, from
    /proc/<pid>/stat and /proc/<pid>/status."""
    with open(f"/proc/{pid}/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    cpu_s = (int(fields[11]) + int(fields[12])) / os.sysconf("SC_CLK_TCK")
    rss = 0.0
    with open(f"/proc/{pid}/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                rss = float(line.split()[1]) * 1024
    return cpu_s, rss


class HostCpu:
    """The host's CPU, read every HOST_READ_S on a thread for as long as the
    block: each reading is (time.monotonic(), /proc/stat's busy and total
    ticks, /proc/loadavg's 1-minute load and its running/total tasks, the
    user and system ticks of every process in /proc), from ``start()`` to
    ``close()``."""

    def __init__(self) -> None:
        import threading

        self.readings: list = []
        self.stop = threading.Event()
        self.thread = threading.Thread(target=self.run, name="host-cpu", daemon=True)

    @staticmethod
    def read() -> tuple:
        with open("/proc/stat") as f:
            ticks = [int(x) for x in f.readline().split()[1:9]]
        with open("/proc/loadavg") as f:
            load = f.read().split()
        processes = 0
        for pid in os.listdir("/proc"):
            if not pid.isdigit():
                continue
            try:
                with open(f"/proc/{pid}/stat") as f:
                    fields = f.read().rsplit(")", 1)[1].split()
            except OSError:  # the process has exited
                continue
            processes += int(fields[11]) + int(fields[12])
        # busy: all but idle and iowait
        return (time.monotonic(), sum(ticks) - ticks[3] - ticks[4], sum(ticks),
                float(load[0]), load[3], processes)

    def run(self) -> None:
        self.readings.append(self.read())
        while not self.stop.wait(HOST_READ_S):
            self.readings.append(self.read())

    def start(self) -> None:
        self.thread.start()

    def close(self) -> None:
        self.stop.set()
        if self.thread.ident is not None:
            self.thread.join(timeout=10)


def host_between(a: tuple, b: tuple, cpus: int) -> dict:
    """The host's CPU between two HostCpu readings: /proc/stat's busy share
    (None where its ticks did not move), the processes' busy share of
    ``cpus`` cores, and the load and tasks of the later reading."""
    dt = b[0] - a[0]
    return {"stat_busy_share": (b[1] - a[1]) / (b[2] - a[2]) if b[2] > a[2] else None,
            "process_busy_share": ((b[5] - a[5]) / (dt * os.sysconf("SC_CLK_TCK") * cpus)
                                   if dt > 0 else None),
            "load1": b[3], "tasks": b[4]}


def stall_timeline(exporter: list, probes: dict, readings: list, t0: float,
                   cpus: int) -> dict:
    """The node exporter's slow samples (its timing bootstrap's, each with
    ``start_s``, ``wall_ms``, ``cpu_ms`` and its ``calls``) and each probe's
    (``probes``: name -> its JSON line) on one CLOCK_MONOTONIC time line from
    ``t0``. Each carries the other processes' probe calls over
    PROBE_SLOW_CALL_MS that overlap it and the host's CPU between the
    readings around it; the exporter's, the call that held most of it."""
    def around(start: float, end: float) -> dict:
        before = [r for r in readings if r[0] <= start]
        after = [r for r in readings if r[0] >= end]
        return host_between(before[-1], after[0], cpus) if before and after else {}

    calls = [(name, c) for name, line in probes.items() for c in line["slow_calls"]]
    events = []
    for who, samples in (("exporter", exporter),
                         *((name, line["slow_samples"]) for name, line in probes.items())):
        for sample in samples:
            start = sample["start_s"]
            end = start + sample["wall_ms"] / 1e3
            event = {"t_s": start - t0, "who": who, "wall_ms": sample["wall_ms"],
                     "cpu_ms": sample["cpu_ms"],
                     "probe_calls_over_slow": [
                         [name, c["call"], c["start_s"] - t0, c["wall_ms"]] for name, c in calls
                         if name != who and c["start_s"] < end
                         and c["start_s"] + c["wall_ms"] / 1e3 > start],
                     **around(start, end)}
            if who == "exporter" and sample["calls"]:
                event["held_by"] = max(sample["calls"], key=lambda c: c[1])[:2]
            events.append(event)
    events.sort(key=lambda e: e["t_s"])
    window = [host_between(a, b, cpus) for a, b in zip(readings, readings[1:])]

    def spread(key: str) -> dict | None:
        values = sorted(w[key] for w in window if w[key] is not None)
        return None if not values else {
            "median": values[len(values) // 2],
            "p99": values[math.ceil(0.99 * len(values)) - 1], "max": values[-1]}

    mine = [e for e in events if e["who"] == "exporter"]
    return {"cpus": cpus, "readings": len(readings),
            "window_s": readings[-1][0] - readings[0][0] if readings else 0.0,
            "stat_busy_share": spread("stat_busy_share"),
            "process_busy_share": spread("process_busy_share"),
            "loadavg": sorted({r[3] for r in readings}),
            "exporter_slow": len(mine),
            "exporter_slow_beside_probe_call": sum(bool(e["probe_calls_over_slow"])
                                                   for e in mine),
            "probe_slow": {name: line["over_limit"] for name, line in probes.items()},
            "probe_calls_over_slow": {name: line["slow_calls_total"]
                                      for name, line in probes.items()},
            "events": events}


def parsed(body: bytes) -> list:
    from tpu_pod_exporter_torch.metrics.parse import parse_exposition

    return list(parse_exposition(body.decode()))


def rollups(rows: list, prefixes=("tpu_slice_", "tpu_fleet_family_")) -> dict:
    """{(name, sorted labels): value} of the parsed samples whose name starts
    with one of ``prefixes``."""
    return {(s.name, tuple(sorted(s.labels.items()))): s.value
            for s in rows if s.name.startswith(prefixes)}


def pick(table: dict, name: str, **labels) -> float | None:
    """The one value of ``name`` in a ``rollups`` table whose labels include
    ``labels``; None when there is none."""
    hits = [v for (n, lab), v in table.items()
            if n == name and all(dict(lab).get(k) == x for k, x in labels.items())]
    if len(hits) > 1:
        raise AssertionError(f"fleet: {len(hits)} series of {name}{labels}")
    return hits[0] if hits else None


def nearest_rank_ms(values: list) -> dict:
    """p50 and p99 (nearest rank) in ms of durations in seconds."""
    ordered = sorted(values)
    return {"rounds": len(ordered), **{
        f"p{round(q * 100)}_ms": ordered[math.ceil(q * len(ordered)) - 1] * 1e3
        for q in (0.5, 0.99)}}


def fleet_node_argv(port: int, kubelet: dict) -> list:
    """The real node of phase 14: the port's exporter on the card through
    NVML, with the process scan and checkpoint attribution, under
    NVML_TIMING_BOOTSTRAP."""
    node, pool = FLEET_REAL_NODE
    return [sys.executable, "-c", NVML_TIMING_BOOTSTRAP, "--host", "127.0.0.1",
            "--port", str(port), "--interval-s", str(FLEET_INTERVAL_S),
            "--log-level", "warning", "--backend", "nvml", "--process-metrics",
            "--attribution", "checkpoint", "--checkpoint-path", kubelet["checkpoint_path"],
            "--uid-map-file", kubelet["uid_map_file"], "--slice-name", pool,
            "--node-name", node, "--accelerator", FLEET_ACCELERATOR]


def fleet_status_node_argv(kubelet: dict) -> list:
    """``status`` in node mode on the card, as an operator runs it there."""
    return [sys.executable, "-m", "tpu_pod_exporter_torch.status", "--backend", "nvml",
            "--process-metrics", "--attribution", "checkpoint",
            "--checkpoint-path", kubelet["checkpoint_path"],
            "--uid-map-file", kubelet["uid_map_file"], "--json"]


# Phase 14's simulated nodes in one process: the port's ExporterApp on the
# simulated NVML driver, FLEET_SIM_GPUS cards each. Prints the ports as one
# JSON line, serves until SIGTERM, then stops every app and exits 0.
SIM_NODES_CODE = """
import json, signal, sys, threading
from tpu_pod_exporter_torch.app import ExporterApp
from tpu_pod_exporter_torch.config import ExporterConfig
nodes, gpus, accelerator, interval = json.loads(sys.argv[1])
done = threading.Event()
signal.signal(signal.SIGTERM, lambda *_: done.set())
apps = []
for node, pool in nodes:
    app = ExporterApp(ExporterConfig(
        port=0, host="127.0.0.1", backend="nvml", nvml_sim_gpus=gpus,
        attribution="none", slice_name=pool, node_name=node,
        accelerator=accelerator, interval_s=interval, log_level="warning"))
    app.start()
    apps.append(app)
print(json.dumps([app.port for app in apps]), flush=True)
done.wait()
for app in apps:
    app.stop()
"""


def phase_fleet(dev, tm, hwcheck, uuid: str) -> dict:
    """Phase 14 under the full-size load held by this process: the real
    node and fifteen simulated ones, scraped by a flat aggregator and by a
    two-leaf shard tree whose root keeps a store, evaluates an alert and
    serves a stream, beside a replica; ``status`` over the tree and on the
    node. Returns the launches by kernel of its load."""
    import signal
    import tempfile

    t_phase = time.monotonic()
    node_name, pool_a = FLEET_REAL_NODE
    pool_b = next(p for p in FLEET_POOLS if p != pool_a)
    sim_nodes = [(f"node-{i:02d}", pool_a if i < FLEET_HOSTS_PER_POOL else pool_b)
                 for i in range(1, 2 * FLEET_HOSTS_PER_POOL)]
    cards = {pool_a: 1 + (FLEET_HOSTS_PER_POOL - 1) * FLEET_SIM_GPUS,
             pool_b: FLEET_HOSTS_PER_POOL * FLEET_SIM_GPUS}
    tmp = tempfile.TemporaryDirectory()
    procs: dict = {}
    logs: dict = {}

    def spawn(name: str, argv: list, stdout=None) -> subprocess.Popen:
        logs[name] = Path(tmp.name, f"{name}.log")
        with open(logs[name], "wb") as log:
            procs[name] = subprocess.Popen(argv, cwd=REPO, stdout=stdout or log, stderr=log)
        return procs[name]

    def fail(msg: str):
        tails = {name: path.read_text(errors="replace")[-1500:]
                 for name, path in logs.items() if path.exists()}
        raise AssertionError(f"fleet: {msg}\nlogs: {json.dumps(tails, indent=1)}")

    def tier(module: str, port: int, *args: str) -> list:
        return [sys.executable, "-m", f"tpu_pod_exporter_torch.{module}", "--host",
                "127.0.0.1", "--port", str(port), "--interval-s", str(FLEET_INTERVAL_S),
                "--log-level", "warning", *args]

    def metrics(port: int) -> bytes:
        status, body = http_get(f"http://127.0.0.1:{port}/metrics")
        if status != 200:
            raise OSError(f"/metrics on {port} answered {status}")
        return body

    def usage_now() -> dict:
        return {"t": time.time(),
                "procs": {name: proc_usage(proc.pid) for name, proc in procs.items()},
                "node_threads": thread_schedstat(procs["node"].pid)}

    def pod_filled(body: bytes) -> bytes | None:
        pod = [s.value for s in samples_of(body, "gpu_pod_memory_used_bytes")
               if s.labels.get("pod") == SMOKE_POD]
        return body if pod and max(pod) >= FILL_BYTES else None

    reset_counts(tm)
    stim = hwcheck.TorchStimulus(hbm_bytes=FILL_BYTES, width=WIDTH, depth=DEPTH,
                                 batch=BATCH, iters=ITERS, device=dev)
    host = HostCpu()
    probes = [f"probe_{period:g}ms" for period in PROBE_SECONDS]
    receiver = WebhookReceiver()
    receiver.start()  # before the try: its stop() waits for a started server
    stream = None
    try:
        kubelet = kubelet_fixture(tmp.name, uuid)
        # The probes beside the real node for as long as it is polled, and
        # the host's CPU read over the same window.
        probe = build_nvml_probe(PROBE_DIR)
        host.start()
        for period in PROBE_SECONDS:
            spawn(f"probe_{period:g}ms", probe_argv(probe, period, PROBE_MAX_SECONDS))
        # The nodes: the real one on the card, the simulated ones in a helper.
        node_port = free_port()
        spawn("node", fleet_node_argv(node_port, kubelet))
        helper = spawn("sim_nodes", [sys.executable, "-c", SIM_NODES_CODE, json.dumps(
            [sim_nodes, FLEET_SIM_GPUS, FLEET_ACCELERATOR, FLEET_INTERVAL_S])],
            stdout=subprocess.PIPE)
        sim_ports = json.loads(helper.stdout.readline() or "null")
        if not sim_ports:
            fail("the simulated nodes did not start")
        sim_targets = {f"127.0.0.1:{port}": node for port, node in zip(sim_ports, sim_nodes)}
        node_target = f"127.0.0.1:{node_port}"
        targets = ",".join([node_target, *sim_targets])
        node_body = wait_for(lambda: metrics(node_port), 30, "the real node's /metrics",
                             phase="fleet")
        node_rows = samples_of(node_body, "gpu_hbm_used_bytes")
        held = held_card_nodes()
        if len(node_rows) != 1 or {node_rows[0].labels["device_path"]} != held:
            fail(f"the real node serves {[r.labels for r in node_rows]}; "
                 f"this process holds {sorted(held)}")
        emit("fleet_setup", real_node={"target": node_target, "node": node_name,
                                       "pool": pool_a, "backend": "nvml",
                                       "device_path": node_rows[0].labels["device_path"]},
             simulated_nodes={target: {"node": n, "pool": p, "cards": FLEET_SIM_GPUS,
                                       "backend": "nvml simulated"}
                              for target, (n, p) in sim_targets.items()},
             hosts=1 + len(sim_nodes), cards=sum(cards.values()))

        # The flat aggregator first: its idle pool level sets the alert's threshold.
        flat_port, record = free_port(), Path(tmp.name, "rounds.jsonl")
        spawn("aggregate", tier("aggregate", flat_port, "--targets", targets,
                                "--stream", "on", "--record-to", str(record)))

        def flat_full():
            table = rollups(parsed(metrics(flat_port)))
            hosts = [pick(table, "tpu_slice_hosts_reporting", family="gpu", slice_name=p)
                     for p in FLEET_POOLS]
            return table if hosts == [FLEET_HOSTS_PER_POOL] * len(FLEET_POOLS) else None

        idle_a = pick(wait_for(flat_full, 30, "the flat aggregator over every host",
                               phase="fleet"),
                      "tpu_slice_hbm_used_bytes", family="gpu", slice_name=pool_a)
        threshold = idle_a + FILL_BYTES / 2
        rules, alerts = Path(tmp.name, "store.rules"), Path(tmp.name, "alert.rules")
        rules.write_text(FLEET_STORE_RULE + "\n")
        alerts.write_text(FLEET_ALERT_RULE.format(pool=pool_a, threshold=f"{threshold:.0f}"))

        # The shard tree: two leaves, the root with store and alerting, a replica.
        leaf_ports = [free_port(), free_port()]
        for i, port in enumerate(leaf_ports):
            spawn(f"leaf{i}", tier("shard", port, "--role", "leaf", "--shard-index", str(i),
                                   "--num-shards", "2", "--targets", targets))
        leaves = ",".join(f"shard-{i}=127.0.0.1:{p}" for i, p in enumerate(leaf_ports))
        root_port, replica_port = free_port(), free_port()
        store_dir, alert_dir = Path(tmp.name, "store"), Path(tmp.name, "alerts")
        spawn("root", tier("shard", root_port, "--role", "root", "--leaves", leaves,
                           "--store-dir", str(store_dir), "--store-tiers", FLEET_STORE_TIERS,
                           "--store-rules", str(rules), "--alert-rules", str(alerts),
                           "--alert-dir", str(alert_dir),
                           "--alert-webhook-url", receiver.url))
        spawn("replica", tier("shard", replica_port, "--role", "replica", "--leaves", leaves,
                              "--root-url", f"127.0.0.1:{root_port}"))

        def root_full():
            table = rollups(parsed(metrics(root_port)))
            chips = {p: pick(table, "tpu_slice_chip_count", family="gpu", slice_name=p)
                     for p in FLEET_POOLS}
            return table if chips == cards else None

        wait_for(root_full, 30, "the root over both leaves", phase="fleet")
        wait_for(lambda: rollups(parsed(metrics(replica_port))), 30, "the replica's rollups",
                 phase="fleet")
        stream = SseReader(root_port, *FLEET_STREAM)

        # Each observation scrapes the flat aggregator, the root and the
        # replica, and keeps each tier's round duration by round timestamp.
        seen: dict = {"idle": [], "load": [], "release": []}
        rounds: dict = {"flat": {}, "root": {}}
        alert_states: list = []

        def observe(stage: str) -> dict:
            now = time.time()
            flat_rows, root_rows = parsed(metrics(flat_port)), parsed(metrics(root_port))
            obs = {"t": now, "flat": rollups(flat_rows), "root": rollups(root_rows),
                   "replica": rollups(parsed(metrics(replica_port)),
                                      ("tpu_slice_", "tpu_fleet_family_", "tpu_replica_info")),
                   "workload": {(s.labels.get("pod"), s.labels.get("slice_name")): s.value
                                for s in flat_rows if s.name == "tpu_workload_hbm_used_bytes"},
                   "leaf_up": {s.labels["leaf"]: s.value
                               for s in root_rows if s.name == "tpu_root_leaf_up"},
                   "tpu_family": sorted({s.name for s in flat_rows + root_rows
                                         if s.labels.get("family") == "tpu"})}
            for who, rows, prefix in (("flat", flat_rows, "tpu_aggregator"),
                                      ("root", root_rows, "tpu_root")):
                one = {s.name: s.value for s in rows if s.name in (
                    f"{prefix}_last_round_timestamp_seconds", f"{prefix}_round_duration_seconds")}
                if len(one) == 2:
                    rounds[who][one[f"{prefix}_last_round_timestamp_seconds"]] = \
                        one[f"{prefix}_round_duration_seconds"]
            gauges = {s.name: s.value for s in root_rows
                      if s.name in ("tpu_root_alerts_firing", "tpu_root_alerts_pending")}
            obs["alert"] = ("firing" if gauges.get("tpu_root_alerts_firing") else
                            "pending" if gauges.get("tpu_root_alerts_pending") else "inactive")
            if not alert_states or alert_states[-1][1] != obs["alert"]:
                alert_states.append((now, obs["alert"]))
            seen[stage].append(obs)
            return obs

        # 1. At least FLEET_IDLE_ROUNDS idle rounds of the root over the whole fleet.
        t0 = time.time()
        usage = {"idle": usage_now()}
        first_round = max(rounds["root"], default=0.0)
        while True:
            observe("idle")
            if sum(t > first_round for t in rounds["root"]) >= FLEET_IDLE_ROUNDS + 1:
                break
            if time.time() - t0 > 30:
                fail(f"{len(rounds['root'])} root rounds in 30 s")
            time.sleep(FLEET_OBSERVE_S)

        # 2. The fill and the burn: at least FLEET_LOAD_S, until the alert fired.
        usage["fill"] = usage_now()
        t_fill = time.time()
        stim.start()
        status_tree = status_node = node_filled = None
        while True:
            obs = observe("load")
            if obs["alert"] == "firing" and status_tree is None:
                status_tree = subprocess.run(
                    [sys.executable, "-m", "tpu_pod_exporter_torch.status", "--tree",
                     f"127.0.0.1:{root_port}", "--store-dir", str(store_dir),
                     "--alert-dir", str(alert_dir), "--json"],
                    cwd=REPO, capture_output=True, text=True, timeout=60)
                status_node = subprocess.run(fleet_status_node_argv(kubelet), cwd=REPO,
                                             capture_output=True, text=True, timeout=60)
                node_filled = wait_for(lambda: pod_filled(metrics(node_port)), 10,
                                       "the node's pod at the fill", phase="fleet")
            if status_tree is not None and time.time() - t_fill >= FLEET_LOAD_S:
                break
            if time.time() - t_fill > FLEET_LOAD_S + 30:
                fail(f"the alert did not fire under the fill: {alert_states}")
            time.sleep(FLEET_OBSERVE_S)

        # 3. Release; idle for at least FLEET_RELEASE_S, until the alert resolved.
        usage["release"] = usage_now()
        t_release = time.time()
        stim.stop()
        while True:
            obs = observe("release")
            released = pick(obs["flat"], "tpu_slice_hbm_used_bytes", family="gpu",
                            slice_name=pool_a)
            if (time.time() - t_release >= FLEET_RELEASE_S and obs["alert"] == "inactive"
                    and released is not None and released < threshold):
                break
            if time.time() - t_release > FLEET_RELEASE_S + 30:
                fail(f"no release in 30 s: pool a at {released}, alert {alert_states}")
            time.sleep(FLEET_OBSERVE_S)
        t_end = time.time()
        usage["end"] = usage_now()
        # The node exporter's own poll phases and scrapes, with the burn in
        # another process (phase 13 ran the exporter beside the burn thread).
        node_poll = exporter_latency(metrics(node_port))
        root = f"http://127.0.0.1:{root_port}"
        store_answer = json.loads(http_get(
            f"{root}/api/v1/query_range?metric={FLEET_STORE_METRIC}&source=store"
            f"&start={t0 - 5:.3f}&end={t_end + 1:.3f}")[1])
        node_history = json.loads(http_get(
            f"http://127.0.0.1:{node_port}/api/v1/query_range?metric=gpu_hbm_used_bytes"
            f"&start={t0 - 5:.3f}&end={t_end + 1:.3f}")[1])["data"]["result"]
        readyz = json.loads(http_get(f"{root}/readyz")[1])
        transitions = {s.labels.get("to"): s.value
                       for s in samples_of(metrics(root_port), "tpu_root_alert_transitions_total")}
        wait_for(lambda: len(receiver.posts()) >= 2, 10, "the resolved notification", phase="fleet")
        frames = stream.stop()
        stream = None

        # Every tier drains on SIGTERM and exits 0; then the nodes.
        exits = {}
        for name in ("replica", "root", "leaf0", "leaf1", "aggregate", "node", *probes,
                     "sim_nodes"):
            procs[name].send_signal(signal.SIGTERM)
            try:
                exits[name] = procs[name].wait(timeout=30)
            except subprocess.TimeoutExpired:
                exits[name] = None
        host.close()
        posts = receiver.posts()
        node_calls = [json.loads(line) for line in logs["node"].read_text().splitlines()
                      if line.startswith('{"nvml_call_times"')]
        if len(node_calls) != 1:
            fail(f"the node exporter printed {len(node_calls)} NVML timing lines")
        probe_lines = {name: probe_line(exits[name], logs[name].read_text()) for name in probes}

        # ------------------------------------------------------------ checks
        # 1. The flat aggregator.
        def levels(stage: str, who: str = "flat") -> list:
            return [v for v in (pick(o[who], "tpu_slice_hbm_used_bytes", family="gpu",
                                     slice_name=pool_a) for o in seen[stage]) if v is not None]

        idle_level, load_level = levels("idle")[-1], max(levels("load"))
        released_level = levels("release")[-1]
        # The node's reading in the round whose pool-a sum the aggregator
        # published, from the aggregator's own round record.
        pool_a_targets = [node_target] + [t for t, (_, p) in sim_targets.items() if p == pool_a]
        node_by_sum: dict = {}
        for line in record.read_text().splitlines():
            bodies = json.loads(line)["bodies"]
            if any(bodies.get(t) is None for t in pool_a_targets):
                continue
            used = {t: sum(s.value for s in samples_of(bodies[t].encode(), "gpu_hbm_used_bytes"))
                    for t in pool_a_targets}
            node_by_sum.setdefault(sum(used.values()), set()).add(used[node_target])
        node_at = {level: sorted(node_by_sum.get(level, ())) for level in (idle_level, load_level)}
        if any(len(v) != 1 for v in node_at.values()):
            fail(f"pool a's published levels and the node's in the round record: {node_at}")
        last = seen["load"][-1]
        flat = {"idle": idle_level, "load_max": load_level, "released": released_level,
                "rise": load_level - idle_level, "fall": load_level - released_level,
                "node_rise_same_round": node_at[load_level][0] - node_at[idle_level][0],
                "recorded_rounds": len(record.read_text().splitlines()),
                "chips": {p: pick(last["flat"], "tpu_slice_chip_count", family="gpu",
                                  slice_name=p) for p in FLEET_POOLS},
                "hosts": {p: pick(last["flat"], "tpu_slice_hosts_reporting", family="gpu",
                                  slice_name=p) for p in FLEET_POOLS}}
        if flat["rise"] < FILL_BYTES or flat["fall"] < FILL_BYTES:
            fail(f"pool a's slice HBM did not rise and fall by the fill: {flat}")
        if flat["rise"] != flat["node_rise_same_round"]:
            fail(f"pool a rose {flat['rise']} B, the node {flat['node_rise_same_round']} B")
        if flat["chips"] != cards or set(flat["hosts"].values()) != {FLEET_HOSTS_PER_POOL}:
            fail(f"slice chips {flat['chips']}, hosts {flat['hosts']}")
        for obs in seen["idle"] + seen["load"] + seen["release"]:
            for field in ("chip_count", "hbm_used_bytes", "hbm_total_bytes", "hosts_reporting"):
                total = pick(obs["flat"], f"tpu_fleet_family_{field}", family="gpu")
                pools = [pick(obs["flat"], f"tpu_slice_{field}", family="gpu", slice_name=p)
                         for p in FLEET_POOLS]
                if None in pools or total != sum(pools):
                    fail(f"tpu_fleet_family_{field} {total}, the pools {pools}")
            if obs["tpu_family"]:
                fail(f"family=\"tpu\" series at a tier: {obs['tpu_family']}")
        pod = [o["workload"].get((SMOKE_POD, pool_a)) for o in seen["idle"] + seen["load"]]
        flat["pod_rise"] = max(v or 0.0 for v in pod) - (pod[len(seen["idle"]) - 1] or 0.0)
        if flat["pod_rise"] < FILL_BYTES:
            fail(f"tpu_workload_hbm_used_bytes{{pod={SMOKE_POD}}} rose {flat['pod_rise']} B")

        # 2. The shard tree: observations where both tiers folded one reading.
        every = seen["idle"] + seen["load"] + seen["release"]
        equal = {stage: sum(o["flat"] == o["root"] for o in seen[stage]) for stage in seen}
        filled_equal = sum(o["flat"] == o["root"] and (pick(
            o["root"], "tpu_slice_hbm_used_bytes", family="gpu", slice_name=pool_a)
            or 0.0) >= idle_level + FILL_BYTES for o in seen["load"])
        tree = {"observations": {stage: len(v) for stage, v in seen.items()},
                "equal": equal, "filled_equal": filled_equal, "leaf_up": last["leaf_up"],
                "replica_equal": sum({k: v for k, v in o["replica"].items()
                                      if k[0] != "tpu_replica_info"} == o["root"] for o in every),
                "replica_info": [dict(k[1]) for k in last["replica"]
                                 if k[0] == "tpu_replica_info"]}
        if not equal["idle"] or not filled_equal:
            fail(f"the root's rollups never equal the flat aggregator's: {tree}")
        if sorted(last["leaf_up"].values()) != [1.0, 1.0]:
            fail(f"tpu_root_leaf_up {last['leaf_up']}")
        if not tree["replica_equal"] or not tree["replica_info"]:
            fail(f"the replica does not serve the root's rollups: {tree}")

        # 3. The stream: a snapshot, then deltas with consecutive seqs.
        data = [(t, f) for t, f in frames if f["type"] != "heartbeat"]
        seqs = [f.get("seq") for _, f in data]

        def filled_row(row) -> bool:
            return (row["labels"].get("slice_name") == pool_a
                    and row["labels"].get("family") == "gpu"
                    and (row.get("stats") or {}).get("last", 0.0) >= idle_level + FILL_BYTES)

        filled = [t for t, f in data if f["type"] == "delta" and any(map(filled_row, f["changed"]))]
        node_idle = node_at[idle_level][0]
        node_points = [(t, v) for row in node_history for t, v in row["values"]]
        first_filled_poll = min((t for t, v in node_points if v >= node_idle + FILL_BYTES),
                                default=None)
        stream_check = {"frames": len(frames), "types": sorted({f["type"] for _, f in frames}),
                        "first": data[0][1]["type"] if data else None, "seq_first": seqs[:1],
                        "seq_last": seqs[-1:], "filled_deltas": len(filled),
                        "delta_lag_s": (filled[0] - first_filled_poll
                                        if filled and first_filled_poll else None)}
        if (not data or data[0][1]["type"] != "snapshot"
                or any(f["type"] != "delta" for _, f in data[1:])
                or seqs != list(range(seqs[0], seqs[0] + len(seqs)))):
            fail(f"the stream's frames {stream_check}, seqs {seqs}")
        if not filled or first_filled_poll is None:
            fail(f"no delta carried pool a's filled level: {stream_check}")

        # 4. The store: the idle, filled and released levels of pool a, in order.
        rows = [r for r in store_answer.get("data", {}).get("result", ())
                if r["labels"].get("slice_name") == pool_a]
        values = [v for r in rows for _, v in r["values"]]
        marks = [i for i, v in enumerate(values) if v >= idle_level + FILL_BYTES]
        store = {"status": store_answer.get("status"), "source": store_answer.get("source"),
                 "points": len(values), "filled_points": len(marks),
                 "levels": sorted(set(values))}
        if not (marks and any(v < threshold for v in values[:marks[0]])
                and any(v < threshold for v in values[marks[-1]:])):
            fail(f"the store's {FLEET_STORE_METRIC} for {pool_a}: {store}")

        # 5. Alerting: pending, firing, resolved; contiguous webhook seqs.
        states = [s for _, s in alert_states]
        firing_post = next((p for p in posts if p["body"].get("state") == "firing"), None)
        alerting = {"states": states, "transitions": transitions,
                    "posts": [(p["seq"], p["body"].get("state")) for p in posts],
                    "readyz": readyz.get("alerting"),
                    "firing_after_fill_s": (firing_post["body"]["wall"] - t_fill
                                            if firing_post else None),
                    "webhook_after_fill_s": firing_post["wall"] - t_fill if firing_post else None}
        if "pending" not in states or states[states.index("pending"):] != [
                "pending", "firing", "inactive"]:
            fail(f"the alert's states {alerting}")
        if [(p["seq"], p["body"].get("state"), p["body"].get("alert")) for p in posts] != [
                ("1", "firing", FLEET_ALERT), ("2", "resolved", FLEET_ALERT)]:
            fail(f"the webhook's notifications {alerting}")
        if (transitions.get("firing"), transitions.get("resolved")) != (1.0, 1.0) \
                or not transitions.get("pending"):
            fail(f"the root's transition counts {alerting}")
        if (readyz.get("alerting") or {}).get("status") != "ok":
            fail(f"the root's /readyz alerting {alerting}")

        # 6. status over the tree while the alert fired, and on the node.
        tree_doc = json.loads(status_tree.stdout) if status_tree.returncode == 0 else {}
        node_doc = json.loads(status_node.stdout) if status_node.returncode == 0 else {}
        card = [c for c in node_doc.get("chips", ()) if c["device_path"] in held]
        status = {"tree_rc": status_tree.returncode, "node_rc": status_node.returncode,
                  "tree_family_chips": tree_doc.get("fleet", {}).get("family_chips"),
                  "tree_alerts": {k: tree_doc.get("alerts", {}).get(k)
                                  for k in ("rules", "firing", "pending")},
                  "node_chips": [{k: c.get(k) for k in ("device_path", "device_kind",
                                                         "hbm_used_bytes", "pod", "holders")}
                                 for c in node_doc.get("chips", ())]}
        if status_tree.returncode != 0 or status_node.returncode != 0:
            fail(f"status: {status}\n{status_tree.stderr[-1500:]}\n{status_node.stderr[-1500:]}")
        if status["tree_family_chips"] != {"gpu": float(sum(cards.values()))} \
                or status["tree_alerts"]["firing"] != 1:
            fail(f"status --tree {status}")
        if (len(card) != 1 or card[0]["hbm_used_bytes"] < FILL_BYTES
                or os.getpid() not in [h["pid"] for h in card[0]["holders"]]):
            fail(f"status on the node {status}")
        (CAPTURE_DIR / "h100-metrics.txt").write_bytes(node_filled)
        (CAPTURE_DIR / "h100-status.json").write_text(status_node.stdout)

        # Every tier and both node processes drained: exit 0.
        if any(rc != 0 for rc in exits.values()):
            fail(f"exit codes on SIGTERM {exits}")
    finally:
        for proc in procs.values():  # first: nothing below may leave them running
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=10)
        if stream is not None:
            stream.stop()
        receiver.stop()
        stim.stop()
        host.close()
        tmp.cleanup()

    def cpu_and_rss(since: str, until: str) -> dict:
        a, b = usage[since], usage[until]
        return {name: {"cpu_s_per_s": (cpu - a["procs"][name][0]) / (b["t"] - a["t"]),
                       "rss_bytes": rss} for name, (cpu, rss) in b["procs"].items()}

    emit("fleet_rounds", flat=nearest_rank_ms(list(rounds["flat"].values())),
         root=nearest_rank_ms(list(rounds["root"].values())))
    emit("fleet_stream", **stream_check)
    emit("fleet_alert", **alerting)
    emit("fleet_processes", idle=cpu_and_rss("idle", "fill"), load=cpu_and_rss("fill", "release"),
         clock_ticks_per_s=os.sysconf("SC_CLK_TCK"), node_poll_phase_ms=node_poll)
    (calls,) = node_calls
    # [process-table calls, of them answered with a grown table, samples]
    tables = calls["process_table_calls"]
    table_calls = sum(n * k for n, _, k in tables)
    samples = sum(k for _, _, k in tables)
    nvml_tids = {tid for times in calls["nvml_call_times"].values() for tid in times["tids"]}
    waits = {stage: run_queue_wait(usage[a]["node_threads"], usage[b]["node_threads"],
                                   usage[b]["t"] - usage[a]["t"], sorted(nvml_tids))
             for stage, a, b in (("idle", "idle", "fill"), ("load", "fill", "release"),
                                 ("release", "release", "end"))}
    emit_device_read("fleet", {"node": node_poll.get("device_read", {}).get("p99_ms")},
                     polls={"node": node_poll["polls"]},
                     scrape_p99_ms={"node": node_poll["scrape"]["p99_ms"]},
                     scrapes={"node": node_poll["scrape"]["scrapes"]},
                     device_read_buckets_ms={"node": node_poll["device_read_buckets_ms"]},
                     nvml_call_times={"node": calls["nvml_call_times"]},
                     slow_samples={"node": calls["slow_samples"]},
                     process_table_calls={"node": tables},
                     process_table_calls_per_sample={"node": table_calls / max(1, samples)},
                     run_queue_wait={"node": waits})
    emit("fleet_probe", card=card_line(), probes=probe_lines,
         timeline=stall_timeline(calls["slow_samples"], probe_lines, host.readings,
                                 host.readings[0][0], os.cpu_count()))
    if any(n - grown > 1 for n, grown, _ in tables) or not any(n == 1 for n, _, _ in tables):
        raise AssertionError("the node's samples made more than one process-table call "
                             f"beside those NVML answered with a grown table: {tables}")
    launches = tm.tanh_matmul.launches
    by_kernel = launch_counts(tm)
    emit("fleet", seconds=time.monotonic() - t_phase, burn_steps=stim.steps,
         launches_by_kernel=by_kernel, flat=flat, tree=tree, store=store, status=status,
         exits=exits, threshold=threshold, simulated_hosts=len(sim_nodes))
    if launches <= 0:
        raise AssertionError("no tanh_matmul launch during the fleet phase")
    check_all_wgmma(tm, "fleet", launches)
    return by_kernel


def run_port(module: str, *args: str, timeout: float = 60, env=None):
    """``python -m tpu_pod_exporter_torch.<module> *args``, completed."""
    return subprocess.run([sys.executable, "-m", f"tpu_pod_exporter_torch.{module}", *args],
                          cwd=REPO, capture_output=True, text=True, timeout=timeout, env=env)


def probe_card(out: Path | None = None) -> dict:
    """The port's NVML probe as a subprocess, its report also written to
    ``out``: it must exit 0."""
    proc = run_port("probe", "--runtime", "nvml", *(("--out", str(out)) if out else ()))
    if proc.returncode != 0:
        raise AssertionError(f"drills: probe --runtime nvml rc={proc.returncode}\n"
                             f"{proc.stdout[-2000:]}{proc.stderr[-2000:]}")
    return json.loads(proc.stdout)


def phase_drills_probe(dev, uuid: str, hwcheck_probe: dict) -> dict:
    """Phase 15 (a): the NVML probe on the card, idle, under the 16 GiB fill
    and after its release; hwcheck's artifact; the liveness watch."""
    import gc
    import tempfile

    from tpu_pod_exporter_torch.loadgen.workload import hbm_fill

    def settle() -> None:
        # Tensors of earlier phases that only a collection frees, then the
        # allocator's cache: the card holds no memory of this process's
        # but the fill's.
        gc.collect()
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()

    settle()
    idle = probe_card()
    fill = hbm_fill(FILL_BYTES, device=dev)
    filled = probe_card(CAPTURE_DIR / "h100-probe.json")
    del fill
    settle()
    released = probe_card()
    held = held_card_nodes()
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp, "watch.jsonl")
        watch = run_port("tunnelwatch", "--out", str(out), "--max-seconds", "2",
                         "--interval", "1", timeout=30)
        records = [json.loads(line) for line in out.read_text().splitlines()] if out.exists() else []
    (card,) = idle["devices"] if idle["count"] == 1 else (None,)
    used = [r["devices"][0]["memory_used_bytes"] if r["count"] == 1 else None
            for r in (idle, filled, released)]
    hw_card = (hwcheck_probe.get("devices") or [{}])[0]
    emit("drills_probe", count=idle["count"], device=card, supported=idle["supported"],
         errors=idle["errors"], used_bytes={"idle": used[0], "filled": used[1],
                                            "released": used[2]},
         held_nodes=sorted(held), hwcheck_probe={"reachable": hwcheck_probe.get("reachable"),
                                                 "uuid": hw_card.get("uuid")},
         tunnelwatch={"rc": watch.returncode, "records": records})
    if card is None or card["uuid"] != uuid:
        raise AssertionError(f"drills: probe counted {idle['count']}, card {card}, "
                             f"nvidia-smi UUID {uuid}")
    if held != {f"/dev/nvidia{card['minor']}"}:
        raise AssertionError(f"drills: probe minor {card['minor']}, this process holds {held}")
    if not (used[1] - used[0] >= FILL_BYTES and used[1] - used[2] >= FILL_BYTES):
        raise AssertionError(f"drills: probe used {used} against the {FILL_BYTES} B fill")
    if not (hwcheck_probe.get("reachable") and hw_card.get("uuid") == uuid):
        raise AssertionError(f"drills: hwcheck's artifact carries probe {hwcheck_probe}")
    if not (watch.returncode == 0 and len(records) == 1 and records[0]["device_nodes"]
            and records[0]["change"]):
        raise AssertionError(f"drills: tunnelwatch rc={watch.returncode} {records} "
                             f"{watch.stderr[-1000:]}")
    return card


class LibtpuService:
    """A RuntimeMetricService on a unix socket, from the port's protobufs:
    ``tables`` maps a metric name to its rows ``[(device, value)]``, any
    other name answers NOT_FOUND and the enumeration RPC UNIMPLEMENTED.
    ``unavailable`` answers every call UNAVAILABLE instead, as a service
    that refuses connections does."""

    def __init__(self, sock: str, tables: dict, unavailable: bool = False):
        from concurrent import futures

        import grpc

        from tpu_pod_exporter_torch.backend.proto import tpu_metric_service_pb2 as pb

        self.addr = f"unix://{sock}"
        responses = {}
        for name, rows in tables.items():
            resp = pb.MetricResponse()
            for device, value in rows:
                m = resp.metric.metrics.add()
                attr = m.attribute.add()
                attr.key, attr.value.int_attr = "device-id", device
                m.gauge.as_int = value
            responses[name] = resp

        def get(request, context):
            if unavailable:
                context.abort(grpc.StatusCode.UNAVAILABLE, "connection refused")
            if request.metric_name not in responses:
                context.abort(grpc.StatusCode.NOT_FOUND, "unsupported metric")
            return responses[request.metric_name]

        def list_supported(request, context):
            context.abort(grpc.StatusCode.UNAVAILABLE if unavailable
                          else grpc.StatusCode.UNIMPLEMENTED, "no enumeration")

        self._server = grpc.server(futures.ThreadPoolExecutor(max_workers=4))
        self._server.add_generic_rpc_handlers((grpc.method_handlers_generic_handler(
            "tpu.monitoring.runtime.RuntimeMetricService", {
                "GetRuntimeMetric": grpc.unary_unary_rpc_method_handler(
                    get, request_deserializer=pb.MetricRequest.FromString,
                    response_serializer=pb.MetricResponse.SerializeToString),
                "ListSupportedMetrics": grpc.unary_unary_rpc_method_handler(
                    list_supported,
                    request_deserializer=pb.ListSupportedMetricsRequest.FromString,
                    response_serializer=pb.ListSupportedMetricsResponse.SerializeToString),
            }),))
        self._server.add_insecure_port(self.addr)
        self._server.start()

    def stop(self) -> None:
        self._server.stop(0)


def phase_drills_libtpu() -> dict:
    """Phase 15 (b): ``--backend libtpu`` on the card's machine. Without
    grpc the exporter must exit non-zero naming grpc; with it, the probe
    replays the committed fixture's unreachable service, and the exporter
    serves the fixture's metric names from a fake service as tpu_* series."""
    import importlib.util
    import signal
    import tempfile

    blocked = ("import sys\nsys.modules['grpc'] = None\n"
               "from tpu_pod_exporter_torch.app import main\n"
               "sys.exit(main(sys.argv[1:]))\n")
    argv = ["--backend", "libtpu", "--attribution", "none", "--port", "0",
            "--host", "127.0.0.1"]
    have_grpc = importlib.util.find_spec("grpc") is not None
    refused = subprocess.run([sys.executable, "-c", blocked, *argv] if have_grpc
                             else [sys.executable, "-m", "tpu_pod_exporter_torch", *argv],
                             cwd=REPO, capture_output=True, text=True, timeout=60)
    result = {"grpc_installed": have_grpc, "without_grpc_rc": refused.returncode,
              "without_grpc_stderr": refused.stderr.strip().splitlines()[-1:]}
    if refused.returncode == 0 or "grpc" not in refused.stderr:
        raise AssertionError(f"drills: --backend libtpu without grpc rc={refused.returncode} "
                             f"{refused.stderr[-1000:]}")
    if not have_grpc:
        emit("drills_libtpu", **result)
        return result

    from tpu_pod_exporter_torch.backend.libtpu import DUTY_CYCLE, HBM_TOTAL, HBM_USAGE

    recorded = json.loads(LIBTPU_FIXTURE.read_text())
    names = sorted(n for n in recorded["errors"] if not n.startswith("<"))
    gib = 1 << 30
    tables = {HBM_USAGE: [(d, (d + 1) * gib) for d in range(LIBTPU_CHIPS)],
              HBM_TOTAL: [(d, 32 * gib) for d in range(LIBTPU_CHIPS)],
              DUTY_CYCLE: [(d, 10 * d) for d in range(LIBTPU_CHIPS)]}
    if not set(tables) <= set(names):
        raise AssertionError(f"drills: the fixture does not name {sorted(set(tables) - set(names))}")
    with tempfile.TemporaryDirectory() as tmp:
        service = LibtpuService(f"{tmp}/recorded.sock", {}, unavailable=True)
        try:
            replay = run_port("probe", "--runtime", "libtpu", "--addr", service.addr,
                              "--timeout-s", "1", timeout=120)
        finally:
            service.stop()
        doc = json.loads(replay.stdout)
        result["fixture_replay"] = {"rc": replay.returncode, "reachable": doc["reachable"],
                                    "errors": len(doc["errors"])}
        if replay.returncode != 2 or doc["reachable"] or sorted(doc["errors"]) != sorted(
                recorded["errors"]):
            raise AssertionError(f"drills: the recorded service probed as {doc}")

        service = LibtpuService(f"{tmp}/served.sock", tables)
        port = free_port()
        with open(Path(tmp, "exporter.log"), "wb") as log:
            proc = subprocess.Popen(
                [sys.executable, "-m", "tpu_pod_exporter_torch", "--backend", "libtpu",
                 "--libtpu-metrics-addr", service.addr, "--attribution", "none",
                 "--port", str(port), "--host", "127.0.0.1", "--interval-s", "0.5"],
                cwd=REPO, stdout=log, stderr=log)
        try:
            base = f"http://127.0.0.1:{port}"

            def served():
                body = http_get(base + "/metrics")[1]
                return body if len(samples_of(body, "tpu_hbm_used_bytes")) == LIBTPU_CHIPS else None

            body = wait_for(served, 30, "the libtpu chips on /metrics", phase="drills")
            proc.send_signal(signal.SIGTERM)
            rc = proc.wait(timeout=30)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            service.stop()
        log_tail = Path(tmp, "exporter.log").read_text()[-2000:]
    used = {s.labels["chip_id"]: s.value for s in samples_of(body, "tpu_hbm_used_bytes")}
    total = [s.value for s in samples_of(body, "tpu_hbm_total_bytes")]
    duty = {s.labels["chip_id"]: s.value
            for s in samples_of(body, "tpu_tensorcore_duty_cycle_percent")}
    result.update(exporter_rc=rc, hbm_used_bytes=used, hbm_total_bytes=total,
                  duty_cycle_percent=duty, gpu_series=b"gpu_hbm_used_bytes" in body)
    emit("drills_libtpu", **result)
    want_used = {str(d): float((d + 1) * gib) for d in range(LIBTPU_CHIPS)}
    want_duty = {str(d): float(10 * d) for d in range(LIBTPU_CHIPS)}
    if not (rc == 0 and used == want_used and total == [32.0 * gib] * LIBTPU_CHIPS
            and duty == want_duty and not result["gpu_series"]):
        raise AssertionError(f"drills: --backend libtpu served {result}\n{log_tail}")
    return result


def run_drill(tmp: str, name: str, module: str, args: tuple, want_ok: bool,
              must_print: str, memory: bool = False) -> dict:
    """One drill as a subprocess with its state (and TMPDIR) under ``tmp``,
    under DRILL_MEMORY_BOOTSTRAP with ``memory``. Raises, with the end of
    its output, unless it exits as it must and prints ``must_print``."""
    state = Path(tmp, name)
    state.mkdir()
    flag = DRILL_STATE_FLAG.get(module)
    argv = [*args, flag, str(state / "state")] if flag else list(args)
    env = dict(os.environ, TMPDIR=str(state))
    t0 = time.monotonic()
    if memory:
        proc = subprocess.run([sys.executable, "-c", DRILL_MEMORY_BOOTSTRAP, module, *argv],
                              cwd=REPO, capture_output=True, text=True,
                              timeout=DRILL_TIMEOUT_S, env=env)
    else:
        proc = run_port(module, *argv, timeout=DRILL_TIMEOUT_S, env=env)
    seconds = time.monotonic() - t0
    record = {"name": name, "rc": proc.returncode, "seconds": seconds,
              "verdict": next((ln.strip() for ln in reversed(proc.stdout.splitlines())
                               if must_print in ln), None)}
    failures = ""
    if module == "loadgen.scenario" and (state / "state" / "result.json").exists():
        summary = json.loads((state / "state" / "result.json").read_text())
        record["scenarios"] = {n: [r["ok"], r.get("wall_s"), r.get("rss_growth_mb")]
                               for n, r in summary["scenarios"].items()}
        # A failed scenario's round and problems, last in the error: the end
        # of the output is what a reader of a failed run sees first.
        failures = json.dumps({n: [r.get("failed_round"), r.get("problems")]
                               for n, r in summary["scenarios"].items() if not r["ok"]})
    if memory:
        record["memory"] = {line["memory"]: line for line in map(
            json.loads, (ln for ln in proc.stdout.splitlines() if ln.startswith('{"memory"')))}
    if (proc.returncode == 0) != want_ok or record["verdict"] is None:
        raise AssertionError(f"drills: {name} rc={proc.returncode}, want "
                             f"{'0' if want_ok else 'non-zero'} and {must_print!r}\n"
                             f"{proc.stdout[-3000:]}\n{proc.stderr[-2000:]}\n"
                             f"failed scenarios: {failures}")
    if name == "scenario_suite" and not (len(record["scenarios"]) == DRILL_SCENARIOS and all(
            ok for ok, *_ in record["scenarios"].values())):
        raise AssertionError(f"drills: scenario suite {record['scenarios']}\n"
                             f"failed scenarios: {failures}")
    return record


def phase_drills(dev, uuid: str, hwcheck_probe: dict) -> None:
    """Phase 15: the probe and the liveness watch on the card, --backend
    libtpu, then every drill of the port as a subprocess (the card idle:
    the drills do not read it)."""
    import tempfile
    import threading

    t_phase = time.monotonic()
    card = phase_drills_probe(dev, uuid, hwcheck_probe)
    libtpu = phase_drills_libtpu()
    thread_rss = json.loads(subprocess.run(
        [sys.executable, "-c", THREAD_RSS_BOOTSTRAP, str(THREAD_RSS_THREADS)],
        capture_output=True, text=True, timeout=60, check=True).stdout)
    runs: list = []
    errors: list = []

    def lane(tmp: str, drills) -> None:
        for drill in drills:
            try:
                record = run_drill(tmp, *drill)
            except Exception as e:  # noqa: BLE001 — raised below, after every lane
                errors.append(e)
                return
            runs.append(record)
            emit("drill", **record)

    t_drills = time.monotonic()
    groups_s = []
    with tempfile.TemporaryDirectory() as tmp:
        for lanes in DRILL_GROUPS:
            t_group = time.monotonic()
            threads = [threading.Thread(target=lane, args=(tmp, drills), daemon=True,
                                        name=f"drill-lane-{i}")
                       for i, drills in enumerate(lanes)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            groups_s.append(time.monotonic() - t_group)
            if errors:
                break
    emit("drills", seconds=time.monotonic() - t_phase, groups_seconds=groups_s,
         drills_seconds=time.monotonic() - t_drills, runs=len(runs), card_minor=card["minor"],
         libtpu_grpc=libtpu["grpc_installed"], thread_rss=thread_rss)
    if errors:
        raise errors[0]


def run_lint(*args: str) -> subprocess.Popen:
    """The port's exporter-lint CLI as a subprocess (output piped)."""
    proc = subprocess.Popen([sys.executable, "-m", "tpu_pod_exporter_torch.analysis", *args],
                            cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    proc.started = time.monotonic()
    return proc


def finish(procs: dict) -> dict:
    """Wait for the named lint subprocesses side by side:
    {name: (rc, output, seconds from its start to its exit)}."""
    import threading

    out = {}

    def wait(name: str, proc: subprocess.Popen) -> None:
        try:
            text, _ = proc.communicate(timeout=LINT_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            text, _ = proc.communicate()
            text += f"\n(killed after {LINT_TIMEOUT_S} s)"
        out[name] = (proc.returncode, text, time.monotonic() - proc.started)

    threads = [threading.Thread(target=wait, args=item, name=f"lint-{item[0]}", daemon=True)
               for item in procs.items()]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return out


def card_lock_sites() -> list:
    """The witness sites (``path:line``) of :data:`LINT_CARD_LOCKS`."""
    sites = []
    for rel, statement in LINT_CARD_LOCKS:
        lines = (REPO / rel).read_text().splitlines()
        (line,) = [i for i, text in enumerate(lines, 1) if text.strip() == statement]
        sites.append(f"{rel}:{line}")
    return sites


def lint_static(tmp: str) -> None:
    """Phase 16a: the static lint is clean, the demo catches every seeded
    family, the regenerated artifacts equal the committed ones, and the
    static graph holds every edge of the JAX package's committed graph."""
    from tpu_pod_exporter_torch.analysis.rules import ALL_RULES

    art = {"lock-graph.json": os.path.join(tmp, "lock-graph.json"),
           "lock-graph.dot": os.path.join(tmp, "lock-graph.dot"),
           "fork-inventory.json": os.path.join(tmp, "fork-inventory.json")}
    done = finish({
        "lint": run_lint("--format", "json"),
        "demo": run_lint("--demo"),
        "artifacts": run_lint("--lock-graph", art["lock-graph.json"],
                              "--lock-graph-dot", art["lock-graph.dot"],
                              "--fork-inventory", art["fork-inventory.json"]),
    })
    for name, (rc, text, _) in done.items():
        if rc != 0:
            raise AssertionError(f"lint: {name} exited {rc}:\n{text[-4000:]}")
    rc, text, seconds = done["lint"]
    doc = json.loads(text)
    by_rule = {rule.name: 0 for rule in ALL_RULES}
    for finding in doc["findings"]:
        by_rule[finding["rule"]] = by_rule.get(finding["rule"], 0) + 1
    emit("lint_static", findings=len(doc["findings"]), by_rule=by_rule,
         baseline_suppressed=doc["baseline_suppressed"], seconds=seconds)
    if doc["findings"] or doc["baseline_suppressed"]:
        raise AssertionError(f"lint: {doc['findings']}")
    demo = done["demo"][1]
    caught = re.search(r"all seeded violations caught \(([^)]*)\)", demo)
    families = caught.group(1).split(", ") if caught else []
    emit("lint_demo", caught=families, seconds=done["demo"][2])
    if len(families) != 7:
        raise AssertionError(f"lint demo: {demo[-4000:]}")
    stale = [name for name, path in art.items()
             if Path(path).read_bytes() != (LINT_REVIEWED / name).read_bytes()]
    graph = json.loads(Path(art["lock-graph.json"]).read_text())
    edges = {(e["from"], e["to"]) for e in graph["edges"]}
    reference = {(e["from"], e["to"]) for e in json.loads(LINT_REFERENCE_GRAPH.read_text())["edges"]}
    emit("lint_artifacts", locks=len(graph["locks"]), edges=sorted(edges),
         reference_edges=sorted(reference), stale=stale, seconds=done["artifacts"][2])
    if stale:
        raise AssertionError(f"lint: regenerated {stale} differ from analysis/reviewed/")
    if not reference <= edges:
        raise AssertionError(f"lint: the port's graph lacks {sorted(reference - edges)}")


def phase_lint(uuid: str) -> dict:
    """Phase 16: the port's exporter-lint on its own tree, then hwcheck's
    closed loop at full size on the torch and NVML backends in a child
    process under the port's lock and loop witnesses, each dump checked
    against the static model. Returns the child's launches by kernel."""
    import tempfile

    t_phase = time.monotonic()
    with tempfile.TemporaryDirectory() as tmp:
        lint_static(tmp)
        stimulus = {"hbm_bytes": FILL_BYTES, "width": WIDTH, "depth": DEPTH,
                    "batch": BATCH, "iters": ITERS}
        spec = {"out": tmp, "runs": [
            {"backend": "torch", "stimulus": stimulus, "exporter_args": {}},
            {"backend": "nvml", "stimulus": stimulus,
             "exporter_args": {"process_metrics": True, "legacy_metrics": True,
                               **kubelet_fixture(tmp, uuid)}},
        ]}
        t_child = time.monotonic()
        child = subprocess.run([sys.executable, "-c", LINT_CHILD, json.dumps(spec)], cwd=REPO,
                               capture_output=True, text=True, timeout=LINT_TIMEOUT_S)
        child_s = time.monotonic() - t_child
        if child.returncode != 0:
            raise AssertionError(f"lint: the witnessed child exited {child.returncode}:\n"
                                 f"{child.stdout[-3000:]}{child.stderr[-3000:]}")
        result = json.loads(child.stdout.strip().splitlines()[-1])
        torch_report, nvml_report = result["reports"]
        by_kernel = result["launches_by_kernel"]
        emit("lint_witness_loop", seconds=child_s, pid=result["pid"],
             launches=result["launches"], launches_by_kernel=by_kernel,
             burn_steps=[r["burn_steps"] for r in result["reports"]],
             checks={"torch": torch_report["checks"], "nvml": nvml_report["checks"]})
        check_torch_loop(torch_report, "witnessed torch closed loop")
        check_nvml_loop(nvml_report, result["pid"], "witnessed nvml closed loop")
        if not (result["launches"] > 0 and by_kernel == {
                **{name: 0 for name in by_kernel}, "wgmma": result["launches"]}):
            raise AssertionError(f"lint: the child's launches {result['launches']}, "
                                 f"by kernel {by_kernel}")
        lock_dump = os.path.join(tmp, "lock-witness.json")
        loop_dump = os.path.join(tmp, "loop-witness.json")
        done = finish({"check_witness": run_lint("--check-witness", lock_dump),
                       "check_loop_witness": run_lint("--check-loop-witness", loop_dump)})
        locks = json.loads(Path(lock_dump).read_text())
        loop = json.loads(Path(loop_dump).read_text())
    holds = locks["max_hold_ms"]
    longest = max(holds, key=holds.get) if holds else None
    slowest = max(loop["callbacks"], key=lambda c: c["max_ms"], default=None)
    sites = {lk["site"]: lk for lk in locks["locks"]}
    card_sites = {site: sites.get(site, {}).get("acquired") for site in card_lock_sites()}
    emit("lint_witness", lock_sites=len(sites), acquisitions=locks["meta"]["acquisitions"],
         edges=[{"from": e["from"], "to": e["to"], "count": e["count"]} for e in locks["edges"]],
         inversions=len(locks["inversions"]), long_holds=len(locks["long_holds"]),
         longest_hold_ms=holds.get(longest), longest_hold_site=longest,
         card_lock_acquisitions=card_sites,
         loop_callbacks=loop["meta"]["callbacks"],
         loop_callback_runs=sum(c["count"] for c in loop["callbacks"]),
         slowest_callback_ms=slowest and slowest["max_ms"],
         slowest_callback=slowest and f"{slowest['module']}.{slowest['qualname']}",
         stalls=loop["meta"]["stalls"],
         check_witness_rc=done["check_witness"][0],
         check_loop_witness_rc=done["check_loop_witness"][0])
    for name, (rc, text, _) in done.items():
        if rc != 0:
            raise AssertionError(f"lint: {name} exited {rc}:\n{text[-4000:]}")
    if not all(card_sites.values()):
        raise AssertionError(f"lint: card-only locks not witnessed: {card_sites}")
    emit("lint", seconds=time.monotonic() - t_phase)
    return by_kernel


def kube_quantity(text: str) -> float:
    """A Kubernetes quantity as a number: bytes for memory ("256Mi"), cores
    for CPU ("200m")."""
    for suffix, scale in (("Ki", 1 << 10), ("Mi", 1 << 20), ("Gi", 1 << 30), ("m", 1e-3)):
        if text.endswith(suffix):
            return float(text[:-len(suffix)]) * scale
    return float(text)


def deploy_container(manifest: str, kind: str, name: str) -> tuple[dict, dict]:
    """(pod spec, first container) of the ``kind`` object ``name`` in
    ``deploy/gpu/<manifest>``."""
    import yaml

    (obj,) = [d for d in yaml.safe_load_all((DEPLOY_DIR / manifest).read_text())
              if d and d["kind"] == kind and d["metadata"]["name"] == name]
    pod = obj["spec"]["template"]["spec"]
    return pod, pod["containers"][0]


def dockerfile_stages(path: Path = DEPLOY_DIR / "Dockerfile") -> list:
    """The Dockerfile's stages, each a list of (instruction, argument text)
    with continuation lines joined and comments dropped."""
    stages: list = []
    logical = ""
    for line in path.read_text().splitlines():
        if not logical and (not line.strip() or line.lstrip().startswith("#")):
            continue
        logical += line.rstrip()
        if logical.endswith("\\"):
            logical = logical[:-1] + " "
            continue
        instruction, _, rest = logical.strip().partition(" ")
        if instruction.upper() == "FROM":
            stages.append([])
        stages[-1].append((instruction.upper(), " ".join(rest.split())))
        logical = ""
    return stages


def build_context(dst: Path) -> Path:
    """Copy what the Dockerfile's build stage copies from the repo (its COPY
    sources, to their destinations under ``/src``) into ``dst``; return
    where ``/src`` landed. Only the interpreter's caches stay behind: build
    outputs such as ``_build/`` go along, as into a docker build without a
    .dockerignore, so the wheel has to leave them out itself."""
    import shutil

    src = dst / "src"
    for instruction, text in dockerfile_stages()[0]:
        if instruction != "COPY":
            continue
        *sources, target = text.split()
        for source in sources:
            path, at = REPO / source, src / target.removeprefix("/src").lstrip("/")
            if path.is_dir():
                shutil.copytree(path, at, ignore=shutil.ignore_patterns("__pycache__"))
                continue
            if target.endswith("/"):
                at = at / path.name
            at.parent.mkdir(parents=True, exist_ok=True)
            shutil.copy(path, at)
    return src


def build_image(src: Path, tmp: Path) -> dict:
    """The image's two stages on this host, from :func:`build_context`'s
    copy. Build stage: its g++ line as written (``/src`` moved to ``src``)
    beside the wheel, built offline by ``pip wheel`` where the stage runs
    ``python -m build`` (which fetches its build dependencies); the
    stage's apt-get is this host's g++. Runtime stage: the wheel unpacked
    into ``tmp/site`` (``pip install`` without extras installs its files
    and no torch) and made read-only, the library copied to its
    destination under ``tmp``, ENV paths moved under ``tmp``, the
    ENTRYPOINT read. Any other instruction fails, so the emulation cannot
    drift from the Dockerfile."""
    import shlex
    import shutil
    import zipfile

    build, runtime = dockerfile_stages()
    dist = tmp / "dist"
    procs = []
    t0 = time.monotonic()
    for instruction, text in build:
        if instruction in ("FROM", "COPY") or text.startswith("apt-get "):
            continue
        if instruction == "RUN" and text.startswith("g++ "):
            argv = [a.replace("/src", str(src)) for a in shlex.split(text)]
        elif instruction == "RUN" and "python -m build --wheel" in text:
            argv = [sys.executable, "-m", "pip", "wheel", "--no-build-isolation", "--no-deps",
                    "--no-index", "--disable-pip-version-check", "-w", str(dist), str(src)]
        else:
            raise AssertionError(f"deploy: the build stage's {instruction} {text} is not emulated")
        procs.append(subprocess.Popen(argv, cwd=src, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    for proc in procs:
        out, _ = proc.communicate(timeout=300)
        if proc.returncode != 0:
            raise AssertionError(f"deploy: {proc.args[:3]} exited {proc.returncode}:\n"
                                 f"{out[-3000:]}")
    build_s = time.monotonic() - t0
    (wheel,) = dist.glob("*.whl")
    image = {"site": tmp / "site", "wheel": wheel, "lib": None, "env": {}, "entrypoint": None,
             "build_s": build_s}
    for instruction, text in runtime:
        if instruction == "COPY" and text.startswith("--from=build /dist/"):
            with zipfile.ZipFile(wheel) as whl:
                whl.extractall(image["site"])
        elif instruction == "COPY" and text.startswith("--from=build "):
            source, target = text.split()[1:]
            image["lib"] = tmp / target.lstrip("/")
            image["lib"].parent.mkdir(parents=True, exist_ok=True)
            shutil.copy(source.replace("/src", str(src)), image["lib"])
        elif instruction == "ENV":
            key, _, value = text.partition("=")
            image["env"][key] = str(tmp / value.lstrip("/")) if value.startswith("/") else value
        elif instruction == "ENTRYPOINT":
            (image["entrypoint"],) = json.loads(text)
        elif not (instruction == "FROM" or text.startswith("pip install --no-cache-dir /tmp/")):
            raise AssertionError(f"deploy: the runtime stage's {instruction} {text} "
                                 "is not emulated")
    for path in [image["site"], *image["site"].rglob("*")]:
        path.chmod(path.stat().st_mode & ~0o222)
    return image


def tree_state(root: Path) -> dict:
    """{relative path: (size, mtime)} of everything under ``root``."""
    return {str(p.relative_to(root)): (p.stat().st_size, p.stat().st_mtime_ns)
            for p in root.rglob("*")}


def container_argv(container: dict, tmp: Path, port: int,
                   targets: str | None = None) -> tuple[list, list]:
    """The container's args on this host: every absolute path moves under
    ``tmp``, ``--port`` (added where the manifest keeps the default) to
    ``port``, and ``--targets`` to ``targets``. Returns (args, rewrites)."""
    args, rewrites = [], []
    for arg in container.get("args", []):
        flag, eq, value = arg.partition("=")
        new = value
        if flag == "--port":
            new = str(port)
        elif flag == "--targets" and targets is not None:
            new = targets
        elif value.startswith("/"):
            new = str(tmp / value.lstrip("/"))
        if new != value:
            rewrites.append({"arg": flag, "manifest": value, "here": new})
        args.append(f"{flag}={new}" if eq else arg)
    if not any(r["arg"] == "--port" for r in rewrites):
        args.append(f"--port={port}")
        rewrites.append({"arg": "--port", "manifest": None, "here": str(port)})
    return args, rewrites


def container_env(container: dict, image_env: dict) -> tuple[dict, list]:
    """A container's environment on this host: this process's without
    PYTHONPATH, the image's ENV, the manifest's env; the downward-API node
    name is this host's name, and LD_LIBRARY_PATH stays this host's, where
    its driver is. Returns (env, rewrites)."""
    import socket

    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(image_env)
    rewrites = []
    for var in container.get("env", []):
        name = var["name"]
        if name == "LD_LIBRARY_PATH":
            rewrites.append({"env": name, "manifest": var["value"], "here": env.get(name, "")})
        elif "valueFrom" in var:
            field = var["valueFrom"]["fieldRef"]["fieldPath"]
            if field != "spec.nodeName":
                raise AssertionError(f"deploy: {name} from {field} is not emulated")
            env[name] = socket.gethostname()
            rewrites.append({"env": name, "manifest": field, "here": env[name]})
        else:
            env[name] = var["value"]
    return env, rewrites


def start_container(image: dict, kind: str, entry: str, args: list, env: dict,
                    cwd: Path, log: Path) -> subprocess.Popen:
    """A container's process from the unpacked wheel under the bootstrap
    (``kind`` "script" for the ENTRYPOINT, "module" for ``python -m``),
    stdout piped, stderr into ``log``. Waits for the bootstrap's first
    line and checks it: the package from the wheel, libtpumon the library
    TPE_NATIVE_LIB names."""
    with open(log, "wb") as err:
        proc = subprocess.Popen(
            [sys.executable, "-s", "-B", "-c", DEPLOY_BOOTSTRAP, str(image["site"]), kind,
             entry, *args], cwd=cwd, env=env, stdout=subprocess.PIPE, stderr=err, text=True)
    line = proc.stdout.readline()
    if not line:
        raise AssertionError(f"deploy: {entry} exited {proc.wait()}:\n"
                             f"{log.read_text(errors='replace')[-3000:]}")
    proc.started = json.loads(line)
    if not Path(proc.started["package"]).is_relative_to(image["site"]):
        raise AssertionError(f"deploy: {entry} imported {proc.started['package']}")
    if proc.started["native_lib"] != image["env"]["TPE_NATIVE_LIB"]:
        raise AssertionError(f"deploy: {entry} loaded libtpumon {proc.started['native_lib']}, "
                             f"not TPE_NATIVE_LIB {image['env']['TPE_NATIVE_LIB']}")
    return proc


def stop_container(proc: subprocess.Popen, grace_s: float) -> dict:
    """SIGTERM, then SIGKILL after ``grace_s`` as the kubelet would: the
    exit code, the seconds to exit and the bootstrap's exit line."""
    import signal

    t0 = time.monotonic()
    proc.send_signal(signal.SIGTERM)
    try:
        out, _ = proc.communicate(timeout=grace_s)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, _ = proc.communicate()
    lines = [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]
    return {"rc": proc.returncode, "drain_s": time.monotonic() - t0,
            **(lines[-1] if lines else {})}


def status_bytes(pid: int) -> dict:
    """VmRSS, and VmHWM where the kernel keeps it, in bytes."""
    out = {}
    with open(f"/proc/{pid}/status") as f:
        for line in f:
            key, _, value = line.partition(":")
            if key in ("VmRSS", "VmHWM"):
                out[key] = float(value.split()[0]) * 1024
    return out


def rss_by_mapping(pid: int, top: int = 8) -> dict:
    """A process's resident bytes by what they map (a file, ``[heap]``,
    ``[anon]``): the ``top`` largest, from /proc/<pid>/smaps."""
    sizes: dict = {}
    name = None
    with open(f"/proc/{pid}/smaps") as f:
        for line in f:
            head = line.split()
            if re.fullmatch(r"[0-9a-f]+-[0-9a-f]+", head[0]):
                name = head[5] if len(head) > 5 else "[anon]"
            elif head[0] == "Rss:":
                sizes[name] = sizes.get(name, 0) + int(head[1]) * 1024
    return dict(sorted(sizes.items(), key=lambda kv: -kv[1])[:top])


def run_deployment(image: dict, tmp: Path, extra_args: tuple = (), load=None,
                   fill_bytes: int = 0, card_nodes: set | None = None) -> dict:
    """The DaemonSet's container from the image, then the aggregator's on
    it. With ``load``: once both serve, start it, wait for the card's
    ``gpu_hbm_used_bytes`` (the series of ``card_nodes``; None: every
    series) to rise by ``fill_bytes`` at the exporter and the pool to rise
    by as much at the aggregator (keeping that /metrics body of the
    aggregator's), stop it, wait for the fall. Then SIGTERM both. Returns
    what it saw."""
    import threading

    pod, node = deploy_container("daemonset.yaml", "DaemonSet", "gpu-pod-exporter")
    _, agg = deploy_container("aggregator.yaml", "Deployment", "tpu-slice-aggregator")
    grace_s = float(pod["terminationGracePeriodSeconds"])
    probes = {"readiness": node["readinessProbe"]["httpGet"]["path"],
              "liveness": node["livenessProbe"]["httpGet"]["path"]}
    node_port, agg_port = free_port(), free_port()
    node_args, rewrites = container_argv(node, tmp, node_port)
    node_env, env_rewrites = container_env(node, image["env"])
    seen = {"rewrites": rewrites + env_rewrites, "grace_s": grace_s,
            "limits": node["resources"]["limits"], "aggregator_command": agg["command"]}
    base = f"http://127.0.0.1:{node_port}"
    logs = {name: tmp / f"{name}.log" for name in ("exporter", "aggregator")}
    procs: dict = {}
    loaded = False

    def cards() -> dict:
        return {s.labels["device_path"]: s.value
                for s in samples_of(http_get(base + "/metrics")[1], "gpu_hbm_used_bytes")}

    def card_used(ok=lambda used: True) -> list | None:
        """[the card's used bytes] once it is served and ``ok``, else None."""
        used = [v for path, v in cards().items() if card_nodes is None or path in card_nodes]
        return [sum(used)] if used and ok(sum(used)) else None

    def pool() -> tuple | None:
        seen["aggregator_body"] = http_get(f"http://127.0.0.1:{agg_port}/metrics")[1]
        table = rollups(parsed(seen["aggregator_body"]))
        used = pick(table, "tpu_slice_hbm_used_bytes", family="gpu")
        chips = pick(table, "tpu_slice_chip_count", family="gpu")
        return (used, chips) if used is not None and chips == len(seen["cards"]) else None

    def usage() -> dict:
        cpu, _ = proc_usage(procs["exporter"].pid)
        return {"t": time.monotonic(), "cpu_s": cpu,
                "threads": thread_schedstat(procs["exporter"].pid)}

    def sample_rss(pid: int) -> None:
        while not sampled.wait(DEPLOY_RSS_EVERY_S):
            try:
                rss.append(status_bytes(pid))
            except OSError:  # the process has exited
                return

    rss: list = []
    sampled = threading.Event()
    try:
        t0 = time.monotonic()
        procs["exporter"] = start_container(image, "script", image["entrypoint"],
                                            [*node_args, *extra_args], node_env, tmp,
                                            logs["exporter"])
        sampler = threading.Thread(target=sample_rss, args=(procs["exporter"].pid,),
                                   name="deploy-rss", daemon=True)
        sampler.start()
        (seen["idle_used"],) = wait_for(
            card_used, DEPLOY_START_S, f"the exporter's series of {sorted(card_nodes or [])} "
            f"(log: {logs['exporter']})", phase="deploy")
        seen["ready_s"] = time.monotonic() - t0
        seen["cards"] = cards()
        seen["maps_native_lib"] = image["env"]["TPE_NATIVE_LIB"] in Path(
            f"/proc/{procs['exporter'].pid}/maps").read_text()
        if agg["command"][:2] != ["python", "-m"]:
            raise AssertionError(f"deploy: the aggregator's command {agg['command']}")
        agg_args, seen["aggregator_rewrites"] = container_argv(
            agg, tmp, agg_port, targets=f"127.0.0.1:{node_port}")
        agg_env, _ = container_env(agg, image["env"])
        procs["aggregator"] = start_container(image, "module", agg["command"][2], agg_args,
                                              agg_env, tmp, logs["aggregator"])
        seen["pool_idle"] = wait_for(pool, DEPLOY_START_S, "the aggregator's pool rollup",
                                     phase="deploy")
        seen["probes_idle"] = {name: http_get(base + path)[0] for name, path in probes.items()}
        seen["usage"] = [usage()]
        if load is not None:
            load.start()
            loaded = True
            (seen["filled_used"],) = wait_for(
                lambda: card_used(lambda v: v >= seen["idle_used"] + fill_bytes),
                DEPLOY_START_S, "the card's rise by the fill", phase="deploy")
            seen["fill_s"] = time.monotonic() - seen["usage"][0]["t"]
            seen["pool_filled"] = wait_for(
                lambda: (p := pool()) and p[0] >= seen["pool_idle"][0] + fill_bytes and p,
                DEPLOY_START_S, "the pool's rise by the fill", phase="deploy")
            seen["aggregator_filled_body"] = seen["aggregator_body"]
            seen["probes_load"] = {name: http_get(base + path)[0]
                                   for name, path in probes.items()}
            seen["usage"].append(usage())
            loaded = False
            load.stop()
            (seen["released_used"],) = wait_for(
                lambda: card_used(lambda v: v < seen["idle_used"] + fill_bytes / 2),
                DEPLOY_START_S, "the card's fall after the release", phase="deploy")
        seen["usage"].append(usage())
        seen["latency"] = exporter_latency(http_get(base + "/metrics")[1])
        seen["rss_by_mapping"] = rss_by_mapping(procs["exporter"].pid)
        sampled.set()
        sampler.join(timeout=5)
        seen["rss"] = rss
        seen["started"] = {name: proc.started for name, proc in procs.items()}
        seen["exits"] = {name: stop_container(procs.pop(name), grace_s)
                         for name in ("aggregator", "exporter")}
    finally:
        sampled.set()
        if loaded:
            load.stop()
        for proc in procs.values():
            proc.kill()
            proc.wait()
        seen["logs"] = {name: path.read_text(errors="replace")[-2000:]
                        for name, path in logs.items() if path.exists()}
    return seen


def check_deployment(seen: dict) -> dict:
    """The checks every run of :func:`run_deployment` must pass; returns
    the exporter's peak RSS and CPU seconds a second beside its limits."""
    mem_limit = kube_quantity(seen["limits"]["memory"])
    for name, end in seen["exits"].items():
        if (end["rc"] != 0 or end["drain_s"] > seen["grace_s"]
                or end.get("refused_loaded") != [] or end.get("refused_attempts") != []):
            raise AssertionError(f"deploy: the {name} ended {end}:\n{seen['logs'][name]}")
    codes = {**seen["probes_idle"], **{f"{k}_load": v
                                       for k, v in seen.get("probes_load", {}).items()}}
    if set(codes.values()) != {200}:
        raise AssertionError(f"deploy: the probes answered {codes}")
    if not seen["maps_native_lib"]:
        raise AssertionError("deploy: the exporter has not mapped TPE_NATIVE_LIB")
    usage = seen["usage"]
    peak = max(max(r.values()) for r in seen["rss"])
    if peak >= mem_limit:
        raise AssertionError(f"deploy: the exporter's peak RSS {peak:.0f} B reaches the "
                             f"manifest's limit {mem_limit:.0f} B")
    return {"peak_rss_bytes": peak, "rss_samples": len(seen["rss"]),
            "memory_limit_bytes": mem_limit,
            "cpu_s_per_s": (usage[-1]["cpu_s"] - usage[0]["cpu_s"])
            / (usage[-1]["t"] - usage[0]["t"]),
            "cpu_limit": kube_quantity(seen["limits"]["cpu"])}


def phase_deploy(dev, tm, hwcheck) -> dict:
    """Phase 17: the GPU image emulated on the card's host, and its
    DaemonSet's and aggregator's containers run from it as their manifests
    write them, under the full-size load held by this process. Returns the
    launches by kernel of that load."""
    import tempfile

    t_phase = time.monotonic()
    reset_counts(tm)
    stim = hwcheck.TorchStimulus(hbm_bytes=FILL_BYTES, width=WIDTH, depth=DEPTH,
                                 batch=BATCH, iters=ITERS, device=dev)
    with tempfile.TemporaryDirectory() as tmp_name:
        tmp = Path(tmp_name)
        image = build_image(build_context(tmp), tmp)
        before = tree_state(image["site"])
        emit("deploy_image", build_s=image["build_s"], wheel=image["wheel"].name,
             wheel_bytes=image["wheel"].stat().st_size,
             files=sum(p.is_file() for p in image["site"].rglob("*")),
             env=image["env"], entrypoint=image["entrypoint"])
        torch.empty(0, device=dev)  # a context on the card holds its node open
        held = held_card_nodes()
        if not held:
            raise AssertionError("deploy: this process holds no /dev/nvidia<N> node")
        seen = run_deployment(image, tmp, load=stim, fill_bytes=FILL_BYTES, card_nodes=held)
        changed = sorted(k for k, v in tree_state(image["site"]).items() if before.get(k) != v)
        changed += sorted(before.keys() - tree_state(image["site"]).keys())
    cost = check_deployment(seen)
    (CAPTURE_DIR / "h100-aggregate.txt").write_bytes(seen["aggregator_filled_body"])
    node, agg = seen["exits"]["exporter"], seen["exits"]["aggregator"]
    emit("deploy_exporter", package=seen["started"]["exporter"]["package"],
         native_lib=seen["started"]["exporter"]["native_lib"], rewrites=seen["rewrites"],
         cards=seen["cards"], ready_s=seen["ready_s"],
         probes={"idle": seen["probes_idle"], "load": seen["probes_load"]},
         used_bytes={"idle": seen["idle_used"], "filled": seen["filled_used"],
                     "released": seen["released_used"]},
         rise_bytes=seen["filled_used"] - seen["idle_used"], fill_s=seen["fill_s"],
         vm_hwm_kept="VmHWM" in seen["rss"][-1], **cost, rss_by_mapping=seen["rss_by_mapping"],
         rc=node["rc"], drain_s=node["drain_s"],
         grace_s=seen["grace_s"], refused_attempts=node["refused_attempts"],
         refused_loaded=node["refused_loaded"], poll_phase_ms=seen["latency"])
    latency, usage = seen["latency"], seen["usage"]
    emit_device_read("deploy", {"daemonset": latency.get("device_read", {}).get("p99_ms")},
                     polls={"daemonset": latency["polls"]},
                     scrape_p99_ms={"daemonset": latency["scrape"]["p99_ms"]},
                     scrapes={"daemonset": latency["scrape"]["scrapes"]},
                     device_read_buckets_ms={"daemonset": latency["device_read_buckets_ms"]},
                     run_queue_wait={"daemonset": {
                         stage: run_queue_wait(usage[a]["threads"], usage[b]["threads"],
                                               usage[b]["t"] - usage[a]["t"])
                         for stage, a, b in (("load", 0, 1), ("release", 1, 2))}})
    emit("deploy_aggregator", command=seen["aggregator_command"],
         rewrites=seen["aggregator_rewrites"],
         pool={"idle": seen["pool_idle"], "filled": seen["pool_filled"]},
         rc=agg["rc"], drain_s=agg["drain_s"], refused_attempts=agg["refused_attempts"],
         refused_loaded=agg["refused_loaded"])
    if seen["filled_used"] - seen["idle_used"] < FILL_BYTES:
        raise AssertionError(f"deploy: the card rose {seen['filled_used'] - seen['idle_used']} B")
    if changed:
        raise AssertionError(f"deploy: the read-only wheel changed: {changed[:20]}")
    launches = tm.tanh_matmul.launches
    by_kernel = launch_counts(tm)
    emit("deploy", seconds=time.monotonic() - t_phase, burn_steps=stim.steps,
         launches_by_kernel=by_kernel, card=card_line())
    if launches <= 0:
        raise AssertionError("no tanh_matmul launch during the deploy phase")
    check_all_wgmma(tm, "deploy", launches)
    return by_kernel


def probe_spec(report: dict) -> dict:
    """An NVML probe's report as a simulated-driver spec
    (``--nvml-sim-spec``): each device's name, UUID, memory, utilization and
    process rows, and each call that failed as a fault that answers its
    NVML code on every call a test makes (a field that failed has no value
    in the spec)."""
    gpus = []
    for dev in report["devices"]:
        gpu = {"name": dev["name"], "uuid": dev["uuid"], "utilization": None,
               "processes": [[pid, used, ""] for pid, used in dev["processes"]]}
        for key, field in (("mem_total", "memory_total_bytes"),
                           ("mem_used", "memory_used_bytes"),
                           ("utilization", "utilization_percent")):
            if not isinstance(dev[field], str):  # a failed call's field is its code
                gpu[key] = dev[field]
        gpus.append(gpu)
    faults = [{"call": label.split("(")[0], "code": text.split()[0], "times": 1 << 20}
              for label, text in sorted(report["errors"].items())]
    return {"gpus": gpus, "faults": faults}


def check_capture(directory: Path) -> dict:
    """The capture in ``directory`` replayed through the port. Every file of
    CAPTURES is in the manifest with its phase, size and sha256, under
    CAPTURE_MAX_BYTES. The recording: one card each frame, of the
    manifest's name, NVML's memory total within 1 MiB of nvidia-smi's, used
    memory up by the fill and back within 1 GiB, a process row holding the
    fill, every frame through a Collector to the same gpu_hbm_used_bytes.
    The node's /metrics body: the smoke pod at the fill, parsed alike by
    both parsers, one card of the gpu family at the fill through a
    SliceAggregator. The aggregator's body: one card at the fill, every
    target up. The status document: the card at the fill, held by the
    smoke pod. The probe: the card, its answers replayed through a
    simulated driver to the same sample. Raises on any difference; returns
    what it read."""
    import hashlib

    from tpu_pod_exporter_torch.aggregate import CONSUMED_NAMES, SliceAggregator
    from tpu_pod_exporter_torch.attribution.fake import FakeAttribution
    from tpu_pod_exporter_torch.backend.nvml import NvmlBackend, sim_driver_from_spec
    from tpu_pod_exporter_torch.backend.recorded import RecordedBackend
    from tpu_pod_exporter_torch.collector import Collector
    from tpu_pod_exporter_torch.metrics import SnapshotStore
    from tpu_pod_exporter_torch.metrics.parse import (
        LayoutCache,
        parse_exposition,
        parse_exposition_layout,
    )

    def need(ok: bool, what: str) -> None:
        if not ok:
            raise AssertionError(f"capture: {what}")

    manifest = json.loads((directory / CAPTURE_MANIFEST).read_text())
    files = manifest["files"]
    need(sorted(files) == sorted(CAPTURES), f"the manifest lists {sorted(files)}")
    for name, entry in files.items():
        data = (directory / name).read_bytes()
        need(entry == {"phase": CAPTURES[name], "bytes": len(data),
                       "sha256": hashlib.sha256(data).hexdigest()},
             f"{name} is not as its manifest entry {entry}")
        need(len(data) < CAPTURE_MAX_BYTES, f"{name} holds {len(data)} B")
    name = manifest["card"].split(",")[0]
    total = int(manifest["memory_total"].split()[0]) << 20
    probe = json.loads((directory / "h100-probe.json").read_text())
    need(probe["reachable"] and probe["count"] == 1 and probe["devices"][0]["name"] == name,
         f"the probe {probe}")
    (card,) = probe["devices"]
    node = f"/dev/nvidia{card['minor']}"

    # The recording, frame by frame, and through a Collector.
    trace = str(directory / "h100-trace.jsonl")
    frames = RecordedBackend(trace, loop=False)
    samples = [frames.sample() for _ in range(len(frames))]
    chips = [c for s in samples for c in s.chips]
    need(frames.family == "gpu" and len(chips) == len(samples)
         and {(c.info.family, c.info.device_kind, c.info.device_path) for c in chips}
         == {("gpu", name, node)}, f"the recording's cards {chips[:1]}")
    need(all(abs(c.hbm_total_bytes - total) <= 1 << 20 for c in chips),
         f"NVML's total {chips[0].hbm_total_bytes} B, nvidia-smi's {manifest['memory_total']}")
    used = [c.hbm_used_bytes for c in chips]
    need(max(used) - used[0] >= FILL_BYTES and abs(used[-1] - used[0]) <= 1 << 30,
         f"the recorded used memory {used}")
    need(max(p.used_bytes or 0.0 for c in chips for p in c.processes) >= FILL_BYTES,
         "no recorded process row holds the fill")
    store = SnapshotStore()
    collector = Collector(RecordedBackend(trace, loop=False), FakeAttribution(), store)
    served = []
    for _ in samples:
        collector.poll_once()
        served += [s.value for s in parse_exposition(store.current().encode().decode())
                   if s.name == "gpu_hbm_used_bytes"]
    need(served == used, "the Collector served other gpu_hbm_used_bytes than recorded")

    # The node's /metrics body and the deployed aggregator's.
    body = (directory / "h100-metrics.txt").read_text()
    pod = [s.value for s in parse_exposition(body)
           if s.name == "gpu_pod_memory_used_bytes" and s.labels.get("pod") == SMOKE_POD]
    need(pod and pod[0] >= FILL_BYTES, f"the node's body holds pod {SMOKE_POD} at {pod}")
    layout = LayoutCache()
    for _ in ("cold", "warm"):
        need([tuple(s) for s in parse_exposition_layout(body, CONSUMED_NAMES, layout)]
             == [tuple(s) for s in parse_exposition(body, CONSUMED_NAMES)],
             "the layout parser and the plain one differ on the node's body")
    agg_store = SnapshotStore()
    agg = SliceAggregator(("node:8000",), agg_store, fetch=lambda target, timeout_s: body)
    agg.poll_once()
    agg.close()
    folded = rollups(parsed(agg_store.current().encode()))
    aggregate = rollups(parsed((directory / "h100-aggregate.txt").read_bytes()),
                        ("tpu_slice_", "tpu_aggregator_target_up"))
    for who, table in (("the node's body folded", folded), ("the aggregator's body", aggregate)):
        need(pick(table, "tpu_slice_chip_count", family="gpu") == 1.0
             and pick(table, "tpu_slice_hbm_used_bytes", family="gpu") >= FILL_BYTES,
             f"{who}: {table}")
    up = [v for (n, _), v in aggregate.items() if n == "tpu_aggregator_target_up"]
    need(up and set(up) == {1.0}, f"the aggregator's targets up {up}")

    # The status document on the node.
    status = json.loads((directory / "h100-status.json").read_text())
    need([(c["device_kind"], c["device_path"], c["pod"]) for c in status["chips"]]
         == [(name, node, SMOKE_POD)] and status["chips"][0]["hbm_used_bytes"] >= FILL_BYTES,
         f"status on the node {status['chips']}")

    # The probe's answers through a simulated driver.
    (chip,) = NvmlBackend(driver=sim_driver_from_spec(probe_spec(probe))).sample().chips
    need((chip.info.device_kind, chip.info.device_ids[0], chip.hbm_used_bytes,
          chip.hbm_total_bytes)
         == (name, card["uuid"], card["memory_used_bytes"], card["memory_total_bytes"]),
         f"the probe's answers replayed as {chip}")
    return {"frames": len(samples), "used_bytes": {"first": used[0], "max": max(used),
                                                   "last": used[-1]},
            "device_path": node, "total_bytes": chips[0].hbm_total_bytes,
            "utilization": sorted({c.tensorcore_duty_cycle_percent for c in chips},
                                  key=lambda v: (v is None, v or 0.0)),
            "partial_errors": sorted({e for s in samples for e in s.partial_errors}),
            "probe_errors": probe["errors"], "node_pod_bytes": pod[0],
            "status_used_bytes": status["chips"][0]["hbm_used_bytes"]}


def phase_capture(kind: str) -> dict:
    """Phase 18: the manifest of what the phases captured, then the capture
    replayed through the port (``check_capture``) and its replay demos."""
    import datetime
    import hashlib

    t_phase = time.monotonic()
    files = {}
    for name, phase in CAPTURES.items():
        data = (CAPTURE_DIR / name).read_bytes()
        files[name] = {"phase": phase, "bytes": len(data),
                       "sha256": hashlib.sha256(data).hexdigest()}
    manifest = {"card": card_line(), "device": kind,
                "driver_version": nvidia_smi("driver_version"),
                "memory_total": nvidia_smi("memory.total"), "torch": torch.__version__,
                "cuda": torch.version.cuda,
                "utc": datetime.datetime.now(datetime.timezone.utc).isoformat(),
                "files": files}
    (CAPTURE_DIR / CAPTURE_MANIFEST).write_text(json.dumps(manifest, indent=1) + "\n")
    replayed = check_capture(CAPTURE_DIR)
    trace = str(CAPTURE_DIR / "h100-trace.jsonl")
    demos = {"trace": run_port("trace", "--replay", trace),
             "history": run_port("history", "--replay", trace)}
    for demo, proc in demos.items():
        if proc.returncode != 0 or (demo == "trace" and not (
                "device_read" in proc.stdout and "publish" in proc.stdout)):
            raise AssertionError(f"capture: {demo} --replay rc={proc.returncode}\n"
                                 f"{proc.stdout[-2000:]}{proc.stderr[-2000:]}")
    emit("capture", seconds=time.monotonic() - t_phase, manifest=manifest,
         replayed=replayed, demos={demo: proc.returncode for demo, proc in demos.items()})
    return manifest


def run_budget_check(tmp: str, module: str, args: tuple) -> tuple:
    """``python -m tpu_pod_exporter_torch.<module> *args`` from the repo's
    root, the values of its state flags and TMPDIR in a new directory under
    ``tmp``: (exit code, stdout then stderr, seconds)."""
    import tempfile

    state = Path(tempfile.mkdtemp(dir=tmp))
    argv = [str(state / a) if i and args[i - 1] in BUDGET_STATE_FLAGS else a
            for i, a in enumerate(args)]
    t0 = time.monotonic()
    proc = run_port(module, *argv, timeout=BUDGET_TIMEOUT_S,
                    env=dict(os.environ, TMPDIR=str(state)))
    return proc.returncode, proc.stdout + proc.stderr, time.monotonic() - t0


def egress_overhead(text: str) -> float | None:
    """The egress demo's wedged-receiver p99s against its egress-off
    baseline, in per cent of what its --perf-budget bounds: it passes while
    (wedged - 2 ms) / baseline - 1 is within the budget for both the scrape
    and the poll. The larger of the two."""
    base = re.search(r"baseline: scrape p99 ([\d.]+)ms, poll p99 ([\d.]+)ms", text)
    wedged = re.search(r"during wedge: scrape p99 ([\d.]+)ms, poll p99 ([\d.]+)ms", text)
    if base is None or wedged is None:
        return None
    return max(100.0 * ((float(w) - 2.0) / float(b) - 1.0)
               for b, w in zip(base.groups(), wedged.groups()))


def budget_value(check: dict, text: str) -> float | None:
    """A timing check's measured value, read from its output."""
    if check["value"] is None:
        return egress_overhead(text)
    match = re.search(check["value"], text)
    return None if match is None else float(match[1])


def budget_verdict(rc: int, text: str) -> str | None:
    """"ok" for a run that exited 0; "timing miss" for one that failed on
    its own budget line alone; None for any other failure, or a traceback."""
    if "Traceback (most recent call last)" in text:
        return None
    if rc == 0:
        return "ok"
    fails = [ln for ln in text.splitlines() if ln.startswith("FAIL") or "FAILED" in ln]
    if rc == 1 and fails and all(BUDGET_MISS.search(ln) for ln in fails):
        return "timing miss"
    return None


def phase_budgets(seconds: float) -> dict:
    """Phase 19: the Makefile's host checks against the port, the card
    idle, the timing checks' repeats only while they fit in ``seconds``.
    Returns each timing check's median by target."""
    import tempfile

    t_phase = time.monotonic()
    deadline = t_phase + seconds
    runs: dict = {check["target"]: [] for check in BUDGET_TIMING}

    def run(check: dict) -> None:
        rc, out, took = run_budget_check(tmp, check["module"], check["args"])
        record = {"rc": rc, "seconds": took, "value": budget_value(check, out),
                  "verdict": budget_verdict(rc, out)}
        runs[check["target"]].append(record)
        if record["verdict"] is None or record["value"] is None:
            raise AssertionError(f"budgets: {check['target']} {runs[check['target']]}\n"
                                 f"{out[-3000:]}")

    with tempfile.TemporaryDirectory() as tmp:
        for target, module, args, ok_text in BUDGET_FUNCTIONAL:
            rc, out, took = run_budget_check(tmp, module, args)
            ok_line = next((ln.strip() for ln in out.splitlines() if ok_text in ln), None)
            emit("budget", target=target, kind="functional", rc=rc, seconds=took,
                 ok_line=ok_line)
            if rc != 0 or ok_line is None:
                raise AssertionError(f"budgets: {target} rc={rc}, want 0 and {ok_text!r}\n"
                                     f"{out[-3000:]}")
        for check in BUDGET_TIMING:
            run(check)
        for check in sorted(BUDGET_TIMING, key=lambda c: -runs[c["target"]][0]["seconds"]):
            cost = runs[check["target"]][0]["seconds"]
            while (len(runs[check["target"]]) < check["runs"]
                   and time.monotonic() + cost <= deadline):
                run(check)
    medians = {}
    for check in BUDGET_TIMING:
        done = runs[check["target"]]
        median = medians[check["target"]] = statistics.median(r["value"] for r in done)
        emit("budget", target=check["target"], kind="timing", unit=check["unit"], runs=done,
             runs_planned=check["runs"], median=median, budgets=check["budgets"],
             median_meets={name: median <= budget for name, budget in check["budgets"].items()},
             card=card_line())
    misses = sum(r["verdict"] == "timing miss" for done in runs.values() for r in done)
    emit("budgets", seconds=time.monotonic() - t_phase, seconds_allowed=seconds,
         checks=len(BUDGET_FUNCTIONAL) + len(BUDGET_TIMING), timing_misses=misses,
         repeats_cut=[c["target"] for c in BUDGET_TIMING
                      if len(runs[c["target"]]) < c["runs"]], card=card_line())
    return medians


def main() -> int:
    from tpu_pod_exporter_torch import hwcheck, nativelib
    from tpu_pod_exporter_torch.kernels import online_softmax as osm
    from tpu_pod_exporter_torch.kernels import sgd
    from tpu_pod_exporter_torch.kernels import tanh_matmul as tm
    from tpu_pod_exporter_torch.loadgen import parallel as par
    from tpu_pod_exporter_torch.loadgen import sharded
    from tpu_pod_exporter_torch.loadgen import workload as wl

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible to torch", file=sys.stderr)
        return 2

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    # A hang anywhere becomes every thread's traceback on stderr and a
    # non-zero exit inside the run's time limit.
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    smi = card_line()
    uuid = nvidia_smi("uuid")
    emit("device", kind=kind, count=torch.cuda.device_count(), nvidia_smi=smi,
         uuid=uuid, torch=torch.__version__, cuda=torch.version.cuda)
    shutil.rmtree(CAPTURE_DIR, ignore_errors=True)  # the recording appends
    CAPTURE_DIR.mkdir(parents=True)

    t0 = time.monotonic()
    path, log = tm.build()
    emit("build", seconds=time.monotonic() - t0, library=path.name,
         ptxas=[ln.strip() for ln in log.splitlines()
                if "ptxas" in ln or "spill" in ln])  # spills print unprefixed
    t0 = time.monotonic()
    prebuilt = nativelib.library_path().exists()
    libtpumon = nativelib.build()
    emit("build_libtpumon", seconds=time.monotonic() - t0, prebuilt=prebuilt,
         library=str(libtpumon.relative_to(REPO)), flags=list(nativelib.CXX_FLAGS))

    records = phase_kernel(dev, tm)
    phase_workload(dev, tm, wl)
    torch.cuda.empty_cache()
    closed_loop = phase_closed_loop(dev, tm, hwcheck, uuid)
    torch.cuda.empty_cache()
    records["sgd"] = phase_sgd(dev, sgd)
    phase_grad(dev, tm, wl)
    torch.cuda.empty_cache()
    train = phase_train(dev, tm, sgd, sharded)
    torch.cuda.empty_cache()
    phase_cli(dev)
    records["online_softmax"] = phase_online_softmax(dev, osm)
    torch.cuda.empty_cache()
    parallel = phase_parallel(dev, tm, sgd, osm, par)
    torch.cuda.empty_cache()
    nvml, hwcheck_probe = phase_nvml(dev, tm, hwcheck, uuid)
    torch.cuda.empty_cache()
    node_state = phase_node_state(dev, tm, hwcheck, uuid, libtpumon)
    torch.cuda.empty_cache()
    fleet = phase_fleet(dev, tm, hwcheck, uuid)
    torch.cuda.empty_cache()
    phase_drills(dev, uuid, hwcheck_probe)
    lint = phase_lint(uuid)
    deploy = phase_deploy(dev, tm, hwcheck)
    phase_capture(kind)
    phase_budgets(SCRIPT_TARGET_S - SCRIPT_TAIL_S - (time.monotonic() - STARTED))

    # Launches on the main paths: the closed loop, the training run, the
    # collective programs, the NVML closed loop, the node state phase, the
    # fleet phase, the lint phase's witnessed closed loop and the deploy
    # phase's load (the deployed exporter itself launches none).
    names = (*SOURCES, "stage_rows", "sgd", "online_softmax")
    by_path = {kernel: {"closed_loop": closed_loop.get(kernel, 0),
                        "train": train.get(kernel, 0), "parallel": parallel[kernel],
                        "nvml": nvml.get(kernel, 0), "node_state": node_state.get(kernel, 0),
                        "fleet": fleet.get(kernel, 0), "lint_witness": lint.get(kernel, 0),
                        "deploy": deploy.get(kernel, 0)}
               for kernel in names}
    kernels = [{
        "name": tm.ENTRIES[kernel],
        "route": "cuda",
        "source": f"tpu_pod_exporter_torch/kernels/csrc/{source}",
        "replaces": "tpu_pod_exporter/loadgen/workload.py:40",
    } for kernel, source in SOURCES.items()] + [{
        "name": "stage_rows_bf16",
        "route": "cuda",
        "source": f"tpu_pod_exporter_torch/kernels/csrc/{STAGE_SOURCE}",
        "replaces": "tpu_pod_exporter/loadgen/workload.py:40",
    }, {
        "name": "sgd_update_bf16",
        "route": "cuda",
        "source": "tpu_pod_exporter_torch/kernels/csrc/sgd_update.cu",
        "replaces": "tpu_pod_exporter/loadgen/sharded.py:103",
    }, {
        "name": "online_softmax_f32",
        "route": "cuda",
        "source": "tpu_pod_exporter_torch/kernels/csrc/online_softmax.cu",
        "replaces": "tpu_pod_exporter/loadgen/parallel.py:88",
    }]
    for record, kernel in zip(kernels, names):
        record.update(launches=sum(by_path[kernel].values()),
                      launches_by_path=by_path[kernel], **records[kernel])
    faulthandler.cancel_dump_traceback_later()
    emit("script", seconds=time.monotonic() - STARTED, target_s=SCRIPT_TARGET_S)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
