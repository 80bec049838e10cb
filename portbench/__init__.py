"""The benchmark of the PyTorch and CUDA port (``tpu_pod_exporter_torch``).

``python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` once on the machine it is started on
and prints its result as one JSON line (``run.py``). Everything a cell or a
metric needs is found by its name (``spec.py``); the program is started
as users start it, or, for the fleet, built as its command line builds
it, and judged against the plain reference in ``reference/``, which
imports nothing of the program. ``python -m pytest portbench/tests`` holds
the harness on the CPU; its card tests carry the ``gpu`` marker.
"""
