"""tpu_pod_exporter_torch — the exporter's closed loop on an NVIDIA GPU, in PyTorch.

A port of ``tpu_pod_exporter`` that imports ``torch`` and never ``jax``.
It keeps the JAX package's module layout, so each counterpart sits at the
same relative path:

- ``kernels/tanh_matmul.py`` — the flagship layer ``tanh(h @ W)`` as a
  hand-written CUDA C++ kernel for Hopper, wgmma fed by TMA
  (``kernels/csrc/tanh_matmul_sm90.cu``): on the operands as they lie
  wherever TMA can address them, else after ``kernels/csrc/stage_rows.cu``
  copies them to 16-byte rows at an aligned base;
- ``loadgen/workload.py`` — the synthetic load (matmul chain, HBM fill);
- ``backend/nvml.py`` over ``backend/nvml_ctypes.py`` — every card's
  memory, utilization and process table from the driver's NVML library,
  with ``backend/discovery.py`` (``/dev/nvidia<minor>``), ``procscan.py``
  (which process holds which card) and the kubelet attribution sources
  that join cards to pods;
- ``backend/torchdev.py`` — the in-process device backend, reading the
  CUDA caching allocator;
- ``hwcheck.py`` — the closed-loop check: a live exporter scraped over
  HTTP while a stimulus loads the card;
- ``nativelib.py`` — the package's own ``libtpumon``, built with g++ at
  first use from ``native/tpumon.cc`` into ``_build/``: the native
  exposition renderer (``metrics/native.py``) and ``/proc`` walk;
- ``persist.py``, ``egress.py``, ``chaos.py`` — restart survivability
  (``--state-dir``), remote-write shipping (``--egress-url``) and fault
  injection (``--chaos-spec``);
- ``aggregate.py``, ``shard.py``, ``fleet.py``, ``store.py``,
  ``stream.py``, ``alerting.py`` and ``status.py`` — the fleet plane
  above the nodes: slice rollups (the GPU family as ``family="gpu"``), the
  leaf/root/replica tree, the federated query plane, the root's store,
  streams and alerts, and the node and tree doctor;
- ``scenario.py``, ``loadgen/scenario.py``, ``fuzz.py``,
  ``loadgen/fleet.py`` and ``pressure_demo.py`` — the drills: timelines,
  the invariant-checked scenario engine, the fuzzer and the fleet,
  shard, dashboard and pressure demos, on simulated nodes;
- ``backend/libtpu.py`` — the TPU runtime-metrics gRPC backend
  (``--backend libtpu``); ``probe.py`` — what NVML (or that service)
  serves; ``tunnelwatch.py`` — the card's liveness watch;
- the exporter core (collector, registry, server, history, …) and the
  fleet plane, copied from the JAX package with only the package name
  changed, so that the port holds no import of it.

Entry points run on the card; the CPU is used only where a caller asks for
it (``device="cpu"``, ``--backend fake``, the NVML sim flags).
"""

from tpu_pod_exporter_torch.version import __version__

__all__ = ["__version__"]
