"""tpu_pod_exporter_torch — the exporter's closed loop on an NVIDIA GPU, in PyTorch.

A port of ``tpu_pod_exporter`` that imports ``torch`` and never ``jax``.
It keeps the JAX package's module layout, so each counterpart sits at the
same relative path:

- ``kernels/tanh_matmul.py`` — the flagship layer ``tanh(h @ W)`` as a
  hand-written CUDA C++ kernel for Hopper (``kernels/csrc/tanh_matmul.cu``);
- ``loadgen/workload.py`` — the synthetic load (matmul chain, HBM fill);
- ``backend/torchdev.py`` — the in-process device backend, reading the
  CUDA caching allocator;
- ``hwcheck.py`` — the closed-loop check: a live exporter scraped over
  HTTP while a stimulus loads the card;
- the exporter core (collector, registry, server, history, …), copied from
  the JAX package with only the package name changed, so that the port
  holds no import of it.

Entry points run on the card; the CPU is used only where a caller asks for
it (``device="cpu"``, ``--backend fake``).
"""

from tpu_pod_exporter_torch.version import __version__

__all__ = ["__version__"]
