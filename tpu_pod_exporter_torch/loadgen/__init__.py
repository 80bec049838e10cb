"""Synthetic GPU workloads for telemetry validation: drive the tensor cores
with a matmul chain and fill device memory with known shapes, then assert
that the exporter reports them."""

from tpu_pod_exporter_torch.loadgen.workload import (
    burn_step,
    flagship,
    hbm_fill,
    init_params,
)

__all__ = ["burn_step", "flagship", "hbm_fill", "init_params"]
