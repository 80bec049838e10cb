"""Vendored libtpu runtime metrics protobufs (see tpu_metric_service.proto)."""

from tpu_pod_exporter_torch.backend.proto import tpu_metric_service_pb2

__all__ = ["tpu_metric_service_pb2"]
