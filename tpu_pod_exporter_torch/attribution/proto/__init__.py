"""Vendored kubelet podresources v1 protobufs.

``podresources_pb2.py`` is generated from ``podresources.proto`` via
``protoc --python_out=.``; regenerate with ``make proto`` at the repo root.
"""

from tpu_pod_exporter_torch.attribution.proto import podresources_pb2

__all__ = ["podresources_pb2"]
