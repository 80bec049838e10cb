# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: tpu_metric_service.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x18tpu_metric_service.proto\x12\x16tpu.monitoring.runtime\"$\n\rMetricRequest\x12\x13\n\x0bmetric_name\x18\x01 \x01(\t\">\n\tAttrValue\x12\x12\n\x08int_attr\x18\x01 \x01(\x03H\x00\x12\x15\n\x0bstring_attr\x18\x02 \x01(\tH\x00\x42\x06\n\x04\x61ttr\"J\n\tAttribute\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\x30\n\x05value\x18\x02 \x01(\x0b\x32!.tpu.monitoring.runtime.AttrValue\"L\n\x05Gauge\x12\x10\n\x06\x61s_int\x18\x01 \x01(\x03H\x00\x12\x13\n\tas_double\x18\x02 \x01(\x01H\x00\x12\x13\n\tas_string\x18\x03 \x01(\tH\x00\x42\x07\n\x05value\"l\n\x06Metric\x12\x34\n\tattribute\x18\x01 \x03(\x0b\x32!.tpu.monitoring.runtime.Attribute\x12,\n\x05gauge\x18\x03 \x01(\x0b\x32\x1d.tpu.monitoring.runtime.Gauge\"J\n\tTPUMetric\x12\x0c\n\x04name\x18\x01 \x01(\t\x12/\n\x07metrics\x18\x02 \x03(\x0b\x32\x1e.tpu.monitoring.runtime.Metric\"C\n\x0eMetricResponse\x12\x31\n\x06metric\x18\x01 \x01(\x0b\x32!.tpu.monitoring.runtime.TPUMetric\"\x1d\n\x1bListSupportedMetricsRequest\"&\n\x0fSupportedMetric\x12\x13\n\x0bmetric_name\x18\x01 \x01(\t\"a\n\x1cListSupportedMetricsResponse\x12\x41\n\x10supported_metric\x18\x01 \x03(\x0b\x32\'.tpu.monitoring.runtime.SupportedMetric2\x81\x02\n\x14RuntimeMetricService\x12\x63\n\x10GetRuntimeMetric\x12%.tpu.monitoring.runtime.MetricRequest\x1a&.tpu.monitoring.runtime.MetricResponse\"\x00\x12\x83\x01\n\x14ListSupportedMetrics\x12\x33.tpu.monitoring.runtime.ListSupportedMetricsRequest\x1a\x34.tpu.monitoring.runtime.ListSupportedMetricsResponse\"\x00\x62\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'tpu_metric_service_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _METRICREQUEST._serialized_start=52
  _METRICREQUEST._serialized_end=88
  _ATTRVALUE._serialized_start=90
  _ATTRVALUE._serialized_end=152
  _ATTRIBUTE._serialized_start=154
  _ATTRIBUTE._serialized_end=228
  _GAUGE._serialized_start=230
  _GAUGE._serialized_end=306
  _METRIC._serialized_start=308
  _METRIC._serialized_end=416
  _TPUMETRIC._serialized_start=418
  _TPUMETRIC._serialized_end=492
  _METRICRESPONSE._serialized_start=494
  _METRICRESPONSE._serialized_end=561
  _LISTSUPPORTEDMETRICSREQUEST._serialized_start=563
  _LISTSUPPORTEDMETRICSREQUEST._serialized_end=592
  _SUPPORTEDMETRIC._serialized_start=594
  _SUPPORTEDMETRIC._serialized_end=632
  _LISTSUPPORTEDMETRICSRESPONSE._serialized_start=634
  _LISTSUPPORTEDMETRICSRESPONSE._serialized_end=731
  _RUNTIMEMETRICSERVICE._serialized_start=734
  _RUNTIMEMETRICSERVICE._serialized_end=991
# @@protoc_insertion_point(module_scope)
