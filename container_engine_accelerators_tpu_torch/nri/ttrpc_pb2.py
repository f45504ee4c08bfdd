# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: ttrpc.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x0bttrpc.proto\x12\x05ttrpc\"t\n\x07Request\x12\x0f\n\x07service\x18\x01 \x01(\t\x12\x0e\n\x06method\x18\x02 \x01(\t\x12\x0f\n\x07payload\x18\x03 \x01(\x0c\x12\x14\n\x0ctimeout_nano\x18\x04 \x01(\x03\x12!\n\x08metadata\x18\x05 \x03(\x0b\x32\x0f.ttrpc.KeyValue\":\n\x08Response\x12\x1d\n\x06status\x18\x01 \x01(\x0b\x32\r.ttrpc.Status\x12\x0f\n\x07payload\x18\x02 \x01(\x0c\"\'\n\x06Status\x12\x0c\n\x04\x63ode\x18\x01 \x01(\x05\x12\x0f\n\x07message\x18\x02 \x01(\t\"&\n\x08KeyValue\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\tb\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'ttrpc_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _REQUEST._serialized_start=22
  _REQUEST._serialized_end=138
  _RESPONSE._serialized_start=140
  _RESPONSE._serialized_end=198
  _STATUS._serialized_start=200
  _STATUS._serialized_end=239
  _KEYVALUE._serialized_start=241
  _KEYVALUE._serialized_end=279
# @@protoc_insertion_point(module_scope)
