# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: podresources_v1.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x15podresources_v1.proto\x12\x02v1\"\x1d\n\x1b\x41llocatableResourcesRequest\"{\n\x1c\x41llocatableResourcesResponse\x12%\n\x07\x64\x65vices\x18\x01 \x03(\x0b\x32\x14.v1.ContainerDevices\x12\x0f\n\x07\x63pu_ids\x18\x02 \x03(\x03\x12#\n\x06memory\x18\x03 \x03(\x0b\x32\x13.v1.ContainerMemory\"\x19\n\x17ListPodResourcesRequest\"C\n\x18ListPodResourcesResponse\x12\'\n\rpod_resources\x18\x01 \x03(\x0b\x32\x10.v1.PodResources\"A\n\x16GetPodResourcesRequest\x12\x10\n\x08pod_name\x18\x01 \x01(\t\x12\x15\n\rpod_namespace\x18\x02 \x01(\t\"B\n\x17GetPodResourcesResponse\x12\'\n\rpod_resources\x18\x01 \x01(\x0b\x32\x10.v1.PodResources\"[\n\x0cPodResources\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\x11\n\tnamespace\x18\x02 \x01(\t\x12*\n\ncontainers\x18\x03 \x03(\x0b\x32\x16.v1.ContainerResources\"\x7f\n\x12\x43ontainerResources\x12\x0c\n\x04name\x18\x01 \x01(\t\x12%\n\x07\x64\x65vices\x18\x02 \x03(\x0b\x32\x14.v1.ContainerDevices\x12\x0f\n\x07\x63pu_ids\x18\x03 \x03(\x03\x12#\n\x06memory\x18\x04 \x03(\x0b\x32\x13.v1.ContainerMemory\"X\n\x0f\x43ontainerMemory\x12\x13\n\x0bmemory_type\x18\x01 \x01(\t\x12\x0c\n\x04size\x18\x02 \x01(\x04\x12\"\n\x08topology\x18\x03 \x01(\x0b\x32\x10.v1.TopologyInfo\"a\n\x10\x43ontainerDevices\x12\x15\n\rresource_name\x18\x01 \x01(\t\x12\x12\n\ndevice_ids\x18\x02 \x03(\t\x12\"\n\x08topology\x18\x03 \x01(\x0b\x32\x10.v1.TopologyInfo\"+\n\x0cTopologyInfo\x12\x1b\n\x05nodes\x18\x01 \x03(\x0b\x32\x0c.v1.NUMANode\"\x16\n\x08NUMANode\x12\n\n\x02ID\x18\x01 \x01(\x03\x32\xfb\x01\n\x12PodResourcesLister\x12\x43\n\x04List\x12\x1b.v1.ListPodResourcesRequest\x1a\x1c.v1.ListPodResourcesResponse\"\x00\x12^\n\x17GetAllocatableResources\x12\x1f.v1.AllocatableResourcesRequest\x1a .v1.AllocatableResourcesResponse\"\x00\x12@\n\x03Get\x12\x1a.v1.GetPodResourcesRequest\x1a\x1b.v1.GetPodResourcesResponse\"\x00\x62\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'podresources_v1_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _ALLOCATABLERESOURCESREQUEST._serialized_start=29
  _ALLOCATABLERESOURCESREQUEST._serialized_end=58
  _ALLOCATABLERESOURCESRESPONSE._serialized_start=60
  _ALLOCATABLERESOURCESRESPONSE._serialized_end=183
  _LISTPODRESOURCESREQUEST._serialized_start=185
  _LISTPODRESOURCESREQUEST._serialized_end=210
  _LISTPODRESOURCESRESPONSE._serialized_start=212
  _LISTPODRESOURCESRESPONSE._serialized_end=279
  _GETPODRESOURCESREQUEST._serialized_start=281
  _GETPODRESOURCESREQUEST._serialized_end=346
  _GETPODRESOURCESRESPONSE._serialized_start=348
  _GETPODRESOURCESRESPONSE._serialized_end=414
  _PODRESOURCES._serialized_start=416
  _PODRESOURCES._serialized_end=507
  _CONTAINERRESOURCES._serialized_start=509
  _CONTAINERRESOURCES._serialized_end=636
  _CONTAINERMEMORY._serialized_start=638
  _CONTAINERMEMORY._serialized_end=726
  _CONTAINERDEVICES._serialized_start=728
  _CONTAINERDEVICES._serialized_end=825
  _TOPOLOGYINFO._serialized_start=827
  _TOPOLOGYINFO._serialized_end=870
  _NUMANODE._serialized_start=872
  _NUMANODE._serialized_end=894
  _PODRESOURCESLISTER._serialized_start=897
  _PODRESOURCESLISTER._serialized_end=1148
# @@protoc_insertion_point(module_scope)
