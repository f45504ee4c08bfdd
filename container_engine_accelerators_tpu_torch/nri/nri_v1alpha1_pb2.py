# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: nri_v1alpha1.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x12nri_v1alpha1.proto\x12\x14nri.pkg.api.v1alpha1\"@\n\x15RegisterPluginRequest\x12\x13\n\x0bplugin_name\x18\x01 \x01(\t\x12\x12\n\nplugin_idx\x18\x02 \x01(\t\"Q\n\x10\x43onfigureRequest\x12\x0e\n\x06\x63onfig\x18\x01 \x01(\t\x12\x14\n\x0cruntime_name\x18\x02 \x01(\t\x12\x17\n\x0fruntime_version\x18\x03 \x01(\t\"#\n\x11\x43onfigureResponse\x12\x0e\n\x06\x65vents\x18\x02 \x01(\x05\"y\n\x12SynchronizeRequest\x12.\n\x04pods\x18\x01 \x03(\x0b\x32 .nri.pkg.api.v1alpha1.PodSandbox\x12\x33\n\ncontainers\x18\x02 \x03(\x0b\x32\x1f.nri.pkg.api.v1alpha1.Container\"L\n\x13SynchronizeResponse\x12\x35\n\x06update\x18\x01 \x03(\x0b\x32%.nri.pkg.api.v1alpha1.ContainerUpdate\"{\n\x16\x43reateContainerRequest\x12-\n\x03pod\x18\x01 \x01(\x0b\x32 .nri.pkg.api.v1alpha1.PodSandbox\x12\x32\n\tcontainer\x18\x02 \x01(\x0b\x32\x1f.nri.pkg.api.v1alpha1.Container\"\xc3\x01\n\x17\x43reateContainerResponse\x12\x39\n\x06\x61\x64just\x18\x01 \x01(\x0b\x32).nri.pkg.api.v1alpha1.ContainerAdjustment\x12\x35\n\x06update\x18\x02 \x03(\x0b\x32%.nri.pkg.api.v1alpha1.ContainerUpdate\x12\x36\n\x05\x65vict\x18\x03 \x03(\x0b\x32\'.nri.pkg.api.v1alpha1.ContainerEviction\"y\n\x14StopContainerRequest\x12-\n\x03pod\x18\x01 \x01(\x0b\x32 .nri.pkg.api.v1alpha1.PodSandbox\x12\x32\n\tcontainer\x18\x02 \x01(\x0b\x32\x1f.nri.pkg.api.v1alpha1.Container\"N\n\x15StopContainerResponse\x12\x35\n\x06update\x18\x01 \x03(\x0b\x32%.nri.pkg.api.v1alpha1.ContainerUpdate\"\xa1\x01\n\x10StateChangeEvent\x12*\n\x05\x65vent\x18\x01 \x01(\x0e\x32\x1b.nri.pkg.api.v1alpha1.Event\x12-\n\x03pod\x18\x02 \x01(\x0b\x32 .nri.pkg.api.v1alpha1.PodSandbox\x12\x32\n\tcontainer\x18\x03 \x01(\x0b\x32\x1f.nri.pkg.api.v1alpha1.Container\"\x07\n\x05\x45mpty\"\xc8\x02\n\nPodSandbox\x12\n\n\x02id\x18\x01 \x01(\t\x12\x0c\n\x04name\x18\x02 \x01(\t\x12\x0b\n\x03uid\x18\x03 \x01(\t\x12\x11\n\tnamespace\x18\x04 \x01(\t\x12<\n\x06labels\x18\x05 \x03(\x0b\x32,.nri.pkg.api.v1alpha1.PodSandbox.LabelsEntry\x12\x46\n\x0b\x61nnotations\x18\x06 \x03(\x0b\x32\x31.nri.pkg.api.v1alpha1.PodSandbox.AnnotationsEntry\x12\x17\n\x0fruntime_handler\x18\x07 \x01(\t\x1a-\n\x0bLabelsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t:\x02\x38\x01\x1a\x32\n\x10\x41nnotationsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t:\x02\x38\x01\"\xd9\x02\n\tContainer\x12\n\n\x02id\x18\x01 \x01(\t\x12\x16\n\x0epod_sandbox_id\x18\x02 \x01(\t\x12\x0c\n\x04name\x18\x03 \x01(\t\x12\x33\n\x05state\x18\x04 \x01(\x0e\x32$.nri.pkg.api.v1alpha1.ContainerState\x12;\n\x06labels\x18\x05 \x03(\x0b\x32+.nri.pkg.api.v1alpha1.Container.LabelsEntry\x12\x45\n\x0b\x61nnotations\x18\x06 \x03(\x0b\x32\x30.nri.pkg.api.v1alpha1.Container.AnnotationsEntry\x1a-\n\x0bLabelsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t:\x02\x38\x01\x1a\x32\n\x10\x41nnotationsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t:\x02\x38\x01\"\xe8\x01\n\x0bLinuxDevice\x12\x0c\n\x04path\x18\x01 \x01(\t\x12\x0c\n\x04type\x18\x02 \x01(\t\x12\r\n\x05major\x18\x03 \x01(\x03\x12\r\n\x05minor\x18\x04 \x01(\x03\x12\x39\n\tfile_mode\x18\x05 \x01(\x0b\x32&.nri.pkg.api.v1alpha1.OptionalFileMode\x12\x31\n\x03uid\x18\x06 \x01(\x0b\x32$.nri.pkg.api.v1alpha1.OptionalUInt32\x12\x31\n\x03gid\x18\x07 \x01(\x0b\x32$.nri.pkg.api.v1alpha1.OptionalUInt32\"\x86\x02\n\x13\x43ontainerAdjustment\x12O\n\x0b\x61nnotations\x18\x02 \x03(\x0b\x32:.nri.pkg.api.v1alpha1.ContainerAdjustment.AnnotationsEntry\x12+\n\x03\x65nv\x18\x04 \x03(\x0b\x32\x1e.nri.pkg.api.v1alpha1.KeyValue\x12=\n\x05linux\x18\x06 \x01(\x0b\x32..nri.pkg.api.v1alpha1.LinuxContainerAdjustment\x1a\x32\n\x10\x41nnotationsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t:\x02\x38\x01\"N\n\x18LinuxContainerAdjustment\x12\x32\n\x07\x64\x65vices\x18\x01 \x03(\x0b\x32!.nri.pkg.api.v1alpha1.LinuxDevice\"?\n\x0f\x43ontainerUpdate\x12\x14\n\x0c\x63ontainer_id\x18\x01 \x01(\t\x12\x16\n\x0eignore_failure\x18\x03 \x01(\x08\"9\n\x11\x43ontainerEviction\x12\x14\n\x0c\x63ontainer_id\x18\x01 \x01(\t\x12\x0e\n\x06reason\x18\x02 \x01(\t\"&\n\x08KeyValue\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t\"!\n\x10OptionalFileMode\x12\r\n\x05value\x18\x01 \x01(\r\"\x1f\n\x0eOptionalUInt32\x12\r\n\x05value\x18\x01 \x01(\r*\x9c\x02\n\x05\x45vent\x12\x0b\n\x07UNKNOWN\x10\x00\x12\x13\n\x0fRUN_POD_SANDBOX\x10\x01\x12\x14\n\x10STOP_POD_SANDBOX\x10\x02\x12\x16\n\x12REMOVE_POD_SANDBOX\x10\x03\x12\x14\n\x10\x43REATE_CONTAINER\x10\x04\x12\x19\n\x15POST_CREATE_CONTAINER\x10\x05\x12\x13\n\x0fSTART_CONTAINER\x10\x06\x12\x18\n\x14POST_START_CONTAINER\x10\x07\x12\x14\n\x10UPDATE_CONTAINER\x10\x08\x12\x19\n\x15POST_UPDATE_CONTAINER\x10\t\x12\x12\n\x0eSTOP_CONTAINER\x10\n\x12\x14\n\x10REMOVE_CONTAINER\x10\x0b\x12\x08\n\x04LAST\x10\x0c*\x82\x01\n\x0e\x43ontainerState\x12\x15\n\x11\x43ONTAINER_UNKNOWN\x10\x00\x12\x15\n\x11\x43ONTAINER_CREATED\x10\x01\x12\x14\n\x10\x43ONTAINER_PAUSED\x10\x02\x12\x15\n\x11\x43ONTAINER_RUNNING\x10\x03\x12\x15\n\x11\x43ONTAINER_STOPPED\x10\x04\x62\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'nri_v1alpha1_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _PODSANDBOX_LABELSENTRY._options = None
  _PODSANDBOX_LABELSENTRY._serialized_options = b'8\001'
  _PODSANDBOX_ANNOTATIONSENTRY._options = None
  _PODSANDBOX_ANNOTATIONSENTRY._serialized_options = b'8\001'
  _CONTAINER_LABELSENTRY._options = None
  _CONTAINER_LABELSENTRY._serialized_options = b'8\001'
  _CONTAINER_ANNOTATIONSENTRY._options = None
  _CONTAINER_ANNOTATIONSENTRY._serialized_options = b'8\001'
  _CONTAINERADJUSTMENT_ANNOTATIONSENTRY._options = None
  _CONTAINERADJUSTMENT_ANNOTATIONSENTRY._serialized_options = b'8\001'
  _EVENT._serialized_start=2622
  _EVENT._serialized_end=2906
  _CONTAINERSTATE._serialized_start=2909
  _CONTAINERSTATE._serialized_end=3039
  _REGISTERPLUGINREQUEST._serialized_start=44
  _REGISTERPLUGINREQUEST._serialized_end=108
  _CONFIGUREREQUEST._serialized_start=110
  _CONFIGUREREQUEST._serialized_end=191
  _CONFIGURERESPONSE._serialized_start=193
  _CONFIGURERESPONSE._serialized_end=228
  _SYNCHRONIZEREQUEST._serialized_start=230
  _SYNCHRONIZEREQUEST._serialized_end=351
  _SYNCHRONIZERESPONSE._serialized_start=353
  _SYNCHRONIZERESPONSE._serialized_end=429
  _CREATECONTAINERREQUEST._serialized_start=431
  _CREATECONTAINERREQUEST._serialized_end=554
  _CREATECONTAINERRESPONSE._serialized_start=557
  _CREATECONTAINERRESPONSE._serialized_end=752
  _STOPCONTAINERREQUEST._serialized_start=754
  _STOPCONTAINERREQUEST._serialized_end=875
  _STOPCONTAINERRESPONSE._serialized_start=877
  _STOPCONTAINERRESPONSE._serialized_end=955
  _STATECHANGEEVENT._serialized_start=958
  _STATECHANGEEVENT._serialized_end=1119
  _EMPTY._serialized_start=1121
  _EMPTY._serialized_end=1128
  _PODSANDBOX._serialized_start=1131
  _PODSANDBOX._serialized_end=1459
  _PODSANDBOX_LABELSENTRY._serialized_start=1362
  _PODSANDBOX_LABELSENTRY._serialized_end=1407
  _PODSANDBOX_ANNOTATIONSENTRY._serialized_start=1409
  _PODSANDBOX_ANNOTATIONSENTRY._serialized_end=1459
  _CONTAINER._serialized_start=1462
  _CONTAINER._serialized_end=1807
  _CONTAINER_LABELSENTRY._serialized_start=1362
  _CONTAINER_LABELSENTRY._serialized_end=1407
  _CONTAINER_ANNOTATIONSENTRY._serialized_start=1409
  _CONTAINER_ANNOTATIONSENTRY._serialized_end=1459
  _LINUXDEVICE._serialized_start=1810
  _LINUXDEVICE._serialized_end=2042
  _CONTAINERADJUSTMENT._serialized_start=2045
  _CONTAINERADJUSTMENT._serialized_end=2307
  _CONTAINERADJUSTMENT_ANNOTATIONSENTRY._serialized_start=1409
  _CONTAINERADJUSTMENT_ANNOTATIONSENTRY._serialized_end=1459
  _LINUXCONTAINERADJUSTMENT._serialized_start=2309
  _LINUXCONTAINERADJUSTMENT._serialized_end=2387
  _CONTAINERUPDATE._serialized_start=2389
  _CONTAINERUPDATE._serialized_end=2452
  _CONTAINEREVICTION._serialized_start=2454
  _CONTAINEREVICTION._serialized_end=2511
  _KEYVALUE._serialized_start=2513
  _KEYVALUE._serialized_end=2551
  _OPTIONALFILEMODE._serialized_start=2553
  _OPTIONALFILEMODE._serialized_end=2586
  _OPTIONALUINT32._serialized_start=2588
  _OPTIONALUINT32._serialized_end=2619
# @@protoc_insertion_point(module_scope)
