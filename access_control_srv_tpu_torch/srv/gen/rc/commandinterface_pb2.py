# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: io/restorecommerce/commandinterface.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()


from google.protobuf import any_pb2 as google_dot_protobuf_dot_any__pb2


DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n)io/restorecommerce/commandinterface.proto\x12#io.restorecommerce.commandinterface\x1a\x19google/protobuf/any.proto\"E\n\x0e\x43ommandRequest\x12\x0c\n\x04name\x18\x01 \x01(\t\x12%\n\x07payload\x18\x02 \x01(\x0b\x32\x14.google.protobuf.Any\"7\n\x0f\x43ommandResponse\x12$\n\x06result\x18\x01 \x01(\x0b\x32\x14.google.protobuf.Any2\x8f\x01\n\x17\x43ommandInterfaceService\x12t\n\x07\x43ommand\x12\x33.io.restorecommerce.commandinterface.CommandRequest\x1a\x34.io.restorecommerce.commandinterface.CommandResponseb\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'io.restorecommerce.commandinterface_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _COMMANDREQUEST._serialized_start=109
  _COMMANDREQUEST._serialized_end=178
  _COMMANDRESPONSE._serialized_start=180
  _COMMANDRESPONSE._serialized_end=235
  _COMMANDINTERFACESERVICE._serialized_start=238
  _COMMANDINTERFACESERVICE._serialized_end=381
# @@protoc_insertion_point(module_scope)
