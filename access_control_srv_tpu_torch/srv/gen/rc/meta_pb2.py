# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: io/restorecommerce/meta.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()


from . import attribute_pb2 as io_dot_restorecommerce_dot_attribute__pb2


DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x1dio/restorecommerce/meta.proto\x12\x17io.restorecommerce.meta\x1a\"io/restorecommerce/attribute.proto\"\xae\x01\n\x04Meta\x12\x0f\n\x07\x63reated\x18\x01 \x01(\x01\x12\x10\n\x08modified\x18\x02 \x01(\x01\x12\x13\n\x0bmodified_by\x18\x03 \x01(\t\x12\x37\n\x06owners\x18\x04 \x03(\x0b\x32\'.io.restorecommerce.attribute.Attribute\x12\x35\n\x04\x61\x63ls\x18\x05 \x03(\x0b\x32\'.io.restorecommerce.attribute.Attributeb\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'io.restorecommerce.meta_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _META._serialized_start=95
  _META._serialized_end=269
# @@protoc_insertion_point(module_scope)
