# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: io/restorecommerce/auth.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()


from . import attribute_pb2 as io_dot_restorecommerce_dot_attribute__pb2


DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x1dio/restorecommerce/auth.proto\x12\x17io.restorecommerce.auth\x1a\"io/restorecommerce/attribute.proto\"h\n\x0fRoleAssociation\x12\x0c\n\x04role\x18\x01 \x01(\t\x12;\n\nattributes\x18\x02 \x03(\x0b\x32\'.io.restorecommerce.attribute.Attribute\x12\n\n\x02id\x18\x03 \x01(\t\"k\n\x11HierarchicalScope\x12\n\n\x02id\x18\x01 \x01(\t\x12<\n\x08\x63hildren\x18\x02 \x03(\x0b\x32*.io.restorecommerce.auth.HierarchicalScope\x12\x0c\n\x04role\x18\x03 \x01(\t\"\xda\x01\n\x07Subject\x12\n\n\x02id\x18\x01 \x01(\t\x12\r\n\x05scope\x18\x02 \x01(\t\x12\x43\n\x11role_associations\x18\x03 \x03(\x0b\x32(.io.restorecommerce.auth.RoleAssociation\x12G\n\x13hierarchical_scopes\x18\x04 \x03(\x0b\x32*.io.restorecommerce.auth.HierarchicalScope\x12\r\n\x05token\x18\x05 \x01(\t\x12\x17\n\x0funauthenticated\x18\x06 \x01(\x08\x62\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'io.restorecommerce.auth_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _ROLEASSOCIATION._serialized_start=94
  _ROLEASSOCIATION._serialized_end=198
  _HIERARCHICALSCOPE._serialized_start=200
  _HIERARCHICALSCOPE._serialized_end=307
  _SUBJECT._serialized_start=310
  _SUBJECT._serialized_end=528
# @@protoc_insertion_point(module_scope)
