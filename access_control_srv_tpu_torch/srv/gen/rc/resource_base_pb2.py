# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: io/restorecommerce/resource_base.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()


from . import auth_pb2 as io_dot_restorecommerce_dot_auth__pb2
from . import status_pb2 as io_dot_restorecommerce_dot_status__pb2


DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n&io/restorecommerce/resource_base.proto\x12\x1fio.restorecommerce.resourcebase\x1a\x1dio/restorecommerce/auth.proto\x1a\x1fio/restorecommerce/status.proto\"\x90\x03\n\x06\x46ilter\x12\r\n\x05\x66ield\x18\x01 \x01(\t\x12\x44\n\toperation\x18\x02 \x01(\x0e\x32\x31.io.restorecommerce.resourcebase.Filter.Operation\x12\r\n\x05value\x18\x03 \x01(\t\x12?\n\x04type\x18\x04 \x01(\x0e\x32\x31.io.restorecommerce.resourcebase.Filter.ValueType\x12:\n\x07\x66ilters\x18\x05 \x03(\x0b\x32).io.restorecommerce.resourcebase.FilterOp\"^\n\tOperation\x12\x06\n\x02\x65q\x10\x00\x12\x06\n\x02lt\x10\x01\x12\x07\n\x03lte\x10\x02\x12\x06\n\x02gt\x10\x03\x12\x07\n\x03gte\x10\x04\x12\x0b\n\x07isEmpty\x10\x05\x12\t\n\x05iLike\x10\x06\x12\x06\n\x02in\x10\x07\x12\x07\n\x03neq\x10\x08\"E\n\tValueType\x12\n\n\x06STRING\x10\x00\x12\n\n\x06NUMBER\x10\x01\x12\x0b\n\x07\x42OOLEAN\x10\x02\x12\x08\n\x04\x44\x41TE\x10\x03\x12\t\n\x05\x41RRAY\x10\x04\"\xa7\x01\n\x08\x46ilterOp\x12\x38\n\x07\x66ilters\x18\x01 \x03(\x0b\x32\'.io.restorecommerce.resourcebase.Filter\x12\x44\n\x08operator\x18\x02 \x01(\x0e\x32\x32.io.restorecommerce.resourcebase.FilterOp.Operator\"\x1b\n\x08Operator\x12\x07\n\x03\x61nd\x10\x00\x12\x06\n\x02or\x10\x01\"\xf1\x01\n\x0bReadRequest\x12\x0e\n\x06offset\x18\x01 \x01(\r\x12\r\n\x05limit\x18\x02 \x01(\r\x12\x34\n\x05sorts\x18\x03 \x03(\x0b\x32%.io.restorecommerce.resourcebase.Sort\x12:\n\x07\x66ilters\x18\x04 \x03(\x0b\x32).io.restorecommerce.resourcebase.FilterOp\x12\x0e\n\x06\x66ields\x18\x05 \x03(\t\x12\x0e\n\x06search\x18\x06 \x03(\t\x12\x31\n\x07subject\x18\x07 \x01(\x0b\x32 .io.restorecommerce.auth.Subject\"\x8f\x01\n\x04Sort\x12\r\n\x05\x66ield\x18\x01 \x01(\t\x12>\n\x05order\x18\x02 \x01(\x0e\x32/.io.restorecommerce.resourcebase.Sort.SortOrder\"8\n\tSortOrder\x12\x0c\n\x08UNSORTED\x10\x00\x12\r\n\tASCENDING\x10\x01\x12\x0e\n\nDESCENDING\x10\x02\"c\n\rDeleteRequest\x12\x12\n\ncollection\x18\x01 \x01(\x08\x12\x0b\n\x03ids\x18\x02 \x03(\t\x12\x31\n\x07subject\x18\x03 \x01(\x0b\x32 .io.restorecommerce.auth.Subject\"\x89\x01\n\x0e\x44\x65leteResponse\x12\x31\n\x06status\x18\x01 \x03(\x0b\x32!.io.restorecommerce.status.Status\x12\x44\n\x10operation_status\x18\x02 \x01(\x0b\x32*.io.restorecommerce.status.OperationStatusb\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'io.restorecommerce.resource_base_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _FILTER._serialized_start=140
  _FILTER._serialized_end=540
  _FILTER_OPERATION._serialized_start=375
  _FILTER_OPERATION._serialized_end=469
  _FILTER_VALUETYPE._serialized_start=471
  _FILTER_VALUETYPE._serialized_end=540
  _FILTEROP._serialized_start=543
  _FILTEROP._serialized_end=710
  _FILTEROP_OPERATOR._serialized_start=683
  _FILTEROP_OPERATOR._serialized_end=710
  _READREQUEST._serialized_start=713
  _READREQUEST._serialized_end=954
  _SORT._serialized_start=957
  _SORT._serialized_end=1100
  _SORT_SORTORDER._serialized_start=1044
  _SORT_SORTORDER._serialized_end=1100
  _DELETEREQUEST._serialized_start=1102
  _DELETEREQUEST._serialized_end=1201
  _DELETERESPONSE._serialized_start=1204
  _DELETERESPONSE._serialized_end=1341
# @@protoc_insertion_point(module_scope)
