# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: io/restorecommerce/access_control.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()


from google.protobuf import any_pb2 as google_dot_protobuf_dot_any__pb2
from . import attribute_pb2 as io_dot_restorecommerce_dot_attribute__pb2
from . import policy_set_pb2 as io_dot_restorecommerce_dot_policy__set__pb2
from . import rule_pb2 as io_dot_restorecommerce_dot_rule__pb2
from . import status_pb2 as io_dot_restorecommerce_dot_status__pb2


DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\'io/restorecommerce/access_control.proto\x12!io.restorecommerce.access_control\x1a\x19google/protobuf/any.proto\x1a\"io/restorecommerce/attribute.proto\x1a#io/restorecommerce/policy_set.proto\x1a\x1dio/restorecommerce/rule.proto\x1a\x1fio/restorecommerce/status.proto\"w\n\x07Request\x12/\n\x06target\x18\x01 \x01(\x0b\x32\x1f.io.restorecommerce.rule.Target\x12;\n\x07\x63ontext\x18\x02 \x01(\x0b\x32*.io.restorecommerce.access_control.Context\"\x81\x01\n\x07\x43ontext\x12%\n\x07subject\x18\x01 \x01(\x0b\x32\x14.google.protobuf.Any\x12\'\n\tresources\x18\x02 \x03(\x0b\x32\x14.google.protobuf.Any\x12&\n\x08security\x18\x03 \x01(\x0b\x32\x14.google.protobuf.Any\"\xa9\x02\n\x08Response\x12\x46\n\x08\x64\x65\x63ision\x18\x01 \x01(\x0e\x32\x34.io.restorecommerce.access_control.Response.Decision\x12<\n\x0bobligations\x18\x02 \x03(\x0b\x32\'.io.restorecommerce.attribute.Attribute\x12\x1c\n\x14\x65valuation_cacheable\x18\x03 \x01(\x08\x12\x44\n\x10operation_status\x18\x04 \x01(\x0b\x32*.io.restorecommerce.status.OperationStatus\"3\n\x08\x44\x65\x63ision\x12\n\n\x06PERMIT\x10\x00\x12\x08\n\x04\x44\x45NY\x10\x01\x12\x11\n\rINDETERMINATE\x10\x02\"\xd3\x01\n\x0cReverseQuery\x12?\n\x0bpolicy_sets\x18\x01 \x03(\x0b\x32*.io.restorecommerce.policy_set.PolicySetRQ\x12<\n\x0bobligations\x18\x02 \x03(\x0b\x32\'.io.restorecommerce.attribute.Attribute\x12\x44\n\x10operation_status\x18\x03 \x01(\x0b\x32*.io.restorecommerce.status.OperationStatus2\xea\x01\n\x14\x41\x63\x63\x65ssControlService\x12\x64\n\tIsAllowed\x12*.io.restorecommerce.access_control.Request\x1a+.io.restorecommerce.access_control.Response\x12l\n\rWhatIsAllowed\x12*.io.restorecommerce.access_control.Request\x1a/.io.restorecommerce.access_control.ReverseQueryb\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'io.restorecommerce.access_control_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _REQUEST._serialized_start=242
  _REQUEST._serialized_end=361
  _CONTEXT._serialized_start=364
  _CONTEXT._serialized_end=493
  _RESPONSE._serialized_start=496
  _RESPONSE._serialized_end=793
  _RESPONSE_DECISION._serialized_start=742
  _RESPONSE_DECISION._serialized_end=793
  _REVERSEQUERY._serialized_start=796
  _REVERSEQUERY._serialized_end=1007
  _ACCESSCONTROLSERVICE._serialized_start=1010
  _ACCESSCONTROLSERVICE._serialized_end=1244
# @@protoc_insertion_point(module_scope)
