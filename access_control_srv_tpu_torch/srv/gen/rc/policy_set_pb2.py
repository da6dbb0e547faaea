# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: io/restorecommerce/policy_set.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()


from . import auth_pb2 as io_dot_restorecommerce_dot_auth__pb2
from . import meta_pb2 as io_dot_restorecommerce_dot_meta__pb2
from . import policy_pb2 as io_dot_restorecommerce_dot_policy__pb2
from . import resource_base_pb2 as io_dot_restorecommerce_dot_resource__base__pb2
from . import rule_pb2 as io_dot_restorecommerce_dot_rule__pb2
from . import status_pb2 as io_dot_restorecommerce_dot_status__pb2


DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n#io/restorecommerce/policy_set.proto\x12\x1dio.restorecommerce.policy_set\x1a\x1dio/restorecommerce/auth.proto\x1a\x1dio/restorecommerce/meta.proto\x1a\x1fio/restorecommerce/policy.proto\x1a&io/restorecommerce/resource_base.proto\x1a\x1dio/restorecommerce/rule.proto\x1a\x1fio/restorecommerce/status.proto\"\xc7\x01\n\tPolicySet\x12\n\n\x02id\x18\x01 \x01(\t\x12+\n\x04meta\x18\x02 \x01(\x0b\x32\x1d.io.restorecommerce.meta.Meta\x12\x0c\n\x04name\x18\x03 \x01(\t\x12\x13\n\x0b\x64\x65scription\x18\x04 \x01(\t\x12/\n\x06target\x18\x05 \x01(\x0b\x32\x1f.io.restorecommerce.rule.Target\x12\x10\n\x08policies\x18\x06 \x03(\t\x12\x1b\n\x13\x63ombining_algorithm\x18\x07 \x01(\t\"\xcf\x01\n\x0bPolicySetRQ\x12\n\n\x02id\x18\x01 \x01(\t\x12/\n\x06target\x18\x02 \x01(\x0b\x32\x1f.io.restorecommerce.rule.Target\x12\x1b\n\x13\x63ombining_algorithm\x18\x03 \x01(\t\x12/\n\x06\x65\x66\x66\x65\x63t\x18\x04 \x01(\x0e\x32\x1f.io.restorecommerce.rule.Effect\x12\x35\n\x08policies\x18\x05 \x03(\x0b\x32#.io.restorecommerce.policy.PolicyRQ\"\x90\x01\n\rPolicySetList\x12\x37\n\x05items\x18\x01 \x03(\x0b\x32(.io.restorecommerce.policy_set.PolicySet\x12\x13\n\x0btotal_count\x18\x02 \x01(\r\x12\x31\n\x07subject\x18\x03 \x01(\x0b\x32 .io.restorecommerce.auth.Subject\"\x81\x01\n\x11PolicySetResponse\x12\x39\n\x07payload\x18\x01 \x01(\x0b\x32(.io.restorecommerce.policy_set.PolicySet\x12\x31\n\x06status\x18\x02 \x01(\x0b\x32!.io.restorecommerce.status.Status\"\xb3\x01\n\x15PolicySetListResponse\x12?\n\x05items\x18\x01 \x03(\x0b\x32\x30.io.restorecommerce.policy_set.PolicySetResponse\x12\x13\n\x0btotal_count\x18\x02 \x01(\r\x12\x44\n\x10operation_status\x18\x03 \x01(\x0b\x32*.io.restorecommerce.status.OperationStatus2\xb3\x04\n\x10PolicySetService\x12j\n\x04Read\x12,.io.restorecommerce.resourcebase.ReadRequest\x1a\x34.io.restorecommerce.policy_set.PolicySetListResponse\x12l\n\x06\x43reate\x12,.io.restorecommerce.policy_set.PolicySetList\x1a\x34.io.restorecommerce.policy_set.PolicySetListResponse\x12i\n\x06\x44\x65lete\x12..io.restorecommerce.resourcebase.DeleteRequest\x1a/.io.restorecommerce.resourcebase.DeleteResponse\x12l\n\x06Update\x12,.io.restorecommerce.policy_set.PolicySetList\x1a\x34.io.restorecommerce.policy_set.PolicySetListResponse\x12l\n\x06Upsert\x12,.io.restorecommerce.policy_set.PolicySetList\x1a\x34.io.restorecommerce.policy_set.PolicySetListResponseb\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'io.restorecommerce.policy_set_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _POLICYSET._serialized_start=270
  _POLICYSET._serialized_end=469
  _POLICYSETRQ._serialized_start=472
  _POLICYSETRQ._serialized_end=679
  _POLICYSETLIST._serialized_start=682
  _POLICYSETLIST._serialized_end=826
  _POLICYSETRESPONSE._serialized_start=829
  _POLICYSETRESPONSE._serialized_end=958
  _POLICYSETLISTRESPONSE._serialized_start=961
  _POLICYSETLISTRESPONSE._serialized_end=1140
  _POLICYSETSERVICE._serialized_start=1143
  _POLICYSETSERVICE._serialized_end=1706
# @@protoc_insertion_point(module_scope)
