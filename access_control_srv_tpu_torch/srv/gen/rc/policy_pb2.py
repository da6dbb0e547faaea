# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: io/restorecommerce/policy.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()


from . import auth_pb2 as io_dot_restorecommerce_dot_auth__pb2
from . import meta_pb2 as io_dot_restorecommerce_dot_meta__pb2
from . import resource_base_pb2 as io_dot_restorecommerce_dot_resource__base__pb2
from . import rule_pb2 as io_dot_restorecommerce_dot_rule__pb2
from . import status_pb2 as io_dot_restorecommerce_dot_status__pb2


DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x1fio/restorecommerce/policy.proto\x12\x19io.restorecommerce.policy\x1a\x1dio/restorecommerce/auth.proto\x1a\x1dio/restorecommerce/meta.proto\x1a&io/restorecommerce/resource_base.proto\x1a\x1dio/restorecommerce/rule.proto\x1a\x1fio/restorecommerce/status.proto\"\x90\x02\n\x06Policy\x12\n\n\x02id\x18\x01 \x01(\t\x12+\n\x04meta\x18\x02 \x01(\x0b\x32\x1d.io.restorecommerce.meta.Meta\x12\x0c\n\x04name\x18\x03 \x01(\t\x12\x13\n\x0b\x64\x65scription\x18\x04 \x01(\t\x12/\n\x06target\x18\x05 \x01(\x0b\x32\x1f.io.restorecommerce.rule.Target\x12\r\n\x05rules\x18\x06 \x03(\t\x12\x1b\n\x13\x63ombining_algorithm\x18\x07 \x01(\t\x12/\n\x06\x65\x66\x66\x65\x63t\x18\x08 \x01(\x0e\x32\x1f.io.restorecommerce.rule.Effect\x12\x1c\n\x14\x65valuation_cacheable\x18\t \x01(\x08\"\xf6\x01\n\x08PolicyRQ\x12\n\n\x02id\x18\x01 \x01(\t\x12/\n\x06target\x18\x02 \x01(\x0b\x32\x1f.io.restorecommerce.rule.Target\x12\x1b\n\x13\x63ombining_algorithm\x18\x03 \x01(\t\x12/\n\x06\x65\x66\x66\x65\x63t\x18\x04 \x01(\x0e\x32\x1f.io.restorecommerce.rule.Effect\x12.\n\x05rules\x18\x05 \x03(\x0b\x32\x1f.io.restorecommerce.rule.RuleRQ\x12\x11\n\thas_rules\x18\x06 \x01(\x08\x12\x1c\n\x14\x65valuation_cacheable\x18\x07 \x01(\x08\"\x86\x01\n\nPolicyList\x12\x30\n\x05items\x18\x01 \x03(\x0b\x32!.io.restorecommerce.policy.Policy\x12\x13\n\x0btotal_count\x18\x02 \x01(\r\x12\x31\n\x07subject\x18\x03 \x01(\x0b\x32 .io.restorecommerce.auth.Subject\"w\n\x0ePolicyResponse\x12\x32\n\x07payload\x18\x01 \x01(\x0b\x32!.io.restorecommerce.policy.Policy\x12\x31\n\x06status\x18\x02 \x01(\x0b\x32!.io.restorecommerce.status.Status\"\xa9\x01\n\x12PolicyListResponse\x12\x38\n\x05items\x18\x01 \x03(\x0b\x32).io.restorecommerce.policy.PolicyResponse\x12\x13\n\x0btotal_count\x18\x02 \x01(\r\x12\x44\n\x10operation_status\x18\x03 \x01(\x0b\x32*.io.restorecommerce.status.OperationStatus2\xff\x03\n\rPolicyService\x12\x63\n\x04Read\x12,.io.restorecommerce.resourcebase.ReadRequest\x1a-.io.restorecommerce.policy.PolicyListResponse\x12^\n\x06\x43reate\x12%.io.restorecommerce.policy.PolicyList\x1a-.io.restorecommerce.policy.PolicyListResponse\x12i\n\x06\x44\x65lete\x12..io.restorecommerce.resourcebase.DeleteRequest\x1a/.io.restorecommerce.resourcebase.DeleteResponse\x12^\n\x06Update\x12%.io.restorecommerce.policy.PolicyList\x1a-.io.restorecommerce.policy.PolicyListResponse\x12^\n\x06Upsert\x12%.io.restorecommerce.policy.PolicyList\x1a-.io.restorecommerce.policy.PolicyListResponseb\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'io.restorecommerce.policy_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _POLICY._serialized_start=229
  _POLICY._serialized_end=501
  _POLICYRQ._serialized_start=504
  _POLICYRQ._serialized_end=750
  _POLICYLIST._serialized_start=753
  _POLICYLIST._serialized_end=887
  _POLICYRESPONSE._serialized_start=889
  _POLICYRESPONSE._serialized_end=1008
  _POLICYLISTRESPONSE._serialized_start=1011
  _POLICYLISTRESPONSE._serialized_end=1180
  _POLICYSERVICE._serialized_start=1183
  _POLICYSERVICE._serialized_end=1694
# @@protoc_insertion_point(module_scope)
