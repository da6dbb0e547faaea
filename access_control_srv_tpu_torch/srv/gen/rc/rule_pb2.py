# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: io/restorecommerce/rule.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()


from . import attribute_pb2 as io_dot_restorecommerce_dot_attribute__pb2
from . import auth_pb2 as io_dot_restorecommerce_dot_auth__pb2
from . import meta_pb2 as io_dot_restorecommerce_dot_meta__pb2
from . import resource_base_pb2 as io_dot_restorecommerce_dot_resource__base__pb2
from . import status_pb2 as io_dot_restorecommerce_dot_status__pb2


DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x1dio/restorecommerce/rule.proto\x12\x17io.restorecommerce.rule\x1a\"io/restorecommerce/attribute.proto\x1a\x1dio/restorecommerce/auth.proto\x1a\x1dio/restorecommerce/meta.proto\x1a&io/restorecommerce/resource_base.proto\x1a\x1fio/restorecommerce/status.proto\"\xb9\x01\n\x06Target\x12\x39\n\x08subjects\x18\x01 \x03(\x0b\x32\'.io.restorecommerce.attribute.Attribute\x12:\n\tresources\x18\x02 \x03(\x0b\x32\'.io.restorecommerce.attribute.Attribute\x12\x38\n\x07\x61\x63tions\x18\x03 \x03(\x0b\x32\'.io.restorecommerce.attribute.Attribute\"\xe2\x01\n\x0c\x43ontextQuery\x12>\n\x07\x66ilters\x18\x01 \x03(\x0b\x32-.io.restorecommerce.rule.ContextQuery.Filters\x12\r\n\x05query\x18\x02 \x01(\t\x1a\x39\n\x06\x46ilter\x12\r\n\x05\x66ield\x18\x01 \x01(\t\x12\x11\n\toperation\x18\x02 \x01(\t\x12\r\n\x05value\x18\x03 \x01(\t\x1aH\n\x07\x46ilters\x12=\n\x07\x66ilters\x18\x01 \x03(\x0b\x32,.io.restorecommerce.rule.ContextQuery.Filter\"\xb3\x02\n\x04Rule\x12\n\n\x02id\x18\x01 \x01(\t\x12+\n\x04meta\x18\x02 \x01(\x0b\x32\x1d.io.restorecommerce.meta.Meta\x12\x0c\n\x04name\x18\x03 \x01(\t\x12\x13\n\x0b\x64\x65scription\x18\x04 \x01(\t\x12/\n\x06target\x18\x05 \x01(\x0b\x32\x1f.io.restorecommerce.rule.Target\x12<\n\rcontext_query\x18\x06 \x01(\x0b\x32%.io.restorecommerce.rule.ContextQuery\x12\x11\n\tcondition\x18\x07 \x01(\t\x12/\n\x06\x65\x66\x66\x65\x63t\x18\x08 \x01(\x0e\x32\x1f.io.restorecommerce.rule.Effect\x12\x1c\n\x14\x65valuation_cacheable\x18\t \x01(\x08\"\xe5\x01\n\x06RuleRQ\x12\n\n\x02id\x18\x01 \x01(\t\x12/\n\x06target\x18\x02 \x01(\x0b\x32\x1f.io.restorecommerce.rule.Target\x12/\n\x06\x65\x66\x66\x65\x63t\x18\x03 \x01(\x0e\x32\x1f.io.restorecommerce.rule.Effect\x12\x11\n\tcondition\x18\x04 \x01(\t\x12<\n\rcontext_query\x18\x05 \x01(\x0b\x32%.io.restorecommerce.rule.ContextQuery\x12\x1c\n\x14\x65valuation_cacheable\x18\x06 \x01(\x08\"\x80\x01\n\x08RuleList\x12,\n\x05items\x18\x01 \x03(\x0b\x32\x1d.io.restorecommerce.rule.Rule\x12\x13\n\x0btotal_count\x18\x02 \x01(\r\x12\x31\n\x07subject\x18\x03 \x01(\x0b\x32 .io.restorecommerce.auth.Subject\"q\n\x0cRuleResponse\x12.\n\x07payload\x18\x01 \x01(\x0b\x32\x1d.io.restorecommerce.rule.Rule\x12\x31\n\x06status\x18\x02 \x01(\x0b\x32!.io.restorecommerce.status.Status\"\xa3\x01\n\x10RuleListResponse\x12\x34\n\x05items\x18\x01 \x03(\x0b\x32%.io.restorecommerce.rule.RuleResponse\x12\x13\n\x0btotal_count\x18\x02 \x01(\r\x12\x44\n\x10operation_status\x18\x03 \x01(\x0b\x32*.io.restorecommerce.status.OperationStatus*\x1e\n\x06\x45\x66\x66\x65\x63t\x12\n\n\x06PERMIT\x10\x00\x12\x08\n\x04\x44\x45NY\x10\x01\x32\xe1\x03\n\x0bRuleService\x12_\n\x04Read\x12,.io.restorecommerce.resourcebase.ReadRequest\x1a).io.restorecommerce.rule.RuleListResponse\x12V\n\x06\x43reate\x12!.io.restorecommerce.rule.RuleList\x1a).io.restorecommerce.rule.RuleListResponse\x12i\n\x06\x44\x65lete\x12..io.restorecommerce.resourcebase.DeleteRequest\x1a/.io.restorecommerce.resourcebase.DeleteResponse\x12V\n\x06Update\x12!.io.restorecommerce.rule.RuleList\x1a).io.restorecommerce.rule.RuleListResponse\x12V\n\x06Upsert\x12!.io.restorecommerce.rule.RuleList\x1a).io.restorecommerce.rule.RuleListResponseb\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'io.restorecommerce.rule_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _EFFECT._serialized_start=1600
  _EFFECT._serialized_end=1630
  _TARGET._serialized_start=230
  _TARGET._serialized_end=415
  _CONTEXTQUERY._serialized_start=418
  _CONTEXTQUERY._serialized_end=644
  _CONTEXTQUERY_FILTER._serialized_start=513
  _CONTEXTQUERY_FILTER._serialized_end=570
  _CONTEXTQUERY_FILTERS._serialized_start=572
  _CONTEXTQUERY_FILTERS._serialized_end=644
  _RULE._serialized_start=647
  _RULE._serialized_end=954
  _RULERQ._serialized_start=957
  _RULERQ._serialized_end=1186
  _RULELIST._serialized_start=1189
  _RULELIST._serialized_end=1317
  _RULERESPONSE._serialized_start=1319
  _RULERESPONSE._serialized_end=1432
  _RULELISTRESPONSE._serialized_start=1435
  _RULELISTRESPONSE._serialized_end=1598
  _RULESERVICE._serialized_start=1633
  _RULESERVICE._serialized_end=2114
# @@protoc_insertion_point(module_scope)
