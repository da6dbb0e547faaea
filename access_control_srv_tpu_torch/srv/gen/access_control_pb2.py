# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: access_control.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x14\x61\x63\x63\x65ss_control.proto\x12\x06\x61\x63stpu\"M\n\tAttribute\x12\n\n\x02id\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t\x12%\n\nattributes\x18\x03 \x03(\x0b\x32\x11.acstpu.Attribute\"w\n\x06Target\x12#\n\x08subjects\x18\x01 \x03(\x0b\x32\x11.acstpu.Attribute\x12$\n\tresources\x18\x02 \x03(\x0b\x32\x11.acstpu.Attribute\x12\"\n\x07\x61\x63tions\x18\x03 \x03(\x0b\x32\x11.acstpu.Attribute\"/\n\x0c\x43ontextValue\x12\x10\n\x08type_url\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\x0c\"\x81\x01\n\x07\x43ontext\x12%\n\x07subject\x18\x01 \x01(\x0b\x32\x14.acstpu.ContextValue\x12\'\n\tresources\x18\x02 \x03(\x0b\x32\x14.acstpu.ContextValue\x12&\n\x08security\x18\x03 \x01(\x0b\x32\x14.acstpu.ContextValue\"0\n\x0fOperationStatus\x12\x0c\n\x04\x63ode\x18\x01 \x01(\x05\x12\x0f\n\x07message\x18\x02 \x01(\t\"K\n\x07Request\x12\x1e\n\x06target\x18\x01 \x01(\x0b\x32\x0e.acstpu.Target\x12 \n\x07\x63ontext\x18\x02 \x01(\x0b\x32\x0f.acstpu.Context\"\xa7\x01\n\x08Response\x12\"\n\x08\x64\x65\x63ision\x18\x01 \x01(\x0e\x32\x10.acstpu.Decision\x12&\n\x0bobligations\x18\x02 \x03(\x0b\x32\x11.acstpu.Attribute\x12\x1c\n\x14\x65valuation_cacheable\x18\x03 \x01(\x08\x12\x31\n\x10operation_status\x18\x04 \x01(\x0b\x32\x17.acstpu.OperationStatus\"1\n\x0c\x42\x61tchRequest\x12!\n\x08requests\x18\x01 \x03(\x0b\x32\x0f.acstpu.Request\"4\n\rBatchResponse\x12#\n\tresponses\x18\x01 \x03(\x0b\x32\x10.acstpu.Response\"<\n\x11\x42\x61tchReverseQuery\x12\'\n\tresponses\x18\x01 \x03(\x0b\x32\x14.acstpu.ReverseQuery\"E\n\x12\x43ontextQueryFilter\x12\r\n\x05\x66ield\x18\x01 \x01(\t\x12\x11\n\toperation\x18\x02 \x01(\t\x12\r\n\x05value\x18\x03 \x01(\t\"J\n\x0c\x43ontextQuery\x12+\n\x07\x66ilters\x18\x01 \x03(\x0b\x32\x1a.acstpu.ContextQueryFilter\x12\r\n\x05query\x18\x02 \x01(\t\"\xa2\x01\n\x06RuleRQ\x12\n\n\x02id\x18\x01 \x01(\t\x12\x1e\n\x06target\x18\x02 \x01(\x0b\x32\x0e.acstpu.Target\x12\x0e\n\x06\x65\x66\x66\x65\x63t\x18\x03 \x01(\t\x12\x11\n\tcondition\x18\x04 \x01(\t\x12+\n\rcontext_query\x18\x05 \x01(\x0b\x32\x14.acstpu.ContextQuery\x12\x1c\n\x14\x65valuation_cacheable\x18\x06 \x01(\x08\"\xb3\x01\n\x08PolicyRQ\x12\n\n\x02id\x18\x01 \x01(\t\x12\x1e\n\x06target\x18\x02 \x01(\x0b\x32\x0e.acstpu.Target\x12\x0e\n\x06\x65\x66\x66\x65\x63t\x18\x03 \x01(\t\x12\x1b\n\x13\x63ombining_algorithm\x18\x04 \x01(\t\x12\x1c\n\x14\x65valuation_cacheable\x18\x05 \x01(\x08\x12\x11\n\thas_rules\x18\x06 \x01(\x08\x12\x1d\n\x05rules\x18\x07 \x03(\x0b\x32\x0e.acstpu.RuleRQ\"\x8a\x01\n\x0bPolicySetRQ\x12\n\n\x02id\x18\x01 \x01(\t\x12\x1e\n\x06target\x18\x02 \x01(\x0b\x32\x0e.acstpu.Target\x12\x0e\n\x06\x65\x66\x66\x65\x63t\x18\x03 \x01(\t\x12\x1b\n\x13\x63ombining_algorithm\x18\x04 \x01(\t\x12\"\n\x08policies\x18\x05 \x03(\x0b\x32\x10.acstpu.PolicyRQ\"\x93\x01\n\x0cReverseQuery\x12(\n\x0bpolicy_sets\x18\x01 \x03(\x0b\x32\x13.acstpu.PolicySetRQ\x12&\n\x0bobligations\x18\x02 \x03(\x0b\x32\x11.acstpu.Attribute\x12\x31\n\x10operation_status\x18\x03 \x01(\x0b\x32\x17.acstpu.OperationStatus\"m\n\x04Meta\x12!\n\x06owners\x18\x01 \x03(\x0b\x32\x11.acstpu.Attribute\x12\x1f\n\x04\x61\x63ls\x18\x02 \x03(\x0b\x32\x11.acstpu.Attribute\x12\x0f\n\x07\x63reated\x18\x03 \x01(\x01\x12\x10\n\x08modified\x18\x04 \x01(\x01\"\xdf\x01\n\x04Rule\x12\n\n\x02id\x18\x01 \x01(\t\x12\x0c\n\x04name\x18\x02 \x01(\t\x12\x13\n\x0b\x64\x65scription\x18\x03 \x01(\t\x12\x1e\n\x06target\x18\x04 \x01(\x0b\x32\x0e.acstpu.Target\x12\x0e\n\x06\x65\x66\x66\x65\x63t\x18\x05 \x01(\t\x12\x11\n\tcondition\x18\x06 \x01(\t\x12+\n\rcontext_query\x18\x07 \x01(\x0b\x32\x14.acstpu.ContextQuery\x12\x1c\n\x14\x65valuation_cacheable\x18\x08 \x01(\x08\x12\x1a\n\x04meta\x18\t \x01(\x0b\x32\x0c.acstpu.Meta\"\xcd\x01\n\x06Policy\x12\n\n\x02id\x18\x01 \x01(\t\x12\x0c\n\x04name\x18\x02 \x01(\t\x12\x13\n\x0b\x64\x65scription\x18\x03 \x01(\t\x12\x1e\n\x06target\x18\x04 \x01(\x0b\x32\x0e.acstpu.Target\x12\x0e\n\x06\x65\x66\x66\x65\x63t\x18\x05 \x01(\t\x12\x1b\n\x13\x63ombining_algorithm\x18\x06 \x01(\t\x12\r\n\x05rules\x18\x07 \x03(\t\x12\x1c\n\x14\x65valuation_cacheable\x18\x08 \x01(\x08\x12\x1a\n\x04meta\x18\t \x01(\x0b\x32\x0c.acstpu.Meta\"\xa5\x01\n\tPolicySet\x12\n\n\x02id\x18\x01 \x01(\t\x12\x0c\n\x04name\x18\x02 \x01(\t\x12\x13\n\x0b\x64\x65scription\x18\x03 \x01(\t\x12\x1e\n\x06target\x18\x04 \x01(\x0b\x32\x0e.acstpu.Target\x12\x1b\n\x13\x63ombining_algorithm\x18\x05 \x01(\t\x12\x10\n\x08policies\x18\x06 \x03(\t\x12\x1a\n\x04meta\x18\x07 \x01(\x0b\x32\x0c.acstpu.Meta\"A\n\x07Subject\x12\n\n\x02id\x18\x01 \x01(\t\x12\r\n\x05token\x18\x02 \x01(\t\x12\r\n\x05scope\x18\x03 \x01(\t\x12\x0c\n\x04\x64\x61ta\x18\x04 \x01(\x0c\"I\n\x08RuleList\x12\x1b\n\x05items\x18\x01 \x03(\x0b\x32\x0c.acstpu.Rule\x12 \n\x07subject\x18\x02 \x01(\x0b\x32\x0f.acstpu.Subject\"M\n\nPolicyList\x12\x1d\n\x05items\x18\x01 \x03(\x0b\x32\x0e.acstpu.Policy\x12 \n\x07subject\x18\x02 \x01(\x0b\x32\x0f.acstpu.Subject\"S\n\rPolicySetList\x12 \n\x05items\x18\x01 \x03(\x0b\x32\x11.acstpu.PolicySet\x12 \n\x07subject\x18\x02 \x01(\x0b\x32\x0f.acstpu.Subject\"R\n\rDeleteRequest\x12\x0b\n\x03ids\x18\x01 \x03(\t\x12\x12\n\ncollection\x18\x02 \x01(\x08\x12 \n\x07subject\x18\x03 \x01(\x0b\x32\x0f.acstpu.Subject\"9\n\x06\x46ilter\x12\r\n\x05\x66ield\x18\x01 \x01(\t\x12\x11\n\toperation\x18\x02 \x01(\t\x12\r\n\x05value\x18\x03 \x01(\t\"@\n\x0b\x46ilterGroup\x12\x1f\n\x07\x66ilters\x18\x01 \x03(\x0b\x32\x0e.acstpu.Filter\x12\x10\n\x08operator\x18\x02 \x01(\t\"b\n\x0bReadRequest\x12\x0b\n\x03ids\x18\x01 \x03(\t\x12 \n\x07subject\x18\x02 \x01(\x0b\x32\x0f.acstpu.Subject\x12$\n\x07\x66ilters\x18\x03 \x03(\x0b\x32\x13.acstpu.FilterGroup\"7\n\nItemStatus\x12\n\n\x02id\x18\x01 \x01(\t\x12\x0c\n\x04\x63ode\x18\x02 \x01(\x05\x12\x0f\n\x07message\x18\x03 \x01(\t\"k\n\x10MutationResponse\x12$\n\x08statuses\x18\x01 \x03(\x0b\x32\x12.acstpu.ItemStatus\x12\x31\n\x10operation_status\x18\x02 \x01(\x0b\x32\x17.acstpu.OperationStatus\"\x88\x01\n\x10RuleListResponse\x12\x1b\n\x05items\x18\x01 \x03(\x0b\x32\x0c.acstpu.Rule\x12$\n\x08statuses\x18\x02 \x03(\x0b\x32\x12.acstpu.ItemStatus\x12\x31\n\x10operation_status\x18\x03 \x01(\x0b\x32\x17.acstpu.OperationStatus\"\x8c\x01\n\x12PolicyListResponse\x12\x1d\n\x05items\x18\x01 \x03(\x0b\x32\x0e.acstpu.Policy\x12$\n\x08statuses\x18\x02 \x03(\x0b\x32\x12.acstpu.ItemStatus\x12\x31\n\x10operation_status\x18\x03 \x01(\x0b\x32\x17.acstpu.OperationStatus\"\x92\x01\n\x15PolicySetListResponse\x12 \n\x05items\x18\x01 \x03(\x0b\x32\x11.acstpu.PolicySet\x12$\n\x08statuses\x18\x02 \x03(\x0b\x32\x12.acstpu.ItemStatus\x12\x31\n\x10operation_status\x18\x03 \x01(\x0b\x32\x17.acstpu.OperationStatus\"/\n\x0e\x43ommandRequest\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\x0f\n\x07payload\x18\x02 \x01(\x0c\"\"\n\x0f\x43ommandResponse\x12\x0f\n\x07payload\x18\x01 \x01(\x0c\"%\n\x12HealthCheckRequest\x12\x0f\n\x07service\x18\x01 \x01(\t\"%\n\x13HealthCheckResponse\x12\x0e\n\x06status\x18\x01 \x01(\t\"#\n\x12\x46indByTokenRequest\x12\r\n\x05token\x18\x01 \x01(\t\"K\n\x0fSubjectResponse\x12\x0f\n\x07payload\x18\x01 \x01(\x0c\x12\'\n\x06status\x18\x02 \x01(\x0b\x32\x17.acstpu.OperationStatus*M\n\x08\x44\x65\x63ision\x12\x18\n\x14\x44\x45\x43ISION_UNSPECIFIED\x10\x00\x12\n\n\x06PERMIT\x10\x01\x12\x08\n\x04\x44\x45NY\x10\x02\x12\x11\n\rINDETERMINATE\x10\x03\x62\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'access_control_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _DECISION._serialized_start=3864
  _DECISION._serialized_end=3941
  _ATTRIBUTE._serialized_start=32
  _ATTRIBUTE._serialized_end=109
  _TARGET._serialized_start=111
  _TARGET._serialized_end=230
  _CONTEXTVALUE._serialized_start=232
  _CONTEXTVALUE._serialized_end=279
  _CONTEXT._serialized_start=282
  _CONTEXT._serialized_end=411
  _OPERATIONSTATUS._serialized_start=413
  _OPERATIONSTATUS._serialized_end=461
  _REQUEST._serialized_start=463
  _REQUEST._serialized_end=538
  _RESPONSE._serialized_start=541
  _RESPONSE._serialized_end=708
  _BATCHREQUEST._serialized_start=710
  _BATCHREQUEST._serialized_end=759
  _BATCHRESPONSE._serialized_start=761
  _BATCHRESPONSE._serialized_end=813
  _BATCHREVERSEQUERY._serialized_start=815
  _BATCHREVERSEQUERY._serialized_end=875
  _CONTEXTQUERYFILTER._serialized_start=877
  _CONTEXTQUERYFILTER._serialized_end=946
  _CONTEXTQUERY._serialized_start=948
  _CONTEXTQUERY._serialized_end=1022
  _RULERQ._serialized_start=1025
  _RULERQ._serialized_end=1187
  _POLICYRQ._serialized_start=1190
  _POLICYRQ._serialized_end=1369
  _POLICYSETRQ._serialized_start=1372
  _POLICYSETRQ._serialized_end=1510
  _REVERSEQUERY._serialized_start=1513
  _REVERSEQUERY._serialized_end=1660
  _META._serialized_start=1662
  _META._serialized_end=1771
  _RULE._serialized_start=1774
  _RULE._serialized_end=1997
  _POLICY._serialized_start=2000
  _POLICY._serialized_end=2205
  _POLICYSET._serialized_start=2208
  _POLICYSET._serialized_end=2373
  _SUBJECT._serialized_start=2375
  _SUBJECT._serialized_end=2440
  _RULELIST._serialized_start=2442
  _RULELIST._serialized_end=2515
  _POLICYLIST._serialized_start=2517
  _POLICYLIST._serialized_end=2594
  _POLICYSETLIST._serialized_start=2596
  _POLICYSETLIST._serialized_end=2679
  _DELETEREQUEST._serialized_start=2681
  _DELETEREQUEST._serialized_end=2763
  _FILTER._serialized_start=2765
  _FILTER._serialized_end=2822
  _FILTERGROUP._serialized_start=2824
  _FILTERGROUP._serialized_end=2888
  _READREQUEST._serialized_start=2890
  _READREQUEST._serialized_end=2988
  _ITEMSTATUS._serialized_start=2990
  _ITEMSTATUS._serialized_end=3045
  _MUTATIONRESPONSE._serialized_start=3047
  _MUTATIONRESPONSE._serialized_end=3154
  _RULELISTRESPONSE._serialized_start=3157
  _RULELISTRESPONSE._serialized_end=3293
  _POLICYLISTRESPONSE._serialized_start=3296
  _POLICYLISTRESPONSE._serialized_end=3436
  _POLICYSETLISTRESPONSE._serialized_start=3439
  _POLICYSETLISTRESPONSE._serialized_end=3585
  _COMMANDREQUEST._serialized_start=3587
  _COMMANDREQUEST._serialized_end=3634
  _COMMANDRESPONSE._serialized_start=3636
  _COMMANDRESPONSE._serialized_end=3670
  _HEALTHCHECKREQUEST._serialized_start=3672
  _HEALTHCHECKREQUEST._serialized_end=3709
  _HEALTHCHECKRESPONSE._serialized_start=3711
  _HEALTHCHECKRESPONSE._serialized_end=3748
  _FINDBYTOKENREQUEST._serialized_start=3750
  _FINDBYTOKENREQUEST._serialized_end=3785
  _SUBJECTRESPONSE._serialized_start=3787
  _SUBJECTRESPONSE._serialized_end=3862
# @@protoc_insertion_point(module_scope)
