# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: moverjax.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x0emoverjax.proto\x12\x08moverjax\"(\n\x0b\x44\x61taSegment\x12\x0c\n\x04\x64\x61ta\x18\x01 \x01(\x0c\x12\x0b\n\x03\x65of\x18\x02 \x01(\x08\"7\n\x05\x43hunk\x12\x0e\n\x06offset\x18\x01 \x01(\x04\x12\x0e\n\x06length\x18\x02 \x01(\x04\x12\x0e\n\x06\x64igest\x18\x03 \x01(\t\"<\n\nChunkBatch\x12\x1f\n\x06\x63hunks\x18\x01 \x03(\x0b\x32\x0f.moverjax.Chunk\x12\r\n\x05\x66inal\x18\x02 \x01(\x08\"&\n\x04Span\x12\x0e\n\x06offset\x18\x01 \x01(\x04\x12\x0e\n\x06length\x18\x02 \x01(\x04\"?\n\x10HashSpansRequest\x12\x0c\n\x04\x64\x61ta\x18\x01 \x01(\x0c\x12\x1d\n\x05spans\x18\x02 \x03(\x0b\x32\x0e.moverjax.Span\"$\n\x11HashSpansResponse\x12\x0f\n\x07\x64igests\x18\x01 \x03(\t\"\r\n\x0bInfoRequest\"d\n\x0cInfoResponse\x12\x0f\n\x07\x62\x61\x63kend\x18\x01 \x01(\t\x12\x10\n\x08min_size\x18\x02 \x01(\x04\x12\x10\n\x08\x61vg_size\x18\x03 \x01(\x04\x12\x10\n\x08max_size\x18\x04 \x01(\x04\x12\r\n\x05\x61lign\x18\x05 \x01(\x04\x62\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'moverjax_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _DATASEGMENT._serialized_start=28
  _DATASEGMENT._serialized_end=68
  _CHUNK._serialized_start=70
  _CHUNK._serialized_end=125
  _CHUNKBATCH._serialized_start=127
  _CHUNKBATCH._serialized_end=187
  _SPAN._serialized_start=189
  _SPAN._serialized_end=227
  _HASHSPANSREQUEST._serialized_start=229
  _HASHSPANSREQUEST._serialized_end=292
  _HASHSPANSRESPONSE._serialized_start=294
  _HASHSPANSRESPONSE._serialized_end=330
  _INFOREQUEST._serialized_start=332
  _INFOREQUEST._serialized_end=345
  _INFORESPONSE._serialized_start=347
  _INFORESPONSE._serialized_end=447
# @@protoc_insertion_point(module_scope)
