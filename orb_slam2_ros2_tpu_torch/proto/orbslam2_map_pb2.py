# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: orbslam2_map.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x12orbslam2_map.proto\x12\x08orbslam2\"?\n\x08KeyPoint\x12\t\n\x01x\x18\x01 \x01(\x02\x12\t\n\x01y\x18\x02 \x01(\x02\x12\x0e\n\x06octave\x18\x03 \x01(\x05\x12\r\n\x05\x61ngle\x18\x04 \x01(\x02\"\x1a\n\nDescriptor\x12\x0c\n\x04\x64\x61ta\x18\x01 \x01(\x0c\"h\n\tBowVector\x12-\n\x05words\x18\x01 \x03(\x0b\x32\x1e.orbslam2.BowVector.WordsEntry\x1a,\n\nWordsEntry\x12\x0b\n\x03key\x18\x01 \x01(\r\x12\r\n\x05value\x18\x02 \x01(\x01:\x02\x38\x01\"x\n\rFeatureVector\x12\x32\n\x05nodes\x18\x01 \x03(\x0b\x32#.orbslam2.FeatureVector.FeatureNode\x1a\x33\n\x0b\x46\x65\x61tureNode\x12\x0f\n\x07node_id\x18\x01 \x01(\r\x12\x13\n\x0b\x66\x65\x61ture_ids\x18\x02 \x03(\r\"-\n\x04Pose\x12\x10\n\x08rotation\x18\x01 \x03(\x02\x12\x13\n\x0btranslation\x18\x02 \x03(\x02\"/\n\x11\x43onnectedKeyFrame\x12\n\n\x02id\x18\x01 \x01(\x04\x12\x0e\n\x06weight\x18\x02 \x01(\x05\"\xb3\x03\n\x0cKeyFrameData\x12\n\n\x02id\x18\x01 \x01(\x04\x12\r\n\x05max_u\x18\x02 \x01(\x02\x12\r\n\x05max_v\x18\x03 \x01(\x02\x12\r\n\x05min_u\x18\x04 \x01(\x02\x12\r\n\x05min_v\x18\x05 \x01(\x02\x12%\n\tkeypoints\x18\x06 \x03(\x0b\x32\x12.orbslam2.KeyPoint\x12\x0f\n\x07right_u\x18\x07 \x03(\x02\x12\x0e\n\x06\x64\x65pths\x18\x08 \x03(\x02\x12)\n\x0b\x64\x65scriptors\x18\t \x03(\x0b\x32\x14.orbslam2.Descriptor\x12\'\n\nbow_vector\x18\n \x01(\x0b\x32\x13.orbslam2.BowVector\x12/\n\x0e\x66\x65\x61ture_vector\x18\x0b \x01(\x0b\x32\x17.orbslam2.FeatureVector\x12\x1c\n\x04pose\x18\x0c \x01(\x0b\x32\x0e.orbslam2.Pose\x12\x32\n\rconnected_kfs\x18\r \x03(\x0b\x32\x1b.orbslam2.ConnectedKeyFrame\x12\x14\n\x0c\x63hildren_ids\x18\x0e \x03(\x04\x12\x12\n\nloop_edges\x18\x0f \x03(\x04\x12\x12\n\nmap_points\x18\x10 \x03(\x03\"a\n\x0cKeyFrameList\x12\x0f\n\x07next_id\x18\x01 \x01(\x04\x12\x15\n\rscale_factors\x18\x02 \x03(\x02\x12)\n\tkeyframes\x18\x03 \x03(\x0b\x32\x16.orbslam2.KeyFrameData\"*\n\x07Vector3\x12\t\n\x01x\x18\x01 \x01(\x02\x12\t\n\x01y\x18\x02 \x01(\x02\x12\t\n\x01z\x18\x03 \x01(\x02\"\x96\x02\n\x0cMapPointData\x12\n\n\x02id\x18\x01 \x01(\x04\x12\x14\n\x0cmax_distance\x18\x02 \x01(\x02\x12\x14\n\x0cmin_distance\x18\x03 \x01(\x02\x12\x11\n\tref_kf_id\x18\x04 \x01(\x04\x12\x13\n\x0bref_feat_id\x18\x05 \x01(\x04\x12\x18\n\x10matches_in_track\x18\x06 \x01(\x05\x12\x18\n\x10inliers_in_track\x18\x07 \x01(\x05\x12#\n\x08position\x18\x08 \x01(\x0b\x32\x11.orbslam2.Vector3\x12)\n\x0eview_direction\x18\t \x01(\x0b\x32\x11.orbslam2.Vector3\x12\"\n\x04\x64\x65sc\x18\n \x01(\x0b\x32\x14.orbslam2.Descriptor\"9\n\x0cMapPointList\x12)\n\tmappoints\x18\x01 \x03(\x0b\x32\x16.orbslam2.MapPointData\"_\n\x07MapData\x12)\n\tkeyframes\x18\x01 \x01(\x0b\x32\x16.orbslam2.KeyFrameList\x12)\n\tmappoints\x18\x02 \x01(\x0b\x32\x16.orbslam2.MapPointListb\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'orbslam2_map_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _BOWVECTOR_WORDSENTRY._options = None
  _BOWVECTOR_WORDSENTRY._serialized_options = b'8\001'
  _KEYPOINT._serialized_start=32
  _KEYPOINT._serialized_end=95
  _DESCRIPTOR._serialized_start=97
  _DESCRIPTOR._serialized_end=123
  _BOWVECTOR._serialized_start=125
  _BOWVECTOR._serialized_end=229
  _BOWVECTOR_WORDSENTRY._serialized_start=185
  _BOWVECTOR_WORDSENTRY._serialized_end=229
  _FEATUREVECTOR._serialized_start=231
  _FEATUREVECTOR._serialized_end=351
  _FEATUREVECTOR_FEATURENODE._serialized_start=300
  _FEATUREVECTOR_FEATURENODE._serialized_end=351
  _POSE._serialized_start=353
  _POSE._serialized_end=398
  _CONNECTEDKEYFRAME._serialized_start=400
  _CONNECTEDKEYFRAME._serialized_end=447
  _KEYFRAMEDATA._serialized_start=450
  _KEYFRAMEDATA._serialized_end=885
  _KEYFRAMELIST._serialized_start=887
  _KEYFRAMELIST._serialized_end=984
  _VECTOR3._serialized_start=986
  _VECTOR3._serialized_end=1028
  _MAPPOINTDATA._serialized_start=1031
  _MAPPOINTDATA._serialized_end=1309
  _MAPPOINTLIST._serialized_start=1311
  _MAPPOINTLIST._serialized_end=1368
  _MAPDATA._serialized_start=1370
  _MAPDATA._serialized_end=1465
# @@protoc_insertion_point(module_scope)
