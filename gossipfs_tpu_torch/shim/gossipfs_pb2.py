# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: gossipfs.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()


from google.protobuf import struct_pb2 as google_dot_protobuf_dot_struct__pb2


DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x0egossipfs.proto\x12\x08gossipfs\x1a\x1cgoogle/protobuf/struct.proto\"\x07\n\x05\x45mpty\"[\n\x07OkReply\x12\n\n\x02ok\x18\x01 \x01(\x08\x12\x15\n\x08\x63onflict\x18\x02 \x01(\x08H\x00\x88\x01\x01\x12\x14\n\x07\x65xpired\x18\x03 \x01(\x08H\x01\x88\x01\x01\x42\x0b\n\t_conflictB\n\n\x08_expired\"\x1b\n\x0bNodeRequest\x12\x0c\n\x04node\x18\x01 \x01(\x05\"\x1e\n\nLsmRequest\x12\x10\n\x08observer\x18\x01 \x01(\x05\"E\n\x08LsmReply\x12\x0f\n\x07members\x18\x01 \x03(\x05\x12\x18\n\x0b\x61s_of_round\x18\x02 \x01(\x05H\x00\x88\x01\x01\x42\x0e\n\x0c_as_of_round\"J\n\x0f\x41liveNodesReply\x12\r\n\x05nodes\x18\x01 \x03(\x05\x12\x18\n\x0b\x61s_of_round\x18\x02 \x01(\x05H\x00\x88\x01\x01\x42\x0e\n\x0c_as_of_round\" \n\x0e\x41\x64vanceRequest\x12\x0e\n\x06rounds\x18\x01 \x01(\x05\"\x1d\n\x0c\x41\x64vanceReply\x12\r\n\x05round\x18\x01 \x01(\x05\"T\n\x12\x41\x64vanceBulkRequest\x12\x0e\n\x06rounds\x18\x01 \x01(\x05\x12\x1b\n\x0esnapshot_every\x18\x02 \x01(\x05H\x00\x88\x01\x01\x42\x11\n\x0f_snapshot_every\"@\n\x10\x41\x64vanceBulkReply\x12\x14\n\x0cround_target\x18\x01 \x01(\x05\x12\x16\n\x0esnapshot_every\x18\x02 \x01(\x05\"\x1e\n\rEventsRequest\x12\r\n\x05since\x18\x01 \x01(\x05\"Z\n\x0e\x44\x65tectionEvent\x12\r\n\x05round\x18\x01 \x01(\x05\x12\x10\n\x08observer\x18\x02 \x01(\x05\x12\x0f\n\x07subject\x18\x03 \x01(\x05\x12\x16\n\x0e\x66\x61lse_positive\x18\x04 \x01(\x08\"E\n\x0b\x45ventsReply\x12(\n\x06\x65vents\x18\x01 \x03(\x0b\x32\x18.gossipfs.DetectionEvent\x12\x0c\n\x04next\x18\x02 \x01(\x05\":\n\x0bGrepRequest\x12\x0f\n\x07pattern\x18\x01 \x01(\t\x12\x11\n\x04node\x18\x02 \x01(\x05H\x00\x88\x01\x01\x42\x07\n\x05_node\"3\n\tGrepReply\x12&\n\x05lines\x18\x01 \x03(\x0b\x32\x17.google.protobuf.Struct\"\x1b\n\x0b\x46ileRequest\x12\x0c\n\x04\x66ile\x18\x01 \x01(\t\"-\n\x0fNodeFileRequest\x12\x0c\n\x04node\x18\x01 \x01(\x05\x12\x0c\n\x04\x66ile\x18\x02 \x01(\t\"A\n\x0ePutInfoRequest\x12\x0c\n\x04\x66ile\x18\x01 \x01(\t\x12\x0f\n\x07\x63onfirm\x18\x02 \x01(\x08\x12\x10\n\x08\x63\x61llback\x18\x03 \x01(\t\"a\n\x0cPutInfoReply\x12\n\n\x02ok\x18\x01 \x01(\x08\x12\x15\n\x08\x63onflict\x18\x02 \x01(\x08H\x00\x88\x01\x01\x12\x10\n\x08replicas\x18\x03 \x03(\x05\x12\x0f\n\x07version\x18\x04 \x01(\x05\x42\x0b\n\t_conflict\"8\n\rFileDataReply\x12\x15\n\rlocal_version\x18\x01 \x01(\x05\x12\x10\n\x08\x64\x61ta_b64\x18\x02 \x01(\t\"S\n\x12PutFileDataRequest\x12\x0c\n\x04node\x18\x01 \x01(\x05\x12\x0c\n\x04\x66ile\x18\x02 \x01(\t\x12\x0f\n\x07version\x18\x03 \x01(\x05\x12\x10\n\x08\x64\x61ta_b64\x18\x04 \x01(\t\"2\n\rFileInfoReply\x12\x10\n\x08replicas\x18\x01 \x03(\x05\x12\x0f\n\x07version\x18\x02 \x01(\x05\"\x1f\n\x0c\x43onfirmReply\x12\x0f\n\x07\x63onfirm\x18\x01 \x01(\x08\"\'\n\x0f\x44\x65leteInfoReply\x12\x14\n\x0cold_replicas\x18\x01 \x03(\x05\"M\n\x0cReputRequest\x12\x0e\n\x06source\x18\x01 \x01(\x05\x12\x0e\n\x06target\x18\x02 \x01(\x05\x12\x0c\n\x04\x66ile\x18\x03 \x01(\t\x12\x0f\n\x07version\x18\x04 \x01(\x05\"/\n\x0bVoteRequest\x12\x11\n\tcandidate\x18\x01 \x01(\x05\x12\r\n\x05voter\x18\x02 \x01(\x05\"+\n\tVoteReply\x12\x0f\n\x07\x65lected\x18\x01 \x01(\x08\x12\r\n\x05votes\x18\x02 \x01(\x05\"-\n\rAssignRequest\x12\x0c\n\x04node\x18\x01 \x01(\x05\x12\x0e\n\x06master\x18\x02 \x01(\x05\"r\n\x0b\x41ssignReply\x12\x33\n\x07listing\x18\x01 \x03(\x0b\x32\".gossipfs.AssignReply.ListingEntry\x1a.\n\x0cListingEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\x05:\x02\x38\x01\"C\n\x14UpdateVersionRequest\x12\x0c\n\x04node\x18\x01 \x01(\x05\x12\x0c\n\x04\x66ile\x18\x02 \x01(\t\x12\x0f\n\x07version\x18\x03 \x01(\x05\"\'\n\x11UpdateMetaRequest\x12\x12\n\nmembership\x18\x01 \x03(\x05\"a\n\nRepairPlan\x12\x0c\n\x04\x66ile\x18\x01 \x01(\t\x12\x0e\n\x06source\x18\x02 \x01(\x05\x12\x0f\n\x07version\x18\x03 \x01(\x05\x12\x11\n\tnew_nodes\x18\x04 \x03(\x05\x12\x11\n\tsurvivors\x18\x05 \x03(\x05\"6\n\x0fUpdateMetaReply\x12#\n\x05plans\x18\x01 \x03(\x0b\x32\x14.gossipfs.RepairPlan\"O\n\nPutRequest\x12\x0c\n\x04\x66ile\x18\x01 \x01(\t\x12\x10\n\x08\x64\x61ta_b64\x18\x02 \x01(\t\x12\x0f\n\x07\x63onfirm\x18\x03 \x01(\x08\x12\x10\n\x08\x63\x61llback\x18\x04 \x01(\t\"+\n\x08GetReply\x12\r\n\x05\x66ound\x18\x01 \x01(\x08\x12\x10\n\x08\x64\x61ta_b64\x18\x02 \x01(\t\"\x1b\n\x07LsReply\x12\x10\n\x08replicas\x18\x01 \x03(\x05\"p\n\nStoreReply\x12\x32\n\x07listing\x18\x01 \x03(\x0b\x32!.gossipfs.StoreReply.ListingEntry\x1a.\n\x0cListingEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\x05:\x02\x38\x01\".\n\x08\x46ileMeta\x12\x0f\n\x07version\x18\x01 \x01(\x05\x12\x11\n\tnode_list\x18\x02 \x03(\x05\"\x84\x01\n\rMetadataReply\x12\x31\n\x05\x66iles\x18\x01 \x03(\x0b\x32\".gossipfs.MetadataReply.FilesEntry\x1a@\n\nFilesEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12!\n\x05value\x18\x02 \x01(\x0b\x32\x12.gossipfs.FileMeta:\x02\x38\x01\x32\xbf\x0c\n\x04Shim\x12\x30\n\x04Join\x12\x15.gossipfs.NodeRequest\x1a\x11.gossipfs.OkReply\x12\x31\n\x05Leave\x12\x15.gossipfs.NodeRequest\x1a\x11.gossipfs.OkReply\x12\x31\n\x05\x43rash\x12\x15.gossipfs.NodeRequest\x1a\x11.gossipfs.OkReply\x12/\n\x03Lsm\x12\x14.gossipfs.LsmRequest\x1a\x12.gossipfs.LsmReply\x12\x38\n\nAliveNodes\x12\x0f.gossipfs.Empty\x1a\x19.gossipfs.AliveNodesReply\x12;\n\x07\x41\x64vance\x12\x18.gossipfs.AdvanceRequest\x1a\x16.gossipfs.AdvanceReply\x12G\n\x0b\x41\x64vanceBulk\x12\x1c.gossipfs.AdvanceBulkRequest\x1a\x1a.gossipfs.AdvanceBulkReply\x12\x38\n\x06\x45vents\x12\x17.gossipfs.EventsRequest\x1a\x15.gossipfs.EventsReply\x12\x32\n\x04Grep\x12\x15.gossipfs.GrepRequest\x1a\x13.gossipfs.GrepReply\x12>\n\nGetPutInfo\x12\x18.gossipfs.PutInfoRequest\x1a\x16.gossipfs.PutInfoReply\x12\x41\n\x0bGetFileData\x12\x19.gossipfs.NodeFileRequest\x1a\x17.gossipfs.FileDataReply\x12=\n\x0bGetFileInfo\x12\x15.gossipfs.FileRequest\x1a\x17.gossipfs.FileInfoReply\x12\x43\n\x12\x41skForConfirmation\x12\x15.gossipfs.FileRequest\x1a\x16.gossipfs.ConfirmReply\x12\x41\n\rGetDeleteInfo\x12\x15.gossipfs.FileRequest\x1a\x19.gossipfs.DeleteInfoReply\x12>\n\x0e\x44\x65leteFileData\x12\x19.gossipfs.NodeFileRequest\x1a\x11.gossipfs.OkReply\x12\x38\n\x0bRemoteReput\x12\x16.gossipfs.ReputRequest\x1a\x11.gossipfs.OkReply\x12>\n\x0bPutFileData\x12\x1c.gossipfs.PutFileDataRequest\x1a\x11.gossipfs.OkReply\x12\x32\n\x04Vote\x12\x15.gossipfs.VoteRequest\x1a\x13.gossipfs.VoteReply\x12\x41\n\x0f\x41ssignNewMaster\x12\x17.gossipfs.AssignRequest\x1a\x15.gossipfs.AssignReply\x12\x46\n\x11UpdateFileVersion\x12\x1e.gossipfs.UpdateVersionRequest\x1a\x11.gossipfs.OkReply\x12G\n\rGetUpdateMeta\x12\x1b.gossipfs.UpdateMetaRequest\x1a\x19.gossipfs.UpdateMetaReply\x12.\n\x03Put\x12\x14.gossipfs.PutRequest\x1a\x11.gossipfs.OkReply\x12\x30\n\x03Get\x12\x15.gossipfs.FileRequest\x1a\x12.gossipfs.GetReply\x12\x32\n\x06\x44\x65lete\x12\x15.gossipfs.FileRequest\x1a\x11.gossipfs.OkReply\x12.\n\x02Ls\x12\x15.gossipfs.FileRequest\x1a\x11.gossipfs.LsReply\x12\x34\n\x05Store\x12\x15.gossipfs.NodeRequest\x1a\x14.gossipfs.StoreReply\x12\x38\n\x0cShowMetadata\x12\x0f.gossipfs.Empty\x1a\x17.gossipfs.MetadataReplyb\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'gossipfs_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _ASSIGNREPLY_LISTINGENTRY._options = None
  _ASSIGNREPLY_LISTINGENTRY._serialized_options = b'8\001'
  _STOREREPLY_LISTINGENTRY._options = None
  _STOREREPLY_LISTINGENTRY._serialized_options = b'8\001'
  _METADATAREPLY_FILESENTRY._options = None
  _METADATAREPLY_FILESENTRY._serialized_options = b'8\001'
  _EMPTY._serialized_start=58
  _EMPTY._serialized_end=65
  _OKREPLY._serialized_start=67
  _OKREPLY._serialized_end=158
  _NODEREQUEST._serialized_start=160
  _NODEREQUEST._serialized_end=187
  _LSMREQUEST._serialized_start=189
  _LSMREQUEST._serialized_end=219
  _LSMREPLY._serialized_start=221
  _LSMREPLY._serialized_end=290
  _ALIVENODESREPLY._serialized_start=292
  _ALIVENODESREPLY._serialized_end=366
  _ADVANCEREQUEST._serialized_start=368
  _ADVANCEREQUEST._serialized_end=400
  _ADVANCEREPLY._serialized_start=402
  _ADVANCEREPLY._serialized_end=431
  _ADVANCEBULKREQUEST._serialized_start=433
  _ADVANCEBULKREQUEST._serialized_end=517
  _ADVANCEBULKREPLY._serialized_start=519
  _ADVANCEBULKREPLY._serialized_end=583
  _EVENTSREQUEST._serialized_start=585
  _EVENTSREQUEST._serialized_end=615
  _DETECTIONEVENT._serialized_start=617
  _DETECTIONEVENT._serialized_end=707
  _EVENTSREPLY._serialized_start=709
  _EVENTSREPLY._serialized_end=778
  _GREPREQUEST._serialized_start=780
  _GREPREQUEST._serialized_end=838
  _GREPREPLY._serialized_start=840
  _GREPREPLY._serialized_end=891
  _FILEREQUEST._serialized_start=893
  _FILEREQUEST._serialized_end=920
  _NODEFILEREQUEST._serialized_start=922
  _NODEFILEREQUEST._serialized_end=967
  _PUTINFOREQUEST._serialized_start=969
  _PUTINFOREQUEST._serialized_end=1034
  _PUTINFOREPLY._serialized_start=1036
  _PUTINFOREPLY._serialized_end=1133
  _FILEDATAREPLY._serialized_start=1135
  _FILEDATAREPLY._serialized_end=1191
  _PUTFILEDATAREQUEST._serialized_start=1193
  _PUTFILEDATAREQUEST._serialized_end=1276
  _FILEINFOREPLY._serialized_start=1278
  _FILEINFOREPLY._serialized_end=1328
  _CONFIRMREPLY._serialized_start=1330
  _CONFIRMREPLY._serialized_end=1361
  _DELETEINFOREPLY._serialized_start=1363
  _DELETEINFOREPLY._serialized_end=1402
  _REPUTREQUEST._serialized_start=1404
  _REPUTREQUEST._serialized_end=1481
  _VOTEREQUEST._serialized_start=1483
  _VOTEREQUEST._serialized_end=1530
  _VOTEREPLY._serialized_start=1532
  _VOTEREPLY._serialized_end=1575
  _ASSIGNREQUEST._serialized_start=1577
  _ASSIGNREQUEST._serialized_end=1622
  _ASSIGNREPLY._serialized_start=1624
  _ASSIGNREPLY._serialized_end=1738
  _ASSIGNREPLY_LISTINGENTRY._serialized_start=1692
  _ASSIGNREPLY_LISTINGENTRY._serialized_end=1738
  _UPDATEVERSIONREQUEST._serialized_start=1740
  _UPDATEVERSIONREQUEST._serialized_end=1807
  _UPDATEMETAREQUEST._serialized_start=1809
  _UPDATEMETAREQUEST._serialized_end=1848
  _REPAIRPLAN._serialized_start=1850
  _REPAIRPLAN._serialized_end=1947
  _UPDATEMETAREPLY._serialized_start=1949
  _UPDATEMETAREPLY._serialized_end=2003
  _PUTREQUEST._serialized_start=2005
  _PUTREQUEST._serialized_end=2084
  _GETREPLY._serialized_start=2086
  _GETREPLY._serialized_end=2129
  _LSREPLY._serialized_start=2131
  _LSREPLY._serialized_end=2158
  _STOREREPLY._serialized_start=2160
  _STOREREPLY._serialized_end=2272
  _STOREREPLY_LISTINGENTRY._serialized_start=1692
  _STOREREPLY_LISTINGENTRY._serialized_end=1738
  _FILEMETA._serialized_start=2274
  _FILEMETA._serialized_end=2320
  _METADATAREPLY._serialized_start=2323
  _METADATAREPLY._serialized_end=2455
  _METADATAREPLY_FILESENTRY._serialized_start=2391
  _METADATAREPLY_FILESENTRY._serialized_end=2455
  _SHIM._serialized_start=2458
  _SHIM._serialized_end=4057
# @@protoc_insertion_point(module_scope)
