from npswf.io.rawstream import RawSegment, encode_event_stream, write_segment, read_segment
from npswf.io.decode import decode_segment, hms_corrections

__all__ = ["RawSegment", "encode_event_stream", "write_segment", "read_segment",
           "decode_segment", "hms_corrections"]
