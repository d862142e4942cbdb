"""Streaming (incremental) fingerprint extraction and identification on a
torch device."""

from lbaudiodetective_torch.streaming.identify import StreamingIdentifier, StreamMatch
from lbaudiodetective_torch.streaming.runtime import StreamingDetective, StreamingExtractor

__all__ = ["StreamingExtractor", "StreamingDetective", "StreamingIdentifier",
           "StreamMatch"]
