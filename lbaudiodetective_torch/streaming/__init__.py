"""Streaming (incremental) fingerprint extraction on a torch device."""

from lbaudiodetective_torch.streaming.runtime import StreamingDetective, StreamingExtractor

__all__ = ["StreamingExtractor", "StreamingDetective"]
