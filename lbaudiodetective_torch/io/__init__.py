"""Host-side audio IO: CAF container parsing, IMA4 ADPCM / LPCM decoding and
rational-rate polyphase resampling.

This subsystem replaces the reference's reliance on Apple AudioToolbox
(`ExtAudioFileOpenURL/Read` + implicit sample-rate conversion,
LBAudioDetective.m:224-288).  A native C++ decoder (``native/``) provides the
fast path, with a pure-NumPy fallback that is always available.
"""

from lbaudiodetective_torch.io.caf import read_caf
from lbaudiodetective_torch.io.decode import decode_audio_file
from lbaudiodetective_torch.io.resample import resample_rational, design_polyphase_bank

__all__ = ["read_caf", "decode_audio_file", "resample_rational", "design_polyphase_bank"]
