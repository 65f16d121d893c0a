"""DDUF archive reader (the port's own copy of ``diffusion_rs_tpu/io/dduf.py``):
a zip of model components, Hugging Face's diffusion checkpoint container.

The archive is mmap'd once; STORED (uncompressed) members are exposed as
zero-copy (start, end) slices of the mmap, and safetensors inside the
archive are parsed straight from those slices. Standard library only.
"""

from __future__ import annotations

import mmap
import struct
import zipfile
from typing import Dict, Tuple

from .safetensors import SafeTensors

_LOCAL_HEADER_FMT = "<4s5H3I2H"
_LOCAL_HEADER_LEN = 30


class DdufFile:
    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            self._mmap = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
        self._entries: Dict[str, Tuple[int, int, bool]] = {}
        with zipfile.ZipFile(path) as zf:
            for zi in zf.infolist():
                if zi.is_dir():
                    continue
                # The central directory's header_offset points at the local
                # header, whose variable-length name/extra fields precede
                # the member's data.
                ho = zi.header_offset
                hdr = self._mmap[ho: ho + _LOCAL_HEADER_LEN]
                (sig, _, _, method, _, _, _, _, _, name_len, extra_len
                 ) = struct.unpack(_LOCAL_HEADER_FMT, hdr)
                if sig != b"PK\x03\x04":
                    raise ValueError(f"bad local header for {zi.filename}")
                start = ho + _LOCAL_HEADER_LEN + name_len + extra_len
                stored = method == zipfile.ZIP_STORED
                self._entries[zi.filename] = (start, start + zi.compress_size, stored)

    def names(self):
        return list(self._entries)

    def __contains__(self, name: str) -> bool:
        return name in self._entries

    def read_bytes(self, name: str) -> bytes:
        """Owned bytes (decompresses members that are not stored)."""
        start, end, stored = self._entries[name]
        if stored:
            return bytes(self._mmap[start:end])
        with zipfile.ZipFile(self.path) as zf:
            return zf.read(name)

    def safetensors(self, name: str) -> SafeTensors:
        """Zero-copy safetensors view into the mmap (stored members only)."""
        start, end, stored = self._entries[name]
        if not stored:
            raise ValueError(
                f"{name} is compressed inside the DDUF; zero-copy requires stored entries")
        return SafeTensors(self._mmap, base_offset=start, length=end - start)
