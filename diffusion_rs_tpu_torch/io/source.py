"""Model sources and unified file access (the port's own copy of
``diffusion_rs_tpu/io/source.py``).

A source is a local directory, a DDUF zip, or a Hugging Face hub id
(snapshot-downloaded through ``huggingface_hub``, imported only on that
branch). :class:`FileLoader` lists and reads uniformly over them, with
zero-copy reads out of DDUF mmaps. Token resolution: literal > ``path:FILE``
> ``HF_TOKEN`` / ``HUGGING_FACE_HUB_TOKEN`` > the cached token file > none.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import List, Optional

from .dduf import DdufFile
from .safetensors import SafeTensors


def resolve_token(token: Optional[str] = None) -> Optional[str]:
    if token:
        if token.startswith("path:"):
            return Path(token[len("path:"):]).read_text().strip() or None
        return token
    for env in ("HF_TOKEN", "HUGGING_FACE_HUB_TOKEN"):
        if os.environ.get(env):
            return os.environ[env]
    cache = Path.home() / ".cache" / "huggingface" / "token"
    if cache.exists():
        return cache.read_text().strip() or None
    return None


class FileLoader:
    """Uniform listing/reads over a local dir, a hub snapshot, or a DDUF."""

    def __init__(self, model_id: Optional[str] = None, dduf_file: Optional[str] = None,
                 token: Optional[str] = None, revision: Optional[str] = None,
                 silent: bool = False):
        self._dduf: Optional[DdufFile] = None
        self._root: Optional[Path] = None
        if dduf_file is not None:
            self._dduf = DdufFile(dduf_file)
        elif model_id is not None and Path(model_id).is_dir():
            self._root = Path(model_id)
        elif model_id is not None:
            from huggingface_hub import snapshot_download

            self._root = Path(snapshot_download(
                model_id, token=resolve_token(token), revision=revision))
        else:
            raise ValueError("need model_id or dduf_file")

    @property
    def root(self) -> Optional[Path]:
        """The directory behind a directory or hub source (None for DDUF)."""
        return self._root

    def list_files(self) -> List[str]:
        if self._dduf is not None:
            return self._dduf.names()
        return sorted(str(p.relative_to(self._root))
                      for p in self._root.rglob("*") if p.is_file())

    def exists(self, name: str) -> bool:
        if self._dduf is not None:
            return name in self._dduf
        return (self._root / name).is_file()

    def read_bytes(self, name: str) -> bytes:
        if self._dduf is not None:
            return self._dduf.read_bytes(name)
        return (self._root / name).read_bytes()

    def safetensors(self, name: str) -> SafeTensors:
        if self._dduf is not None:
            return self._dduf.safetensors(name)
        return SafeTensors.from_file(str(self._root / name))
