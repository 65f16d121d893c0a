"""Host-memory weight offload (port of ``parallel/offload.py``).

``Offloading.Full`` keeps each component's weights in host memory and puts
them on the device only around their use, component by component, as the
reference does (pipelines/flux/mod.rs:231-325).

``register`` packs a component into one host buffer (util/hostmem.py),
page-locked at its exact size on a CUDA target, so that ``resident`` is one
DMA enqueued on the device's current stream with ``non_blocking=True``: the
stream orders the copy before the compute that reads it, and the host does
not wait. The component is rebuilt as views of the host buffer and of its
device copy. ``release`` drops the device copy; the caching allocator
reuses its memory in stream order. On a CPU target the host copy is the
resident one, with the same refcounts.
"""

from __future__ import annotations

import threading
from typing import Any, Optional

from ..util.device import resolve_device
from ..util.hostmem import pack_tree, unpack_tree


class HostOffload:
    """Component-granularity offload manager.

    Components register their param trees; :meth:`resident` places a device
    copy (refcounted, under a lock, so that concurrent users of one
    component do not evict each other's copy mid-use) and :meth:`release`
    drops it at refcount zero; the registry keeps the host copies.
    ``only``: offload just these component names (e.g. ``("t5", "clip")``
    keeps the transformer resident)."""

    def __init__(self, only=None):
        self._host: dict = {}  # name -> (host buffer, its views, template, specs)
        self._device: dict = {}
        self._target: dict = {}
        self._refs: dict = {}
        self._only = frozenset(only) if only is not None else None
        self._lock = threading.RLock()

    def manages(self, name: str) -> bool:
        return name in self._host

    def register(self, name: str, params: Any, device="cuda") -> Any:
        """Keep ``params``' host copy under ``name``, to be placed on
        ``device`` (under a mesh, the rank's card). Returns the tree the
        caller keeps: the host copy, or ``params`` when ``only`` leaves
        ``name`` out."""
        if self._only is not None and name not in self._only:
            return params
        dev = resolve_device(device)
        with self._lock:
            self._target[name] = dev
            buf, template, specs = pack_tree(params, pin=dev.type == "cuda")
            self._host[name] = (buf, unpack_tree(buf, template, specs), template, specs)
            return self._host[name][1]

    def resident(self, name: str) -> Any:
        """Acquire a device copy (refcounted; pair with :meth:`release`)."""
        with self._lock:
            if name not in self._device:
                dev = self._target[name]
                buf, host, template, specs = self._host[name]
                self._device[name] = host if dev.type == "cpu" else unpack_tree(
                    buf.to(dev, non_blocking=True), template, specs)
            self._refs[name] = self._refs.get(name, 0) + 1
            return self._device[name]

    def release(self, name: str):
        """Drop one reference; the device copy is evicted at refcount zero."""
        with self._lock:
            n = self._refs.get(name, 0) - 1
            if n <= 0:
                self._refs.pop(name, None)
                self._device.pop(name, None)
            else:
                self._refs[name] = n

    def ensure_resident(self, name: Optional[str] = None):
        if name is not None:
            return self.resident(name)
        return None
