"""Decoded-image LRU cache (host-side; counterpart of
``densefusion_tpu/data/cache.py``). PNGs decode in the host library
(:mod:`densefusion_tpu_torch.native`), other files and the PNG formats it
does not take with PIL.

Training revisits frames constantly (LineMOD repeats each epoch 20x), so
caching decoded arrays trades RAM for decode time. Thread-safe (the loader
may use a thread pool); entries are read-only arrays shared across threads.
"""

from __future__ import annotations

import collections
import threading

import numpy as np

from densefusion_tpu_torch import native


class ImageCache:
    """LRU of path -> decoded ndarray. ``capacity`` is an entry count
    (frames), 0 disables caching."""

    def __init__(self, capacity: int = 0):
        self.capacity = capacity
        self._store: collections.OrderedDict[str, np.ndarray] = \
            collections.OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    def load(self, path: str) -> np.ndarray:
        if self.capacity <= 0:
            return self._decode(path)
        with self._lock:
            arr = self._store.get(path)
            if arr is not None:
                self._store.move_to_end(path)
                self.hits += 1
                return arr
        arr = self._decode(path)
        arr.setflags(write=False)  # shared across threads: freeze
        with self._lock:
            self.misses += 1
            self._store[path] = arr
            self._store.move_to_end(path)
            while len(self._store) > self.capacity:
                self._store.popitem(last=False)
        return arr

    @staticmethod
    def _decode(path: str) -> np.ndarray:
        if path.endswith(".png") and native.available():
            arr = native.decode_png_file(path)
            if arr is not None:
                return arr
        from PIL import Image
        with Image.open(path) as im:
            return np.array(im)
