"""Host prepared-artifact store: disk cache with a byte quota + eviction.

The reference persists every prepared image with ``wx.saveFile`` so it
survives temp-path eviction, and governs the quota explicitly: on errno
1300202 ("file storage limit is exceeded") it evicts the oldest saved files
down to an 8 MB soft limit, then flips a session-wide ``_disableSaveFile``
with a one-shot toast (pages/index/index.js:158-199,486-532,629-676).

The framework's analog stores *decode results* (raw uint8 array +
orientation) on local disk keyed by source identity, so a server restart —
or a second process — never re-decodes unchanged inputs:

* content key = (absolute path, mtime_ns, size, decode params);
* LRU eviction by access time down to a soft limit whenever the byte quota
  is exceeded (the ``_cleanupSavedStorage`` analog);
* any write failure disables the store for the session with a one-shot
  logger event (the ``_disableSaveFile`` + toast analog) — caching is an
  optimization and must never fail a job.
"""

from __future__ import annotations

import hashlib
import os
import threading
from typing import Optional, Tuple

import numpy as np

from .logger import get_logger


class ArtifactStore:
    def __init__(self, root: str, quota_bytes: int = 512 << 20,
                 soft_limit_bytes: Optional[int] = None):
        self.root = os.fspath(root)
        self.quota = int(quota_bytes)
        self.soft_limit = (int(soft_limit_bytes) if soft_limit_bytes
                           is not None else self.quota // 2)
        self._lock = threading.Lock()
        self._disabled = False
        try:
            os.makedirs(self.root, exist_ok=True)
        except OSError:
            self._disable("mkdir failed")

    # ---------------------------------------------------------------- keys

    @staticmethod
    def key_for(path: str, params: str = "") -> Optional[str]:
        """Identity key for a source file, or None if it can't be stat'd."""
        try:
            st = os.stat(os.fspath(path))
        except OSError:
            return None
        raw = f"{os.path.abspath(os.fspath(path))}|{st.st_mtime_ns}|" \
              f"{st.st_size}|{params}"
        return hashlib.sha1(raw.encode()).hexdigest()

    def _file(self, key: str) -> str:
        return os.path.join(self.root, key + ".npz")

    # ---------------------------------------------------------------- api

    @property
    def disabled(self) -> bool:
        return self._disabled

    def get(self, key: str) -> Optional[Tuple[np.ndarray, int]]:
        if self._disabled or key is None:
            return None
        f = self._file(key)
        try:
            with np.load(f) as z:
                arr = np.ascontiguousarray(z["arr"])
                orientation = int(z["orientation"])
            os.utime(f, None)        # LRU touch
            return arr, orientation
        except FileNotFoundError:
            return None
        except Exception:            # corrupt entry: drop it
            try:
                os.unlink(f)
            except OSError:
                pass
            return None

    def put(self, key: str, arr: np.ndarray, orientation: int) -> None:
        if self._disabled or key is None:
            return
        f = self._file(key)
        # pid AND thread id: the prepare pool can put the same key from two
        # threads at once (duplicate inputs) — a pid-only tmp name would
        # interleave their writes and publish a corrupt entry
        tmp = f + f".tmp{os.getpid()}.{threading.get_ident()}"
        try:
            with open(tmp, "wb") as fh:
                np.savez(fh, arr=np.asarray(arr),
                         orientation=np.int64(orientation))
            os.replace(tmp, f)       # atomic publish
        except OSError as e:
            # the errno-1300202 analog: disable for the session, warn once
            self._disable(repr(e))
            try:
                os.unlink(tmp)
            except OSError:
                pass
            return
        self._evict_to_quota()

    def clear(self) -> None:
        with self._lock:
            for name in os.listdir(self.root):
                if name.endswith(".npz"):
                    try:
                        os.unlink(os.path.join(self.root, name))
                    except OSError:
                        pass

    def total_bytes(self) -> int:
        total = 0
        for name in os.listdir(self.root):
            if name.endswith(".npz"):
                try:
                    total += os.path.getsize(os.path.join(self.root, name))
                except OSError:
                    pass
        return total

    # ------------------------------------------------------------ internals

    def _disable(self, reason: str) -> None:
        self._disabled = True
        get_logger().once("artifacts.disabled", reason=reason,
                          root=self.root)

    def _evict_to_quota(self) -> None:
        """Oldest-accessed entries out first, down to the soft limit
        (``_cleanupSavedStorage``, index.js:177-199)."""
        with self._lock:
            try:
                entries = []
                total = 0
                for name in os.listdir(self.root):
                    if not name.endswith(".npz"):
                        continue
                    f = os.path.join(self.root, name)
                    try:
                        st = os.stat(f)
                    except OSError:
                        continue
                    entries.append((st.st_atime_ns, st.st_size, f))
                    total += st.st_size
                if total <= self.quota:
                    return
                evicted = 0
                for _, size, f in sorted(entries):
                    if total <= self.soft_limit:
                        break
                    try:
                        os.unlink(f)
                        total -= size
                        evicted += 1
                    except OSError:
                        pass
                get_logger().event("artifacts.evicted", n=evicted,
                                   bytes_left=total)
            except OSError as e:
                self._disable(repr(e))


_stores: dict = {}
_stores_lock = threading.Lock()


def get_store(root: str, quota_bytes: int = 512 << 20) -> ArtifactStore:
    """Process-wide store per root directory."""
    with _stores_lock:
        st = _stores.get(root)
        if st is None or st.quota != quota_bytes:
            st = ArtifactStore(root, quota_bytes)
            _stores[root] = st
        return st
