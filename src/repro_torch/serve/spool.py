"""Content-addressed, size-capped checkpoint spool.

Between chunks the server snapshots in-flight batches (cursor checkpoint +
per-job partial results) into this spool; after a process crash,
``SampleServer.recover`` reads the newest record per batch back and
resumes every job from its last checkpoint, bitwise-identically to an
uninterrupted run.

Layout and durability:

- One pickle file per record, named by the sha1 of its bytes
  (``<digest>.ck``) — content addressing makes writes idempotent and
  de-duplicates identical states.
- Writes are atomic (temp file + ``os.replace``), and a new checkpoint is
  durable *before* the one it supersedes is deleted — a kill -9 at any
  instant leaves at least one valid checkpoint per batch on disk.  A
  crash between replace and delete can leave two records for one batch;
  :meth:`records` surfaces all of them and the server keeps the one with
  the highest ``sweeps_done``.
- The spool is size-capped: after each put, oldest-first eviction (by
  mtime, never the record just written) keeps the directory under
  ``max_bytes``.  Truncated or unreadable files (a crash mid-write before
  the atomic rename only leaves ``*.tmp`` litter, which is ignored) are
  skipped, never fatal.
"""

from __future__ import annotations

import os
import pickle
from typing import Any, List, Optional, Tuple

from repro_torch.core.snapshot import snapshot_digest, write_snapshot_file

__all__ = ["CheckpointSpool"]

_SUFFIX = ".ck"


class CheckpointSpool:
    """Directory of pickled checkpoint records; see the module docstring."""

    def __init__(self, root: str, max_bytes: int = 256 * 1024 * 1024):
        if max_bytes < 1:
            raise ValueError("max_bytes must be >= 1")
        self.root = str(root)
        self.max_bytes = int(max_bytes)
        os.makedirs(self.root, exist_ok=True)
        self.puts = 0
        self.evictions = 0
        self.corrupt_checkpoints = 0

    def _path(self, digest: str) -> str:
        return os.path.join(self.root, digest + _SUFFIX)

    def put(self, record: Any, replaces: Optional[str] = None) -> str:
        """Persist ``record``; returns its content digest.

        ``replaces`` names the digest this record supersedes (the batch's
        previous checkpoint): it is deleted only after the new record is
        durably in place."""
        blob = pickle.dumps(record, protocol=pickle.HIGHEST_PROTOCOL)
        digest = snapshot_digest(blob)
        write_snapshot_file(self._path(digest), blob)
        self.puts += 1
        if replaces and replaces != digest:
            self.remove(replaces)
        self._enforce_cap(keep=digest)
        return digest

    def load(self, digest: str) -> Any:
        """Load a record, verifying its bytes still hash to ``digest``.

        A bit-flipped or truncated file (disk rot, torn write) is treated
        as *missing* — counted in ``corrupt_checkpoints`` and removed so
        the next scan doesn't re-verify it — rather than letting a random
        ``UnpicklingError`` (or worse, a silently wrong record) escape
        into the resume/retry path.  Callers already handle missing
        checkpoints with a from-scratch restart."""
        path = self._path(digest)
        try:
            with open(path, "rb") as f:
                blob = f.read()
        except OSError:
            raise FileNotFoundError(path)
        if snapshot_digest(blob) != digest:
            self.corrupt_checkpoints += 1
            try:
                os.remove(path)
            except OSError:
                pass
            raise FileNotFoundError(
                f"checkpoint {digest} failed content-hash verification; "
                "treated as missing")
        return pickle.loads(blob)

    def remove(self, digest: str) -> bool:
        try:
            os.remove(self._path(digest))
            return True
        except OSError:
            return False

    def records(self) -> List[Tuple[str, Any]]:
        """All readable (digest, record) pairs; corrupt files skipped."""
        out = []
        for name in sorted(os.listdir(self.root)):
            if not name.endswith(_SUFFIX):
                continue
            digest = name[:-len(_SUFFIX)]
            try:
                out.append((digest, self.load(digest)))
            except (OSError, pickle.UnpicklingError, EOFError,
                    AttributeError, ImportError, ValueError):
                continue
        return out

    def nbytes(self) -> int:
        total = 0
        for name in os.listdir(self.root):
            if name.endswith(_SUFFIX):
                try:
                    total += os.path.getsize(os.path.join(self.root, name))
                except OSError:
                    pass
        return total

    def __len__(self) -> int:
        return sum(1 for n in os.listdir(self.root) if n.endswith(_SUFFIX))

    def _enforce_cap(self, keep: str):
        """Oldest-first eviction down to ``max_bytes``; the record just
        written is never evicted (the cap must not undo the put)."""
        entries = []
        for name in os.listdir(self.root):
            if not name.endswith(_SUFFIX) or name == keep + _SUFFIX:
                continue
            p = os.path.join(self.root, name)
            try:
                st = os.stat(p)
            except OSError:
                continue
            entries.append((st.st_mtime, st.st_size, p))
        total = self.nbytes()
        for _, size, p in sorted(entries):
            if total <= self.max_bytes:
                break
            try:
                os.remove(p)
                total -= size
                self.evictions += 1
            except OSError:
                pass

    def stats(self) -> dict:
        return {"root": self.root, "records": len(self),
                "nbytes": self.nbytes(), "max_bytes": self.max_bytes,
                "puts": self.puts, "evictions": self.evictions,
                "corrupt_checkpoints": self.corrupt_checkpoints}
