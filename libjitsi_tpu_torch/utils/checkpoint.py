"""Shared array-state checkpointing (SURVEY §5 checkpoint/resume).

Dense components keep their whole mutable state in numpy arrays, so a
checkpoint is "copy the arrays, plus the constructor scalars".  This
mixin factors that once: subclasses list their arrays in `_SNAP_FIELDS`
and provide the two scalar hooks; `restore()` rebuilds via the
constructor and writes the arrays back in place (dtype-preserving).

Counterpart: `libjitsi_tpu/utils/checkpoint.py` (copied; host only).
"""

from __future__ import annotations


class ArraySnapshotMixin:
    _SNAP_FIELDS: tuple = ()

    def _snap_scalars(self) -> dict:
        """Non-array constructor state to carry in the snapshot."""
        return {}

    @classmethod
    def _restore_kwargs(cls, snap: dict) -> dict:
        """Constructor kwargs recovered from a snapshot."""
        return {}

    def snapshot(self) -> dict:
        snap = {f: getattr(self, f).copy() for f in self._SNAP_FIELDS}
        snap.update(self._snap_scalars())
        return snap

    @classmethod
    def restore(cls, snap: dict):
        inst = cls(**cls._restore_kwargs(snap))
        for f in cls._SNAP_FIELDS:
            getattr(inst, f)[:] = snap[f]
        return inst
