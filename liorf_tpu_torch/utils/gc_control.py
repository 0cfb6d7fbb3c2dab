"""Low-latency GC control for the streaming hot loop.

A full (gen-2) CPython garbage collection walks every tracked object in
the process; with a large long-lived object graph resident (torch's
modules and caches, the pipeline's state) that is a stop-the-world pause
that can land mid-run in the 10 Hz streaming loop (the JAX package
measured a 395 ms frame among 1.2 ms frames). The reference never hits this
class of pause because it is C++ (no tracing GC); a Python host shell must
manage it.

The fix is the standard low-latency recipe rather than turning GC off:

- ``gc.collect()`` once, at a moment the caller chooses (post-warmup,
  when the long-lived object population is stable);
- ``gc.freeze()`` — move everything currently alive into the permanent
  generation, so future collections never traverse it. This also resets
  the ``long_lived_total`` heuristic that schedules full collections;
- raise the gen-2 threshold so the young generations (cheap, ~µs) keep
  collecting per-frame garbage while full collections effectively never
  trigger inside a session.

No counterpart in the reference — the pause itself is an artifact of the
Python host shell. A copy of ``liorf_tpu/utils/gc_control.py``.
"""

from __future__ import annotations

import gc

_GEN2_QUIET_THRESHOLD = 1_000_000

_saved_threshold: tuple | None = None


def quiesce() -> None:
    """Collect once, freeze survivors, and quiet gen-2 auto-collections.

    Idempotent and safe to call repeatedly (e.g. again after a ring growth
    created a new batch of long-lived objects)."""
    global _saved_threshold
    if not gc.isenabled():  # caller already manages GC wholesale
        return
    gc.collect()
    gc.freeze()
    t0, t1, t2 = gc.get_threshold()
    if t2 < _GEN2_QUIET_THRESHOLD:
        if _saved_threshold is None:
            _saved_threshold = (t0, t1, t2)
        gc.set_threshold(t0, t1, _GEN2_QUIET_THRESHOLD)


def restore() -> None:
    """Undo ``quiesce``: unfreeze and restore the original thresholds.

    For long-running hosts that interleave SLAM sessions with other work
    (and for test isolation)."""
    global _saved_threshold
    gc.unfreeze()
    if _saved_threshold is not None:
        gc.set_threshold(*_saved_threshold)
        _saved_threshold = None
