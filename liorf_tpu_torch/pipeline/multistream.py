"""Multi-session serving: N independent SLAM streams advanced as ONE batch.

One session leaves the card mostly idle: its frame is thousands of small
eager launches, so the host, not the device, sets the pace. For a fleet or
a server the scaling axis is therefore the batch: ``MultiStreamPipeline``
runs N sessions through ``resident_step_lanes`` with a leading stream (lane)
axis on the whole device state, so deskew, registration, fusion, the
keyframe graph and loop closure run batched for every stream, one tick per
scan round, and the same launches serve N sessions.

Semantics per stream are the single-stream ``ResidentPipeline``'s. The JAX
package vmaps its compiled step, and ``lax.cond`` becomes a select that runs
both branches; here the host reads each branch condition once per tick as a
[B] vector, runs a branch when any lane takes it, batched over all lanes,
and masks every ring write by the lane's own flag (the same values). Both
k-NN kernels take the lane axis: one K1 launch per batched GN iteration,
one K2 launch per batched ICP iteration.

Constraints (by design of the batched mode):

* All streams share one ``SlamConfig``.
* Streams advance in lock-step ticks: every stream processes exactly one
  scan per ``step()``; the mapping throttle must stay disabled.

Capacity: device-ring growth is ONE coordinated doubling of the stacked
state — when any lane's host-side ring bound nears capacity, the whole
``[N, ...]`` state is padded along the ring axis before the next tick.
The JAX package also warms the post-growth executable in a background
thread (``_maybe_precompile_growth``); eager PyTorch compiles nothing when a
ring grows, so that thread is not ported (ROADMAP rule R7).
"""

from __future__ import annotations

import logging
from collections import Counter

import numpy as np
import torch

from ..core.device import resolve_device
from .resident import (
    ResidentPipeline,
    _grown_state,
    lane_state,
    resident_step_packed_lanes,
    stack_states,
)


class _BatchedMarker:
    """Stands in for a stream shell's state while the real state lives
    stacked in the coordinator."""

    def __bool__(self):  # pragma: no cover - defensive
        return True


_BATCHED = _BatchedMarker()


class _StreamShell(ResidentPipeline):
    """Per-stream host shell: does all host-side work (scan packing, IMU
    windows, GPS gating, loop cadence) but hands its frame buffer to the
    coordinator instead of stepping."""

    def __init__(self, cfg, coord, lane: int):
        super().__init__(cfg, device=coord.device)
        self._coord = coord
        self._lane = lane

    def _dispatch_step(self, buf: np.ndarray, S: int, W: int):
        self._coord._stash(self._lane, buf)

    def _ring_bounds(self) -> dict:
        """Exact host-side upper bounds on this lane's device ring counts
        (same accounting as ResidentPipeline._maybe_grow_rings)."""
        return dict(
            traj=self.frame_idx,
            kf=self._kf_known[0] + (self.frame_idx - self._kf_known[1]),
            gps=self._g_known[0] + (self._gps_feeds - self._g_known[1]),
            loop=self._l_known[0] + (self._loop_flags - self._l_known[1]),
            imu=self._imu_feeds,
        )

    def _maybe_grow_rings(self):
        # growth is coordinated: report which rings near capacity; the
        # coordinator grows the STACKED state once for all lanes before the
        # next tick (the batched state is one shape)
        caps = self._coord._ring_shapes
        b = self._ring_bounds()
        m = 2
        req = self._coord._grow_request
        for name in ("traj", "kf", "gps", "loop"):
            req[name] = req[name] or b[name] >= caps[name] - m
        req["imu"] = req["imu"] or b["imu"] >= caps["imu"] - (m + 2) * self.cfg.imu_window

    def block(self):
        self._coord.block()


class MultiStreamPipeline:
    """Coordinator for N lock-step SLAM sessions on one card.

    Usage::

        pipe = MultiStreamPipeline(cfg, n_streams=8)
        pipe.push_imu(lane, sample)           # per-stream ingest
        pipe.step([scan_0, ..., scan_{N-1}])  # one scan per stream
        pipe.finish()
        times, poses = pipe.stream(0).trajectory_arrays()

    ``device=None`` means ``cuda`` and raises when there is none.
    """

    def __init__(self, cfg, n_streams: int, device=None):
        if n_streams < 1:
            raise ValueError("n_streams must be >= 1")
        if cfg.mappingProcessInterval > 0.0:
            raise ValueError(
                "batched streams advance in lock-step; set "
                "mappingProcessInterval=0 (the host feed controls cadence)"
            )
        self.device = resolve_device(device, "MultiStreamPipeline")
        self.cfg = cfg
        self.n = n_streams
        self.streams = [_StreamShell(cfg, self, i) for i in range(n_streams)]
        self.params = self.streams[0].params
        self.state = None  # stacked [N, ...] once every lane bootstrapped
        self._bufs: list = [None] * n_streams
        self._ring_shapes = dict(
            traj=cfg.traj_capacity, kf=cfg.kf_capacity, gps=cfg.gps_capacity,
            loop=cfg.loop_capacity, imu=cfg.imu_rate_capacity,
        )
        self._grow_request = dict.fromkeys(self._ring_shapes, False)
        self.growth_events = 0
        self.ticks = 0  # batched steps (bootstrap excluded)
        # host reads by kind, per tick ("read:is_kf", "read:loop_gate",
        # "read:full"), batched ICP runs ("icp_runs") and the lanes they
        # served ("icp_lanes"); the batched scan matcher and ICP add one
        # "all done" read per iteration
        self.tally: Counter = Counter()
        self._gn_iters = torch.zeros((n_streams,), dtype=torch.int64, device=self.device)
        # batched GN iterations (the longest lane's, tick by tick): one K1
        # launch each
        self._gn_batched = torch.zeros((), dtype=torch.int64, device=self.device)
        self.last_gn_iters = None  # [N] GN iterations of the last tick (device)

    # -- ingest --------------------------------------------------------
    def stream(self, lane: int) -> _StreamShell:
        return self.streams[lane]

    def push_imu(self, lane: int, sample):
        self.streams[lane].push_imu(sample)

    def push_gps(self, lane: int, fix):
        self.streams[lane].push_gps(fix)

    def host_reads(self) -> dict[str, int]:
        """Device->host reads of the batched step, by kind (one per tick
        and kind, whatever the lane count)."""
        return {k[5:]: v for k, v in sorted(self.tally.items()) if k.startswith("read:")}

    def gn_iters_per_lane(self) -> list[int]:
        """GN iterations each lane's scan matcher ran (one read)."""
        return self._gn_iters.tolist()

    def gn_iters_batched(self) -> int:
        """Iterations of the batched GN loop over the session, one K1 launch
        each: per tick, its longest lane's count (one read)."""
        return int(self._gn_batched)

    # -- per-tick ------------------------------------------------------
    def _stash(self, lane: int, buf: np.ndarray):
        self._bufs[lane] = buf

    def step(self, scans):
        """Process exactly one scan per stream (lock-step tick)."""
        if len(scans) != self.n:
            raise ValueError(f"expected {self.n} scans, got {len(scans)}")
        for shell, scan in zip(self.streams, scans):
            shell.process_scan(scan)
        if self.state is None:
            # bootstrap tick: every shell built its own single-stream state
            if any(s.state is None or s.state is _BATCHED for s in self.streams):
                raise RuntimeError("a stream failed to bootstrap")
            self.state = stack_states([s.state for s in self.streams])
            for s in self.streams:
                s.state = _BATCHED
            return
        if any(b is None for b in self._bufs):
            missing = [i for i, b in enumerate(self._bufs) if b is None]
            self._bufs = [None] * self.n
            raise RuntimeError(
                f"streams {missing} produced no frame this tick (mapping "
                "throttle or empty scan?) — batched mode is lock-step"
            )
        if any(self._grow_request.values()):
            self._grow_stacked()
        S, W = self.cfg.raw_cap, self.cfg.imu_window
        bufs = np.stack(self._bufs)  # one [N, L] upload for the tick
        self._bufs = [None] * self.n
        hosts = [s._host for s in self.streams]
        self.state, hosts, gn_iters = resident_step_packed_lanes(
            self.state, hosts, bufs, self.params, S, W, self.tally
        )
        for s, h in zip(self.streams, hosts):
            s._host = h
        self._gn_iters += gn_iters
        self._gn_batched += gn_iters.max()
        self.last_gn_iters = gn_iters
        self.ticks += 1

    # -- coordinated capacity growth -----------------------------------
    def _grow_stacked(self):
        """ONE capacity doubling of the whole stacked state: every lane's
        flagged rings grow together (the batched state is a single shape)."""
        req = self._grow_request
        flags = (req["kf"], req["traj"], req["gps"], req["loop"], req["imu"])
        self.state = torch.func.vmap(lambda st: _grown_state(st, *flags))(self.state)
        for name, grown in zip(("kf", "traj", "gps", "loop", "imu"), flags):
            if grown:
                self._ring_shapes[name] *= 2
        self._grow_request = dict.fromkeys(self._ring_shapes, False)
        self.growth_events += 1
        logging.getLogger("liorf_tpu_torch").warning(
            "multistream device rings grown (kf=%s traj=%s gps=%s loop=%s "
            "imu=%s) for all %d lanes -> %s. Set capacities in SlamConfig "
            "upfront to avoid the copy.", *flags, self.n, dict(self._ring_shapes),
        )

    # -- end-of-run ----------------------------------------------------
    def block(self):
        """Wait for all enqueued device work (timing barrier); reads
        nothing."""
        if self.state is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def finish(self):
        """Barrier, then hand each stream its own state slice so the
        single-stream readbacks (trajectory_arrays / imu_rate_trajectory /
        sync_store / save_checkpoint) work per stream."""
        self.block()
        if self.state is None:
            return
        for i, s in enumerate(self.streams):
            s.state = lane_state(self.state, i)
            s._gn_iters = self._gn_iters[i].clone()
            s._synced = False
