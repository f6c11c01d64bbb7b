"""Geometry router: the multi-geometry product contract.

Copied from espflix_tpu/runtime/router.py; tests/test_torch_isolation.py
pins the copy to the original.

A Fleet's frame planes are fixed-shape [N, H, W] device arrays, so ONE
fleet decodes ONE geometry -- that is the performance contract that
lets every kernel run static shapes (the reference has no such limit
only because its buffers are per-stream, player.cpp:25-52, and it
serves exactly one stream).  The visible policy for a stream of
another geometry (SURVEY.md 5.3, VERDICT r2 #10):

  1. the lane PARKS with a LANE_GEOMETRY event and a structured
     (width, height) on the session (scheduler._gather_pictures);
  2. this router re-homes parked sessions to a fleet of their
     geometry, creating one lazily up to `max_fleets`, and replays
     the session into the new fleet's free lane;
  3. a geometry beyond the router's budget stays parked -- visible,
     evented, inspectable -- never silently dropped or letterboxed
     (letterboxing would silently change the signal timing the
     composite synthesizer generates).

`FleetRouter.route()` runs between ticks; it is O(parked lanes).
"""

from __future__ import annotations

from espflix_tpu_torch.runtime.player import PlayerSession, State
from espflix_tpu_torch.runtime.scheduler import Fleet


class FleetRouter:
    def __init__(self, main_fleet: Fleet, *, max_fleets: int = 4,
                 lanes_per_fleet: int = 8, fleet_kwargs: dict | None = None):
        self.main = main_fleet
        self.max_fleets = max_fleets
        self.lanes_per_fleet = lanes_per_fleet
        self.fleet_kwargs = fleet_kwargs or {}
        # (width, height) -> Fleet; the main fleet serves its own
        self.fleets: dict[tuple, Fleet] = {
            (main_fleet.width, main_fleet.height): main_fleet}
        self.rejected: list[tuple[int, tuple]] = []  # (lane, geometry)

    def route(self) -> int:
        """Re-home geometry-parked sessions; returns lanes moved."""
        moved = 0
        for src in list(self.fleets.values()):
            for i, s in enumerate(src.sessions):
                if s is None or s.state != State.STOPPED:
                    continue
                geom = getattr(s, "park_geometry", None)
                if geom is None:
                    continue
                dst = self._fleet_for(geom)
                if dst is None:
                    self.rejected.append((i, geom))
                    s.park_geometry = None
                    continue
                lane = self._free_lane(dst)
                if lane is None:
                    continue          # destination full: stay parked
                src.sessions[i] = None
                s.park_geometry = None
                dst.attach(lane, s)
                # revive: re-nav + resume playback at the saved spot
                if s.nav_index >= 0:
                    s.nav(s.nav_index)
                    s.play_pause()
                moved += 1
        return moved

    def _fleet_for(self, geom: tuple) -> Fleet | None:
        if geom in self.fleets:
            return self.fleets[geom]
        if len(self.fleets) >= self.max_fleets:
            return None
        w, h = geom
        f = Fleet(self.lanes_per_fleet, width=w, height=h,
                  **self.fleet_kwargs)
        self.fleets[geom] = f
        return f

    def _free_lane(self, fleet: Fleet) -> int | None:
        for i, s in enumerate(fleet.sessions):
            if s is None:
                return i
        return None

    def tick_all(self, **kw):
        """One tick on every geometry fleet (each is an independent
        batched decode); returns {geometry: TickResult}."""
        return {g: f.tick(**kw) for g, f in self.fleets.items()
                if any(s is not None for s in f.sessions)}
