"""Global time synchronisation.

Parity with the reference's client time base (gui_client/WorldState.h:66-70 +
ClientThread.cpp:1267-1358): the server periodically sends TimeSyncMessage
with its global time; the client keeps an estimate of server time built from
the best (lowest-RTT) sync seen, correcting for half the round-trip, and
slews smoothly rather than stepping (skew correction).

A copy of ``substrata_tpu/net/timesync.py`` with the port's imports: importing
any module of the reference package loads jax, so the port keeps its own.
"""

from __future__ import annotations

import time


class GlobalTimeSync:
    def __init__(self, clock=time.monotonic):
        self._clock = clock
        self._offset = 0.0          # server_time - local_time
        self._have_sync = False
        self._best_rtt = float("inf")
        self.last_rtt = 0.0

    def local_time(self) -> float:
        return self._clock()

    def global_time(self) -> float:
        return self._clock() + self._offset

    def update_with_global_time_received(self, server_time: float,
                                         rtt: float | None = None):
        """Apply a TimeSyncMessage.  With a known RTT the one-way delay is
        assumed rtt/2; the best (lowest-RTT) measurement wins
        (WorldState 'best TimeSync selection')."""
        now = self._clock()
        one_way = (rtt / 2.0) if rtt is not None else 0.0
        offset = (server_time + one_way) - now
        use_rtt = rtt if rtt is not None else 1.0
        if not self._have_sync:
            self._offset = offset
            self._best_rtt = use_rtt
            self._have_sync = True
        elif use_rtt <= self._best_rtt * 1.2:
            # Slew toward the better estimate (skew correction, no stepping).
            self._offset += 0.5 * (offset - self._offset)
            self._best_rtt = min(self._best_rtt, use_rtt)
        if rtt is not None:
            self.last_rtt = rtt

    @property
    def synced(self) -> bool:
        return self._have_sync
