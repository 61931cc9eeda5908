"""Event handlers, timers and the user-script VM.

A copy of ``substrata_tpu/scripting/events.py``: importing any module of the
reference package loads jax, so the port keeps its own.

Parity surface:
- shared/ObjectEventHandlers.*: per-object handler lists for
  onUserTouchedObject, onUserUsedObject, onUserMovedNearToObject,
  onUserMovedAwayFromObject, onUserEnteredParcel, onUserExitedParcel,
  onTimerEvent.
- shared/ScriptTimerQueue.*: ordered timer queue with ids + cancellation
  (doOnTimer / destroyTimer Lua API), polled from the main tick
  (client tick step 1, GUIClient.cpp:5926-5975; server Server.cpp:636-668).
- shared/SubstrataLuaVM + LuaScriptEvaluator: the reference embeds Luau
  with a sandboxed environment and per-script evaluators that register the
  handlers above; here user scripts run in a restricted Python environment
  with the same event/timer API, on both client and server
  (SubstrataLuaVM.h:74-88 runs on both sides).
"""

from __future__ import annotations

import heapq
import itertools
import math
import time
from dataclasses import dataclass, field


class HandlerList:
    def __init__(self):
        self.handlers = []

    def add(self, fn):
        self.handlers.append(fn)

    def remove(self, fn):
        if fn in self.handlers:
            self.handlers.remove(fn)

    @property
    def non_empty(self):
        return bool(self.handlers)

    def fire(self, *args, **kw):
        for fn in list(self.handlers):
            fn(*args, **kw)


class ObjectEventHandlers:
    """shared/ObjectEventHandlers.h parity."""

    def __init__(self):
        self.on_user_touched_object = HandlerList()
        self.on_user_used_object = HandlerList()
        self.on_user_moved_near_to_object = HandlerList()
        self.on_user_moved_away_from_object = HandlerList()
        self.on_user_entered_parcel = HandlerList()
        self.on_user_exited_parcel = HandlerList()
        self.on_user_entered_vehicle = HandlerList()
        self.on_user_exited_vehicle = HandlerList()


@dataclass(order=True)
class _Timer:
    fire_time: float
    timer_id: int = field(compare=False)
    fn: object = field(compare=False)
    repeating: bool = field(compare=False, default=False)
    period: float = field(compare=False, default=0.0)
    cancelled: bool = field(compare=False, default=False)


class ScriptTimerQueue:
    """shared/ScriptTimerQueue parity: doOnTimer(fn, delay, repeating) ->
    timer id; destroyTimer(id); update(now) fires due timers."""

    MAX_TIMERS_PER_SCRIPT = 16  # reference limits concurrent timers

    def __init__(self):
        self._heap: list[_Timer] = []
        self._by_id: dict[int, _Timer] = {}
        self._next_id = itertools.count(1)

    def do_on_timer(self, fn, delay: float, now: float,
                    repeating: bool = False, period: float | None = None) -> int:
        tid = next(self._next_id)
        t = _Timer(fire_time=now + delay, timer_id=tid, fn=fn,
                   repeating=repeating, period=period if period is not None else delay)
        heapq.heappush(self._heap, t)
        self._by_id[tid] = t
        return tid

    def destroy_timer(self, timer_id: int):
        t = self._by_id.pop(timer_id, None)
        if t is not None:
            t.cancelled = True

    def update(self, now: float, max_fires: int = 64):
        fired = 0
        while self._heap and self._heap[0].fire_time <= now and fired < max_fires:
            t = heapq.heappop(self._heap)
            if t.cancelled:
                continue
            fired += 1
            t.fn()
            if t.repeating and not t.cancelled:
                t.fire_time = now + t.period
                heapq.heappush(self._heap, t)
            else:
                self._by_id.pop(t.timer_id, None)
        return fired

    def __len__(self):
        return len(self._by_id)


class ScriptExecutionError(Exception):
    pass


class ScriptVM:
    """Sandboxed user-script host (SubstrataLuaVM equivalent).

    The reference embeds Luau; this engine hosts user event scripts in a
    restricted Python dialect exposing the same API surface the Luau
    environment provides (SubstrataLuaVM.h:21-67 diagram):

        addEventListener("onUserTouchedObject", obj, function)
        doOnTimer(function, delay_s, repeating) -> id / destroyTimer(id)
        getObjectForUID(uid), showMessageToUser(msg), createTimedText(...)

    Scripts get NO builtins beyond a whitelisted set — no imports, no IO.
    """

    _SAFE_BUILTINS = {
        "abs": abs, "min": min, "max": max, "len": len, "range": range,
        "float": float, "int": int, "str": str, "bool": bool, "round": round,
        "enumerate": enumerate, "zip": zip, "print": print, "sum": sum,
    }

    def __init__(self, world_interface=None, clock=time.monotonic,
                 is_server: bool = False):
        self.world = world_interface
        self.timers = ScriptTimerQueue()
        self.handlers_by_ob: dict[int, ObjectEventHandlers] = {}
        self._clock = clock
        self.is_server = is_server
        self.messages_to_user: list[str] = []
        self.object_storage: dict[str, object] = {}   # objectstorage KV
        self.lua_evaluators: list[object] = []

    def handlers_for(self, ob_uid: int) -> ObjectEventHandlers:
        if ob_uid not in self.handlers_by_ob:
            self.handlers_by_ob[ob_uid] = ObjectEventHandlers()
        return self.handlers_by_ob[ob_uid]

    def _make_env(self, this_object):
        vm = self

        def add_event_listener(event_name: str, ob_uid, fn):
            h = vm.handlers_for(int(ob_uid))
            attr = {
                "onUserTouchedObject": "on_user_touched_object",
                "onUserUsedObject": "on_user_used_object",
                "onUserMovedNearToObject": "on_user_moved_near_to_object",
                "onUserMovedAwayFromObject": "on_user_moved_away_from_object",
                "onUserEnteredParcel": "on_user_entered_parcel",
                "onUserExitedParcel": "on_user_exited_parcel",
                "onUserEnteredVehicle": "on_user_entered_vehicle",
                "onUserExitedVehicle": "on_user_exited_vehicle",
            }.get(event_name)
            if attr is None:
                raise ScriptExecutionError(f"unknown event {event_name}")
            getattr(h, attr).add(fn)

        env = {
            "__builtins__": dict(self._SAFE_BUILTINS),
            "math": math,
            "this_object": this_object,
            "addEventListener": add_event_listener,
            "doOnTimer": lambda fn, delay, repeating=False: vm.timers.do_on_timer(
                fn, delay, vm._clock(), repeating),
            "destroyTimer": vm.timers.destroy_timer,
            "getObjectForUID": (lambda uid: vm.world.objects.get(uid)
                                if vm.world is not None else None),
            "showMessageToUser": vm.messages_to_user.append,
        }
        return env

    def run_script(self, src: str, this_object=None):
        """Execute a user script (its top level registers handlers/timers —
        LuaScriptEvaluator construction parity).

        Scripts beginning with ``--lua`` run in the from-scratch Lua
        interpreter with the Substrata API (the reference's Luau path,
        detected the same way — server/Server.cpp:551); anything else uses
        the legacy restricted-Python dialect.
        """
        from substrata_tpu_torch.scripting import lua_api
        if lua_api.is_lua_script(src):
            from substrata_tpu_torch.scripting.lua import LuaError
            try:
                ev = lua_api.LuaScriptEvaluator(
                    self, src, this_object=this_object,
                    is_server=self.is_server)
            except LuaError as e:
                raise ScriptExecutionError(str(e)) from e
            self.lua_evaluators.append(ev)
            return ev
        env = self._make_env(this_object)
        try:
            code = compile(src, "<user-script>", "exec")
            exec(code, env)
        except ScriptExecutionError:
            raise
        except Exception as e:  # surface script errors like Lua error traps
            raise ScriptExecutionError(str(e)) from e
        return env

    # Event dispatch (called by the client/server tick).
    def fire_user_touched_object(self, ob_uid: int, avatar_uid: int):
        h = self.handlers_by_ob.get(ob_uid)
        if h and h.on_user_touched_object.non_empty:
            h.on_user_touched_object.fire(avatar_uid, ob_uid)

    def fire_user_used_object(self, ob_uid: int, avatar_uid: int):
        h = self.handlers_by_ob.get(ob_uid)
        if h and h.on_user_used_object.non_empty:
            h.on_user_used_object.fire(avatar_uid, ob_uid)

    def fire_user_moved_near(self, ob_uid: int, avatar_uid: int):
        h = self.handlers_by_ob.get(ob_uid)
        if h and h.on_user_moved_near_to_object.non_empty:
            h.on_user_moved_near_to_object.fire(avatar_uid, ob_uid)

    def fire_user_moved_away(self, ob_uid: int, avatar_uid: int):
        h = self.handlers_by_ob.get(ob_uid)
        if h and h.on_user_moved_away_from_object.non_empty:
            h.on_user_moved_away_from_object.fire(avatar_uid, ob_uid)

    def update(self, now: float | None = None):
        """Poll timers (tick step 1 parity)."""
        return self.timers.update(self._clock() if now is None else now)
