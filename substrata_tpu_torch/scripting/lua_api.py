"""Substrata Lua scripting environment.

A copy of ``substrata_tpu/scripting/lua_api.py``: importing any module of the
reference package loads jax, so the port keeps its own.

The bindings layer between the from-scratch Lua interpreter
(:mod:`substrata_tpu_torch.scripting.lua`) and the engine — the equivalent of the
reference's shared/SubstrataLuaVM.cpp (API registration) +
shared/LuaScriptEvaluator.cpp (per-script state, handler/timer plumbing).

API surface (matching SubstrataLuaVM.cpp's registered globals/atoms):

  this_object                         -- world-object proxy table
  addEventListener(name, ob_uid, fn)  -- SubstrataLuaVM.cpp luaAddEventListener
  createTimer(fn, interval_s, repeating) -> handle   (max 4 per script)
  destroyTimer(handle)
  getObjectForUID(uid) -> object table
  createObject(params_table) -> object table         (host hook)
  showMessageToUser(msg)
  getCurrentTime() -> seconds
  parseJSON(str) -> table
  getSecret(name) -> string|nil                      (host hook)
  objectstorage.setItem(key, value) / getItem(key)   (per-user KV store)
  playAudio(), isPlayingAudio()                      (object methods)
  doHTTPGetRequestAsync / doHTTPPostRequestAsync     (queued for the host)
  IS_CLIENT / IS_SERVER

Object proxy tables expose the WorldObject fields the reference pushes in
pushWorldObjectTableOntoStack: uid, pos {x,y,z}, axis, angle, scale,
model_url, script, content, target_url, audio_source_url, audio_volume,
collidable, dynamic, sensor, mass, friction, restitution,
centre_of_mass_offset_os, plus getNumMaterials()/getMaterial(i).
Writes to writable fields propagate back to the host object and mark it
for re-send (the reference's __newindex meta-methods).

Scripts are detected by their ``--lua`` prefix (server/Server.cpp:551).
"""

from __future__ import annotations

import json
import math

import numpy as np

from substrata_tpu_torch.scripting.lua import (
    Interpreter, LuaError, LuaTable, lua_tostring_basic, truthy)

MAX_NUM_TIMERS = 4            # LuaScriptEvaluator::MAX_NUM_TIMERS
MAX_OB_EVENT_LISTENS = 32     # SubstrataLuaVM MAX_NUM_OB_EVENT_LISTENS
DEFAULT_BUDGET = 2_000_000


# Shared metatable for vector values: Vec3f/Vec3d results support + - *
# (scalar or componentwise) like the reference's Luau Vec3 classes
# (SubstrataLuaVM.cpp vector metamethods; used by the example corpus:
# `ob:moveTo(ob.pos + Vec3d(10,0,0), ...)`).
_VEC3_MT = LuaTable()


def _vec_xyz(v):
    if isinstance(v, LuaTable):
        return (float(v.get("x") or 0.0), float(v.get("y") or 0.0),
                float(v.get("z") or 0.0))
    f = float(v)
    return (f, f, f)


def _vec_binop(fn):
    def op(ip, args):
        a, b = _vec_xyz(args[0]), _vec_xyz(args[1])
        return vec3_table([fn(a[0], b[0]), fn(a[1], b[1]), fn(a[2], b[2])])
    return op


_VEC3_MT.set("__add", _vec_binop(lambda a, b: a + b))
_VEC3_MT.set("__sub", _vec_binop(lambda a, b: a - b))
_VEC3_MT.set("__mul", _vec_binop(lambda a, b: a * b))
_VEC3_MT.set("__div", _vec_binop(lambda a, b: a / b if b else math.inf))
_VEC3_MT.set("__unm", lambda ip, args: vec3_table(
    [-c for c in _vec_xyz(args[0])]))
_VEC3_MT.set("__tostring", lambda ip, args: "({}, {}, {})".format(
    *_vec_xyz(args[0])))


def vec3_table(v) -> LuaTable:
    t = LuaTable()
    a = np.asarray(v, np.float64).reshape(-1)
    t.set("x", float(a[0]))
    t.set("y", float(a[1]) if len(a) > 1 else 0.0)
    t.set("z", float(a[2]) if len(a) > 2 else 0.0)
    t.metatable = _VEC3_MT
    return t


def table_to_vec3(t):
    if isinstance(t, LuaTable):
        return np.array([float(t.get("x") or 0.0), float(t.get("y") or 0.0),
                         float(t.get("z") or 0.0)], np.float64)
    raise LuaError("expected a vector table {x=..., y=..., z=...}")


def python_to_lua(v):
    if v is None or isinstance(v, (bool, float, str)):
        return v
    if isinstance(v, int):
        return float(v)
    if isinstance(v, dict):
        t = LuaTable()
        for k, val in v.items():
            t.set(k if isinstance(k, str) else float(k), python_to_lua(val))
        return t
    if isinstance(v, (list, tuple)):
        t = LuaTable()
        for i, item in enumerate(v):
            t.set(float(i + 1), python_to_lua(item))
        return t
    if isinstance(v, np.ndarray):
        return vec3_table(v)
    return None


def lua_to_python(v):
    if isinstance(v, LuaTable):
        # Array-like -> list; else dict.
        n = int(v.length())
        if n and len(v.hash) == n:
            return [lua_to_python(v.get(float(i))) for i in range(1, n + 1)]
        return {k: lua_to_python(val) for k, val in v.hash.items()}
    return v


# Writable WorldObject fields (the reference's objectNewIndexMetaMethod
# whitelist) mapped host-attr -> converter.
_WRITABLE = {
    "model_url": str, "script": str, "content": str, "target_url": str,
    "audio_source_url": str, "audio_volume": float,
    "mass": float, "friction": float, "restitution": float,
    "collidable": bool, "dynamic": bool, "sensor": bool,
    "angle": float,
}
_VEC3_FIELDS = {"pos", "axis", "scale", "centre_of_mass_offset_os",
                "linear_velocity"}   # avatar jump pads write this


class LuaScriptEvaluator:
    """One running ``--lua`` script (LuaScriptEvaluator.cpp parity):
    owns the sandboxed interpreter, its timers (max 4) and its registered
    event handlers; converts engine events into Lua handler calls."""

    def __init__(self, vm, src: str, this_object=None, is_server=False,
                 budget: int = DEFAULT_BUDGET):
        self.vm = vm                      # the hosting ScriptVM
        self.this_object = this_object
        self.is_server = is_server
        self.hit_error = False
        self.error_messages: list[str] = []
        self.timer_handles: list[int] = []
        self.num_event_listens = 0
        self.http_requests: list[dict] = []   # queued async HTTP for the host
        self.interp = Interpreter(budget=budget)
        self._install_api()
        self.interp.run(src)
        self._register_global_handlers()

    # Event-handler functions defined at script top level implicitly listen
    # on the script's own object (LuaScriptEvaluator.cpp:93-160: "Event
    # handling functions defined in this way basically do implicit
    # addEventListener() calls").
    _GLOBAL_HANDLER_EVENTS = (
        ("onUserTouchedObject", "on_user_touched_object"),
        ("onUserUsedObject", "on_user_used_object"),
        ("onUserMovedNearToObject", "on_user_moved_near_to_object"),
        ("onUserMovedAwayFromObject", "on_user_moved_away_from_object"),
        ("onUserEnteredParcel", "on_user_entered_parcel"),
        ("onUserExitedParcel", "on_user_exited_parcel"),
        ("onUserEnteredVehicle", "on_user_entered_vehicle"),
        ("onUserExitedVehicle", "on_user_exited_vehicle"),
    )

    def _register_global_handlers(self):
        if self.this_object is None or self.vm is None:
            return
        uid = int(getattr(self.this_object, "uid", 0) or 0)
        h = self.vm.handlers_for(uid)
        for lua_name, attr in self._GLOBAL_HANDLER_EVENTS:
            fn = self.interp.globals.get(lua_name)
            if fn is not None:
                getattr(h, attr).add(
                    lambda *a, fn=fn: self.call_handler(fn, *a))

    # ------------------------------------------------------------------
    # Engine -> script event dispatch
    # ------------------------------------------------------------------

    def call_handler(self, fn, *args):
        """Call a Lua handler; on error, latch hit_error (the reference
        stops a faulted script from running further handlers)."""
        if self.hit_error:
            return
        try:
            self.interp.ops = 0           # fresh budget per handler call
            self.interp.call(fn, [self._to_lua_arg(a) for a in args])
        except LuaError as e:
            self.hit_error = True
            self.error_messages.append(str(e))

    def _to_lua_arg(self, a):
        if isinstance(a, LuaTable):
            return a
        if isinstance(a, (int, float)) and not isinstance(a, bool):
            # Event args are uids: deliver proxies like the reference's
            # pushAvatarTableOntoStack / pushWorldObjectTableOntoStack.
            return self.object_proxy_for_uid(int(a))
        return python_to_lua(a)

    # ------------------------------------------------------------------
    # Proxies
    # ------------------------------------------------------------------

    def object_proxy_for_uid(self, uid: int) -> LuaTable:
        ob = None
        if self.vm is not None and self.vm.world is not None:
            ob = self.vm.world.objects.get(uid)
        return self.make_object_proxy(ob, uid)

    def make_object_proxy(self, ob, uid=None) -> LuaTable:
        ev = self
        t = LuaTable()
        t.set("uid", float(uid if uid is not None else getattr(ob, "uid", 0)))

        def _index(ip, args):
            key = args[1]
            if ob is None:
                return None
            if key == "pos":
                return vec3_table(getattr(ob, "pos", (0, 0, 0)))
            if key in _VEC3_FIELDS:
                return vec3_table(getattr(ob, key, (0, 0, 0)))
            if key == "sensor":
                return bool(getattr(ob, "is_sensor", False))
            if key == "dynamic":
                d = getattr(ob, "is_dynamic", None)
                return bool(d() if callable(d) else getattr(ob, "dynamic", False))
            if key == "collidable":
                c = getattr(ob, "is_collidable", None)
                return bool(c() if callable(c) else getattr(ob, "collidable", True))
            if key == "getNumMaterials":
                return lambda ip2, a: float(len(getattr(ob, "materials", []) or []))
            if key == "getMaterial":
                def _get_mat(ip2, a):
                    # 0-based like the reference (the example corpus calls
                    # ob:getMaterial(0) for the first material).
                    mats = getattr(ob, "materials", []) or []
                    i = int(ip2.tonum(a[1]))
                    if 0 <= i < len(mats):
                        return ev.make_material_proxy(ob, mats[i])
                    return None
                return _get_mat
            if key == "moveTo":
                # ob:moveTo(pos, duration) — eased kinematic move (the
                # reference's moveTo path, Protocol ObjectMoveToTarget);
                # routed to the host's moveTo controller hook.
                def _move_to(ip2, a):
                    hook = (getattr(ev.vm.world, "move_to", None)
                            if ev.vm and ev.vm.world else None)
                    pos = table_to_vec3(a[1])
                    dur = float(ip2.tonum(a[2])) if len(a) > 2 else 1.0
                    if hook is not None:
                        hook(getattr(ob, "uid", 0), pos, dur)
                return _move_to
            if key == "rotateTo":
                # ob:rotateTo(axis, angle, duration)
                def _rotate_to(ip2, a):
                    hook = (getattr(ev.vm.world, "rotate_to", None)
                            if ev.vm and ev.vm.world else None)
                    axis = table_to_vec3(a[1])
                    angle = float(ip2.tonum(a[2])) if len(a) > 2 else 0.0
                    dur = float(ip2.tonum(a[3])) if len(a) > 3 else 1.0
                    if hook is not None:
                        hook(getattr(ob, "uid", 0), axis, angle, dur)
                return _rotate_to
            if key == "playAudio":
                def _play(ip2, a):
                    hook = getattr(ev.vm.world, "play_audio", None) if ev.vm and ev.vm.world else None
                    if hook is not None:
                        hook(getattr(ob, "uid", 0))
                return _play
            if key == "isPlayingAudio":
                def _isplay(ip2, a):
                    hook = getattr(ev.vm.world, "is_playing_audio", None) if ev.vm and ev.vm.world else None
                    return bool(hook(getattr(ob, "uid", 0))) if hook else False
                return _isplay
            if key == "startPlayingAnimation":
                def _anim(ip2, a):
                    hook = getattr(ev.vm.world, "start_playing_animation", None) if ev.vm and ev.vm.world else None
                    if hook is not None:
                        hook(getattr(ob, "uid", 0), *[lua_to_python(x) for x in a[1:]])
                return _anim
            if key == "getAnimationIndex":
                def _animidx(ip2, a):
                    hook = getattr(ev.vm.world, "get_animation_index", None) if ev.vm and ev.vm.world else None
                    return float(hook(getattr(ob, "uid", 0), lua_to_python(a[1]))) if hook else -1.0
                return _animidx
            if isinstance(key, str) and hasattr(ob, key):
                v = getattr(ob, key)
                # Engine entities (e.g. av.vehicle_inside -> a WorldObject)
                # come back as proxies, matching the reference's
                # pushWorldObjectTableOntoStack for nested references.
                if (v is not None and not isinstance(v, (bool, int, float,
                                                         str, bytes, dict,
                                                         list, tuple,
                                                         np.ndarray))
                        and hasattr(v, "uid")):
                    return ev.make_object_proxy(v)
                return python_to_lua(v)
            return None

        def _newindex(ip, args):
            key, value = args[1], args[2]
            if ob is None:
                raise LuaError("object not loaded")
            if key in _VEC3_FIELDS:
                setattr(ob, key, table_to_vec3(value).astype(
                    np.float64 if key == "pos" else np.float32))
            elif key == "sensor":
                ob.is_sensor = truthy(value)
            elif key in _WRITABLE:
                setattr(ob, key, _WRITABLE[key](
                    value if not isinstance(value, str) else value))
            else:
                raise LuaError(f"field '{lua_tostring_basic(key)}' is not writable")
            mark = getattr(ev.vm.world, "object_modified", None) if ev.vm and ev.vm.world else None
            if mark is not None:
                mark(ob)

        mt = LuaTable()
        mt.set("__index", _index)
        mt.set("__newindex", _newindex)
        t.metatable = mt
        return t

    def make_material_proxy(self, ob, mat) -> LuaTable:
        ev = self
        t = LuaTable()

        def _index(ip, args):
            key = args[1]
            if isinstance(key, str):
                v = (mat.get(key) if isinstance(mat, dict)
                     else getattr(mat, key, None))
                return python_to_lua(v)
            return None

        def _newindex(ip, args):
            key, value = args[1], args[2]
            pv = lua_to_python(value)
            if isinstance(mat, dict):
                mat[key] = pv
            else:
                setattr(mat, key, pv)
            mark = getattr(ev.vm.world, "object_modified", None) if ev.vm and ev.vm.world else None
            if mark is not None:
                mark(ob)

        mt = LuaTable()
        mt.set("__index", _index)
        mt.set("__newindex", _newindex)
        t.metatable = mt
        return t

    # ------------------------------------------------------------------
    # API installation
    # ------------------------------------------------------------------

    def _install_api(self):
        G = self.interp.globals
        vm = self.vm
        ev = self

        G.set("IS_CLIENT", not self.is_server)
        G.set("IS_SERVER", self.is_server)
        if self.this_object is not None:
            G.set("this_object", self.make_object_proxy(self.this_object))

        def _add_event_listener(ip, args):
            # addEventListener(event_name, ob_uid, handler)
            if len(args) < 3:
                raise LuaError("addEventListener() expects 3 args")
            event_name, ob_uid, fn = args[0], args[1], args[2]
            if ev.num_event_listens >= MAX_OB_EVENT_LISTENS:
                raise LuaError(
                    f"Script added too many event listeners, max is {MAX_OB_EVENT_LISTENS}")
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
                raise LuaError(f"Unknown event '{lua_tostring_basic(event_name)}'")
            if isinstance(ob_uid, LuaTable):
                ob_uid = ob_uid.get("uid")
            h = vm.handlers_for(int(ip.tonum(ob_uid)))
            getattr(h, attr).add(
                lambda *a, fn=fn: ev.call_handler(fn, *a))
            ev.num_event_listens += 1
        G.set("addEventListener", _add_event_listener)

        def _create_timer(ip, args):
            # createTimer(onTimerEvent, interval_time_s, repeating) -> handle
            if len(args) < 3:
                raise LuaError("createTimer() expects 3 args")
            fn, interval, repeating = args[0], args[1], args[2]
            live = [h for h in ev.timer_handles
                    if h in vm.timers._by_id]
            if len(live) >= MAX_NUM_TIMERS:
                raise LuaError(
                    f"createTimer(): Could not create timer, {MAX_NUM_TIMERS} timers already created.")
            interval = max(0.1, float(ip.tonum(interval)))  # reference floor
            tid = vm.timers.do_on_timer(
                lambda fn=fn: ev.call_handler(fn), interval, vm._clock(),
                repeating=truthy(repeating), period=interval)
            ev.timer_handles.append(tid)
            return float(tid)
        G.set("createTimer", _create_timer)

        def _destroy_timer(ip, args):
            vm.timers.destroy_timer(int(ip.tonum(args[0])))
        G.set("destroyTimer", _destroy_timer)

        def _get_object_for_uid(ip, args):
            return ev.object_proxy_for_uid(int(ip.tonum(args[0])))
        G.set("getObjectForUID", _get_object_for_uid)

        def _create_object(ip, args):
            params = lua_to_python(args[0]) if args else {}
            hook = getattr(vm.world, "create_object", None) if vm.world else None
            if hook is None:
                raise LuaError("createObject() is not available here")
            ob = hook(params)
            return ev.make_object_proxy(ob)
        G.set("createObject", _create_object)

        def _show_message(ip, args):
            vm.messages_to_user.append(ip.tostring(args[0] if args else None))
        G.set("showMessageToUser", _show_message)

        def _get_current_time(ip, args):
            return float(vm._clock())
        G.set("getCurrentTime", _get_current_time)

        def _parse_json(ip, args):
            try:
                return python_to_lua(json.loads(args[0]))
            except (json.JSONDecodeError, TypeError) as e:
                raise LuaError(f"parseJSON: {e}")
        G.set("parseJSON", _parse_json)

        def _get_secret(ip, args):
            hook = getattr(vm.world, "get_secret", None) if vm.world else None
            return hook(args[0]) if hook else None
        G.set("getSecret", _get_secret)

        storage = LuaTable()

        def _storage_set(ip, args):
            key = args[0] if not isinstance(args[0], LuaTable) else args[1]
            # supports both objectstorage.setItem(k, v) and :setItem(k, v)
            if isinstance(args[0], LuaTable):
                key, value = args[1], args[2] if len(args) > 2 else None
            else:
                key, value = args[0], args[1] if len(args) > 1 else None
            vm.object_storage[str(key)] = lua_to_python(value)
        storage.set("setItem", _storage_set)

        def _storage_get(ip, args):
            key = args[1] if isinstance(args[0], LuaTable) and len(args) > 1 else args[0]
            return python_to_lua(vm.object_storage.get(str(key)))
        storage.set("getItem", _storage_get)
        G.set("objectstorage", storage)
        # Reference also exposes objectStorageSetItem/GetItem free functions.
        G.set("objectStorageSetItem", _storage_set)
        G.set("objectStorageGetItem", _storage_get)

        def _http_get(ip, args):
            ev.http_requests.append({
                "method": "GET", "url": args[0],
                "additional_headers": lua_to_python(_opt(args, 1)),
                "onDone": _opt(args, 2), "onError": _opt(args, 3),
            })
        G.set("doHTTPGetRequestAsync", _http_get)

        def _http_post(ip, args):
            ev.http_requests.append({
                "method": "POST", "url": args[0],
                "content": _opt(args, 1), "content_type": _opt(args, 2),
                "additional_headers": lua_to_python(_opt(args, 3)),
                "onDone": _opt(args, 4), "onError": _opt(args, 5),
            })
        G.set("doHTTPPostRequestAsync", _http_post)

        # Vec3f / Vec3d constructors (SubstrataLuaVM.cpp Vec3 classes; the
        # engine stores doubles for positions — both map to the same
        # metatabled {x, y, z}).
        def _vec3(ip, args):
            return vec3_table([float(ip.tonum(a)) for a in args[:3]]
                              if args else [0.0, 0.0, 0.0])
        G.set("Vec3f", _vec3)
        G.set("Vec3d", _vec3)
        G.set("Vec2f", _vec3)   # z defaults 0
        G.set("Vec4f", _vec3)   # w dropped (scripts only read xyz)

        # Luau `buffer` library subset: the corpus uses
        # buffer.tostring(res.body_data) on HTTP responses.  Buffers are
        # Python bytes on the host side.
        buf_lib = LuaTable()

        def _buf_tostring(ip, args):
            b = args[0]
            if isinstance(b, (bytes, bytearray)):
                return bytes(b).decode("utf-8", "replace")
            return ip.tostring(b)
        buf_lib.set("tostring", _buf_tostring)

        def _buf_fromstring(ip, args):
            return str(args[0]).encode("utf-8")
        buf_lib.set("fromstring", _buf_fromstring)

        def _buf_len(ip, args):
            return float(len(args[0])) if isinstance(
                args[0], (bytes, bytearray)) else 0.0
        buf_lib.set("len", _buf_len)
        G.set("buffer", buf_lib)


def _opt(args, i):
    return args[i] if i < len(args) else None


def is_lua_script(src: str) -> bool:
    """The reference marks Lua scripts with a leading '--lua'
    (server/Server.cpp:551, WorkerThread.cpp:2100)."""
    return src.lstrip().startswith("--lua")
