"""MCP (Model Context Protocol) endpoint: JSON-RPC 2.0 over POST /mcp.

Parity with webserver/MCPHandlers.cpp: API-key ("Authorization: Bearer")
authenticated tool access to the world state — read tools (list_worlds,
get_world_info, list_avatars, list_objects_near, get_object) and mutation
tools (create_object, edit_object, delete_object, create_cube,
create_sphere, create_voxel_object) that act AS the key's user and are
subject to the ordinary object-permission rules (MCPHandlers.cpp:285-290).
Per-user rate limiting (MCPHandlers.cpp:108-113) stops the endpoint being
a guessing oracle.

A copy of ``substrata_tpu/server_side/mcp.py`` with the port's imports: importing
any module of the reference package loads jax, so the port keeps its own.
"""

from __future__ import annotations

import json
import time

import numpy as np

from substrata_tpu_torch.shared.records import RateLimiter
from substrata_tpu_torch.shared.world_object import ObjectType, WorldObject
from substrata_tpu_torch.shared.voxel import compress_voxel_group

JSONRPC_PARSE_ERROR = -32700
JSONRPC_INVALID_REQUEST = -32600
JSONRPC_METHOD_NOT_FOUND = -32601
JSONRPC_INVALID_PARAMS = -32602
JSONRPC_INTERNAL_ERROR = -32603
JSONRPC_AUTH_ERROR = -32001

# MCPHandlers.cpp rate limits: generous for authed users, tight for
# failed-auth attempts.
AUTHED_RATE = (120, 60.0)       # 120 requests / minute per user
UNAUTHED_RATE = (10, 60.0)


def _tool(name, description, properties, required):
    return {"name": name, "description": description,
            "inputSchema": {"type": "object", "properties": properties,
                            "required": required}}


_NUM = {"type": "number"}
_STR = {"type": "string"}
_WORLD = {"world_name": {"type": "string",
                         "description": "empty string = main world"}}

TOOLS = [
    _tool("list_worlds", "List the worlds on this server.", {}, []),
    _tool("get_world_info", "Object/avatar/parcel counts for a world.",
          dict(_WORLD), []),
    _tool("list_avatars", "List avatars currently in a world.",
          dict(_WORLD), []),
    _tool("list_objects_near",
          "List objects within radius of a point (nearest first).",
          dict(_WORLD, x=_NUM, y=_NUM, z=_NUM, radius=_NUM,
               max_results={"type": "integer"}),
          ["x", "y", "z"]),
    _tool("get_object", "Fetch one object by UID.",
          dict(_WORLD, uid={"type": "integer"}), ["uid"]),
    _tool("create_object", "Create a model object.",
          dict(_WORLD, model_url=_STR, x=_NUM, y=_NUM, z=_NUM,
               scale=_NUM, content=_STR), ["x", "y", "z"]),
    _tool("edit_object", "Edit fields of an object you may write.",
          dict(_WORLD, uid={"type": "integer"}, x=_NUM, y=_NUM, z=_NUM,
               scale=_NUM, content=_STR, model_url=_STR), ["uid"]),
    _tool("delete_object", "Delete an object you may write.",
          dict(_WORLD, uid={"type": "integer"}), ["uid"]),
    _tool("create_cube", "Create a unit cube (voxel) at a position.",
          dict(_WORLD, x=_NUM, y=_NUM, z=_NUM, scale=_NUM), ["x", "y", "z"]),
    _tool("create_sphere", "Create a sphere primitive at a position.",
          dict(_WORLD, x=_NUM, y=_NUM, z=_NUM, scale=_NUM), ["x", "y", "z"]),
    _tool("create_voxel_object",
          "Create a voxel object from a list of [x,y,z,material] entries.",
          dict(_WORLD, x=_NUM, y=_NUM, z=_NUM,
               voxels={"type": "array",
                       "items": {"type": "array",
                                 "items": {"type": "integer"}}}),
          ["x", "y", "z", "voxels"]),
]


class MCPError(Exception):
    def __init__(self, code, message):
        super().__init__(message)
        self.code = code


class MCPEndpoint:
    """Stateless-ish dispatcher; one per webserver."""

    def __init__(self, worlds_state, accounts):
        self.worlds_state = worlds_state
        self.accounts = accounts
        self._user_limiters: dict[int, RateLimiter] = {}
        self._unauthed_limiter = RateLimiter(*UNAUTHED_RATE)

    # ---- public entry: returns (http_status, response_json_str) ----
    def handle(self, body: bytes, auth_header: str | None):
        try:
            root = json.loads(body.decode("utf-8"))
        except Exception:
            return 200, self._error(None, JSONRPC_PARSE_ERROR, "parse error")
        if not isinstance(root, dict):
            return 200, self._error(None, JSONRPC_INVALID_REQUEST,
                                    "request must be an object")
        rid = root.get("id")
        user = self._auth(auth_header)
        if user is None:
            if not self._unauthed_limiter.check_add_event():
                return 429, self._error(rid, JSONRPC_AUTH_ERROR,
                                        "rate limited")
            return 401, self._error(rid, JSONRPC_AUTH_ERROR,
                                    "missing or invalid API key")
        lim = self._user_limiters.setdefault(user.user_id,
                                             RateLimiter(*AUTHED_RATE))
        if not lim.check_add_event():
            return 429, self._error(rid, JSONRPC_AUTH_ERROR, "rate limited")

        method = root.get("method")
        if not isinstance(method, str):
            return 200, self._error(rid, JSONRPC_INVALID_REQUEST,
                                    "missing 'method'")
        params = root.get("params") or {}
        try:
            if method == "initialize":
                result = {"protocolVersion": "2024-11-05",
                          "capabilities": {"tools": {}},
                          "serverInfo": {"name": "substrata-tpu",
                                         "version": "1.0"}}
            elif method == "ping":
                result = {}
            elif method == "notifications/initialized":
                return 202, ""
            elif method == "tools/list":
                result = {"tools": TOOLS}
            elif method == "tools/call":
                result = self._tools_call(params, user)
            else:
                return 200, self._error(rid, JSONRPC_METHOD_NOT_FOUND,
                                        f"unknown method {method!r}")
        except MCPError as e:
            return 200, self._error(rid, e.code, str(e))
        except Exception as e:  # tool-level crash -> internal error
            return 200, self._error(rid, JSONRPC_INTERNAL_ERROR, str(e))
        return 200, json.dumps({"jsonrpc": "2.0", "id": rid,
                                "result": result})

    def _auth(self, auth_header):
        if not auth_header:
            return None
        key = auth_header.removeprefix("Bearer ").strip()
        return self.accounts.user_for_api_key(key)

    @staticmethod
    def _error(rid, code, message):
        return json.dumps({"jsonrpc": "2.0", "id": rid,
                           "error": {"code": code, "message": message}})

    # ---- tools ----
    def _tools_call(self, params, user):
        name = params.get("name")
        if not isinstance(name, str):
            raise MCPError(JSONRPC_INVALID_PARAMS,
                           "tools/call is missing 'name'")
        args = params.get("arguments") or {}
        fn = getattr(self, "_tool_" + name, None)
        if fn is None:
            raise MCPError(JSONRPC_INVALID_PARAMS, f"unknown tool {name!r}")
        try:
            out = fn(args, user)
        except MCPError:
            raise
        except PermissionError as e:
            return {"content": [{"type": "text", "text": str(e)}],
                    "isError": True}
        except Exception as e:
            # Tool-level errors return an error RESULT, not a protocol error
            # (MCPHandlers.cpp:1127).
            return {"content": [{"type": "text", "text": str(e)}],
                    "isError": True}
        return {"content": [{"type": "text",
                             "text": json.dumps(out)}]}

    def _world(self, args):
        name = args.get("world_name", "")
        with self.worlds_state.lock:
            if name not in self.worlds_state.worlds:
                raise MCPError(JSONRPC_INVALID_PARAMS,
                               f"no world named {name!r}")
            return self.worlds_state.worlds[name]

    def _tool_list_worlds(self, args, user):
        with self.worlds_state.lock:
            return [{"name": w.name, "num_objects": len(w.objects),
                     "num_avatars": len(w.avatars)}
                    for w in self.worlds_state.worlds.values()]

    def _tool_get_world_info(self, args, user):
        w = self._world(args)
        with self.worlds_state.lock:
            return {"name": w.name, "num_objects": len(w.objects),
                    "num_avatars": len(w.avatars),
                    "num_parcels": len(w.parcels)}

    def _tool_list_avatars(self, args, user):
        w = self._world(args)
        with self.worlds_state.lock:
            return [{"uid": a.uid, "name": a.name,
                     "pos": list(map(float, a.pos))}
                    for a in w.avatars.values()]

    def _tool_list_objects_near(self, args, user):
        w = self._world(args)
        p = np.array([args["x"], args["y"], args["z"]], np.float64)
        radius = float(args.get("radius", 50.0))
        max_results = int(args.get("max_results", 50))
        with self.worlds_state.lock:
            near = [(float(np.linalg.norm(np.asarray(ob.pos) - p)), ob)
                    for ob in w.objects.values()]
        near = [(d, ob) for d, ob in near if d <= radius]
        near.sort(key=lambda t: t[0])
        return [self._ob_json(ob, dist=d) for d, ob in near[:max_results]]

    def _tool_get_object(self, args, user):
        w = self._world(args)
        with self.worlds_state.lock:
            ob = w.objects.get(int(args["uid"]))
        if ob is None:
            raise ValueError(f"no object {args['uid']}")
        return self._ob_json(ob, full=True)

    @staticmethod
    def _ob_json(ob: WorldObject, dist=None, full=False):
        out = {"uid": ob.uid, "type": int(ob.object_type),
               "model_url": ob.model_url,
               "pos": list(map(float, ob.pos)),
               "scale": list(map(float, ob.scale)),
               "creator_id": ob.creator_id}
        if dist is not None:
            out["distance"] = round(dist, 3)
        if full:
            out.update(content=ob.content, script=ob.script,
                       mass=ob.mass, friction=ob.friction,
                       restitution=ob.restitution, flags=ob.flags)
        return out

    # -- mutation tools: act as the API user (MCPHandlers.cpp:285-290) --
    def _can_write(self, user, ob, world) -> bool:
        """ObjectPermissions semantics: creator, god user, or parcel
        write perms at the object's position (ObjectPermissions.cpp:65-118,
        WorkerThread.cpp:2069)."""
        if self.accounts.is_god_user(user.user_id):
            return True
        if ob.creator_id == user.user_id:
            return True
        for p in world.parcels.values():
            if p.contains(ob.pos) and p.user_has_write_perms(user.user_id):
                return True
        return False

    def _insert_object(self, w, ob):
        with self.worlds_state.lock:
            ob.uid = self.worlds_state.next_uid
            self.worlds_state.next_uid += 1
            w.objects[ob.uid] = ob
            w.dirty_objects.add(ob.uid)
            w.db_dirty_objects.add(ob.uid)
        return {"uid": ob.uid}

    def _tool_create_object(self, args, user):
        w = self._world(args)
        s = float(args.get("scale", 1.0))
        ob = WorldObject(
            object_type=int(ObjectType.GENERIC),
            model_url=str(args.get("model_url", "")),
            content=str(args.get("content", "")),
            pos=np.array([args["x"], args["y"], args["z"]], np.float64),
            scale=np.array([s, s, s], np.float32),
            creator_id=user.user_id, created_time=time.time())
        return self._insert_object(w, ob)

    def _tool_create_sphere(self, args, user):
        args = dict(args, model_url="primitive://sphere")
        return self._tool_create_object(args, user)

    def _tool_create_cube(self, args, user):
        return self._tool_create_voxel_object(
            dict(args, voxels=[[0, 0, 0, 0]]), user)

    def _tool_create_voxel_object(self, args, user):
        w = self._world(args)
        vox = args.get("voxels") or []
        if not vox:
            raise ValueError("voxels list is empty")
        coords = np.array([v[:3] for v in vox], np.int32)
        mats = np.array([v[3] if len(v) > 3 else 0 for v in vox], np.int32)
        s = float(args.get("scale", 1.0))
        ob = WorldObject(
            object_type=int(ObjectType.VOXEL_GROUP),
            voxel_data=compress_voxel_group(coords, mats),
            pos=np.array([args["x"], args["y"], args["z"]], np.float64),
            scale=np.array([s, s, s], np.float32),
            creator_id=user.user_id, created_time=time.time())
        return self._insert_object(w, ob)

    def _tool_edit_object(self, args, user):
        w = self._world(args)
        with self.worlds_state.lock:
            ob = w.objects.get(int(args["uid"]))
            if ob is None:
                raise ValueError(f"no object {args['uid']}")
            if not self._can_write(user, ob, w):
                raise PermissionError("you lack write permission on this object")
            if "x" in args:
                ob.pos = np.array([args["x"], args.get("y", ob.pos[1]),
                                   args.get("z", ob.pos[2])], np.float64)
            if "scale" in args:
                s = float(args["scale"])
                ob.scale = np.array([s, s, s], np.float32)
            if "content" in args:
                ob.content = str(args["content"])
            if "model_url" in args:
                ob.model_url = str(args["model_url"])
            w.dirty_objects.add(ob.uid)
            w.db_dirty_objects.add(ob.uid)
        return {"uid": ob.uid, "edited": True}

    def _tool_delete_object(self, args, user):
        w = self._world(args)
        with self.worlds_state.lock:
            ob = w.objects.get(int(args["uid"]))
            if ob is None:
                raise ValueError(f"no object {args['uid']}")
            if not self._can_write(user, ob, w):
                raise PermissionError("you lack write permission on this object")
            del w.objects[ob.uid]
            w.destroyed_objects.add(ob.uid)
        return {"uid": ob.uid, "deleted": True}
