"""Wire protocol: message ids + length-prefixed framing + payload codecs.

Message-id and framing parity with shared/Protocol.h (version 54): every
message is [u32 msg_type][u32 msg_len][payload] with msg_len covering the
whole message including the 8-byte header (the v31+ length-prefixed format;
packet init/length patching helper parity with shared/MessageUtils.h).
Payload layouts are this engine's own (we are not wire-compatible with the
C++ build — same ids + semantics, fresh encoding).

A copy of ``substrata_tpu/net/protocol.py`` with the port's imports: importing
any module of the reference package loads jax, so the port keeps its own.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

import numpy as np

# Handshake (Protocol.h:57-67)
CYBERSPACE_HELLO = 1357924680
CYBERSPACE_PROTOCOL_VERSION = 54
CLIENT_PROTOCOL_OK = 10000
CLIENT_PROTOCOL_TOO_OLD = 10001
CLIENT_PROTOCOL_TOO_NEW = 10002
CLIENT_UDP_SOCKET_OPEN = 10003
CYBERSPACE_GOODBYE = 10010

# Audio stream control (Protocol.h:67-68)
AUDIO_STREAM_TO_SERVER_STARTED = 10020
AUDIO_STREAM_TO_SERVER_ENDED = 10021

# Connection types (Protocol.h:70-76)
CONNECTION_TYPE_UPDATES = 500
CONNECTION_TYPE_UPLOAD_RESOURCE = 501
CONNECTION_TYPE_DOWNLOAD_RESOURCES = 502
CONNECTION_TYPE_SCREENSHOT_BOT = 504
CONNECTION_TYPE_ETH_BOT = 505
CONNECTION_TYPE_UPLOAD_PHOTO = 506

CHANGE_TO_DIFFERENT_WORLD = 600  # Protocol.h:78

# Avatars (Protocol.h:81-98)
AVATAR_CREATED = 1000
AVATAR_DESTROYED = 1001
AVATAR_TRANSFORM_UPDATE = 1002
AVATAR_FULL_UPDATE = 1003
CREATE_AVATAR = 1004
AVATAR_IS_HERE = 1005
AVATAR_PERFORM_GESTURE = 1010
AVATAR_STOP_GESTURE = 1011
AVATAR_ENTERED_VEHICLE = 1100
AVATAR_EXITED_VEHICLE = 1101
AVATAR_SAT_ON_SEAT = 1110
AVATAR_GOT_UP_FROM_SEAT = 1111
USER_MOVED_NEAR_TO_AVATAR = 1200
USER_MOVED_AWAY_FROM_AVATAR = 1201
USER_GESTURE_SETTINGS_CHANGED = 1300

# Gear (Protocol.h:103-109)
QUERY_USER_GEAR = 1400
USER_GEAR_LIST = 1401
GEAR_ITEM_UPDATE = 1402
CREATE_GEAR_ITEM = 1403
PICK_UP_GEAR_ITEM = 1404
DROP_GEAR_ITEM = 1405
CLONE_GEAR_ITEM_IN_INVENTORY = 1406

# Chat
CHAT_MESSAGE_ID = 2000

# Objects (Protocol.h:113-137)
OBJECT_CREATED = 3000
OBJECT_DESTROYED = 3001
OBJECT_TRANSFORM_UPDATE = 3002
OBJECT_FULL_UPDATE = 3003
CREATE_OBJECT = 3004   # client wants to create an object
DESTROY_OBJECT = 3005  # client wants to destroy an object
OBJECT_LIGHTMAP_URL_CHANGED = 3010
OBJECT_FLAGS_CHANGED = 3011
OBJECT_MODEL_URL_CHANGED = 3012
OBJECT_PHYSICS_OWNERSHIP_TAKEN = 3013
OBJECT_PHYSICS_TRANSFORM_UPDATE = 3016
OBJECT_CONTENT_CHANGED = 3017
OBJECT_MOVE_TO = 3018    # scripted moveTo with easing (Protocol.h:123)
OBJECT_ROTATE_TO = 3019  # scripted rotateTo with easing (Protocol.h:124)
SUMMON_OBJECT = 3030
QUERY_OBJECTS = 3020
OBJECT_INITIAL_SEND = 3021
QUERY_OBJECTS_IN_AABB = 3022
OBJECT_INITIAL_SEND_COMPRESSED = 3023

# Easing values for ObjectMoveTo/ObjectRotateTo (Protocol.h:128-129)
MOVE_TO_EASING_LINEAR = 0
MOVE_TO_EASING_SMOOTHSTEP = 1

# Parcels (Protocol.h:140-146)
PARCEL_CREATED = 3100
PARCEL_DESTROYED = 3101
PARCEL_FULL_UPDATE = 3103
PARCEL_INITIAL_SEND_COMPRESSED = 3104
QUERY_PARCELS = 3150
PARCEL_LIST = 3160

# Bulk object fetch (Protocol.h:148-149)
GET_ALL_OBJECTS = 3600
ALL_OBJECTS_SENT = 3601

# World settings / details (Protocol.h:151-154)
WORLD_SETTINGS_INITIAL_SEND_MESSAGE = 3700
WORLD_SETTINGS_UPDATE = 3701
WORLD_DETAILS_INITIAL_SEND_MESSAGE = 3750

# Map tiles (Protocol.h:156-157)
QUERY_MAP_TILES = 3800
MAP_TILES_RESULT = 3801

# LOD chunks (Protocol.h:160-162)
QUERY_LOD_CHUNKS_MESSAGE = 3900
LOD_CHUNK_INITIAL_SEND = 3901
LOD_CHUNK_UPDATED_MESSAGE = 3902

# Resource transfer (Protocol.h:167-170)
GET_FILE = 4000
GET_FILES = 4001
NEW_RESOURCE_ON_SERVER = 4100

# Upload responses / permission errors (Protocol.h:173-178)
UPLOAD_ALLOWED = 5100
LOG_IN_FAILURE = 5101
INVALID_FILE_SIZE = 5102
NO_WRITE_PERMISSIONS = 5103
SERVER_IS_IN_READ_ONLY_MODE = 5104
INVALID_FILE_TYPE = 5105

# User events (Protocol.h:182-190)
USER_SELECTED_OBJECT = 6000
USER_DESELECTED_OBJECT = 6001
USER_USED_OBJECT_MESSAGE = 6500
USER_TOUCHED_OBJECT_MESSAGE = 6501
USER_MOVED_NEAR_TO_OBJECT_MESSAGE = 6510
USER_MOVED_AWAY_FROM_OBJECT_MESSAGE = 6511
USER_ENTERED_PARCEL_MESSAGE = 6512
USER_EXITED_PARCEL_MESSAGE = 6513

# Info / admin (Protocol.h:192-194)
INFO_MESSAGE_ID = 7001
ERROR_MESSAGE_ID = 7002
SERVER_ADMIN_MESSAGE_ID = 7010

# Auth (Protocol.h:196-204)
LOG_IN_MESSAGE = 8000
LOG_OUT_MESSAGE = 8001
SIGN_UP_MESSAGE = 8002
LOGGED_IN_MESSAGE_ID = 8003
LOGGED_OUT_MESSAGE_ID = 8004
SIGNED_UP_MESSAGE_ID = 8005
REQUEST_PASSWORD_RESET = 8010
CHANGE_PASSWORD_WITH_RESET_TOKEN = 8011

TIME_SYNC_MESSAGE = 9000

# Screenshots (Protocol.h:208-211)
SCREENSHOT_REQUEST = 11001
SCREENSHOT_SUCCEEDED = 11002
TILE_SCREENSHOT_REQUEST = 11003
GEAR_SCREENSHOT_REQUEST = 11004

# Ethereum (Protocol.h:214-216)
SUBMIT_ETH_TRANSACTION_REQUEST = 12001
ETH_TRANSACTION_SUBMITTED = 12002
ETH_TRANSACTION_SUBMISSION_FAILED = 12003

KEEP_ALIVE = 13000
PING = 13100  # PingMessage (Protocol.h:220)
PONG = 13101  # PongMessage (Protocol.h:221)

PHOTO_UPLOAD_SUCCEEDED = 14000
PHOTO_UPLOAD_FAILED = 14001

# Builder AI (Protocol.h:234-241)
BUILDER_AI_USER_MESSAGE = 15000
BUILDER_AI_CANCEL = 15001
BUILDER_AI_TEXT_DELTA = 15010
BUILDER_AI_TOOL_ACTIVITY = 15011
BUILDER_AI_TURN_COMPLETE = 15012
BUILDER_AI_ERROR = 15013

# Client capability bits (Protocol.h:246-248)
STREAMING_COMPRESSED_OBJECT_SUPPORT = 0x1
SENDS_USER_MOVED_CHATBOT_MSGS = 0x2

# Server capability bits (Protocol.h:251-253)
OBJECT_TEXTURE_BASISU_SUPPORT = 0x1
TERRAIN_DETAIL_MAPS_BASISU_SUPPORT = 0x2
OPTIMISED_MESH_SUPPORT = 0x4

# UDP packet types (server/UDPHandlerThread.cpp:55-95)
UDP_VOICE_PACKET = 1
UDP_DISCOVERY_PACKET = 2

HEADER = struct.Struct("<II")


def make_message(msg_type: int, payload: bytes = b"") -> bytes:
    """Length includes the 8-byte header (MessageUtils parity)."""
    return HEADER.pack(msg_type, len(payload) + 8) + payload


class MessageReader:
    """Incremental frame splitter for a TCP stream."""

    def __init__(self):
        self._buf = bytearray()

    def feed(self, data: bytes):
        self._buf.extend(data)

    def messages(self):
        while len(self._buf) >= 8:
            msg_type, msg_len = HEADER.unpack_from(self._buf, 0)
            if msg_len < 8 or msg_len > 64 * 1024 * 1024:
                raise ValueError(f"bad message length {msg_len}")
            if len(self._buf) < msg_len:
                return
            payload = bytes(self._buf[8:msg_len])
            del self._buf[:msg_len]
            yield msg_type, payload


# --- Payload codecs -------------------------------------------------------

def pack_string(s: str) -> bytes:
    b = s.encode("utf-8")
    return struct.pack("<I", len(b)) + b


def unpack_string(buf: bytes, off: int):
    (n,) = struct.unpack_from("<I", buf, off)
    off += 4
    return buf[off:off + n].decode("utf-8"), off + n


_PHYS_SNAP = struct.Struct("<Q13fdI")


def pack_physics_transform_update(uid: int, pos, quat, linvel, angvel,
                                  client_time: float, owner_avatar_uid: int) -> bytes:
    """ObjectPhysicsTransformUpdate 3016 payload (WorkerThread.cpp:1968-2039
    semantics: pos/rot/vel/angvel + client timestamp + sender)."""
    return _PHYS_SNAP.pack(uid, *np.asarray(pos, np.float32),
                           *np.asarray(quat, np.float32),
                           *np.asarray(linvel, np.float32),
                           *np.asarray(angvel, np.float32),
                           client_time, owner_avatar_uid)


def unpack_physics_transform_update(payload: bytes):
    vals = _PHYS_SNAP.unpack(payload)
    uid = vals[0]
    f = np.array(vals[1:14], np.float32)
    return (uid, f[0:3], f[3:7], f[7:10], f[10:13], vals[14], vals[15])


_OWNERSHIP = struct.Struct("<QId")


def pack_physics_ownership_taken(uid: int, physics_owner_id: int,
                                 global_time: float, flags: int = 0) -> bytes:
    return _OWNERSHIP.pack(uid, physics_owner_id, global_time) + struct.pack("<I", flags)


def unpack_physics_ownership_taken(payload: bytes):
    uid, owner, t = _OWNERSHIP.unpack_from(payload, 0)
    (flags,) = struct.unpack_from("<I", payload, _OWNERSHIP.size)
    return uid, owner, t, flags


_AVATAR_TRANSFORM = struct.Struct("<Q6fIQII")


def pack_avatar_transform_update(uid: int, pos, rot, anim_state: int,
                                 vehicle_uid: int = 0, seat: int = 0,
                                 input_bitflags: int = 0) -> bytes:
    """AvatarTransformUpdate 1002: pos + (roll, pitch, heading) + anim state
    bitflags (shared/Avatar.h:133-141) + vehicle occupancy and the driver's
    input bitflags for remote vehicle replay (VehiclePhysics.h:79)."""
    return _AVATAR_TRANSFORM.pack(uid, *np.asarray(pos, np.float64).astype(np.float32),
                                  *np.asarray(rot, np.float32), anim_state,
                                  vehicle_uid, seat, input_bitflags)


def unpack_avatar_transform_update(payload: bytes):
    vals = _AVATAR_TRANSFORM.unpack(payload)
    return (vals[0], np.array(vals[1:4], np.float32),
            np.array(vals[4:7], np.float32), vals[7], vals[8], vals[9],
            vals[10])


def pack_time_sync(global_time: float) -> bytes:
    return struct.pack("<d", global_time)


def unpack_time_sync(payload: bytes) -> float:
    return struct.unpack("<d", payload)[0]


def pack_chat_message(name: str, msg: str) -> bytes:
    return pack_string(name) + pack_string(msg)


def unpack_chat_message(payload: bytes):
    name, off = unpack_string(payload, 0)
    msg, _ = unpack_string(payload, off)
    return name, msg


# --- Scripted moveTo / rotateTo / summon (Protocol.h:123-131) --------------

MOVE_TO_EASING_LINEAR = 0
MOVE_TO_EASING_SMOOTHSTEP = 1       # ease in and out

_MOVE_TO = struct.Struct("<QdfI6d")


def pack_object_move_to(uid: int, start_time: float, duration: float,
                        easing: int, start_pos, target_pos) -> bytes:
    """ObjectMoveTo 3018 (gui_client/ClientThread.cpp:675-687 layout:
    uid, start_time f64, duration f32, easing u32, start/target pos f64x3)."""
    return _MOVE_TO.pack(uid, start_time, duration, easing,
                         *np.asarray(start_pos, np.float64),
                         *np.asarray(target_pos, np.float64))


def unpack_object_move_to(payload: bytes):
    v = _MOVE_TO.unpack(payload)
    return (v[0], v[1], v[2], v[3], np.array(v[4:7]), np.array(v[7:10]))


_ROTATE_TO = struct.Struct("<QdfI3ff3ff")


def pack_object_rotate_to(uid: int, start_time: float, duration: float,
                          easing: int, start_axis, start_angle: float,
                          target_axis, target_angle: float) -> bytes:
    """ObjectRotateTo 3019 (ClientThread.cpp:688-701 layout)."""
    return _ROTATE_TO.pack(uid, start_time, duration, easing,
                           *np.asarray(start_axis, np.float32), start_angle,
                           *np.asarray(target_axis, np.float32), target_angle)


def unpack_object_rotate_to(payload: bytes):
    v = _ROTATE_TO.unpack(payload)
    return (v[0], v[1], v[2], v[3], np.array(v[4:7], np.float32), v[7],
            np.array(v[8:11], np.float32), v[11])


_SUMMON = struct.Struct("<Q6dI")


def pack_summon_object(uid: int, pos, axis_angle,
                       transform_update_avatar_uid: int) -> bytes:
    """SummonObject 3030 (SummonObjectMessage structs: new transform +
    the summoning avatar so the sender discards its own echo)."""
    return _SUMMON.pack(uid, *np.asarray(pos, np.float64),
                        *np.asarray(axis_angle, np.float64),
                        transform_update_avatar_uid)


def unpack_summon_object(payload: bytes):
    v = _SUMMON.unpack(payload)
    return v[0], np.array(v[1:4]), np.array(v[4:7]), v[7]


# --- Audio stream control (Protocol.h:10020-10021) -------------------------

def pack_audio_stream_state(avatar_uid: int, sample_rate: int = 48000,
                            stream_id: int = 0) -> bytes:
    return struct.pack("<QII", avatar_uid, sample_rate, stream_id)


def unpack_audio_stream_state(payload: bytes):
    return struct.unpack("<QII", payload[:16])


# --- Seats / vehicles (1101, 1110-1111) ------------------------------------

def pack_avatar_seat_change(avatar_uid: int, vehicle_uid: int,
                            seat_index: int) -> bytes:
    return struct.pack("<QQI", avatar_uid, vehicle_uid, seat_index)


def unpack_avatar_seat_change(payload: bytes):
    return struct.unpack("<QQI", payload[:20])


# --- Eth transactions (12001-12003) ----------------------------------------

def pack_eth_transaction_request(parcel_id: int, to_address: str) -> bytes:
    return struct.pack("<I", parcel_id) + pack_string(to_address)


def unpack_eth_transaction_request(payload: bytes):
    (parcel_id,) = struct.unpack_from("<I", payload, 0)
    addr, _ = unpack_string(payload, 4)
    return parcel_id, addr


# --- BuilderAI (Protocol.h:15000-15013) ------------------------------------

def pack_builder_ai_user_message(text: str) -> bytes:
    return pack_string(text)


def unpack_builder_ai_user_message(payload: bytes):
    return unpack_string(payload, 0)[0]
