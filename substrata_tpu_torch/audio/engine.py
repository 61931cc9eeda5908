"""Host-side AudioEngine facade.

Counterpart of ``substrata_tpu/audio/engine.py`` with the same API (parity
with glare::AudioEngine, audio/AudioEngine.h:130-264): add/remove sources,
the listener's head transform, per-source property pushes, master volume,
one-shots, engine mix-sources and streaming sources.

The sample pool and the source state live on ``device`` (the card unless
the caller asks for the CPU).  Host writes to the pool (loading a sound,
streaming PCM in) are in-place slice and index copies into the engine's
own pool tensor, made at load time or per voice frame, never per block;
source-state writes build new tensors, so a state that ``mix_block``
returned is never changed behind its back.  A pump thread keeps >= 4 mixed
256-frame blocks (~21.3 ms) queued in an output ring; ``read_output``
(the device callback's stand-in) drains it and zero-pads on underflow.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from substrata_tpu_torch.audio.mix import (
    BLOCK, ENGINE_RATE, FETCH_PAD, NUM_MIX_LAYERS, default_listener, mix_block,
    room_from_aabb, zero_sources,
)
from substrata_tpu_torch.audio.readers import read_sound_file
from substrata_tpu_torch.device import resolve_device
from substrata_tpu_torch.maths import quat as quatm

DEFAULT_POOL_SIZE = 1 << 22       # 4M samples = 16 MB, ~87 s of 48 kHz mono
STREAM_RING = 16_384              # per streaming source, ~341 ms
SOURCE_TYPE_LOOPING = 0           # AudioSource SourceType parity
SOURCE_TYPE_ONE_SHOT = 1
SOURCE_TYPE_STREAMING = 2


@dataclass(eq=False)
class AudioSource:
    """Host mirror of one source (audio/AudioEngine.h AudioSource)."""

    engine: "AudioEngine" = None
    slot: int = -1
    pos: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    vel: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    volume: float = 1.0
    spatial: bool = True
    looping: bool = False
    remove_on_finish: bool = True
    source_type: int = SOURCE_TYPE_ONE_SHOT
    num_occlusions: int = 0
    userdata: object = None
    doppler_enabled: bool = True

    @property
    def smoothed_level(self) -> float:
        if self.slot < 0:
            return 0.0
        return float(self.engine.sources.smoothed_level[self.slot])


class AudioEngine:
    def __init__(self, max_sources: int = 512, pool_size: int = DEFAULT_POOL_SIZE,
                 device="cuda"):
        if pool_size % 128:
            raise ValueError(f"pool_size {pool_size}: the fetch reads 128-sample rows")
        self.device = resolve_device(device)
        self.sources = zero_sources(max_sources, device=self.device)
        self.pool = torch.zeros((pool_size,), dtype=torch.float32, device=self.device)
        self.listener = default_listener(device=self.device)
        self._free = list(range(max_sources - 1, -1, -1))
        self._pool_cursor = 0
        self._pool_size = pool_size
        self.source_objs: dict[int, AudioSource] = {}
        self.room = None          # RoomState when room effects enabled
        self.use_hrtf = True      # HRIR binaural (kBinauralHighQuality parity)
        self.sound_file_cache: dict[str, tuple[int, int]] = {}  # path -> (off, len)
        self._stream_ring_pos: dict[int, int] = {}
        self._stream_offset: dict[int, int] = {}

        # Output ring (device-callback side, AudioEngine.cpp:191-226).
        self._ring = np.zeros((ENGINE_RATE, 2), np.float32)  # 1 s
        self._ring_write = 0
        self._ring_read = 0
        self._ring_lock = threading.Lock()
        self._pump_thread = None
        self._running = False
        self._pending: dict[int, dict] = {}

    def _dev(self, x, dtype=None):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=self.device)

    def _set_slot(self, slot: int, **values):
        """New source state with ``values`` written at ``slot``."""
        new = {}
        for name, v in values.items():
            t = getattr(self.sources, name).clone()
            t[slot] = self._dev(v, t.dtype)
            new[name] = t
        self.sources = self.sources.replace(**new)

    # ------------------------------------------------------------------
    # Sound pool
    # ------------------------------------------------------------------
    def load_sound(self, data: np.ndarray) -> tuple[int, int]:
        """Upload a mono f32 buffer into the device pool; returns (off, len).

        Every buffer is stored with FETCH_PAD trailing samples mirroring its
        head, so the windowed fetch can read past the end of a looping
        buffer without per-sample wraparound."""
        data = np.asarray(data, np.float32).reshape(-1)
        n = len(data)
        pad = FETCH_PAD
        if self._pool_cursor + n + pad > self._pool_size:
            raise RuntimeError("audio sample pool full")
        off = self._pool_cursor
        self._pool_cursor += n + pad
        padded = np.concatenate([data, data[np.arange(pad) % max(n, 1)]])
        self.pool[off:off + len(padded)] = self._dev(padded)
        return off, n

    def get_or_load_sound_file(self, path) -> tuple[int, int]:
        key = str(path)
        if key not in self.sound_file_cache:
            sf = read_sound_file(path, target_rate=ENGINE_RATE)
            self.sound_file_cache[key] = self.load_sound(sf.mono())
        return self.sound_file_cache[key]

    # ------------------------------------------------------------------
    # Sources
    # ------------------------------------------------------------------
    def add_source(self, source: AudioSource, sound=None, mixes=None) -> AudioSource:
        """sound: np buffer | (off, len) | None (streaming); mixes: list of
        (buffer_or_offlen, delta, mix_factor) for engine mix-sources."""
        if not self._free:
            raise RuntimeError("audio engine at max sources")
        slot = self._free.pop()
        source.slot = slot
        source.engine = self
        self.source_objs[slot] = source

        offs = np.zeros(NUM_MIX_LAYERS, np.int32)
        lens = np.zeros(NUM_MIX_LAYERS, np.int32)
        deltas = np.ones(NUM_MIX_LAYERS, np.float32)
        facs = np.zeros(NUM_MIX_LAYERS, np.float32)
        stream = source.source_type == SOURCE_TYPE_STREAMING
        if stream:
            off, n = self.load_sound(np.zeros(STREAM_RING, np.float32))
            offs[0], lens[0], facs[0] = off, n, 1.0
            self._stream_ring_pos[slot] = 0
            self._stream_offset[slot] = off
        elif mixes is not None:
            for i, (buf, delta, fac) in enumerate(mixes[:NUM_MIX_LAYERS]):
                off, n = buf if isinstance(buf, tuple) else self.load_sound(buf)
                offs[i], lens[i], deltas[i], facs[i] = off, n, delta, fac
        elif sound is not None:
            off, n = sound if isinstance(sound, tuple) else self.load_sound(sound)
            offs[0], lens[0], facs[0] = off, n, 1.0

        self._set_slot(
            slot, buf_offset=offs, buf_len=lens, playhead=0.0, delta=deltas,
            mix_factor=facs, looping=source.looping,
            remove_on_finish=source.remove_on_finish, finished=False, paused=False,
            pos=np.asarray(source.pos, np.float32), vel=np.asarray(source.vel, np.float32),
            spatial=source.spatial, volume=source.volume, mute_factor=1.0,
            mute_target=1.0, mute_rate=0.0, num_occlusions=float(source.num_occlusions),
            doppler_factor=1.0, lp_state=0.0, smoothed_level=0.0, alive=True,
            stream_mode=stream, stream_write_head=0.0)
        return source

    def remove_source(self, source: AudioSource):
        if source.slot < 0:
            return
        slot = source.slot
        self._set_slot(slot, alive=False)
        self.source_objs.pop(slot, None)
        self._stream_ring_pos.pop(slot, None)
        self._stream_offset.pop(slot, None)
        self._free.append(slot)
        source.slot = -1

    # Per-tick property pushes (batched on render).
    def source_position_updated(self, source: AudioSource):
        self._pending.setdefault(source.slot, {})["pos"] = np.asarray(source.pos, np.float32)
        self._pending[source.slot]["vel"] = np.asarray(source.vel, np.float32)

    def source_volume_updated(self, source: AudioSource):
        self._pending.setdefault(source.slot, {})["volume"] = float(source.volume)

    def source_num_occlusions_updated(self, source: AudioSource):
        self._pending.setdefault(source.slot, {})["occ"] = float(source.num_occlusions)

    def set_source_mix_params(self, source: AudioSource, deltas, factors):
        """Engine-sound layer control (pitch + crossfade per layer)."""
        self._pending.setdefault(source.slot, {})["mix"] = (
            np.asarray(deltas, np.float32), np.asarray(factors, np.float32))

    def mute_source(self, source: AudioSource, fade_time: float = 0.1, unmute=False):
        """Timed mute/unmute fades (AudioEngine.h:79-128)."""
        self._pending.setdefault(source.slot, {})["mute"] = (
            1.0 if unmute else 0.0, 1.0 / max(fade_time, 1e-3))

    def stream_samples(self, source: AudioSource, samples: np.ndarray):
        """Push decoded PCM into a streaming source's ring (voice RX /
        StreamerThread parity).  Writes into the first FETCH_PAD ring
        samples are mirrored past the ring's end, so the fetch never wraps
        inside a block."""
        slot = source.slot
        pos = self._stream_ring_pos[slot]
        samples = np.asarray(samples, np.float32).reshape(-1)
        off = self._stream_offset[slot]
        p = (pos + np.arange(len(samples))) % STREAM_RING
        data = self._dev(samples)
        self.pool[self._dev(off + p)] = data
        mirror = np.where(p < FETCH_PAD, off + STREAM_RING + p, off + p)
        self.pool[self._dev(mirror)] = data
        self._stream_ring_pos[slot] = (pos + len(samples)) % STREAM_RING
        wh = self.sources.stream_write_head.clone()
        wh[slot] += float(len(samples))
        self.sources = self.sources.replace(stream_write_head=wh)

    # ------------------------------------------------------------------
    # Listener (setHeadTransform, AudioEngine.cpp:987-988)
    # ------------------------------------------------------------------
    def set_head_transform(self, pos, rot_quat, vel=None):
        r = self._dev(np.asarray(rot_quat, np.float32))
        axes = self._dev(np.eye(3, dtype=np.float32))
        self.listener = self.listener.replace(
            pos=self._dev(np.asarray(pos, np.float32)),
            right=quatm.rotate_vec_eager(r, axes[0]),
            forward=quatm.rotate_vec_eager(r, axes[1]),
            up=quatm.rotate_vec_eager(r, axes[2]),
            vel=self._dev(np.asarray(vel, np.float32)) if vel is not None
            else self.listener.vel)

    def set_master_volume(self, v: float):
        self.listener = self.listener.replace(master_volume=self._dev(np.float32(v)))

    # ------------------------------------------------------------------
    # One-shots + helpers
    # ------------------------------------------------------------------
    def play_one_shot_sound(self, path, pos) -> AudioSource:
        """playOneShotSound parity (AudioEngine.cpp:1022)."""
        offlen = self.get_or_load_sound_file(path)
        src = AudioSource(pos=np.asarray(pos, np.float32), looping=False,
                          remove_on_finish=True, source_type=SOURCE_TYPE_ONE_SHOT)
        return self.add_source(src, sound=offlen)

    # ------------------------------------------------------------------
    # Mixing
    # ------------------------------------------------------------------
    def _apply_pending(self):
        if not self._pending:
            return
        for slot, upd in self._pending.items():
            if slot < 0:
                continue
            vals = {}
            if "pos" in upd:
                vals.update(pos=upd["pos"], vel=upd["vel"])
            if "volume" in upd:
                vals["volume"] = upd["volume"]
            if "occ" in upd:
                vals["num_occlusions"] = upd["occ"]
            if "mix" in upd:
                vals["delta"], vals["mix_factor"] = upd["mix"]
            if "mute" in upd:
                vals["mute_target"], vals["mute_rate"] = upd["mute"]
            self._set_slot(slot, **vals)
        self._pending.clear()

    def set_room_effects_from_aabb(self, aabb_min, aabb_max, reflectivity: float = 0.5):
        """Enable room reverb derived from the enclosing object's AABB
        (AudioEngine.cpp:738-767 SetRoomProperties/reflections parity)."""
        self.room = room_from_aabb(aabb_min, aabb_max, reflectivity, device=self.device)

    def disable_room_effects(self):
        self.room = None

    def render_block(self) -> np.ndarray:
        """Mix one 256-frame stereo block and return it [BLOCK, 2]."""
        self._apply_pending()
        if self.room is not None:
            self.sources, out, self.room = mix_block(
                self.sources, self.pool, self.listener, room=self.room,
                use_hrtf=self.use_hrtf)
        else:
            self.sources, out = mix_block(self.sources, self.pool, self.listener,
                                          use_hrtf=self.use_hrtf)
        self._retire_finished()
        return out.cpu().numpy()

    def render(self, n_blocks: int) -> np.ndarray:
        return np.concatenate([self.render_block() for _ in range(n_blocks)])

    def _retire_finished(self):
        fin = (self.sources.finished & ~self.sources.alive).cpu().numpy()
        for slot in np.nonzero(fin)[0]:
            ob = self.source_objs.get(int(slot))
            if ob is not None and ob.remove_on_finish:
                self.source_objs.pop(int(slot), None)
                self._free.append(int(slot))
                ob.slot = -1

    # ------------------------------------------------------------------
    # Pump thread + output ring (ResonanceThread + device callback parity)
    # ------------------------------------------------------------------
    def start(self):
        self._running = True
        self._pump_thread = threading.Thread(target=self._pump, daemon=True)
        self._pump_thread.start()

    def shutdown(self):
        self._running = False
        if self._pump_thread:
            self._pump_thread.join(timeout=2.0)

    def _queued_frames(self) -> int:
        return (self._ring_write - self._ring_read) % len(self._ring)

    def _pump(self):
        # Keep 4 blocks (~21.3 ms) queued (AudioEngine.cpp:359-363).
        while self._running:
            if self._queued_frames() < 4 * BLOCK:
                block = self.render_block()
                with self._ring_lock:
                    w = self._ring_write
                    n = len(self._ring)
                    idx = (w + np.arange(BLOCK)) % n
                    self._ring[idx] = block
                    self._ring_write = (w + BLOCK) % n
            else:
                time.sleep(0.002)

    def read_output(self, n_frames: int) -> np.ndarray:
        """Device-callback stand-in: pop n frames, zero-pad underflow
        (AudioEngine.cpp:191-226)."""
        out = np.zeros((n_frames, 2), np.float32)
        with self._ring_lock:
            avail = self._queued_frames()
            take = min(avail, n_frames)
            r = self._ring_read
            n = len(self._ring)
            idx = (r + np.arange(take)) % n
            out[:take] = self._ring[idx]
            self._ring_read = (r + take) % n
        return out

    def get_diagnostics(self) -> str:
        alive = int(self.sources.alive.sum())
        return (f"AudioEngine: {alive} sources, pool "
                f"{self._pool_cursor}/{self._pool_size} samples, "
                f"queued {self._queued_frames()} frames")
