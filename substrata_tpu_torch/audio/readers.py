"""Sound file loading.

Counterpart of ``substrata_tpu/audio/readers.py`` (numpy only): WAV
decode (PCM 8/16/24/32 and float32) and load-time resampling to the engine
rate; MP3 through the system libmpg123 (``runtime.codecs``).

Reference: audio/AudioFileReader.* dispatches to WavAudioFileReader
(stdlib-equivalent RIFF parsing) and MP3AudioFileReader (minimp3).
Decoded audio lands in a SoundFile{buf, num_channels, sample_rate}
(audio/AudioFileReader.h) and is resampled to the 48 kHz engine rate at
load (AudioEngine getOrLoadSoundFile path).
"""

from __future__ import annotations

import io
import struct
import wave
from dataclasses import dataclass

import numpy as np

from substrata_tpu_torch.audio.resampler import resample


@dataclass
class SoundFile:
    buf: np.ndarray        # [frames] mono or [frames, 2] stereo f32 in [-1, 1]
    num_channels: int
    sample_rate: int

    @property
    def num_frames(self) -> int:
        return len(self.buf)

    def mono(self) -> np.ndarray:
        if self.num_channels == 1:
            return self.buf
        return self.buf.mean(axis=1)

    def maxVal(self) -> float:  # reference SoundFile::maxVal parity
        return float(np.max(self.buf)) if len(self.buf) else 0.0

    def minVal(self) -> float:
        return float(np.min(self.buf)) if len(self.buf) else 0.0


def read_wav(path_or_bytes) -> SoundFile:
    """WAV decode (WavAudioFileReader.cpp parity: PCM16/24/32 + float32)."""
    if isinstance(path_or_bytes, (bytes, bytearray)):
        fh = io.BytesIO(path_or_bytes)
    else:
        fh = open(path_or_bytes, "rb")
    try:
        with wave.open(fh, "rb") as w:
            nch = w.getnchannels()
            rate = w.getframerate()
            width = w.getsampwidth()
            raw = w.readframes(w.getnframes())
    except wave.Error:
        # Float32 WAVs are rejected by the wave module; parse minimally.
        fh.seek(0)
        return _read_wav_float(fh.read())
    finally:
        fh.close()
    if width == 2:
        data = np.frombuffer(raw, "<i2").astype(np.float32) / 32768.0
    elif width == 4:
        data = np.frombuffer(raw, "<i4").astype(np.float32) / 2147483648.0
    elif width == 3:
        b = np.frombuffer(raw, np.uint8).reshape(-1, 3)
        as32 = (b[:, 0].astype(np.int32) | (b[:, 1].astype(np.int32) << 8)
                | (b[:, 2].astype(np.int32) << 16))
        as32 = np.where(as32 >= 1 << 23, as32 - (1 << 24), as32)
        data = as32.astype(np.float32) / float(1 << 23)
    elif width == 1:
        data = (np.frombuffer(raw, np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError(f"unsupported WAV sample width {width}")
    if nch > 1:
        data = data.reshape(-1, nch)[:, :2]
        if nch > 2:
            nch = 2
    return SoundFile(buf=data, num_channels=min(nch, 2), sample_rate=rate)


def _read_wav_float(raw: bytes) -> SoundFile:
    """Minimal RIFF parser for IEEE-float WAVs."""
    if raw[:4] != b"RIFF" or raw[8:12] != b"WAVE":
        raise ValueError("not a WAV file")
    pos = 12
    fmt = None
    data = None
    while pos + 8 <= len(raw):
        cid = raw[pos:pos + 4]
        sz = struct.unpack("<I", raw[pos + 4:pos + 8])[0]
        body = raw[pos + 8:pos + 8 + sz]
        if cid == b"fmt ":
            fmt = struct.unpack("<HHIIHH", body[:16])
        elif cid == b"data":
            data = body
        pos += 8 + sz + (sz & 1)
    if fmt is None or data is None:
        raise ValueError("malformed WAV")
    audio_fmt, nch, rate, _, _, bits = fmt
    if audio_fmt == 3 and bits == 32:
        arr = np.frombuffer(data, "<f4").astype(np.float32)
    elif audio_fmt == 1 and bits == 16:
        arr = np.frombuffer(data, "<i2").astype(np.float32) / 32768.0
    else:
        raise ValueError(f"unsupported WAV format {audio_fmt}/{bits}")
    if nch > 1:
        arr = arr.reshape(-1, nch)[:, :2]
    return SoundFile(buf=arr, num_channels=min(nch, 2), sample_rate=rate)


def read_mp3(path) -> SoundFile:
    """MP3 decode via the system libmpg123 (``runtime.codecs``) — the
    reference vendors minimp3 for the same decode
    (audio/MP3AudioFileReader.cpp)."""
    from substrata_tpu_torch.runtime import codecs
    if codecs.has_mp3():
        arr, rate = codecs.decode_mp3(path)
        return SoundFile(buf=arr, num_channels=1 if arr.ndim == 1 else arr.shape[1],
                         sample_rate=rate)
    raise RuntimeError(
        "MP3 decoding requires libmpg123 (not found on this system); "
        "convert to WAV")


def read_sound_file(path, target_rate: int | None = None) -> SoundFile:
    """AudioFileReader::readAudioFile parity: dispatch on extension and
    optionally resample to the engine rate."""
    p = str(path).lower()
    if p.endswith(".wav"):
        sf = read_wav(path)
    elif p.endswith(".mp3"):
        sf = read_mp3(path)
    else:
        raise ValueError(f"unsupported audio format: {path}")
    if target_rate is not None and sf.sample_rate != target_rate:
        if sf.num_channels == 1:
            buf = resample(sf.buf, sf.sample_rate, target_rate)
        else:
            buf = np.stack([resample(sf.buf[:, c], sf.sample_rate, target_rate)
                            for c in range(sf.buf.shape[1])], axis=1)
        sf = SoundFile(buf=buf.astype(np.float32), num_channels=sf.num_channels,
                       sample_rate=target_rate)
    return sf
