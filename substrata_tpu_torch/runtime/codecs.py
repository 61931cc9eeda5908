"""System codec bindings: MP3 decode (libmpg123), MP3 encode (libmp3lame,
used for test fixtures), and Opus voice encode/decode (libopus).

The reference vendors minimp3 for MP3 file/stream decode
(audio/MP3AudioFileReader.cpp, audio/StreamerThread.cpp) and libopus for
voice (audio/MicReadThread.cpp:304-331, gui_client/ClientUDPHandlerThread.cpp);
this build binds the system libraries over ctypes — same capability, no
vendored source.  Every entry point degrades gracefully: callers check the
``has_*()`` predicates and fall back (mu-law voice, WAV-only audio).
"""

from __future__ import annotations

import ctypes
import ctypes.util

import numpy as np

# ---------------------------------------------------------------------------
# Library loading
# ---------------------------------------------------------------------------

def _load(*names):
    for name in names:
        path = ctypes.util.find_library(name) or f"lib{name}.so"
        try:
            return ctypes.CDLL(path)
        except OSError:
            continue
    return None


_mpg123 = _load("mpg123")
_opus = _load("opus")
_lame = _load("mp3lame")

_MPG123_OK = 0
_MPG123_DONE = -12
_MPG123_NEW_FORMAT = -11
_MPG123_ENC_FLOAT_32 = 0x200
_MPG123_ENC_SIGNED_16 = 0xD0


def _pcm_to_f32(data: bytes, enc: int) -> np.ndarray:
    """Convert mpg123 output bytes in the negotiated encoding to f32
    (the handle's format table is locked once the stream is open, so we
    decode whatever was negotiated — s16 by default — and convert here)."""
    if enc == _MPG123_ENC_FLOAT_32:
        return np.frombuffer(data, "<f4").astype(np.float32)
    if enc == _MPG123_ENC_SIGNED_16:
        return np.frombuffer(data, "<i2").astype(np.float32) / 32768.0
    raise RuntimeError(f"unexpected mpg123 encoding 0x{enc:x}")

_mpg123_inited = False


def _mpg123_handle():
    global _mpg123_inited
    if _mpg123 is None:
        return None
    if not _mpg123_inited:
        _mpg123.mpg123_init()
        _mpg123_inited = True
    _mpg123.mpg123_new.restype = ctypes.c_void_p
    err = ctypes.c_int(0)
    return _mpg123.mpg123_new(None, ctypes.byref(err))


def has_mp3() -> bool:
    return _mpg123 is not None


def has_mp3_encode() -> bool:
    return _lame is not None


def has_opus() -> bool:
    return _opus is not None


# ---------------------------------------------------------------------------
# MP3 decode (MP3AudioFileReader parity)
# ---------------------------------------------------------------------------

def decode_mp3(path: str):
    """Decode a whole MP3 file to (samples f32 [N] or [N, ch<=2], rate).

    Raises RuntimeError when libmpg123 is unavailable or the file is bad.
    """
    h = _mpg123_handle()
    if h is None:
        raise RuntimeError("libmpg123 not available")
    try:
        if _mpg123.mpg123_open(ctypes.c_void_p(h), str(path).encode()) != _MPG123_OK:
            raise RuntimeError(f"mpg123_open failed for {path}")
        rate = ctypes.c_long(0)
        channels = ctypes.c_int(0)
        enc = ctypes.c_int(0)
        _mpg123.mpg123_getformat(ctypes.c_void_p(h), ctypes.byref(rate),
                                 ctypes.byref(channels), ctypes.byref(enc))
        chunks = []
        buf = (ctypes.c_ubyte * 65536)()
        done = ctypes.c_size_t(0)
        while True:
            rc = _mpg123.mpg123_read(ctypes.c_void_p(h), buf, len(buf),
                                     ctypes.byref(done))
            if done.value:
                chunks.append(bytes(buf[: done.value]))
            if rc == _MPG123_DONE:
                break
            if rc not in (_MPG123_OK, _MPG123_NEW_FORMAT):
                if not chunks:
                    raise RuntimeError(f"mpg123_read error {rc} for {path}")
                break
        arr = _pcm_to_f32(b"".join(chunks), enc.value)
        ch = max(1, channels.value)
        if ch > 1:
            arr = arr.reshape(-1, ch)[:, :2]
        return arr, int(rate.value)
    finally:
        _mpg123.mpg123_close(ctypes.c_void_p(h))
        _mpg123.mpg123_delete(ctypes.c_void_p(h))


class Mp3Streamer:
    """Progressive MP3 decode for streaming sources (StreamerThread parity,
    audio/StreamerThread.cpp:27-60: decode a few frames per iteration into
    the attached sources' ring buffers, keep >= ~4096 samples queued)."""

    def __init__(self, path: str):
        self._h = _mpg123_handle()
        if self._h is None:
            raise RuntimeError("libmpg123 not available")
        if _mpg123.mpg123_open(ctypes.c_void_p(self._h), str(path).encode()) != _MPG123_OK:
            raise RuntimeError(f"mpg123_open failed for {path}")
        rate = ctypes.c_long(0)
        channels = ctypes.c_int(0)
        enc = ctypes.c_int(0)
        _mpg123.mpg123_getformat(ctypes.c_void_p(self._h), ctypes.byref(rate),
                                 ctypes.byref(channels), ctypes.byref(enc))
        self.sample_rate = int(rate.value)
        self.num_channels = max(1, channels.value)
        self._enc = enc.value
        self._bytes_per_sample = 4 if enc.value == _MPG123_ENC_FLOAT_32 else 2
        self.eof = False

    def read(self, n_frames: int) -> np.ndarray:
        """Decode up to n_frames; shorter (possibly empty) at EOF."""
        want = n_frames * self.num_channels * self._bytes_per_sample
        buf = (ctypes.c_ubyte * want)()
        done = ctypes.c_size_t(0)
        rc = _mpg123.mpg123_read(ctypes.c_void_p(self._h), buf, want,
                                 ctypes.byref(done))
        if rc == _MPG123_DONE:
            self.eof = True
        arr = _pcm_to_f32(bytes(buf[: done.value]), self._enc)
        if self.num_channels > 1:
            arr = arr.reshape(-1, self.num_channels)[:, :2]
        return arr

    def close(self):
        if getattr(self, "_h", None) and _mpg123 is not None:
            _mpg123.mpg123_close(ctypes.c_void_p(self._h))
            _mpg123.mpg123_delete(ctypes.c_void_p(self._h))
            self._h = None

    def __del__(self):
        self.close()


# ---------------------------------------------------------------------------
# MP3 encode (fixture generation / server-side transcode)
# ---------------------------------------------------------------------------

def encode_mp3(samples: np.ndarray, rate: int, path: str,
               bitrate_kbps: int = 128):
    """Encode mono/stereo f32 samples to an MP3 file via libmp3lame."""
    if _lame is None:
        raise RuntimeError("libmp3lame not available")
    samples = np.asarray(samples, np.float32)
    if samples.ndim == 1:
        left = right = np.ascontiguousarray(samples)
        nch = 1
    else:
        left = np.ascontiguousarray(samples[:, 0])
        right = np.ascontiguousarray(samples[:, min(1, samples.shape[1] - 1)])
        nch = 2
    _lame.lame_init.restype = ctypes.c_void_p
    gfp = _lame.lame_init()
    _lame.lame_set_in_samplerate(ctypes.c_void_p(gfp), ctypes.c_int(rate))
    _lame.lame_set_num_channels(ctypes.c_void_p(gfp), ctypes.c_int(nch))
    _lame.lame_set_brate(ctypes.c_void_p(gfp), ctypes.c_int(bitrate_kbps))
    if _lame.lame_init_params(ctypes.c_void_p(gfp)) < 0:
        raise RuntimeError("lame_init_params failed")
    n = len(left)
    out = (ctypes.c_ubyte * (int(1.25 * n) + 7200))()
    written = _lame.lame_encode_buffer_ieee_float(
        ctypes.c_void_p(gfp),
        left.ctypes.data_as(ctypes.c_void_p),
        right.ctypes.data_as(ctypes.c_void_p),
        ctypes.c_int(n), out, ctypes.c_int(len(out)))
    if written < 0:
        raise RuntimeError(f"lame_encode_buffer failed ({written})")
    data = bytes(out[:written])
    flushed = _lame.lame_encode_flush(ctypes.c_void_p(gfp), out,
                                      ctypes.c_int(len(out)))
    data += bytes(out[:max(flushed, 0)])
    _lame.lame_close(ctypes.c_void_p(gfp))
    with open(path, "wb") as f:
        f.write(data)


# ---------------------------------------------------------------------------
# Opus voice codec (MicReadThread / ClientUDPHandlerThread parity)
# ---------------------------------------------------------------------------

_OPUS_APPLICATION_VOIP = 2048


class OpusEncoder:
    """48 kHz mono VoIP encoder (MicReadThread.cpp:304-331 uses the same
    configuration: Opus-legal rate, mono voice, ~10-20 ms frames)."""

    def __init__(self, rate: int = 48_000, bitrate: int = 32_000):
        if _opus is None:
            raise RuntimeError("libopus not available")
        err = ctypes.c_int(0)
        _opus.opus_encoder_create.restype = ctypes.c_void_p
        self._enc = _opus.opus_encoder_create(
            ctypes.c_int(rate), ctypes.c_int(1),
            ctypes.c_int(_OPUS_APPLICATION_VOIP), ctypes.byref(err))
        if err.value != 0:
            raise RuntimeError(f"opus_encoder_create error {err.value}")
        # OPUS_SET_BITRATE_REQUEST = 4002
        _opus.opus_encoder_ctl(ctypes.c_void_p(self._enc), ctypes.c_int(4002),
                               ctypes.c_int(bitrate))
        self.rate = rate

    def encode(self, pcm: np.ndarray) -> bytes:
        """Encode one frame (must be an Opus-legal frame size: 2.5/5/10/20/
        40/60 ms, e.g. 480 or 960 samples at 48 kHz)."""
        pcm = np.ascontiguousarray(pcm, np.float32)
        out = (ctypes.c_ubyte * 4000)()
        n = _opus.opus_encode_float(
            ctypes.c_void_p(self._enc),
            pcm.ctypes.data_as(ctypes.c_void_p),
            ctypes.c_int(len(pcm)), out, ctypes.c_int(len(out)))
        if n < 0:
            raise RuntimeError(f"opus_encode_float error {n}")
        return bytes(out[:n])

    def __del__(self):
        if _opus is not None and getattr(self, "_enc", None):
            _opus.opus_encoder_destroy(ctypes.c_void_p(self._enc))
            self._enc = None


class OpusDecoder:
    """Mono decoder with packet-loss concealment
    (ClientUDPHandlerThread.cpp:190-191: missing sequence numbers decode
    with a null packet so Opus interpolates)."""

    def __init__(self, rate: int = 48_000):
        if _opus is None:
            raise RuntimeError("libopus not available")
        err = ctypes.c_int(0)
        _opus.opus_decoder_create.restype = ctypes.c_void_p
        self._dec = _opus.opus_decoder_create(ctypes.c_int(rate),
                                              ctypes.c_int(1), ctypes.byref(err))
        if err.value != 0:
            raise RuntimeError(f"opus_decoder_create error {err.value}")
        self.rate = rate

    def decode(self, data: bytes | None, frame_size: int) -> np.ndarray:
        """Decode one packet; data=None conceals a lost packet."""
        out = np.empty(frame_size, np.float32)
        if data is None:
            n = _opus.opus_decode_float(
                ctypes.c_void_p(self._dec), None, ctypes.c_int(0),
                out.ctypes.data_as(ctypes.c_void_p),
                ctypes.c_int(frame_size), ctypes.c_int(0))
        else:
            buf = (ctypes.c_ubyte * len(data)).from_buffer_copy(data)
            n = _opus.opus_decode_float(
                ctypes.c_void_p(self._dec), buf, ctypes.c_int(len(data)),
                out.ctypes.data_as(ctypes.c_void_p),
                ctypes.c_int(frame_size), ctypes.c_int(0))
        if n < 0:
            raise RuntimeError(f"opus_decode_float error {n}")
        return out[:n]

    def reset(self):
        """Decoder state reset on stream renewal
        (ClientUDPHandlerThread.cpp:84-121)."""
        # OPUS_RESET_STATE = 4028
        _opus.opus_decoder_ctl(ctypes.c_void_p(self._dec), ctypes.c_int(4028))

    def __del__(self):
        if _opus is not None and getattr(self, "_dec", None):
            _opus.opus_decoder_destroy(ctypes.c_void_p(self._dec))
            self._dec = None
