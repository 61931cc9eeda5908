"""MP3 sources through the port's ``runtime.codecs`` (ctypes to libmpg123,
libopus and libmp3lame, copied from the reference jax-free).

The fixture is built with libmp3lame as tests/test_audio.py builds its
own; the port's decode is held sample-equal to the reference's (the same
library decodes both), the missing library raises the reference's
RuntimeError, and both ClientApps keep an object's MP3 sound as a source.
"""

import numpy as np
import pytest

from substrata_tpu.audio import readers as j_readers
from substrata_tpu.runtime import codecs as j_codecs
from substrata_tpu_torch.audio import readers as t_readers
from substrata_tpu_torch.runtime import codecs as t_codecs


def _fixture(tmp_path, rate=44100, seconds=0.6, stereo=False):
    if not (t_codecs.has_mp3() and t_codecs.has_mp3_encode()):
        pytest.skip("libmpg123 or libmp3lame not on this system")
    t = np.arange(int(rate * seconds)) / rate
    x = (0.4 * np.sin(2 * np.pi * 440 * t) + 0.1 * np.sin(2 * np.pi * 1250 * t))
    if stereo:
        x = np.stack([x, 0.5 * x], axis=1)
    path = str(tmp_path / f"tone_{rate}_{int(stereo)}.mp3")
    t_codecs.encode_mp3(x.astype(np.float32), rate, path)
    return path


@pytest.mark.parametrize("rate,stereo", [(48000, False), (44100, False), (44100, True)])
def test_mp3_decode_sample_equal_to_reference(tmp_path, rate, stereo):
    path = _fixture(tmp_path, rate, stereo=stereo)
    ja, jr = j_codecs.decode_mp3(path)
    ta, tr = t_codecs.decode_mp3(path)
    assert tr == jr == rate
    np.testing.assert_array_equal(ta, ja)
    assert ta.shape[0] > 0.5 * rate and np.abs(ta).max() > 0.3
    # Through the readers, resampled to the engine rate as the engines load it.
    jsf = j_readers.read_sound_file(path, target_rate=48000)
    tsf = t_readers.read_sound_file(path, target_rate=48000)
    assert (tsf.num_channels, tsf.sample_rate) == (jsf.num_channels, jsf.sample_rate)
    np.testing.assert_array_equal(tsf.buf, jsf.buf)


def test_mp3_without_libmpg123_raises_the_reference_error(tmp_path, monkeypatch):
    path = _fixture(tmp_path)
    monkeypatch.setattr(t_codecs, "_mpg123", None)
    monkeypatch.setattr(j_codecs, "_mpg123", None)
    with pytest.raises(RuntimeError) as t_err:
        t_readers.read_mp3(path)
    with pytest.raises(RuntimeError) as j_err:
        j_readers.read_mp3(path)
    assert str(t_err.value) == str(j_err.value)


def test_client_apps_keep_an_mp3_source(tmp_path):
    """The port's ClientApp used to log and drop every MP3 source
    (client_app.py's audio load); now both apps play it."""
    import torch

    from substrata_tpu import client_app as j_app
    from substrata_tpu.physics import state as j_state
    from substrata_tpu.shared import world_object as j_wo
    from substrata_tpu_torch import client_app as t_app
    from substrata_tpu_torch.physics import state as t_state
    from substrata_tpu_torch.shared import world_object as t_wo

    path = _fixture(tmp_path, 48000)
    torch.set_num_threads(2)
    loaded = []
    for app_mod, state_mod, wo_mod, kw in ((j_app, j_state, j_wo, {}),
                                           (t_app, t_state, t_wo, dict(device="cpu"))):
        cfg = state_mod.SimConfig(capacity=64, max_pairs=256, grid_dim=8, cell_size=4.0,
                                  solver_iters=4)
        app = app_mod.ClientApp(config=cfg, enable_audio=True, **kw)
        ob = wo_mod.WorldObject(flags=1, pos=np.array([1.0, 0.0, 1.0]))
        ob.audio_source_url = path
        app.create_object(ob)
        assert ob.audio_source is not None, app_mod.__name__
        off, n = app.audio.get_or_load_sound_file(path)
        loaded.append(np.asarray(app.audio.pool[off:off + n].cpu()
                                 if hasattr(app.audio.pool, "cpu") else app.audio.pool[off:off + n]))
    np.testing.assert_array_equal(loaded[1], loaded[0])
