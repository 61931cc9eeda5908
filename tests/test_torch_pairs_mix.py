"""KS's twin (kernels/pairs.py) against the reference's find_pairs and
_pairs_rebuild on kernels/hard_cases.py's pair scenes: equal score ties
decided by the column order, one neighbour listed twice through a
bucket-hash collision, rows and max_pairs overflowing, 1 and 65 oversize
bodies, static, asleep and non-collidable bodies, none alive, a NaN
velocity and a world at rest at a rebuild, pairs_per_body 1, 3, 10 and 16;
and KS's and KG's plans (one per shape, one packed launch) driven on
``meta`` tensors.

Each scene runs with one margin (0.08) and at a rebuild (margins from the
speeds).  The counters (num_pairs, overflow) and the rebuild's window are
equal; so is the pair set, on every scene, overflowing ones included (the
per-row top-K keeps the lower column on ties and the compaction keeps the
first max_pairs rows slot-major, in both).  ``tests/test_torch_gpu.py``
and ``chip_smoke.py`` hold the kernel to this twin on the same scenes."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from substrata_tpu.physics import broadphase as jbp
from substrata_tpu.physics import state as jstate
from substrata_tpu_torch.kernels import audio_mix as kaudio
from substrata_tpu_torch.kernels import build, hard_cases
from substrata_tpu_torch.kernels import pairs as ks
from substrata_tpu_torch.physics.state import SimConfig

from torch_port_helpers import jax_body

torch.set_num_threads(2)

DT = 1.0 / 60.0
_jfind = jax.jit(jbp.find_pairs, static_argnames=("config", "has_oversize"))
_jrebuild = jax.jit(jbp._pairs_rebuild, static_argnames=("config", "has_oversize"))


def _pair_set(a, b, v):
    a, b, v = np.asarray(a), np.asarray(b), np.asarray(v)
    return sorted(zip(a[v].tolist(), b[v].tolist()))


@pytest.mark.parametrize("case", hard_cases.PAIR_CASES)
def test_pair_scene_twin_matches_reference(case):
    scene = hard_cases.pair_scene(case)
    body, cfg, has_os = hard_cases.pair_inputs(scene, "cpu")
    jb, jcfg = jax_body(scene.bodies), jstate.SimConfig(**scene.cfg)
    want = _jfind(jb, jcfg, has_oversize=has_os)
    got = ks.find_pairs_plain(body, cfg, 0.08, has_os)
    assert _pair_set(*got[:3]) == _pair_set(*want[:3])
    assert int(got[3]) == int(want[3]) and int(got[4]) == int(want[4])
    want = _jrebuild(jb, jnp.float32(DT), config=jcfg, has_oversize=has_os)
    got = ks.pairs_rebuild_plain(body, DT, cfg, has_os)
    assert _pair_set(*got[:3]) == _pair_set(*want[:3])
    assert int(got[3]) == int(want[3]) and int(got[4]) == int(want[4])
    assert int(got[5]) == int(want[5])                       # steps_left
    if case == "none_alive":
        assert int(want[3]) == 0 and int(want[4]) == 0
    if case in ("row_overflow", "max_pairs_overflow", "ppb_1", "oversize_65"):
        assert int(want[4]) > 0
    if case == "max_pairs_overflow":
        assert int(want[3]) > cfg.max_pairs and bool(got[2].all())
    if case == "all_still":
        assert int(want[5]) == cfg.pair_rebuild_interval - 1


# --- KS's and KG's plans, on meta tensors (the CUDA branch without a card).

def _meta(x):
    if isinstance(x, torch.Tensor):
        return torch.empty_like(x, device="meta")
    return x.replace(**{f.name: _meta(getattr(x, f.name)) for f in dataclasses.fields(x)})


@pytest.fixture
def recorded(monkeypatch):
    calls = []
    monkeypatch.setattr(build, "launch_packed", lambda name, args: calls.append((name, args)))
    monkeypatch.setattr(ks, "_plans", {})
    monkeypatch.setattr(kaudio, "_downmix_plans", {})

    def table(pos, *args, num_buckets, cap, **kw):
        n = pos.shape[0]
        return (torch.empty((num_buckets + 1, cap), dtype=torch.int32, device="meta"),
                torch.empty((n, 3), dtype=torch.int32, device="meta"),
                torch.empty((), dtype=torch.int32, device="meta"))
    monkeypatch.setattr(ks.cell_table, "cell_table", table)
    return calls


def test_pair_plan_packs_and_checks(recorded):
    """One plan per world shape and configuration: the packed sizes, the
    outputs' shapes as views of one buffer whose scratch starts at an even
    word past them and holds csrc/pairs.cu's layout; a bad argument
    raises, a bad configuration too."""
    scene = hard_cases.pair_scene("oversize_1")
    body, cfg, has_os = hard_cases.pair_inputs(scene, "cpu")
    mb = _meta(body)
    out = ks.pairs_rebuild(mb, DT, cfg, has_os)
    n, mp, ppb = body.capacity, cfg.max_pairs, cfg.pairs_per_body
    assert [tuple(t.shape) for t in out] == [(mp,), (mp,), (mp,), (), (), (), (n,)]
    assert [t.dtype for t in out] == [torch.int32, torch.int32, torch.bool, torch.int32,
                                      torch.int32, torch.int32, torch.float32]
    name, packed = recorded[-1]
    v = ks._PACK.unpack(packed)
    assert name == "find_pairs" and len(packed) == 33 * 8
    assert v[20:29] == (4, n, cfg.grid_dim ** 2, cfg.cell_capacity, ppb, mp, 1, 1,
                        cfg.pair_rebuild_interval)
    assert v[29:31] == (0.0, DT) and abs(v[31] - 0.84) < 1e-12 and v[32] == cfg.cell_size
    plan = next(iter(ks._plans.values()))
    assert plan.o_scratch % 2 == 0 and plan.o_scratch >= plan.o_pv + mp / 4
    # csrc/pairs.cu:find_pairs' scratch, word by word.
    nb1, rows = -(-n // 256), ppb * n + 64 * n
    words = 8 + 64 + 3 * n + 2 * nb1 + -(-n // 32) + ppb * n + 3 * mp
    words += words & 1
    assert plan.words - plan.o_scratch == (words + 2 * (-(-rows // 1024) + -(-n // 1024))
                                           + -(-ppb * n // 4))
    ks.find_pairs(mb, cfg, 0.08, has_os)
    assert len(ks._plans) == 1 and len(recorded) == 2 and ks._PACK.unpack(recorded[-1][1])[27] == 0
    ks.find_pairs(mb, cfg, 0.08, False)
    assert len(ks._plans) == 2
    for bad, exc in ((mb.replace(pos=mb.pos.double()), TypeError),
                     (mb.replace(linvel=mb.linvel[:-1]), ValueError),
                     (mb.replace(alive=torch.empty(n, dtype=torch.bool)), ValueError),
                     (mb.replace(motion_type=torch.empty((n, 2), dtype=torch.int32,
                                                         device="meta")[:, 0]), ValueError)):
        with pytest.raises(exc):
            ks.pairs_rebuild(bad, DT, cfg, has_os)
    for kw in (dict(pairs_per_body=17), dict(cell_capacity=19)):
        with pytest.raises(ValueError):
            ks.find_pairs(mb, SimConfig(**dict(scene.cfg, **kw)))
    assert len(recorded) == 3
    for _ in range(3 * ks._MAX_PLANS):
        ks.find_pairs(mb, SimConfig(**scene.cfg))
    assert len(ks._plans) <= ks._MAX_PLANS


@pytest.mark.parametrize("case", ["s256_b800", "no_room"])
def test_downmix_plan_packs_and_checks(recorded, case):
    """KG's plan per (S, B, D): the packed sizes, the outputs as views of
    one buffer (out [B, 2], lines [4, D], the write index), and a bad
    argument raises."""
    scene = hard_cases.downmix_scene(case)
    args = [None if a is None else _meta(a) for a in hard_cases.downmix_inputs(scene, "cpu")]
    s, b = scene.wl.shape
    out, lines, widx = kaudio.audio_downmix_reverb(*args)
    name, packed = recorded[-1]
    v = kaudio._DOWNMIX_PACK.unpack(packed)
    room = scene.room is not None
    d = hard_cases.DOWNMIX_D if room else 0
    assert name == "audio_downmix_reverb" and v[12:] == (s, b, d, int(room))
    assert tuple(out.shape) == (b, 2)
    if room:
        assert tuple(lines.shape) == (4, d) and widx.dtype == torch.int32 and widx.dim() == 0
    else:
        assert lines is None and widx is None and v[2] == 0 and v[4:9] == (0,) * 5
    kaudio.audio_downmix_reverb(*args)
    assert len(kaudio._downmix_plans) == 1 and len(recorded) == 2
    for k, bad, exc in ((0, args[0].double(), TypeError), (1, args[1][:, :-1], ValueError),
                        (1, torch.empty((s, b)), ValueError)):
        a = list(args)
        a[k] = bad
        with pytest.raises(exc):
            kaudio.audio_downmix_reverb(*a)
    if room:
        a = list(args)
        a[4] = a[4][:, :b - 1]
        with pytest.raises(ValueError):
            kaudio.audio_downmix_reverb(*a)
    assert len(recorded) == 2
