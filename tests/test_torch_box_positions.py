"""Kernels KA (box-box rows) and KU (the position solve): their plain twins
against the jitted reference on ``kernels/hard_cases.py``'s
``BOX_BOX_CASES`` and ``POSITION_CASES``, and both wrappers' plans and
packed launches driven on ``meta`` tensors, which reach the CUDA branch
without a card, with the launch recorded instead of made.

Tolerances:
- KA (``tests/test_torch_narrowphase.py``'s): ids, keys and restitution
  exact; friction within 1e-6 (torch's float32 sqrt on the CPU); the valid
  and touching masks exact except on pairs whose decisions (axis and face
  choice, signs, point masks) lie within 1e-5 of a threshold, where either
  branch is a correct rounding; points, normals and depths within 1e-5 on
  the rows both keep.  The reference contracts its matrix products and
  multiply-adds, which the twin rounds apart (as the kernel, exact against
  the twin on the card, does).
- KU: one iteration exact; more within 1e-6 m, since the reference reduces
  each later iteration's residual ``jnp.sum(dp * n)`` as an fma chain and
  the twin as ``(a0 b0 + a1 b1) + a2 b2``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from substrata_tpu.physics import narrowphase as jnp_phase
from substrata_tpu.physics import solver as jsolver
from substrata_tpu.physics import state as jstate
from substrata_tpu_torch.kernels import box_box as ka
from substrata_tpu_torch.kernels import build, hard_cases
from substrata_tpu_torch.kernels import positions as ku
from substrata_tpu_torch.physics import state as tstate

from torch_port_helpers import FIELDS, jax_body

torch.set_num_threads(2)

ATOL = 1e-5
_jpair_contacts = jax.jit(jnp_phase.pair_contacts, static_argnames=("config", "blocked_wm"))
_jsolve_positions = jax.jit(jsolver.solve_positions,
                            static_argnames=("config", "iters", "beta", "wm"))


def _body_arrays(n, **fields):
    a = {k: v.numpy().copy() for k, v in vars(tstate.zero_body_state(n, device="cpu")).items()}
    a.update(fields)
    return {k: np.ascontiguousarray(a[k]) for k in FIELDS}


@pytest.mark.parametrize("case", hard_cases.BOX_BOX_CASES)
def test_box_box_cases_twin_matches_reference(case):
    scene = hard_cases.box_box_scene(case)
    b = scene.bodies
    n = b["pos"].shape[0]
    arrays = _body_arrays(n, pos=b["pos"], quat=b["quat"], shape_params=b["shape_params"],
                          friction=b["friction"], restitution=b["restitution"],
                          is_sensor=b["is_sensor"],
                          shape_type=np.full(n, int(jstate.ShapeType.BOX), np.int32),
                          alive=np.ones(n, bool), awake=np.ones(n, bool))
    cfg = jstate.SimConfig(capacity=n, max_pairs=scene.pair_a.shape[0],
                           present_shape_types=(False, True, False, False))
    jc, jtouch, _ = _jpair_contacts(jax_body(arrays), jnp.asarray(scene.pair_a),
                                    jnp.asarray(scene.pair_b), jnp.asarray(scene.pair_valid),
                                    config=cfg, blocked_wm=4)
    args = hard_cases.box_box_inputs(scene, "cpu")
    got = ka.box_box_rows(*args)
    pos, quat, prm = args[:3]
    a = torch.clamp(args[6], min=0).long()
    bb = torch.clamp(args[7], min=0).long()
    gap = ka.box_box(pos[a], quat[a], prm[a, :3], pos[bb], quat[bb], prm[bb, :3],
                     with_gap=True)[4].numpy()
    far = gap >= ATOL
    far4 = np.repeat(far, 4)
    want = {f: np.asarray(getattr(jc, f)) for f in ("a", "b", "point", "normal", "penetration",
                                                     "valid", "friction", "restitution", "key")}
    for i, f in ((0, "a"), (1, "b"), (7, "restitution"), (8, "key")):
        np.testing.assert_array_equal(got[i].numpy(), want[f], err_msg=f)
    np.testing.assert_allclose(got[6].numpy(), want["friction"], atol=1e-6, rtol=0)
    np.testing.assert_array_equal(got[5].numpy()[far4], want["valid"][far4])
    np.testing.assert_array_equal(got[9].numpy()[far], np.asarray(jtouch)[far])
    both = far4 & want["valid"] & got[5].numpy()
    for i, f in ((2, "point"), (3, "normal"), (4, "penetration")):
        np.testing.assert_allclose(got[i].numpy()[both], want[f][both], atol=ATOL, rtol=0,
                                   err_msg=f)
    # The cases are really there.
    valid_slots = scene.pair_valid.sum()
    if case in ("bias_ties", "margin_ties"):
        assert (~far).sum() >= 64, (~far).sum()
    elif case == "separated":
        assert not want["valid"].any()
    elif case == "warp_repeat":
        assert want["valid"].reshape(-1, 4).any(1).all()
    else:
        assert both.sum() > 0.3 * valid_slots
    if case == "ragged":
        assert scene.pair_a.shape[0] % 4 and (scene.pair_a < 0).sum() == 37
    if case == "full":
        assert scene.pair_a.shape[0] == hard_cases.BOX_BOX_FULL and valid_slots == 16384


def _position_reference(scene, args):
    pos, inv_mass, awake = (x.numpy() for x in args[:3])
    n = pos.shape[0]
    arrays = _body_arrays(n, pos=pos, inv_mass=inv_mass, awake=awake)

    def contacts(d, rows, a=None, b=None):
        z = np.zeros(rows, np.float32)
        return jnp_phase.Contacts(
            a=jnp.asarray(d["a"] if a is None else a), b=jnp.asarray(d["b"] if b is None else b),
            point=jnp.zeros((rows, 3)), normal=jnp.asarray(d["normal"]),
            penetration=jnp.asarray(d["penetration"]), valid=jnp.asarray(d["valid"]),
            friction=jnp.asarray(z), restitution=jnp.asarray(z),
            key=jnp.zeros(rows, jnp.int32))
    nk = n * scene.k
    st = contacts(scene.static, nk, a=np.repeat(np.arange(n, dtype=np.int32), scene.k),
                  b=np.full(nk, -1, np.int32))
    pr = contacts(scene.pair, scene.pair["a"].shape[0])
    params = jstate.default_sim_params().replace(contact_slop=jnp.float32(scene.slop))
    cfg = jstate.SimConfig(capacity=n, static_contacts_per_body=scene.k,
                           contacts_per_body=scene.cpb)
    return np.asarray(_jsolve_positions(jnp.asarray(pos), jax_body(arrays), st, pr,
                                        jnp.asarray(args[5].numpy()),
                                        jnp.asarray(args[6].numpy()), params, config=cfg,
                                        iters=scene.iters, beta=scene.beta, wm=scene.wm))


@pytest.mark.parametrize("case", hard_cases.POSITION_CASES)
def test_position_cases_twin_matches_reference(case):
    scene = hard_cases.position_scene(case)
    args, kw = hard_cases.position_inputs(scene, "cpu")
    got = ku.solve_positions(*args, **kw).numpy()
    want = _position_reference(scene, args)
    if scene.iters == 1:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    moved = np.abs(want - args[0].numpy()).max(axis=1) > 1e-4
    table = args[5].numpy()
    assert moved.sum() > 10
    if case == "asleep":
        assert not moved[~scene.awake].any()
    if case == "cpb_limit":
        assert (table[0] >= 0).all() and (table[10] >= 0).all()
    if case == "cpb40":
        assert (table[3] >= 0).all() and table.shape[1] == 40
    if case == "static_only":
        assert (table < 0).all()
    if case == "pairs_only":
        assert not scene.static["valid"].any()


# --- KA's and KU's CUDA branches, on meta tensors (no card needed).

def _meta(x):
    if isinstance(x, torch.Tensor):
        return torch.empty_like(x, device="meta")
    if isinstance(x, tuple):
        return tuple(_meta(y) for y in x)
    return x


@pytest.fixture
def recorded(monkeypatch):
    calls = []
    monkeypatch.setattr(build, "launch_packed", lambda name, args: calls.append((name, args)))
    monkeypatch.setattr(build, "stream", lambda: 0)
    monkeypatch.setattr(ka, "_plans", {})
    monkeypatch.setattr(ku, "_plans", {})
    return calls


@pytest.mark.parametrize("case", ["ragged", "warp_repeat"])
def test_box_box_plan_packs_and_checks(recorded, case):
    """One plan per (bodies, slots, device); the packed launch holds the 9
    inputs, the 10 outputs (new, or the caller's views) and the slot count;
    a bad argument raises before a launch."""
    scene = hard_cases.box_box_scene(case)
    args = [_meta(x) for x in hard_cases.box_box_inputs(scene, "cpu")]
    p = scene.pair_a.shape[0]
    out = ka.box_box_rows(*args)
    assert [tuple(o.shape) for o in out] == [(4 * p,), (4 * p,), (4 * p, 3), (4 * p, 3),
                                             (4 * p,), (4 * p,), (4 * p,), (4 * p,), (4 * p,),
                                             (p,)]
    name, packed = recorded[-1]
    v = ka._PACK.unpack(packed)
    assert name == "box_box_rows" and len(packed) == 20 * 8 and v[19] == p
    fields, touch = ka.contact_rows.contact_buffer(4 * p, p, "meta")
    views = tuple(fields) + (touch,)
    assert ka.box_box_rows(*args, out=views) == views
    assert len(ka._plans) == 1 and len(recorded) == 2
    bads = ((args[:6] + [args[6].float()] + args[7:], TypeError),
            (args[:1] + [args[1][:, :3]] + args[2:], ValueError),
            (args[:8] + [torch.empty(p + 1, dtype=torch.bool, device="meta")], ValueError),
            (args[:5] + [torch.empty(args[5].shape, dtype=torch.bool)] + args[6:], ValueError))
    for bad, exc in bads:
        with pytest.raises(exc):
            ka.box_box_rows(*bad)
    assert len(recorded) == 2


@pytest.mark.parametrize("case", ["wm4", "cpb40", "k8"])
def test_position_plan_packs_and_checks(recorded, case, monkeypatch):
    """One plan per (N, K, Q, WM, CPB, device); one packed launch a call
    (the kernel makes one launch an iteration), its output a tensor of its
    own and a scratch [N, 3] allocated only where an iteration lands
    outside it (iters > 1); a bad argument raises before a launch."""
    scene = hard_cases.position_scene(case)
    args, kw = hard_cases.position_inputs(scene, "cpu")
    args = [_meta(x) for x in args]
    n = scene.pos.shape[0]
    made, empty = [], torch.empty
    monkeypatch.setattr(torch, "empty", lambda *a, **k: made.append(tuple(a[0])) or empty(*a, **k))
    for iters in (1, 2, 3):
        del made[:]
        ku.solve_positions(*args, **dict(kw, iters=iters))
        assert made == [(n, 3)] * (1 if iters == 1 else 2), (iters, made)
    monkeypatch.setattr(torch, "empty", empty)
    del recorded[:]
    before = ku.launches
    out = ku.solve_positions(*args, **kw)
    assert tuple(out.shape) == (n, 3) and ku.launches == before + 1
    name, packed = recorded[-1]
    v = ku._PACK.unpack(packed)
    q = scene.pair["a"].shape[0] // scene.wm
    assert name == "solve_positions" and len(packed) == 23 * 8
    assert v[16:22] == (n, scene.k, q, scene.wm, scene.cpb, scene.iters) and v[22] == 0.25
    assert out._base is None
    ku.solve_positions(*args, **kw)
    assert len(ku._plans) == 1 and len(recorded) == 2
    st, pr = args[3], args[4]
    bads = ((args[:1] + [args[1].double()] + args[2:], TypeError),
            (args[:3] + [(st[0], st[1][:, :2], st[2])] + args[4:], ValueError),
            (args[:4] + [(pr[0].long(),) + pr[1:]] + args[5:], TypeError),
            (args[:5] + [args[5][:, :-1]] + args[6:], ValueError))
    for bad, exc in bads:
        with pytest.raises(exc):
            ku.solve_positions(*bad, **kw)
    with pytest.raises(ValueError):
        ku.solve_positions(*args, **dict(kw, wm=16))
    assert len(recorded) == 2
