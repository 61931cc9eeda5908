"""substrata_tpu_torch's fused serving tick (PhysicsWorld.think_with_player:
the tick input apply of kernel KM, the character of KL, the step, the
digest and transform block of KN — their plain twins on the CPU) against
substrata_tpu's, and the tick-input and digest twins on their own.

Two worlds of 200 boxes, each with a walking player, transform writes
every tick and one teleport (a wake region):

- ``push``: 199 boxes resting apart and one 0.2 m box in the player's
  path, which the player's capsule proxy pushes along (capsule-box
  contacts, combo codes 6 and 9), 40 ticks.  Body positions and
  rotations and the character's packed vector within 1e-5, velocities
  within 5e-5 (measured: 4.2e-7, 1.3e-6, 1.8e-5 m/s and rad/s, with the
  solve's cross and dot products rounded as the jitted reference contracts
  them; 1.6e-6 and 3.9e-5 before, under a 1e-4 bound); the digest head
  (event slots, counts, touching pairs, steps_left) and the touched-body
  list exact.
- ``pile``: the bench's three resting layers (800 contacts), the player
  on open ground beside it, 30 ticks.  The digest head and the touched
  list exact, the packed vector within 1e-4; bodies and the transform
  block within 1e-3 m (the slice-1 bound of test_torch_step.py and
  test_torch_world.py: the solver's bf16 payloads and float32 summation
  order differ in the last bits, and 800 coupled contacts carry that from
  tick to tick — measured 3.7e-4 m), velocities within 1e-2 m/s and
  rad/s (measured 2.6e-3).

The pushed box is lower than the proxy's segment (its bottom end is
0.3 m above the foot): a box face beside the segment, parallel to it,
gives the capsule-box distance a flat minimum along the segment, where
the contact point is rounding's choice and two float32 implementations
part ways within ticks (tests/test_torch_closed_forms.py)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from substrata_tpu.physics import character as jchar
from substrata_tpu.physics import shapes as jshapes
from substrata_tpu.physics import state as jstate
from substrata_tpu.physics import world as jworld
from substrata_tpu_torch import PhysicsObject, PhysicsWorld, convert
from substrata_tpu_torch.kernels import serving_io as km
from substrata_tpu_torch.physics import character as tchar
from substrata_tpu_torch.physics import shapes
from substrata_tpu_torch.physics.state import SimConfig

from torch_port_helpers import FIELDS, body_np, box_world_arrays

torch.set_num_threads(2)

DT = 1.0 / 60.0
CFG = dict(capacity=256, max_pairs=1024, grid_dim=32, cell_size=1.4, cell_capacity=6,
           solver_iters=7, pairs_per_body=10, pair_rebuild_interval=6, contacts_per_body=8)
# scene: (ticks, positions and rotations, velocities, packed vector)
SCENES = {"push": (40, 1e-5, 5e-5, 1e-5), "pile": (30, 1e-3, 1e-2, 1e-4)}


def _build(world_cls, obj_cls, shp, player_cls, cfg, scene):
    """200 boxes and one player at eye height (see the module docstring)."""
    w = world_cls(cfg) if world_cls is jworld.PhysicsWorld else world_cls(cfg, device="cpu")
    w.set_ground_plane(0.0)
    rng = np.random.default_rng(0)
    obs = []

    def box(he, pos):
        obs.append(w.add_object(obj_cls(shape=shp.make_box([he, he, he]),
                                        pos=np.array(pos, np.float32), motion_type=2)))
    if scene == "push":
        box(0.1, [1.0, 0.0, 0.099])
        for n in range(199):
            box(0.4, [-3.0 - (n % 14) * 1.7 + rng.uniform(-0.1, 0.1),
                      (n // 14 - 7) * 1.7 + rng.uniform(-0.1, 0.1), 0.399])
        return w, obs, player_cls(w, eye_pos=(0.0, 0.0, 1.67))
    side = int(np.ceil((200 / 3) ** 0.5))
    for iz in range(3):
        for ix in range(side):
            for iy in range(side):
                if len(obs) < 200:
                    box(0.4, [(ix - side / 2) * 1.7 + rng.uniform(-0.15, 0.15),
                              (iy - side / 2) * 1.7 + rng.uniform(-0.15, 0.15),
                              0.39 + iz * 0.79])
    return w, obs, player_cls(w, eye_pos=(11.0, 0.0, 1.67))


def _script(w, obs, p, tick):
    """The tick's host writes: the player walks in a circle, three boxes
    are moved kinematically a little, and at tick 15 one is teleported out
    of the pile (its old place becomes a wake region)."""
    t = tick * DT
    p.process_move([np.cos(0.3 * t), np.sin(0.3 * t), 0.0])
    for k in (10, 20, 30):
        ob = obs[k]
        w.set_new_ob_to_world_transform(ob, np.asarray(ob.pos) + [0.002, 0.0, 0.0], ob.rot)
    if tick == 15:
        ob = obs[40]
        w.set_new_ob_to_world_transform(ob, np.asarray(ob.pos) + [0.0, 14.0, 0.0], ob.rot,
                                        linvel=[0.0, 0.0, 0.0], angvel=[0.0, 0.0, 0.0])


def _captured_reference(cfg, ticks, scene):
    w, obs, p = _build(jworld.PhysicsWorld, jworld.PhysicsObject, jshapes,
                       jchar.PlayerPhysics, jstate.SimConfig(**cfg), scene)
    seen = {}
    orig = w._dispatch_digest

    def capture(events, diags, rebuild, extra=None, on_extra=None, digest_dev=None):
        seen["digest"] = np.asarray(digest_dev)
        seen["packed"] = np.asarray(extra)
        return orig(events, diags, rebuild, extra, on_extra, digest_dev)
    w._dispatch_digest = capture
    out = []
    for tick in range(ticks):
        _script(w, obs, p, tick)
        w.think_with_player(DT, p, cur_time=tick * DT)
        out.append(dict(body=body_np(w.state), digest=seen["digest"], packed=seen["packed"],
                        tblock=np.asarray(w._pending_tblock)))
    return out


def _captured_port(cfg, ticks, scene):
    w, obs, p = _build(PhysicsWorld, PhysicsObject, shapes, tchar.PlayerPhysics,
                       SimConfig(**cfg), scene)
    seen = {}
    orig_digest, orig_packed = w._read_digest, p._consume_packed

    def digest(events, dig):
        seen["digest"] = np.array(dig)
        return orig_digest(events, dig)

    def packed(pk):
        seen["packed"] = np.array(pk)
        return orig_packed(pk)
    w._read_digest, p._consume_packed = digest, packed
    out = []
    for tick in range(ticks):
        _script(w, obs, p, tick)
        w.think_with_player(DT, p, cur_time=tick * DT)
        out.append(dict(body=body_np(w.state), digest=seen["digest"], packed=seen["packed"],
                        tblock=w._pending_tblock.numpy()))
    return out, w, p


def _compare(scene):
    """The scene's ticks on both worlds (both in the compacted contact
    layout: the capsule proxy makes the world mixed), compared tick by
    tick.  Returns (reference ticks, port world, player)."""
    ticks, tol_pos, tol_vel, tol_packed = SCENES[scene]
    ref = _captured_reference(CFG, ticks, scene)
    port, w, p = _captured_port(CFG, ticks, scene)
    head = km.DIGEST_HEAD
    for t, (r, q) in enumerate(zip(ref, port)):
        msg = f"{scene}, tick {t}"
        for f, tol in (("pos", tol_pos), ("quat", tol_pos), ("linvel", tol_vel),
                       ("angvel", tol_vel)):
            np.testing.assert_allclose(q["body"][f], r["body"][f], atol=tol,
                                       err_msg=f"{msg}: {f}")
        for f in ("awake", "alive", "underwater"):
            np.testing.assert_array_equal(q["body"][f], r["body"][f], err_msg=f"{msg}: {f}")
        np.testing.assert_array_equal(q["digest"][:head], r["digest"], err_msg=msg)
        np.testing.assert_allclose(q["packed"][:15], r["packed"][:15], atol=tol_packed,
                                   err_msg=msg)
        np.testing.assert_array_equal(q["packed"][15:], r["packed"][15:], err_msg=msg)
        np.testing.assert_allclose(q["tblock"][:, :7], r["tblock"][:, :7], atol=tol_pos,
                                   err_msg=msg)
        np.testing.assert_allclose(q["tblock"][:, 7:], r["tblock"][:, 7:], atol=tol_vel,
                                   err_msg=msg)
    return ref, w, p


def test_think_with_player_tracks_reference():
    """The pile: 30 serving ticks against the JAX world's fused tick."""
    ref, w, p = _compare("pile")
    # The player walked on the ground; the pile has pairs and contacts.
    assert p.on_ground and np.linalg.norm(p.get_eye_position()[:2] - [11.0, 0.0]) > 0.5
    assert int(ref[-1]["digest"][196]) > 0 and int(ref[-1]["digest"][198]) > 0


def test_think_with_player_pushes_a_box_like_the_reference():
    """The push: 40 serving ticks against the JAX world's fused tick, at
    the module docstring's bounds; the proxy touches the box on several
    ticks and pushes it along."""
    ref, w, p = _compare("push")
    proxy = p.proxy.slot
    touching = 0
    for r in ref:
        d = r["digest"]
        pairs = d[200:200 + 2 * min(int(d[195]), km.EVT)].reshape(-1, 2)
        touching += bool((pairs == proxy).any())
    assert touching >= 8, touching
    assert float(w.state.pos[0, 0]) > 1.2, w.state.pos[0]


def _tick_in_case(seed, n=256):
    """A body state and a tick input with 100 writes (velocities on every
    other one) and 5 wake regions, the rest padding."""
    rng = np.random.default_rng(seed)
    a = box_world_arrays(n, 200, seed, speed=1.0)
    a["awake"][:] = rng.random(n) < 0.3
    a["sleep_timer"][:] = rng.uniform(0, 1, n).astype(np.float32)
    buf = km.empty_tick_in(n)
    slots = rng.permutation(n)[:100]
    idx = buf[km.O_IDX:km.O_POS].view(np.int32)
    idx[:100] = slots
    buf[km.O_POS:km.O_VOK] = rng.normal(size=km.O_VOK - km.O_POS).astype(np.float32)
    buf[km.O_VOK:km.O_VOK + 100] = np.arange(100) % 2
    buf[km.O_CTR:km.O_CTR + 15] = rng.uniform(-8, 8, 15)
    buf[km.O_RAD:km.O_RAD + 5] = rng.uniform(0.5, 2.0, 5)
    return a, buf


@pytest.mark.parametrize("padded", [True, False])
def test_apply_tick_in_matches_reference(padded):
    """KM's twin against ``_apply_transforms_wake``, eager and jitted, on
    100 writes and 5 regions: exact.  With padding (the reference's -1e9 radius) every
    dynamic body wakes; with all 64 regions real only those near a region
    do."""
    a, buf = _tick_in_case(3)
    if not padded:
        rng = np.random.default_rng(9)
        buf[km.O_CTR:km.O_RAD] = rng.uniform(-30, -20, 3 * km.TIN_R)
        buf[km.O_RAD:] = 0.5
        buf[km.O_CTR:km.O_CTR + 15] = rng.uniform(-8, 8, 15)
    b = jstate.BodyState(**{k: jnp.asarray(a[k]) for k in FIELDS})
    j = jnp.asarray(buf)
    import jax
    ref = jworld._apply_transforms_wake(
        b, jax.lax.bitcast_convert_type(j[km.O_IDX:km.O_POS], jnp.int32),
        j[km.O_POS:km.O_ROT].reshape(-1, 3), j[km.O_ROT:km.O_LV].reshape(-1, 4),
        j[km.O_LV:km.O_AV].reshape(-1, 3), j[km.O_AV:km.O_VOK].reshape(-1, 3),
        j[km.O_VOK:km.O_CTR] > 0, j[km.O_CTR:km.O_RAD].reshape(-1, 3), j[km.O_RAD:])
    got = km.apply_tick_in(convert.body_state_from_numpy(a, device="cpu"), torch.as_tensor(buf))
    for f in km.STATE_OUT:
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(ref, f)), f)
    # And the jitted form, the one the reference runs (its region test's
    # sum of squares contracted into fmas: tests/test_torch_tickin_fetch.py).
    jit = jworld._scatter_transforms_wake(
        jstate.BodyState(**{k: jnp.asarray(a[k]) for k in FIELDS}),
        jax.lax.bitcast_convert_type(j[km.O_IDX:km.O_POS], jnp.int32),
        j[km.O_POS:km.O_ROT].reshape(-1, 3), j[km.O_ROT:km.O_LV].reshape(-1, 4),
        j[km.O_LV:km.O_AV].reshape(-1, 3), j[km.O_AV:km.O_VOK].reshape(-1, 3),
        j[km.O_VOK:km.O_CTR] > 0, j[km.O_CTR:km.O_RAD].reshape(-1, 3), j[km.O_RAD:])
    for f in km.STATE_OUT:
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(jit, f)), f)
    awake = got.awake.numpy()
    assert awake[:200].all() == padded and awake.any()


def test_digest_tblock_matches_reference():
    """KN's twin against ``_digest_core`` and ``_tblock_core`` on a real
    step's events of a 200-box pile, and with overflowing classes (more
    than 64 wakes, more than 128 touching pairs): the digest head is the
    reference's exactly, and the bit-packed masks unpack to the events."""
    from substrata_tpu_torch.physics.step import StepEvents
    rng = np.random.default_rng(4)
    n, p = 256, 1024
    ev = StepEvents(
        contact_pair_a=torch.as_tensor(rng.integers(-1, n, p).astype(np.int32)),
        contact_pair_b=torch.as_tensor(rng.integers(-1, n, p).astype(np.int32)),
        contact_touching=torch.as_tensor(rng.random(p) < 0.3),
        newly_awake=torch.as_tensor(rng.random(n) < 0.4),
        newly_asleep=torch.as_tensor(rng.random(n) < 0.1),
        entered_water=torch.as_tensor(rng.random(n) < 0.02),
        num_pairs=torch.tensor(700, dtype=torch.int32),
        broadphase_overflow=torch.tensor(3, dtype=torch.int32))
    a = box_world_arrays(n, 200, 5, speed=1.0)
    a["underwater"][:] = rng.random(n) < 0.5
    st = convert.body_state_from_numpy(a, device="cpu")
    nc, na, sl = (torch.tensor(v, dtype=torch.int32) for v in (1234, 180, 4))
    dig, blk = km.digest_tblock(ev, nc, na, sl, st)
    dig_only, none = km.digest_tblock(ev, nc, na, sl, st, with_block=False)
    assert none is None and torch.equal(dig_only, dig)
    jev = type("E", (), {k: jnp.asarray(getattr(ev, k).numpy()) for k in (
        "contact_pair_a", "contact_pair_b", "contact_touching", "newly_awake", "newly_asleep",
        "entered_water", "num_pairs", "broadphase_overflow")})
    ref = np.asarray(jworld._digest_core(jev, jnp.int32(1234), jnp.int32(180), jnp.int32(4)))
    dig = dig.numpy()
    np.testing.assert_array_equal(dig[:km.DIGEST_HEAD], ref)
    words = (n + 31) // 32
    masks = dig[km.DIGEST_HEAD:]
    for i, f in enumerate(("newly_awake", "newly_asleep", "entered_water")):
        np.testing.assert_array_equal(km.unpack_bits(masks[i * words:(i + 1) * words], n),
                                      getattr(ev, f).numpy())
    jb = jstate.BodyState(**{k: jnp.asarray(a[k]) for k in FIELDS})
    np.testing.assert_array_equal(blk.numpy(), np.asarray(jworld._tblock_core(jb)))
