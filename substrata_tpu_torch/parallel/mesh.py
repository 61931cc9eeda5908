"""The shard axis on one card, multi-world stepping and source-sharded
audio (K20a, K20b).

Counterpart of ``substrata_tpu/parallel/mesh.py``.  The reference shards a
leading axis of its state over a ``jax.sharding.Mesh`` and reduces across
devices with ``psum``.  The port keeps the leading axis on one card: its
``Mesh`` names the axes, their sizes and one ``torch.device``, each shard
is a contiguous slice of the leading axis, a Python loop over the shards
takes the place of the mesh's devices, and the ``psum``s are kernel KAE
(``kernels/shard_reduce.py``).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from substrata_tpu_torch.audio import mix as mixmod
from substrata_tpu_torch.device import resolve_device
from substrata_tpu_torch.kernels import shard_reduce
from substrata_tpu_torch.physics.state import (BODY_FIELDS, BodyState, SimConfig, SimParams,
                                               StaticWorld)
from substrata_tpu_torch.physics.step import physics_step


class Mesh:
    """Axis sizes and names over one device: ``Mesh((4,), ("worlds",))``
    or a 2-D ``Mesh((px, py), ("sx", "sy"))``.  The shards are raveled
    with the last axis fastest, as the reference's device mesh is."""

    def __init__(self, shape, axis_names, device=None):
        self.shape = tuple(int(s) for s in shape)
        self.axis_names = tuple(axis_names)
        if len(self.shape) != len(self.axis_names) or min(self.shape) < 1:
            raise ValueError(f"mesh shape {self.shape} vs axes {self.axis_names}")
        dev = resolve_device("cuda" if device is None else device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        self.device = dev

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    def stride(self, axis_name: str) -> int:
        """Shard-index step between neighbours along ``axis_name``."""
        i = self.axis_names.index(axis_name)
        return math.prod(self.shape[i + 1:])


def make_mesh(n_shards: int, axis: str = "worlds", *, device=None) -> Mesh:
    """A 1-D mesh of ``n_shards`` shards on the card (``device="cpu"`` on
    request); raises when CUDA is asked for and absent."""
    return Mesh((n_shards,), (axis,), device)


def _check_device(t: torch.Tensor, mesh: Mesh, what: str):
    if t.device != mesh.device:
        raise ValueError(f"{what} on {t.device}, the mesh on {mesh.device}")


def _body_at(states: BodyState, i) -> BodyState:
    return BodyState(**{f: getattr(states, f)[i] for f in BODY_FIELDS})


def multi_world_step(states: BodyState, world: StaticWorld, hull_cv, dt,
                     params: SimParams, config: SimConfig, mesh: Mesh):
    """Step W independent worlds, ``states`` a BodyState with a leading
    worlds axis [W, N, ...]; the static world and params are shared.
    ``hull_cv`` is the reference's ``hull_contact_verts`` argument: the
    port's step reads hull samples from ``world.hulls``, so it may be None.

    Each world takes the cold ``physics_step`` (no caches), as the
    reference's ``vmap`` does.  Returns (new_states [W, ...], total awake
    count) — the count by KAE over the worlds' ``num_awake``."""
    n_worlds = states.pos.shape[0]
    if n_worlds % mesh.size:
        raise ValueError(f"{n_worlds} worlds do not shard over {mesh.size}")
    _check_device(states.pos, mesh, "states")
    stepped, awake = [], []
    for w in range(n_worlds):
        nb, _events, diags = physics_step(_body_at(states, w), world, dt, params, config)
        stepped.append(nb)
        awake.append(diags.num_awake)
    new_states = BodyState(**{f: torch.stack([getattr(b, f) for b in stepped])
                              for f in BODY_FIELDS})
    return new_states, shard_reduce.world_count(awake)


def replicate_states(body: BodyState, n_worlds: int) -> BodyState:
    """Tile one world's BodyState into [W, ...] for multi-world stepping."""
    return BodyState(**{f: getattr(body, f)[None].expand(
        (n_worlds,) + tuple(getattr(body, f).shape)).contiguous() for f in BODY_FIELDS})


def sharded_mix_block(src: mixmod.SourceState, pool: torch.Tensor, listener: mixmod.Listener,
                      mesh: Mesh):
    """The audio downmix sharded over the source axis: every shard mixes
    its contiguous slice of the sources with the whole ``mix_block`` (its
    own clip included) against the shared sample pool, and KAE sums the
    stereo blocks in shard order and clips again, as the reference's psum
    and clip do.  ``src`` capacity must divide by the mesh size.

    Returns (new_src, mixed block [BLOCK, 2])."""
    n = mesh.size
    cap = src.capacity
    if cap % n:
        raise ValueError(f"{cap} sources do not shard over {n}")
    _check_device(src.pos, mesh, "sources")
    k = cap // n
    fields = [f.name for f in dataclasses.fields(src)]
    new, blocks = [], []
    for d in range(n):
        shard = mixmod.SourceState(**{f: getattr(src, f)[d * k:(d + 1) * k] for f in fields})
        new_d, out = mixmod.mix_block(shard, pool, listener)
        new.append(new_d)
        blocks.append(out)
    new_src = mixmod.SourceState(**{f: torch.cat([getattr(s, f) for s in new]) for f in fields})
    return new_src, shard_reduce.sum_clip(blocks)
