"""The reductions over the shard axis (kernel KAE, three entry points).

Replaces the ``psum``s of K20 on one card: the awake and halo-overflow
counts and the ``[:L]`` slice of ``substrata_tpu/parallel/spatial.py:
spatial_world_step`` (:146) and ``spatial_world_step_2d`` (:263), the awake
count of ``parallel/mesh.py:multi_world_step`` (:29) and the stereo sum and
clip of ``sharded_mix_block`` (:63, :85-88).

- ``keep_count``: each stepped shard's first L rows into the sharded
  output state, awake & alive summed over them, the overflow counters
  summed; returns (state [S * L], int32 [2] = (awake, overflow)).
- ``world_count``: the sum of W int32 counts (the worlds' ``num_awake``).
- ``sum_clip``: clip(((b0 + b1) + b2) + ..., -1, 1) over the shards'
  blocks, in shard order in the kernel and the twin alike.

Each runs its plain twin for CPU tensors and its launch in
``csrc/shard_reduce.cu`` for CUDA ones.  CUDA C++ rather than Triton: the
keep reads a descriptor table of every shard's field pointers, which a
plain C launcher passes by value in one launch.
"""

from __future__ import annotations

import ctypes

import torch

from substrata_tpu_torch.kernels import build
from substrata_tpu_torch.kernels.halo import _host_ptrs, aligned, row_bytes
from substrata_tpu_torch.physics.state import BODY_FIELDS, BodyState

launches = {"shard_keep_count": 0, "shard_world_count": 0, "shard_sum_clip": 0}

ALIVE_F = BODY_FIELDS.index("alive")
AWAKE_F = BODY_FIELDS.index("awake")


def keep_count_plain(shards, keep: int, overflow: torch.Tensor):
    """The twin: ``shards`` is a list of stepped BodyStates."""
    out = BodyState(**{f: torch.cat([getattr(s, f)[:keep] for s in shards])
                       for f in BODY_FIELDS})
    awake = (out.awake & out.alive).sum().to(torch.int32)
    return out, torch.stack([awake, overflow.sum().to(torch.int32)])


def keep_count(shards, keep: int, overflow: torch.Tensor):
    """KAE (a): one launch for the kept rows of every shard and the two
    counts (awake, overflow) of the sharded step."""
    if shards[0].device.type == "cpu":
        return keep_count_plain(shards, keep, overflow)
    dev = shards[0].device
    ins = [[aligned(getattr(s, f)) for f in BODY_FIELDS] for s in shards]
    for row in ins:
        for f, t in zip(BODY_FIELDS, row):
            if t.device != dev or t.shape[0] < keep or t.dtype != ins[0][BODY_FIELDS.index(f)].dtype:
                raise ValueError(f"{f}: shape {tuple(t.shape)} {t.dtype} on {t.device}")
    ov = overflow.contiguous()
    build.check(ov, "overflow", torch.int32, tuple(ov.shape), dev)
    outs = [torch.empty((len(shards) * keep,) + tuple(t.shape[1:]), dtype=t.dtype, device=dev)
            for t in ins[0]]
    counts = torch.empty((2,), dtype=torch.int32, device=dev)
    build.launch("shard_keep_count", _host_ptrs([t for row in ins for t in row]),
                 _host_ptrs(outs), (ctypes.c_int * len(outs))(*[row_bytes(t) for t in outs]),
                 len(outs), len(shards), keep, ALIVE_F, AWAKE_F, ov, ov.numel(), counts)
    launches["shard_keep_count"] += 1
    return BodyState(**dict(zip(BODY_FIELDS, outs))), counts


def world_count_plain(counts):
    total = counts[0].to(torch.int32)
    for c in counts[1:]:
        total = total + c
    return total.to(torch.int32)


def world_count(counts):
    """KAE (b): the sum of the worlds' int32 counts (0-d tensors), one
    launch; returns a 0-d int32."""
    if counts[0].device.type == "cpu":
        return world_count_plain(counts)
    dev = counts[0].device
    for c in counts:
        build.check(c, "count", torch.int32, (), dev)
    out = torch.empty((), dtype=torch.int32, device=dev)
    build.launch("shard_world_count", _host_ptrs(counts), len(counts), out)
    launches["shard_world_count"] += 1
    return out


def sum_clip_plain(blocks):
    acc = blocks[0]
    for b in blocks[1:]:
        acc = acc + b
    return torch.clamp(acc, -1.0, 1.0)


def sum_clip(blocks):
    """KAE (c): clip(sum of the shards' float32 blocks in shard order,
    -1, 1), one launch."""
    if blocks[0].device.type == "cpu":
        return sum_clip_plain(blocks)
    dev = blocks[0].device
    shape = tuple(blocks[0].shape)
    blocks = [b.contiguous() for b in blocks]
    for b in blocks:
        build.check(b, "block", torch.float32, shape, dev)
    out = torch.empty(shape, dtype=torch.float32, device=dev)
    build.launch("shard_sum_clip", _host_ptrs(blocks), len(blocks), out.numel(), out)
    launches["shard_sum_clip"] += 1
    return out
