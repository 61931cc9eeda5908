"""What the parent-vs-change bench scripts (``bench_*.py`` beside this
file) share: the port loaded from ``--root`` with the helpers of this
checkout, the cases' inputs and outputs saved for ``--against``, the tick
phases of ``chip_smoke.py`` with the launch counts a script reads, and the
one JSON line each script ends with.

A script runs as ``python3 substrata_tpu_torch/bench_<name>.py --root DIR
--tag NAME ...``, which puts this directory first on ``sys.path``: the
scripts import this module by its bare name, so it comes from this
checkout whichever port ``--root`` names.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
OUT_DIR = os.path.join(REPO, "chiprun_out")
DT = 1.0 / 60.0

# chip_smoke's tick phases: name -> (function, its median's key, its p90's).
PHASES = {"think": ("main_path_phase", "ms_per_think_median", "ms_per_think_p90"),
          "full_tick": ("full_tick_phase", "ms_per_tick_median", "ms_per_tick_p90"),
          "serving": ("serving_phase", "ms_per_serving_tick_median",
                      "ms_per_serving_tick_p90"),
          "mesh": ("mesh_phase", "ms_per_mesh_tick_median", "ms_per_mesh_tick_p90"),
          "client": ("client_phase", "ms_per_client_frame_median",
                     "ms_per_client_frame_p90"),
          "networked": ("networked_phase", "ms_per_tick_p50", "ms_per_tick_p90"),
          "terrain": ("terrain_phase", "ms_per_terrain_tick_median",
                      "ms_per_terrain_tick_p90"),
          # Phase 23's spatial steps (the bench world in 4 slabs; in 2 x 2
          # tiles): one run of sharded_phase serves both.
          "slabs": ("sharded_phase", "slabs.ms_per_step_median", "slabs.ms_per_step_p90"),
          "tiles": ("sharded_phase", "tiles.ms_per_step_median", "tiles.ms_per_step_p90")}
# Arguments a bench gives a phase: phase 23's CPU comparisons held to one
# step and its mix to 10 blocks (the timed steps are chip_smoke's).
PHASE_KW = {"sharded_phase": dict(cpu_steps=1, cpu_drift_steps=1, mix_blocks=10)}


def load(name, path):
    """The module at ``path``, registered as ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def start(script, against=False, ticks=None, flags=()):
    """Parse the common arguments (``--root``, ``--tag``; ``--against`` if
    ``against``; ``--no-ticks``, ``--ticks-only`` and ``--phases`` if the
    script runs the tick phases ``ticks``; each of ``flags`` on or off)
    and, with a card, load chip_smoke's helpers from this checkout and put
    the port under ``--root`` first on the path.  Returns (args, helpers),
    or exits with 2 without a card."""
    ap = argparse.ArgumentParser(prog=script)
    ap.add_argument("--root", default=REPO)
    ap.add_argument("--tag", default="this")
    if against:
        ap.add_argument("--against", default=None)
    if ticks:
        ap.add_argument("--no-ticks", action="store_true")
        ap.add_argument("--ticks-only", action="store_true")
        ap.add_argument("--phases", default=",".join(ticks),
                        help=f"tick phases to run, of {', '.join(PHASES)}")
    for flag in flags:
        ap.add_argument(flag, action="store_true")
    args = ap.parse_args()
    args.root = os.path.abspath(args.root)
    import torch
    if not torch.cuda.is_available():
        print(f"{script}: no CUDA device", file=sys.stderr)
        sys.exit(2)
    cs = load("chip_smoke_helpers", os.path.join(REPO, "chip_smoke.py"))
    sys.path.insert(0, args.root)
    return args, cs


def check_root(mod, root):
    """Raise unless ``mod`` came from the port under ``root``."""
    if not mod.__file__.startswith(root + os.sep):
        raise RuntimeError(f"imported {mod.__file__}, not the port under {root}")


def hard_cases():
    """This checkout's ``kernels/hard_cases.py`` (a parent's may lack the
    newest cases)."""
    return load("hard_cases_here", os.path.join(HERE, "kernels", "hard_cases.py"))


def header(args, cs):
    import torch
    return dict(tag=args.tag, root=args.root, nvidia_smi=cs.nvidia_smi_line(),
                device=torch.cuda.get_device_name(0))


def finish(script, out, tag):
    """Print ``out`` as one JSON line and write it to
    chiprun_out/<script>_<tag>.json; returns 0."""
    line = json.dumps(out)
    print(line, flush=True)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, f"{script}_{tag}.json"), "w") as fh:
        fh.write(line + "\n")
    return 0


def bits(t):
    """A float tensor's words as int32, to compare bit for bit."""
    import torch
    return t.view(torch.int32) if t.is_floating_point() else t


def to_cpu(x):
    import torch
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    if isinstance(x, (tuple, list)):
        return type(x)(to_cpu(y) for y in x)
    return x


def to_cuda(x):
    import torch
    if isinstance(x, torch.Tensor):
        return x.cuda()
    if isinstance(x, (tuple, list)):
        return type(x)(to_cuda(y) for y in x)
    if isinstance(x, dict):
        return {k: to_cuda(y) for k, y in x.items()}
    return x


def clone(x):
    import torch
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, tuple):
        return tuple(clone(y) for y in x)
    return x


def kf_args(ka, sargs, epilogue):
    """KF's arguments for the port's ``audio_mix`` module ``ka``: ``sargs``
    with the mix's epilogue tuple last where KF carries the epilogue
    (its ``audio_spatialise`` takes ``epilogue``), ``sargs`` alone on a
    port from before that."""
    import inspect
    if "epilogue" in inspect.signature(ka.audio_spatialise).parameters:
        return tuple(sargs) + (tuple(epilogue),)
    return tuple(sargs)


def captured(mod, name, run):
    """The arguments (positional, keyword) of every call of ``mod.name``
    that ``run()`` makes, cloned before the call."""
    got = []
    real = getattr(mod, name)

    def capture(*a, **kw):
        got.append((clone(a), {k: clone(v) for k, v in kw.items() if k != "out"}))
        return real(*a, **kw)
    setattr(mod, name, capture)
    try:
        run()
    finally:
        setattr(mod, name, real)
    return got


def row_diffs(names, got, saved, **tags):
    """[{output, rows, first_rows, **tags}] for each output of ``got`` whose
    rows differ from ``saved``'s in any bit."""
    d = []
    for name, x, y in zip(names, got, saved):
        ne = bits(x).cpu() != bits(y)
        if ne.dim() > 1:
            ne = ne.any(dim=1)
        if bool(ne.any()):
            d.append(dict(**tags, output=name, rows=int(ne.sum()),
                          first_rows=ne.nonzero()[:8, 0].tolist()))
    return d


def save_cases(saved, stem, tag):
    import torch
    os.makedirs(OUT_DIR, exist_ok=True)
    torch.save(saved, os.path.join(OUT_DIR, f"{stem}_{tag}.pt"))


def load_cases(stem, tag):
    import torch
    return torch.load(os.path.join(OUT_DIR, f"{stem}_{tag}.pt"))


def ticks(cs, out, phases, counters):
    """Run chip_smoke's ``phases`` (names of ``PHASES``) and record each
    one's median and p90 ms, the launches of ``counters`` ({key in the
    record: launch counter}) and, where the phase reports them, its last
    tick's pairs, contacts and awake bodies, its bodies thrown, the card's
    idle share and ``think``'s mean host ms: what a tick's cost follows
    when two ports' trajectories part."""
    runs = {}
    for name in phases:
        fn, median, p90 = PHASES[name]
        if fn not in runs:
            runs[fn] = getattr(cs, fn)(**PHASE_KW.get(fn, {}))
        r = runs[fn]
        # A key "run.key" reads that run's record of the phase's result.
        if "." in median:
            r = r[median.split(".")[0]]
            median, p90 = median.split(".")[1], p90.split(".")[1]
        out[name] = dict(ms_median=r[median], ms_p90=r[p90],
                         **{f"{k}_launches": r["launches"][c] for k, c in counters.items()},
                         **{k: r[k] for k in ("pairs", "contacts", "awake", "dynamic_thrown",
                                                   "device_idle_share") if k in r})
        if "think" in r.get("phase_ms_mean", {}):
            out[name]["think_ms_mean"] = r["phase_ms_mean"]["think"]
