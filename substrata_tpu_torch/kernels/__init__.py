"""Hand-written Hopper kernels of the physics tick, the audio mix, the ray
queries, the particles, the vehicles, the character, the serving tick,
the hull contacts, the cell table, the solve setup, Winter scripts, the
pair finder, the compacted layout, the position solve and sleeping, the
terrain, the particle spawns and the avatars' pose, and their wrappers.

Each wrapper module holds the kernel's plain PyTorch twin beside it.  A
wrapper runs the twin for tensors on the CPU; for CUDA tensors it launches
the kernel or raises — it never falls back.  Each keeps a plain integer
count of its launches (``launch_counts``), so a run can show that the main
path went through the kernels.

  KA  box_box.py            csrc/box_box.cu          box-box manifolds
  KB  static_contacts.py    csrc/static_contacts.cu  heightfield + trimesh contacts
  KC  solve.py              csrc/solve_contacts.cu   contact-solve iteration
  KD  integrate_triton.py   (Triton)                 forces, integration
  KE  audio_mix.py          csrc/audio_mix.cu        audio fetch + resample
  KF  audio_mix.py          csrc/audio_mix.cu        low-pass, HRIR, gain ramps
  KG  audio_mix.py          csrc/audio_mix.cu        downmix + reverb
  KH  ray_trace.py          csrc/ray_trace.cu        ray trace (bodies, hulls, heightfield,
                                                     trimesh)
  KI  particles_triton.py   (Triton)                 particle update after the ray
  KJ  vehicles.py           csrc/vehicles.cu         vehicle force models
  KK  closed_forms.py       csrc/closed_forms.cu     sphere/box/capsule contacts
  KL  character.py          csrc/character.cu        the character update
  KM  serving_io.py         csrc/serving_io.cu       serving-tick input apply
  KN  serving_io.py         csrc/serving_io.cu       event digest + transform block
  KO  convex.py             csrc/convex.cu           hull (convex SAT) contacts
  KP  cell_table.py         csrc/cell_table.cu       broadphase cell table
  KQ  solve_setup.py        csrc/solve_setup.cu      contact-solve setup + cache refresh
  KR  winter.py             csrc/winter.cu           Winter script evaluation
  KS  pairs.py              csrc/pairs.cu            broadphase pair finding (+ margins)
  KT  layout.py             csrc/layout.cu           combo grouping, touching, contact
                                                     compaction, incidence table
  KU  positions.py          csrc/positions.cu        position solve
  KV  sleep.py              csrc/sleep.cu            strike wake, sleep pass
  KW  terrain.py            csrc/terrain.cu          terrain heights, chunk meshes
  KX  terrain.py            csrc/terrain.cu          vegetation scatter points
  KY  spawn.py              csrc/particles_spawn.cu  particle spawn scatter
  KZ  pose.py               csrc/pose.cu             skeletal pose of every avatar
  KAA audio_setup.py        csrc/audio_setup.cu      the mix's per-source setup + epilogue
  KAB vehicle_setup.py      csrc/vehicle_setup.cu    vehicle pre-ray setup + delta scatter
"""

from substrata_tpu_torch.kernels import (audio_mix, audio_setup, box_box, cell_table,
                                         character, closed_forms, convex, integrate_triton,
                                         layout, pairs, particles_triton, pose, positions,
                                         ray_trace, serving_io, sleep, solve, solve_setup, spawn,
                                         static_contacts, terrain, vehicle_setup, vehicles,
                                         winter)


def launch_counts() -> dict:
    return {
        "box_box_rows": box_box.launches,
        "static_contacts": static_contacts.launches,
        "solve_iteration": solve.launches,
        "apply_forces": integrate_triton.launches["apply_forces"],
        "integrate_positions": integrate_triton.launches["integrate_positions"],
        **audio_mix.launches,
        "ray_trace": ray_trace.launches,
        "particles_update": particles_triton.launches,
        "vehicle_forces": vehicles.launches,
        "closed_form_rows": closed_forms.launches,
        "character_update": character.launches,
        **serving_io.launches,
        "convex_rows": convex.launches,
        "cell_table": cell_table.launches,
        **solve_setup.launches,
        "winter_eval": winter.launches,
        "find_pairs": pairs.launches,
        **layout.launches,
        "solve_positions": positions.launches,
        **sleep.launches,
        **terrain.launches,
        "spawn_rows": spawn.launches,
        "pose_avatars": pose.launches,
        **audio_setup.launches,
        **vehicle_setup.launches,
    }


def reset_launch_counts():
    box_box.launches = 0
    static_contacts.launches = 0
    solve.launches = 0
    ray_trace.launches = 0
    particles_triton.launches = 0
    vehicles.launches = 0
    closed_forms.launches = 0
    character.launches = 0
    convex.launches = 0
    cell_table.launches = 0
    winter.launches = 0
    pairs.launches = 0
    positions.launches = 0
    spawn.launches = 0
    pose.launches = 0
    for counts in (integrate_triton.launches, audio_mix.launches, serving_io.launches,
                   solve_setup.launches, layout.launches, sleep.launches, terrain.launches,
                   audio_setup.launches, vehicle_setup.launches):
        for k in counts:
            counts[k] = 0
