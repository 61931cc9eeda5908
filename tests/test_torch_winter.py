"""substrata_tpu_torch.scripting (Winter, K16) against substrata_tpu.scripting.

The same seeded numpy inputs (time in +-100 s, instance indices in
[0, 512)) go through the reference's JITTED evaluation (``jax.jit`` of
both hooks, as ``ObjectScriptsEvaluator._get_jitted`` runs them, and the
``ObjectScriptsEvaluator`` itself) and through the port's twin of kernel
KR (``kernels/winter.py``) on the CPU.  Tolerances:

- exact (bit for bit) for arithmetic, division, multiply-add, selects,
  comparisons, int ops, conversions, vectors, structs, ``let``, ``if``
  and user functions: the lowering repeats XLA's rounding
  (``scripting/lower.py``);
- within 4 ulp (2 measured) for the transcendentals, ``sqrt``, ``pow``
  and what ``length``/``normalise`` take from ``sqrt``: XLA's CPU
  functions are not torch's;
- ``noise``/``fbm``: h(k) = (sin(k 127.1 + 311.7) 43758.5453 mod 2) - 1.
  A sin that differs by a few ulp moves the product by at most 2 of its
  own ulp (at most 2 x 2^-8 = 0.0078 below 65,536), mod 2 is exact, and
  the blend and the octave weights (sum < 1) shrink it: |diff| <= 0.0079
  unless the product crosses a multiple of 2 there, which moves h by about
  2 (a "wrap").  The wraps are counted, reported and held under 1% of the
  values; the inputs are the same random times as everywhere else.

One difference is left in the lowering on purpose and kept out of the
exact corpus: an expensive expression that appears in BOTH hooks is
materialised once by XLA, which then rounds its multiply-adds by another
operand order (a few ulp).  Each script here gives each output its own
expression, as bench.py's do."""

import pathlib
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from substrata_tpu.scripting.winter import ObjectScriptsEvaluator as JObjects
from substrata_tpu.scripting.winter import WinterParseError as JParseError
from substrata_tpu.scripting.winter import WinterScriptEvaluator as JScript
from substrata_tpu_torch.scripting import (ObjectScriptsEvaluator, WinterParseError,
                                           WinterScriptEvaluator)
from substrata_tpu_torch.scripting.lower import OPS

torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parents[1]
B = 4096
HOOKS = ("def evalRotation(float time, WinterEnv env) vec3 : {}\n"
         "def evalTranslation(float time, WinterEnv env) vec3 : {}")
_rng = np.random.default_rng(0)
TIME = _rng.uniform(-100.0, 100.0, B).astype(np.float32)
IDX = _rng.integers(0, 512, B).astype(np.int32)
NINST = np.full(B, 512, np.int32)


def _reference(src, t=TIME, idx=IDX, n=NINST):
    ev = JScript(src)

    @jax.jit
    def run(t, i, n):
        return ev.eval_rotation(t, i, n), ev.eval_translation(t, i, n)
    r, tr = run(jnp.asarray(t), jnp.asarray(idx), jnp.asarray(n))
    return np.concatenate([np.asarray(r), np.asarray(tr)], axis=1)


def _port(src, t=TIME, idx=IDX, n=NINST):
    ev = WinterScriptEvaluator(src, device="cpu")
    return ev.evaluate(torch.as_tensor(t), torch.as_tensor(idx), torch.as_tensor(n)).numpy()


def ulps(a, b):
    """Distance in float32 units in the last place (NaN == NaN)."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    ia, ib = (x.view(np.int32).astype(np.int64) for x in (a, b))
    ia = np.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = np.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    same = (a == b) | (np.isnan(a) & np.isnan(b))
    return np.where(same, 0, np.abs(ia - ib))


def _vec(*e):
    return "vec3({})".format(", ".join(e))


# name: (rotation, translation); every output its own expression.
EXACT = {
    "bench_rotation": (_vec("0.0", "0.0", "time * 0.5 + env.instance_index"), _vec("0.0")),
    "mul_add": (_vec("time * 0.3 + 0.7", "time * 0.3 - 0.7", "0.7 - time * 0.3"),
                _vec("time * 0.3 + time * 0.2", "time * 0.3 - time * 0.2",
                     "(time + 1.0) * (time - 2.0) + time / 3.0")),
    "division": (_vec("time / 1.4", "toFloat(env.instance_index) / 3.0 + time",
                      "env.instance_index / env.num_instances"),
                 _vec("(time + 1.0) / (time - 1.0)", "time / (1.0 / 3.0)", "recip(time)")),
    "reassociation": (_vec("time * 0.3 * 2.0 + 1.0", "(time + 0.3) + 2.0", "(time - 0.3) + 2.0"),
                      _vec("time * (0.1 + 0.2)", "lerp(1.0, 5.0, time * 0.01)",
                           "(time * 3.0) / 2.0")),
    "shared_products": (_vec("let a = time * 0.3 in (a + 1.0) * (a + 2.0)",
                             "(time * 0.3 + 1.0) * (time * 0.3 + 2.0)",
                             "(time + 1.0) * time + time * 0.3"),
                        _vec("time * 0.3 + (time + 1.0) * (time - 2.0)",
                             "(time + 1.0) * 0.5 + (time - 2.0) * 0.3",
                             "(time + 1.0) * (time - 2.0) - time * 0.3")),
    "modulo_rounding": (_vec("time % 3.0", "mod(time, -2.5)", "fract(time * 0.37)"),
                        _vec("toFloat(env.instance_index % 7)",
                             "floor(time) + ceil(time * 0.5)",
                             "toFloat(truncateToInt(time)) + toFloat(floorToInt(time)) * 0.5"
                             " + toFloat(ceilToInt(time)) * 0.25")),
    "select_compare": (_vec("min(time, 3.0) + max(time, -2.0)", "clamp(time * 0.1, -1.0, 1.0)",
                            "step(0.0, time)"),
                       _vec("if(time > 1.0 && time < 30.0, time * 2.0, 0.0 - 1.0)",
                            "if(time > 0.0 || env.instance_index > 100, time * 0.3 + 1.0, "
                            "time * 0.2 - 1.0)",
                            "pulse(-10.0, 10.0, time)")),
    "smooth": (_vec("smoothstep(-50.0, 50.0, time)", "smootherstep(-50.0, 50.0, time)",
                    "pow(time, 2)"),
               _vec("pow(time, 3) + 1.0", "neg(time) + pi() * time",
                    "toFloat(toInt(time * 3.0))")),
    "logic_names": (_vec("toFloat(not(time > 0.0)) + toFloat(xor(time > 0.0, "
                         "env.instance_index > 3))",
                         "toFloat(lt(time, 1.0)) + toFloat(gte(time, 2.0))",
                         "toFloat(eq(env.instance_index, 5)) + toFloat(neq(time, 1.0))"),
                    _vec("add(time, 1.0) * sub(time, 2.0) + div(time, 3.0)",
                         "mul(time, 0.25) + toFloat(and(true, time > 0.0))",
                         "toFloat(or(false, env.instance_index < 7)) + toFloat(lte(time, 0.0))"
                         " + toFloat(gt(time, 5.0))")),
    "vectors": (_vec("dot(vec3(time, 1.0, 2.0), vec3(0.3, time, 0.7))",
                     "length2(vec2(time, 3.0)) + 1.0",
                     "x(cross(vec3(time, 1.0, 2.0), vec3(0.3, time, 0.7)))"),
                "(vec3(time * 0.3 + 1.0, 2.0, time) * 2.0 + vec3(1.0)) / 3.0"),
    "components": ("[time, time * 2.0, env.instance_index]v",
                   _vec("vec3(time, 1.0, 2.0)[1] + vec3(time, 4.0, 5.0)[-1]",
                        "e1(vec4(time, time + 1.0, 2.0, 3.0)) + w(vec4(time))",
                        "y(vec2(time * 0.5, time * 0.25)) + vec2(time, 1.0).x")),
    "nan_paths": (_vec("vec3(time, 4.0, 5.0)[3]", "vec3(time, 4.0, 5.0)[-4]",
                       "if(time > 0.0, time, sqrt(0.0 - 1.0 - time * time))"),
                  _vec("min(time, 0.0 / 0.0)", "max(0.0 / 0.0, time)",
                       "toFloat(toInt(time / 0.0))")),
    "vector_compare": (_vec("toFloat(vec2(time, 1.0) == vec2(time, 1.0))",
                            "toFloat(vec2(time, 1.0) != vec2(1.0, time))",
                            "e2(-vec3(time, 1.0, 2.0))"),
                       "vec2(time, 2.0) - 1.0"),
}

TRANSCENDENTAL = {
    "trig": (_vec("sin(time) * 2.0", "cos(time * 0.7) * 2.0", "tan(time * 0.01)"),
             _vec("asin(time * 0.009)", "acos(time * 0.009)", "atan(time)")),
    "exp_log": (_vec("exp(time * 0.01)", "log(abs(time) + 1.0)", "sqrt(abs(time))"),
                _vec("pow(abs(time), 1.5)", "atan2(time, 3.0)", "length(vec3(time, 1.0, 2.0))")),
    "normalise": (_vec("z(normalise(vec3(time, 1.0, 2.0)))",
                       "dist(vec3(time, 0.0, 0.0), vec3(1.0, 2.0, 3.0))",
                       "sin(time * 0.01) * cos(time * 0.02) + 1.0"),
                  "normalise(vec3(time, env.instance_index, 1.0))"),
}

NOISE = {
    "noise": (_vec("noise(time)", "noise01(time * 0.1)", "noise(time * 0.1)"),
              _vec("noise(vec2(time, time * 0.5))",
                   "noise(vec3(time, 1.0, toFloat(env.instance_index)))", "0.0")),
    "fbm": (_vec("fbm(time * 0.1, 3)", "fbm(time * 0.1, env.num_instances)", "0.0"),
            _vec("fbm(vec2(time * 0.05, 1.0), 2)", "0.0", "0.0")),
}

NOISE_BOUND = 2.0 * 2.0 ** -8 * 1.01      # two ulp of |s 43758.5| < 65,536


@pytest.mark.parametrize("name", list(EXACT))
def test_exact_corpus_matches_jitted_reference(name):
    src = HOOKS.format(*EXACT[name])
    ref, got = _reference(src), _port(src)
    d = ulps(ref, got)
    assert d.max() == 0, (name, int((d > 0).sum()), np.nonzero(d.max(axis=0))[0].tolist())


@pytest.mark.parametrize("name", list(TRANSCENDENTAL))
def test_transcendentals_within_ulps(name):
    src = HOOKS.format(*TRANSCENDENTAL[name])
    ref, got = _reference(src), _port(src)
    assert ulps(ref, got).max() <= 4
    assert np.isfinite(ref).all()


@pytest.mark.parametrize("name", list(NOISE))
def test_noise_within_its_bound(name):
    src = HOOKS.format(*NOISE[name])
    ref, got = _reference(src), _port(src)
    diff = np.abs(ref - got)
    wraps = diff > NOISE_BOUND
    print(f"{name}: {int(wraps.sum())} wraps of {diff.size} values, "
          f"largest other difference {float(diff[~wraps].max()):.3g}")
    assert wraps.mean() < 0.01
    # A wrap moves h by about 2, weighted by the blend (and octave) factor.
    assert np.all(diff[wraps] <= 2.0 + NOISE_BOUND)


@pytest.mark.parametrize("t", [0.0, 0.5, 1.0 / 60.0, 3.7, 123.456, 1.75, 9.9])
def test_bench_scripts_match_jitted_reference(t):
    """bench.py:192-207: two sources, 256 float32 instance indices each,
    num_instances 512; the rotation exactly, the translation (sin, cos)
    within 1 ulp."""
    widx = np.arange(256, dtype=np.float32)
    tt = np.full(256, np.float32(t), np.float32)
    for src in ("def evalRotation(float time, WinterEnv env) vec3 : "
                "vec3(0.0, 0.0, time * 0.5 + env.instance_index)",
                "def evalTranslation(float time, WinterEnv env) vec3 : "
                "vec3(sin(time) * 2.0, cos(time * 0.7) * 2.0, 0.0)"):
        ev = JScript(src)
        ref = np.concatenate([np.asarray(x) for x in jax.jit(
            lambda t, i: (ev.eval_rotation(t, i, 512), ev.eval_translation(t, i, 512)))(
                jnp.asarray(tt), jnp.asarray(widx))], axis=1)
        got = WinterScriptEvaluator(src, device="cpu").evaluate(
            torch.as_tensor(tt), torch.as_tensor(widx), 512).numpy()
        np.testing.assert_array_equal(got[:, :3], ref[:, :3])
        np.testing.assert_array_max_ulp(got[:, 3:], ref[:, 3:], maxulp=1)


# ---- the scenarios of tests/test_scripting.py:19-91, on both packages

SCENARIOS = {
    "rotation": ("def evalRotation(float time, WinterEnv env) vec3 : vec3(0.0, 0.0, time * 0.5)",
                 dict(time=2.0), [0, 0, 1.0, 0, 0, 0]),
    "translation": ("def evalTranslation(float time, WinterEnv env) vec3 : "
                    "vec3(0.0, 0.0, sin(time) * 2.0)", dict(time=np.pi / 2), [0, 0, 0, 0, 0, 2.0]),
    "bracket_literal_env": ("def evalRotation(float time, WinterEnv env) vec3 : "
                            "[0.0, 0.0, time + env.instance_index * 0.1]vec3",
                            dict(time=1.0, instance_index=3.0), [0, 0, 1.3, 0, 0, 0]),
    "let_and_user_defs": ("""
def wave(float x) float : sin(x * 3.0) * 4.0
def evalTranslation(float time, WinterEnv env) vec3 :
    let
        i = toFloat(env.instance_index)
        ifactor = i * 0.1
        timefactor = time * 0.3
    in
        vec3(wave(timefactor + ifactor), 0.0, sin((timefactor + ifactor) * 2.0) * 4.0)
""", dict(time=1.0, instance_index=2), None),
    "if_comparisons": ("def evalRotation(float time, WinterEnv env) vec3 : "
                       "vec3(if(time > 1.0 && time < 3.0, time * 2.0, 0.0 - 1.0), 0.0, 0.0)",
                       dict(time=2.0), [4.0, 0, 0, 0, 0, 0]),
    "vector_ops": ("""
def evalTranslation(float time, WinterEnv env) vec3 :
    let
        p = vec3(3.0, 4.0, 0.0)
        n = normalise(p)
    in
        vec3(length(p), dot(n, n), cross(vec3(1.0, 0.0, 0.0), vec3(0.0, 1.0, 0.0)).z) * time
""", dict(time=2.0), [0, 0, 0, 10.0, 2.0, 2.0]),
    "struct": ("""
struct Params { real amp, real freq }
def mk() Params : Params(2.0, 3.0)
def evalRotation(float time, WinterEnv env) vec3 :
    let p = mk() in vec3(0.0, 0.0, sin(time * p.freq) * p.amp)
""", dict(time=0.5), [0, 0, np.sin(1.5) * 2.0, 0, 0, 0]),
    "overloads_and_nesting": ("""
def f(float x) float : x * 2.0 + 1.0
def f(float x, float y) float : f(x) * y
def g(vec3 v) vec3 : v * f(1.0, 2.0)
def evalRotation(float time, WinterEnv env) vec3 : g(vec3(time, f(time), f(time, time)))
""", dict(time=1.5), None),
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_scenarios_match_reference(name):
    src, kw, want = SCENARIOS[name]
    t = np.float32(kw["time"])
    i = np.int32(kw.get("instance_index", 0))
    ref = _reference(src, np.array([t]), np.array([i]), np.array([1], np.int32))[0]
    got = _port(src, np.array([t]), np.array([i]), np.array([1], np.int32))[0]
    assert ulps(ref, got).max() <= 4, (ref, got)
    if want is not None:
        np.testing.assert_allclose(got, want, atol=1e-5)
    # The eager single-instance surface of the reference, too.
    ev = WinterScriptEvaluator(src, device="cpu")
    single = np.concatenate([ev.eval_rotation(kw["time"], kw.get("instance_index", 0.0)).numpy(),
                             ev.eval_translation(kw["time"],
                                                 kw.get("instance_index", 0.0)).numpy()])
    np.testing.assert_array_equal(single, got)


def test_batched_by_source_bucket_caching():
    """tests/test_scripting.py:104-119 on the port: programs are cached by
    (source, bucket) and 6 objects of one source stay in bucket 8."""
    src = "def evalRotation(float time, WinterEnv env) vec3 : vec3(0.0, 0.0, time)"
    ose = ObjectScriptsEvaluator(device="cpu")
    obs = [object() for _ in range(6)]
    for ob in obs[:4]:
        ose.add(ob, src)
    ose.evaluate(1.0)
    assert list(ose._jitted) == [(src, 8)]
    for ob in obs[4:]:
        ose.add(ob, src)
    out = ose.evaluate(2.0)
    assert list(ose._jitted) == [(src, 8)]
    assert len(out) == 6
    np.testing.assert_allclose(out[5][1][0], [0, 0, 2.0], atol=1e-6)


def test_object_scripts_evaluator_matches_reference():
    """Three sources, objects with 1, 3 and 40 instances (buckets 8 and 64),
    one removed: every (object, rotation, translation) equal."""
    srcs = ["def evalRotation(float time, WinterEnv env) vec3 : vec3(0.0, 0.0, time)",
            "def evalTranslation(float time, WinterEnv env) vec3 : "
            "vec3(time, toFloat(env.instance_index) * 0.25, toFloat(env.num_instances))",
            HOOKS.format(_vec("time * 0.3 + env.instance_index", "1.0", "time / 1.4"),
                         _vec("sin(time * 0.5) * 3.0", "0.0", "time * time"))]
    obs = [object() for _ in range(7)]
    plan = [(0, 1), (1, 3), (2, 40), (0, 1), (2, 5), (1, 1), (2, 2)]
    jose, tose = JObjects(), ObjectScriptsEvaluator(device="cpu")
    for ob, (s, n) in zip(obs, plan):
        jose.add(ob, srcs[s], num_instances=n)
        tose.add(ob, srcs[s], num_instances=n)
    jose.remove(obs[3])
    tose.remove(obs[3])
    for t in (0.0, 1.25, 17.5):
        jout, tout = jose.evaluate(t), tose.evaluate(t)
        assert len(jout) == len(tout) == 6
        for (job, jr, jt), (tob, tr, tt) in zip(jout, tout):
            assert job is tob
            np.testing.assert_array_equal(tr, np.asarray(jr))
            np.testing.assert_array_equal(tt, np.asarray(jt))
    assert sorted(k[1] for k in tose._jitted) == sorted(k[1] for k in jose._jitted)


REJECTED = [
    "def evalRotation(float time, WinterEnv env) vec3 : __import__('os')",
    "def evalRotation(float time, WinterEnv env) vec3 : vec3(0.0, 0.0, system(time))",
    "def evalRotation(float time, WinterEnv env) vec3 : vec3(0.0, 0.0, secret)",
    "def evalRotation(float time, WinterEnv env) vec3 : vec3(0.0, 0.0, time) @",
    "print(1)",
    "def evalRotation(float time, WinterEnv env) vec3 : vec3(0.0, 0.0, (time)",
    "def helper(float x) float : x",
    "struct S { real a",
]


@pytest.mark.parametrize("src", REJECTED)
def test_rejections_match_reference(src):
    """test_winter_rejects_unsafe and the parser's other refusals: the same
    WinterParseError message from both packages."""
    with pytest.raises(JParseError) as jerr:
        JScript(src)
    with pytest.raises(WinterParseError) as terr:
        WinterScriptEvaluator(src, device="cpu")
    assert str(terr.value) == str(jerr.value)


EVAL_ERRORS = [
    "def f(float x) float : f(x)\n"
    "def evalRotation(float time, WinterEnv env) vec3 : vec3(f(time))",
    "def evalRotation(float time, WinterEnv env) vec3 : vec3(1.0, 2.0)",
    "def evalRotation(float time, WinterEnv env) vec3 : vec3(time) % 2.0",
    "def evalRotation(float time, WinterEnv env) vec3 : vec3(env.colour)",
    "struct P { real a }\n"
    "def evalRotation(float time, WinterEnv env) vec3 : vec3(P(1.0, 2.0).a)",
]


@pytest.mark.parametrize("src", EVAL_ERRORS)
def test_evaluation_errors_match_reference(src):
    """Scripts that parse but cannot be evaluated: both raise
    WinterParseError with the same message at the first evaluation."""
    with pytest.raises(JParseError) as jerr:
        JScript(src).eval_rotation(1.0)
    ev = WinterScriptEvaluator(src, device="cpu")
    with pytest.raises(WinterParseError) as terr:
        ev.eval_rotation(1.0)
    assert str(terr.value) == str(jerr.value)


def test_op_codes_agree_with_the_kernel():
    """csrc/winter.cu's enum lists the ops in scripting/lower.py's order."""
    text = (REPO / "substrata_tpu_torch" / "csrc" / "winter.cu").read_text()
    body = re.search(r"enum Op : int \{(.*?)\};", text, re.S).group(1)
    names = [n.strip()[1:].lower() for n in body.split(",") if n.strip()]
    assert names == list(OPS)


def test_lowering_reuses_registers():
    """A long script's register count stays far below its instruction count."""
    terms = " + ".join(f"sin(time * {k}.5) * {k}.25" for k in range(1, 60))
    ev = WinterScriptEvaluator(HOOKS.format(_vec(terms), _vec("0.0")), device="cpu")
    code, n_regs = ev.code()
    assert code.shape[0] > 200 and n_regs < 20
    ref, got = _reference(ev.src), _port(ev.src)
    assert np.abs(ref - got).max() <= 4e-4     # 59 sines of up to 60 * 1.2e-7 each

