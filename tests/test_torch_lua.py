"""The port's Lua interpreter and script VM against the reference's.

``substrata_tpu_torch.scripting.lua``, ``lua_api`` and ``events`` are
copies of the reference's pure-Python modules.  Every Lua or script-VM
program written out in the reference's ``tests/test_lua.py`` and
``tests/test_scripting.py`` (the string handed to ``run``, ``ip.run`` or
``vm.run_script``, found by reading those files) runs through both
interpreters as one case of a parametrised test: the printed output, the
return values, the error (type and message), the globals, the messages to
the user, the object writes and the timers' effects must be equal.  The
reference's own Lua and script-VM test functions then run again over the
port's modules.  The Luau example corpus joins when the reference's
documentation pages are present (``tests/test_luau_corpus.py``); without
them those cases have no parameters and skip, as the reference's do.
"""

import ast
import math
import os

import numpy as np
import pytest

from substrata_tpu.scripting import events as j_events
from substrata_tpu.scripting import lua as j_lua
from substrata_tpu.scripting import lua_api as j_api
from substrata_tpu.shared import world_object as j_wo
from substrata_tpu_torch.scripting import events as t_events
from substrata_tpu_torch.scripting import lua as t_lua
from substrata_tpu_torch.scripting import lua_api as t_api
from substrata_tpu_torch.shared import world_object as t_wo
from tests import test_luau_corpus as corpus

HERE = os.path.dirname(os.path.abspath(__file__))
SOURCES = ("test_lua.py", "test_scripting.py")
REF = dict(lua=j_lua, api=j_api, events=j_events, wo=j_wo)
PORT = dict(lua=t_lua, api=t_api, events=t_events, wo=t_wo)


def _programs():
    """(case id, 'interp' | 'vm', source, budget) of every literal program
    the reference's tests hand to ``run``/``ip.run``/``vm.run_script``,
    directly or through a local variable."""
    cases = []
    for fname in SOURCES:
        tree = ast.parse(open(os.path.join(HERE, fname)).read())
        for fn in [n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef)]:
            local = {t.id: n.value.value for n in ast.walk(fn) if isinstance(n, ast.Assign)
                     and isinstance(n.value, ast.Constant) and isinstance(n.value.value, str)
                     for t in n.targets if isinstance(t, ast.Name)}
            for call in [n for n in ast.walk(fn) if isinstance(n, ast.Call)]:
                name = (call.func.attr if isinstance(call.func, ast.Attribute)
                        else getattr(call.func, "id", None))
                if name not in ("run", "run_script") or not call.args:
                    continue
                a = call.args[0]
                src = (a.value if isinstance(a, ast.Constant) and isinstance(a.value, str)
                       else local.get(a.id) if isinstance(a, ast.Name) else None)
                if src is None:
                    continue
                budget = next((k.value.value for k in call.keywords
                               if k.arg == "budget" and isinstance(k.value, ast.Constant)),
                              1_000_000)
                kind = "vm" if name == "run_script" else "interp"
                cases.append((f"{fname[:-3]}:{call.lineno}", kind, src, budget))
    return cases


PROGRAMS = _programs()


def plain(v, mods, seen=None):
    """A Lua or Python value as comparable plain data (tables by content,
    functions by kind, cycles cut)."""
    seen = set() if seen is None else seen
    if isinstance(v, mods["lua"].LuaTable):
        if id(v) in seen:
            return "<cycle>"
        seen = seen | {id(v)}
        items = sorted(((repr(plain(k, mods, seen)), plain(x, mods, seen))
                        for k, x in v.hash.items()), key=lambda kv: kv[0])
        return ("table", items, v.metatable is not None)
    if isinstance(v, (list, tuple)):
        return [plain(x, mods, seen) for x in v]
    if isinstance(v, dict):
        return {k: plain(x, mods, seen) for k, x in v.items()
                if not k.startswith("__") and not callable(x) and k != "math"}
    if isinstance(v, np.ndarray):
        return ("array", v.dtype.str, v.tolist())
    if isinstance(v, float) and math.isnan(v):
        return "nan"
    if callable(v):
        return "function"
    if isinstance(v, (bool, int, float, str, bytes)) or v is None:
        return v
    return type(v).__name__


def _err(e):
    return (type(e).__name__, str(e))


def run_interp(mods, src, budget):
    ip = mods["lua"].Interpreter(budget=budget)
    try:
        ret, err = ip.run(src), None
    except Exception as e:       # the error is part of the result
        ret, err = None, _err(e)
    return dict(output=list(ip.output), ret=plain(ret, mods), err=err)


class World:
    """The world surface scripts reach: objects 1, 3 and 7, write records."""

    def __init__(self, mods):
        self.objects = {}
        self.modified = []
        for uid in (1, 3, 7):
            ob = mods["wo"].WorldObject(uid=uid, model_url="m.glb")
            ob.pos = np.array([1.0, 2.0, 3.0])
            self.objects[uid] = ob

    def object_modified(self, ob):
        self.modified.append(ob.uid)


def run_vm(mods, src):
    """Load a script on object 7, touch objects 7 and 3, run the timers for
    3 s; everything the script could change is the result."""
    w = World(mods)
    now = [0.0]
    vm = mods["events"].ScriptVM(world_interface=w, clock=lambda: now[0])
    out = {}
    try:
        res = vm.run_script(src, this_object=w.objects[7])
        out["err"] = None
    except Exception as e:
        res, out["err"] = None, _err(e)
    fired = []
    for t in (0.0, 0.25, 0.6, 1.2, 3.0):
        now[0] = t
        try:
            vm.fire_user_touched_object(7, avatar_uid=55)
            vm.fire_user_touched_object(3, avatar_uid=56)
            fired.append(vm.update(t))
        except Exception as e:
            fired.append(_err(e))
    if isinstance(res, dict):
        out["env"] = plain(res, mods)
    elif res is not None:
        out["globals"] = plain(res.interp.globals.hash, mods)
        out["hit_error"] = res.hit_error
        out["error_messages"] = list(res.error_messages)
        out["output"] = list(res.interp.output)
    out.update(fired=fired, messages=list(vm.messages_to_user), modified=list(w.modified),
               storage=plain(dict(vm.object_storage), mods),
               objects={u: (o.model_url, np.asarray(o.pos, np.float64).tolist(), o.mass)
                        for u, o in w.objects.items()})
    return out


def test_programs_found():
    assert len(PROGRAMS) >= 20, [c[0] for c in PROGRAMS]


@pytest.mark.parametrize("case", PROGRAMS, ids=[c[0] for c in PROGRAMS])
def test_program_runs_alike(case):
    _, kind, src, budget = case
    if kind == "interp":
        a, b = run_interp(REF, src, budget), run_interp(PORT, src, budget)
    else:
        a, b = run_vm(REF, src), run_vm(PORT, src)
    assert a == b


# The reference's own Lua and script-VM tests, over the port's modules.
REF_TESTS = {
    "test_lua.py": None,                      # every test in the file
    "test_scripting.py": ("test_timer_queue", "test_script_vm_events_and_timers",
                          "test_script_vm_sandbox"),
}


def _ported_namespace(fname):
    src = open(os.path.join(HERE, fname)).read().replace("substrata_tpu.", "substrata_tpu_torch.")
    ns = {"__name__": f"ported_{fname[:-3]}", "__file__": os.path.join(HERE, fname)}
    exec(compile(src, fname, "exec"), ns)
    return ns


def _ref_tests():
    out = []
    for fname, names in REF_TESTS.items():
        tree = ast.parse(open(os.path.join(HERE, fname)).read())
        for n in tree.body:
            if (isinstance(n, ast.FunctionDef) and n.name.startswith("test_")
                    and (names is None or n.name in names) and not n.args.args):
                out.append((fname, n.name))
    return out


_NS = {}


@pytest.mark.parametrize("fname,name", _ref_tests(), ids=[f"{f[:-3]}:{n}" for f, n in _ref_tests()])
def test_reference_test_on_port(fname, name):
    if fname not in _NS:
        _NS[fname] = _ported_namespace(fname)
    ns = _NS[fname]
    mods = {getattr(v, "__module__", "") for v in ns.values()}
    assert not any(m.startswith("substrata_tpu.") for m in mods), mods
    ns[name]()


# The Luau example corpus (present only with the reference's pages).
def _corpus_run(mods, src):
    w = corpus.CorpusWorld()
    for uid in (583, 584, 585, 587, 588, 589, 600):
        ob = mods["wo"].WorldObject(uid=uid)
        ob.materials = [{"colour": (1.0, 1.0, 1.0)}]
        ob.content = ""
        w.objects[uid] = ob
    now = [0.0]
    vm = mods["events"].ScriptVM(world_interface=w, clock=lambda: now[0])
    ev = mods["api"].LuaScriptEvaluator(vm, src, this_object=w.objects[600])
    for uid in (587, 583):
        vm.fire_user_touched_object(uid, avatar_uid=55)
        now[0] += 3.0
        vm.update(now[0])
    return dict(hit_error=ev.hit_error, errors=list(ev.error_messages),
                messages=list(vm.messages_to_user), globals=plain(ev.interp.globals.hash, mods),
                moves=w.moves, rotates=w.rotates, modified=w.modified)


CORPUS = corpus._EXAMPLES + corpus._ABOUT


@pytest.mark.parametrize("i", range(len(CORPUS)))
def test_luau_corpus_runs_alike(i):
    assert _corpus_run(REF, CORPUS[i]) == _corpus_run(PORT, CORPUS[i])
