"""The port's documents, ``docs/torch/*.md``, on the CPU.

Every fenced ``python`` block is a complete program: it runs in a fresh
namespace from an empty directory, in a subprocess (one a document) with
the checkout's ``src`` on the path, and prints exactly the ``text`` block
shown after it.  Where the
reference's documents show the same quantity for the same input (the
vector of ``a + b`` on 1024 f32, ``stride_class``, the ``symcount``
examples), and where a block's API is the reference's own, the same
program run against the JAX package prints the same.  Every ``repro_torch``
module, attribute and file named in backticks resolves; every ``--flag``
of a command is in its entry point's ``--help``; every command in its CPU
form runs as written, the commands under one heading in order in one
directory, and prints the lines its document promises (the ``corrupt_registry`` run
without ``--model`` leaves the registry's file byte for byte).  The
conventions are ``chip_smoke.py``'s (``doc_blocks``, ``run_doc_forms``),
which runs the card forms on the H100.
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import importlib
import io
import json
import os
import pkgutil
import re
import shlex
import subprocess
import sys
import tempfile
from pathlib import Path
from unittest import mock

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402

torch.set_num_threads(1)

DOCS = ROOT / "docs" / "torch"
NAMES = ("PORT.md", "KERNELS.md", "MODEL.md", "OBSERVABILITY.md",
         "ROBUSTNESS.md", "FLEET.md")
#: processes at once (a document's blocks, the reference's twins, a
#: document's CPU commands)
WORKERS = 4
TIMEOUT = 300


def _blocks(name: str) -> list:
    return chip_smoke.doc_blocks(str(DOCS / name))


PYTHON = [(n, b["line"]) for n in NAMES for b in _blocks(n)
          if b["lang"] == "python"]
CPU_FORMS = [(n, b["line"]) for n in NAMES for b in _blocks(n)
             if "CPU" in b["tags"]]

#: blocks whose program, run against the JAX package, prints what the
#: port's prints: (document, a piece of the block's code) -> the reference's
#: program, or None for the block with ``repro_torch`` renamed ``repro``
TWINS = {
    ("MODEL.md", "extract.extract_graph(lambda a, b: a + b"): (
        "import jax.numpy as jnp\n"
        "from repro.core import extract\n"
        "a = jnp.ones((1024,), jnp.float32)\n"
        "pv = extract.extract_jaxpr(lambda a, b: a + b, a, a)\n"
        "print(dict(sorted(pv.items())))\n"),
    ("MODEL.md", "props.stride_class(2, 0.5)"): None,
    ("MODEL.md", "barriers = CeilDiv(m, g) * groups"): None,
    ("MODEL.md", "archcount.counts_for"): None,
    ("MODEL.md", "PlanSpace.from_product"): None,
    ("MODEL.md", "exprops.build_program"): None,
    ("MODEL.md", "DriftMonitor()"): None,
    ("MODEL.md", "decode.structure()"): None,
    ("ROBUSTNESS.md", "FaultPlan.random"): None,
    ("ROBUSTNESS.md", "inj.counts()"): None,
    ("OBSERVABILITY.md", "tracer.report_lines()"): None,
    ("OBSERVABILITY.md", "reg.render()"): None,
    ("FLEET.md", "fleet.demo_manifest()"): None,
}


def _block(name: str, line: int) -> dict:
    return next(b for b in _blocks(name) if b["line"] == line)


#: runs each program of a JSON list read from stdin in a fresh namespace
#: from an empty directory of its own (its own compile cache), and prints
#: what each printed, and its traceback if it raised, as one JSON list
_RUNNER = r"""
import contextlib, io, json, os, sys, tempfile, traceback
out = []
for code in json.load(sys.stdin):
    buf, err = io.StringIO(), ""
    with tempfile.TemporaryDirectory() as d:
        os.chdir(d)
        os.environ["REPRO_COMPILE_CACHE"] = os.path.join(d, "cc")
        try:
            with contextlib.redirect_stdout(buf):
                exec(compile(code, "<block>", "exec"), {"__name__": "__main__"})
        except BaseException:
            err = traceback.format_exc()
        os.chdir(tempfile.gettempdir())
    out.append({"stdout": buf.getvalue(), "error": err})
print(json.dumps(out))
"""


def _run_python(codes: list, jax: bool = False) -> list:
    """``_RUNNER`` over ``codes`` in one subprocess; one result a program."""
    env = {k: v for k, v in os.environ.items()
           if k != "REPRO_MODEL_REGISTRY"}
    env.update(PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    if jax:
        env["JAX_PLATFORMS"] = "cpu"
    p = subprocess.run([sys.executable, "-c", _RUNNER], input=json.dumps(codes),
                       env=env, capture_output=True, text=True,
                       timeout=TIMEOUT)
    assert p.returncode == 0, p.stderr[-3000:]
    return json.loads(p.stdout.splitlines()[-1])


def _twin_code(name: str, line: int):
    code = _block(name, line)["code"]
    hits = [(k, v) for (doc, k), v in TWINS.items()
            if doc == name and k in code]
    assert len(hits) <= 1, hits
    if not hits:
        return None
    return hits[0][1] or code.replace("repro_torch", "repro")


def _lines(text: str) -> list:
    return [l.rstrip() for l in text.rstrip("\n").splitlines()]


@pytest.fixture(scope="module")
def runs():
    """Every python block, every reference twin and every document's CPU
    commands, run at once in ``WORKERS`` processes."""
    out = {}
    twins = [k for k in PYTHON if _twin_code(*k) is not None]
    # the commands inherit this process's environment: one thread each
    with mock.patch.dict(os.environ, {"OMP_NUM_THREADS": "1"}), \
            tempfile.TemporaryDirectory(prefix="docs-cli-") as d, \
            concurrent.futures.ThreadPoolExecutor(WORKERS) as pool:
        out["twin"] = pool.submit(_run_python,
                                  [_twin_code(*k) for k in twins], True)
        for n in NAMES:
            blocks = [(n, l) for doc, l in PYTHON if doc == n]
            if blocks:
                out[("py", n)] = pool.submit(
                    _run_python, [_block(*k)["code"] for k in blocks])
        for n in NAMES:
            if any(doc == n for doc, _ in CPU_FORMS):
                work = os.path.join(d, n)
                os.makedirs(work)
                out[("cli", n)] = pool.submit(
                    chip_smoke.run_doc_forms, str(DOCS / n), "CPU", work,
                    TIMEOUT)
        done = {k: f.result() for k, f in out.items()}
    res = dict(zip([("twin",) + k for k in twins], done.pop("twin")))
    for n in NAMES:
        if ("py", n) in done:
            lines = [l for doc, l in PYTHON if doc == n]
            res.update(zip([("py", n, l) for l in lines], done.pop(("py", n))))
    return {**res, **done}


def test_the_documents_exist_and_pair_their_forms():
    assert sorted(p.name for p in DOCS.glob("*.md")) == sorted(NAMES)
    for n in NAMES:
        assert _blocks(n) is not None
    assert len(PYTHON) >= 15 and len(CPU_FORMS) >= 6
    for ref in ("MODEL.md", "FLEET.md", "OBSERVABILITY.md", "ROBUSTNESS.md"):
        assert (ROOT / "docs" / ref).exists()
    # every card form has its CPU form and the other way round
    for n in NAMES:
        tags = [b["tags"] for b in _blocks(n) if b["tags"]]
        card = sum("card" in t for t in tags)
        cpu = sum("CPU" in t for t in tags)
        assert card == cpu, (n, card, cpu)


@pytest.mark.parametrize("name,line", PYTHON,
                         ids=[f"{n}:{l}" for n, l in PYTHON])
def test_python_block_prints_what_its_document_shows(runs, name, line):
    b = _block(name, line)
    r = runs[("py", name, line)]
    assert r["error"] == "", r["error"][-3000:]
    if r["stdout"].strip():
        assert b["expect"] is not None, f"{name}:{line} prints, shows nothing"
    assert _lines(r["stdout"]) == _lines(b["expect"] or "")


@pytest.mark.parametrize("name,line", [
    k for k in PYTHON if _twin_code(*k) is not None],
    ids=[f"{n}:{l}" for n, l in PYTHON if _twin_code(n, l) is not None])
def test_the_reference_prints_the_same(runs, name, line):
    r = runs[("twin", name, line)]
    assert r["error"] == "", r["error"][-3000:]
    assert _lines(r["stdout"]) == _lines(_block(name, line)["expect"])


def test_every_twin_names_a_block():
    for (doc, key) in TWINS:
        hits = [b for b in _blocks(doc) if key in b["code"]]
        assert len(hits) == 1, (doc, key)


@pytest.mark.parametrize("name,line", CPU_FORMS,
                         ids=[f"{n}:{l}" for n, l in CPU_FORMS])
def test_cpu_form_runs_and_prints_the_promised_lines(runs, name, line):
    row = next(r for r in runs[("cli", name)] if r["line"] == line)
    assert row["rc"] == 0, row["out"][-3000:]
    assert row["missing"] == [], row["out"][-3000:]
    assert _block(name, line)["expect"], f"{name}:{line} promises nothing"
    if "registry_kept" in row:
        assert row["registry_kept"] is True


def test_the_repair_run_is_checked():
    """ROBUSTNESS's run without ``--model`` is the one guarded run, and the
    file it keeps was written by the calibration before it."""
    guarded = [(n, b["line"]) for n in NAMES for b in _blocks(n)
               if "CPU" in b["tags"] and "corrupt_registry" in b["code"]
               and "--model" not in b["code"]]
    assert [n for n, _ in guarded] == ["ROBUSTNESS.md"]
    cpu = [b for b in _blocks("ROBUSTNESS.md") if "CPU" in b["tags"]]
    assert "repro_torch.calibration" in cpu[0]["code"]


# ---------------------------------------------------------------------------
# names and flags
# ---------------------------------------------------------------------------

_SPAN = re.compile(r"`([^`\n]+)`")
_PKG = ROOT / "src" / "repro_torch"
_MODULES = {}
for _m in pkgutil.walk_packages([str(_PKG)], "repro_torch."):
    _MODULES.setdefault(_m.name.rsplit(".", 1)[-1], []).append(_m.name)


def _resolve_attr(module: str, attrs: list) -> bool:
    try:
        obj = importlib.import_module(module)
    except ImportError:
        return False
    for a in attrs:
        if not hasattr(obj, a):
            return False
        obj = getattr(obj, a)
    return True


def _resolve(span: str):
    """True / False for a name this test knows how to look up, None for
    any other span."""
    s = span.split("(")[0].strip()
    if "<" in s:
        return None
    m = re.fullmatch(r"((?:[\w.-]+/)*[\w.-]+\.(?:py|cu|cuh|md))"
                     r"(?::(\d+)(?:-(\d+))?)?", s)
    if m and "/" in m.group(1):
        rel = m.group(1)
        cands = [ROOT / rel, _PKG / rel, _PKG / "kernels" / rel]
        hit = next((c for c in cands if c.is_file()), None)
        if hit is None:
            return False
        last = int(m.group(3) or m.group(2) or 0)
        return last <= len(hit.read_text().splitlines())
    m = re.fullmatch(r"((?:\w+/)+\w+)\.(\w+(?:\.\w+)*)", s)
    if m:
        mod = "repro_torch." + m.group(1).replace("/", ".")
        return _resolve_attr(mod, m.group(2).split("."))
    if s.startswith("repro_torch."):
        parts = s.split(".")
        for i in range(len(parts), 0, -1):
            if _resolve_attr(".".join(parts[:i]), parts[i:]):
                return True
        return False
    m = re.fullmatch(r"(\w+)\.(\w+(?:\.\w+)*)", s)
    if m and m.group(1) in _MODULES:
        return any(_resolve_attr(mod, m.group(2).split("."))
                   for mod in _MODULES[m.group(1)])
    return None


@pytest.mark.parametrize("name", NAMES)
def test_named_modules_and_attributes_resolve(name):
    text = (DOCS / name).read_text()
    spans = set(_SPAN.findall(text))
    checked = {s: _resolve(s) for s in spans}
    bad = sorted(s for s, ok in checked.items() if ok is False)
    assert bad == []
    assert sum(ok is True for ok in checked.values()) >= 5


_HELP = {}


def _help(module: str) -> str:
    if module not in _HELP:
        mod = importlib.import_module(module)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf), pytest.raises(SystemExit):
            mod.main(["--help"])
        _HELP[module] = buf.getvalue()
    return _HELP[module]


def _split_commands(code: str) -> list:
    """The commands of a ``bash`` block, continuation lines joined and
    comments dropped."""
    out, cur = [], ""
    for line in code.splitlines():
        if not cur and (not line.strip() or line.lstrip().startswith("#")):
            continue
        cur += line.rstrip()
        if cur.endswith("\\"):
            cur = cur[:-1] + " "
            continue
        out.append(" ".join(cur.split()))
        cur = ""
    return out


def _commands(name: str) -> list:
    text = (DOCS / name).read_text()
    cmds = [c for b in _blocks(name) if b["lang"] == "bash"
            for c in _split_commands(b["code"])]
    cmds += [s for s in _SPAN.findall(text)
             if s.startswith("python -m repro_torch")]
    return cmds


def _entry_point(argv: list):
    if "-m" not in argv:
        return None
    mod = argv[argv.index("-m") + 1]
    if not mod.startswith("repro_torch") or "<" in mod:
        return None
    if mod == "repro_torch.launch":
        rest = argv[argv.index("-m") + 2:]
        if not rest or rest[0].startswith("-") or "<" in rest[0]:
            return None
        return f"repro_torch.launch.{rest[0]}"
    if mod == "repro_torch.calibration":
        return "repro_torch.calibration.__main__"
    return mod


@pytest.mark.parametrize("name", NAMES)
def test_every_flag_is_in_its_entry_point_s_help(name):
    seen = 0
    for cmd in _commands(name):
        if cmd.startswith("export "):
            continue
        argv = shlex.split(cmd)
        module = _entry_point(argv)
        if module is None:
            continue
        flags = {a.split("=")[0] for a in argv if a.startswith("--")}
        known = set(re.findall(r"--[\w-]+", _help(module)))
        assert flags <= known, (cmd, sorted(flags - known))
        seen += 1
    if name != "KERNELS.md":
        assert seen >= 2
