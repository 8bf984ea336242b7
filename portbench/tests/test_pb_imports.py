"""Nothing portbench runs imports JAX or the JAX package (compared by
whole top-level names, so `repro_torch` passes), and the reference
imports nothing of the program either."""

import json
import pathlib
import subprocess
import sys

import pytest

PKG = pathlib.Path(__file__).resolve().parents[1]
ROOT = PKG.parent
MODULES = sorted(
    "portbench." + ".".join(p.relative_to(PKG).with_suffix("").parts)
    for p in PKG.rglob("*.py")
    if "tests" not in p.parts and p.name != "__init__.py"
    and "metrics" not in p.parts) + ["portbench"]
PROBE = """
import importlib, json, sys
sys.path.insert(0, {src!r})
for m in {mods!r}:
    importlib.import_module(m)
print(json.dumps(sorted({{n.split('.')[0] for n in sys.modules}})))
"""


def _loaded(mods):
    out = subprocess.run(
        [sys.executable, "-c", PROBE.format(src=str(ROOT / "src"),
                                            mods=mods)],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_every_module_imports_without_jax_or_repro():
    top = _loaded(MODULES)
    assert not top & {"jax", "jaxlib", "flax", "repro"}, top


def test_the_reference_imports_nothing_of_the_program():
    top = _loaded(["portbench.reference.decoder", "portbench.reference.optim",
                   "portbench.reference.lowp"])
    assert not top & {"jax", "jaxlib", "flax", "repro", "repro_torch"}


@pytest.mark.parametrize("path", sorted((PKG / "metrics").glob("*.py")),
                         ids=lambda p: p.name)
def test_metric_readers_import_no_program(path):
    text = path.read_text()
    assert "repro" not in text.replace("repro_torch/kernels/csrc", "")
