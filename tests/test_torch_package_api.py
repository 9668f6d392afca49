"""The port's public surface against the JAX package's, on the CPU: every
name each JAX ``__init__.py`` exports has a counterpart under the same
name in the port's (the very object its defining module holds), but for a
fixed list of non-counterparts; importing the port pulls in nothing of
JAX or the JAX package and builds no kernel; ``ComparisonResult`` is the
JAX dataclass; and every console entry point of the JAX CLIs has a port
entry that resolves to a callable returning None."""

import ast
import dataclasses
import importlib
import json
import subprocess
import sys
import tomllib
from pathlib import Path

import pytest

from msid_tpu.deployment.export import ComparisonResult as JaxComparisonResult
from msid_tpu_torch.deployment.export import ComparisonResult

ROOT = Path(__file__).resolve().parent.parent
SUBPACKAGES = ("", "data", "deployment", "models", "ops", "parallel", "training", "utils")
# JAX name -> the port's name for it, or None: no counterpart (flax init,
# GSPMD shardings).
NOT_THE_SAME = {"export_stablehlo": "export_program", "init_model": None,
                "batch_sharded": None, "replicated": None}
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "msid_tpu")


def jax_exports(sub: str) -> tuple[dict, list]:
    """``{name: defining module}`` of a JAX ``__init__.py``'s imports, and
    its ``__all__``."""
    path = ROOT / "msid_tpu" / sub / "__init__.py"
    tree = ast.parse(path.read_text())
    defined = {a.asname or a.name: node.module
               for node in tree.body if isinstance(node, ast.ImportFrom)
               for a in node.names}
    module = importlib.import_module("msid_tpu" + (f".{sub}" if sub else ""))
    return defined, list(module.__all__)


@pytest.mark.parametrize("sub", SUBPACKAGES, ids=lambda s: s or "msid_tpu")
def test_every_jax_export_has_the_ports_object(sub):
    defined, names = jax_exports(sub)
    package = importlib.import_module("msid_tpu_torch" + (f".{sub}" if sub else ""))
    jax_package = importlib.import_module("msid_tpu" + (f".{sub}" if sub else ""))
    for name in names:
        ours = NOT_THE_SAME.get(name, name)
        if ours is None:
            assert name not in package.__all__, name
            continue
        assert ours in package.__all__, name
        if name not in defined:             # assigned in the __init__ itself
            assert getattr(package, ours) == getattr(jax_package, name), name
            continue
        home = importlib.import_module(defined[name].replace("msid_tpu", "msid_tpu_torch", 1))
        assert getattr(package, ours) is getattr(home, ours), name


def test_importing_the_port_loads_no_jax_and_builds_no_kernel():
    """In a fresh interpreter: ``ops`` alone pulls in neither ``training``
    nor ``deployment`` (their modules import ``models``, whose blocks import
    ``ops``); then every subpackage imports with nothing of JAX or the JAX
    package loaded and no kernel library built or loaded."""
    script = f"""
import json, sys
import msid_tpu_torch.ops
after_ops = sorted(m for m in sys.modules if m.startswith("msid_tpu_torch."))
import msid_tpu_torch
for sub in {[s for s in SUBPACKAGES if s] + ["benchmarks", "scripts"]!r}:
    __import__("msid_tpu_torch." + sub)
from msid_tpu_torch.ops import _build
print(json.dumps({{"after_ops": after_ops,
                  "roots": sorted({{m.split(".")[0] for m in sys.modules}}),
                  "libraries": len(_build._libraries), "launches": _build.launched.total()}}))
"""
    proc = subprocess.run([sys.executable, "-c", script], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.splitlines()[-1])
    assert not any(m.startswith(("msid_tpu_torch.training", "msid_tpu_torch.deployment",
                                 "msid_tpu_torch.models")) for m in out["after_ops"])
    assert "msid_tpu_torch.ops.metrics" in out["after_ops"]
    assert not set(FORBIDDEN) & set(out["roots"]), out["roots"]
    assert out["libraries"] == 0 and out["launches"] == 0


def test_comparison_result_is_the_jax_dataclass():
    fields = [(f.name, f.type) for f in dataclasses.fields(ComparisonResult)]
    assert fields == [(f.name, f.type) for f in dataclasses.fields(JaxComparisonResult)]
    for values in ((1.25e-3, 3.0e-5, 0.9999876, True), (0.0, 0.0, 1.0, False),
                   (12.5, 0.75, -0.25, False)):
        assert str(ComparisonResult(*values)) == str(JaxComparisonResult(*values))


def console_scripts() -> dict:
    return tomllib.loads((ROOT / "pyproject.toml").read_text())["project"]["scripts"]


JAX_SCRIPTS = sorted(k for k, v in console_scripts().items() if v.startswith("scripts."))


@pytest.mark.parametrize("jax_name", JAX_SCRIPTS)
def test_every_jax_console_script_has_a_port_entry(jax_name, monkeypatch):
    """``msid-X`` has ``msid-torch-X`` on the port's CLI; the entry returns
    None where the CLI's ``main`` returns its result, which ``sys.exit``
    would read as a failure status."""
    scripts = console_scripts()
    target = scripts[jax_name.replace("msid-", "msid-torch-", 1)]
    module_name, _, attr = target.partition(":")
    assert module_name == "msid_tpu_torch." + scripts[jax_name].partition(":")[0]
    module = importlib.import_module(module_name)
    entry = getattr(module, attr)
    assert callable(entry)
    monkeypatch.setattr(module, "main", lambda argv=None: {"psnr": 30.0})
    assert entry() is None
