"""What a run loads: no JAX, no JAX package (compared by whole top-level
names: the port's name begins with the JAX package's); and the reference
loads nothing of the program. Each in a fresh interpreter."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from portbench.run import FORBIDDEN, forbidden_modules
from portbench.tests.conftest import ROOT


def fresh(code: str) -> list[str]:
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_names_are_compared_whole():
    assert forbidden_modules(["msid_tpu_torch.ops", "jax_like", "jaxtyping", "torch"]) == []
    assert forbidden_modules(["msid_tpu.ops", "jax.numpy", "optax"]) == ["jax", "msid_tpu",
                                                                          "optax"]
    assert set(FORBIDDEN) == {"jax", "jaxlib", "flax", "optax", "msid_tpu"}


def test_a_whole_run_loads_no_jax():
    code = (
        "import json, sys, time, torch\n"
        "sys.path.insert(0, 'portbench/tests')\n"
        "from conftest import tiny_cell\n"
        "from portbench import run\n"
        "for cell in ('flagship.scene.b64', 'flagship.train.b64', 'flagship.serve.b1'):\n"
        "    run.execute(tiny_cell(cell), 5, 0.2, cell.endswith('b1'), torch.device('cpu'),\n"
        "                time.perf_counter(), log=lambda line: None)\n"
        "import portbench.control, portbench.sweep\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    loaded = set(fresh(code))
    assert "msid_tpu_torch" in loaded and "portbench" in loaded
    assert not loaded & set(FORBIDDEN), loaded & set(FORBIDDEN)


@pytest.mark.parametrize("module", ["portbench.reference.model", "portbench.reference.scene",
                                    "portbench.reference.train",
                                    "portbench.reference.precision", "portbench.weights"])
def test_the_reference_loads_nothing_of_the_program(module):
    loaded = set(fresh(f"import json, sys, {module}\n"
                       "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"))
    assert "msid_tpu_torch" not in loaded and not loaded & set(FORBIDDEN)
