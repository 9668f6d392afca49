"""The port's notebooks (``msid_tpu_torch/notebooks``) are generated from its
walkthroughs (``msid_tpu_torch/examples``) by
``msid_tpu_torch.scripts.make_notebooks`` and stay in step with them; their
code cells are valid Python with no output, import nothing of JAX or the
JAX package, and their setup cell moves a kernel started in the notebooks'
directory to the repository root. The walkthroughs themselves are run by
``test_torch_examples``."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
NOTEBOOK_DIR = ROOT / "msid_tpu_torch" / "notebooks"
NAMES = ("00_quick_setup_test.ipynb", "02_training.ipynb", "03_evaluation.ipynb")


def code_cells(name: str) -> list[str]:
    nb = json.loads((NOTEBOOK_DIR / name).read_text())
    return ["".join(c["source"]) for c in nb["cells"] if c["cell_type"] == "code"]


def test_notebooks_exist():
    assert {p.name for p in NOTEBOOK_DIR.glob("*.ipynb")} == set(NAMES)


@pytest.mark.parametrize("name", NAMES)
def test_notebook_is_valid(name):
    nb = json.loads((NOTEBOOK_DIR / name).read_text())
    assert nb["nbformat"] == 4
    assert {c["cell_type"] for c in nb["cells"]} == {"code", "markdown"}
    for cell in nb["cells"]:
        if cell["cell_type"] == "code":
            compile("".join(cell["source"]), name, "exec")
            assert cell["outputs"] == [] and cell["execution_count"] is None


@pytest.mark.parametrize("name", NAMES)
def test_no_cell_imports_jax_or_the_jax_package(name):
    imported = set()
    for src in code_cells(name):
        for node in ast.walk(ast.parse(src)):
            if isinstance(node, ast.Import):
                imported |= {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom):
                imported.add(node.module.split(".")[0])
    assert "msid_tpu_torch" in imported
    assert not imported & {"jax", "jaxlib", "flax", "optax", "msid_tpu"}, imported


def test_notebooks_match_generator():
    proc = subprocess.run(
        [sys.executable, "-m", "msid_tpu_torch.scripts.make_notebooks", "--check"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_setup_cell_moves_to_the_repository_root():
    """A kernel starts in the notebook's directory, two levels below the
    root, where the walkthroughs' relative paths (``configs/...``) live."""
    setup = code_cells(NAMES[0])[0]
    proc = subprocess.run(
        [sys.executable, "-c", setup + "\nimport os\nprint(os.getcwd())\n"
         "import msid_tpu_torch\nprint(msid_tpu_torch.__file__)"],
        cwd=NOTEBOOK_DIR, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    cwd, package = proc.stdout.split()
    assert Path(cwd) == ROOT
    assert Path(package) == ROOT / "msid_tpu_torch" / "__init__.py"
