#!/usr/bin/env python
"""Generate the PyTorch port's Jupyter notebooks in
`msid_tpu_torch/notebooks/` from `msid_tpu_torch/examples/*.py`.

The port's own copy of the JAX package's conversion (`scripts/make_notebooks.py`):
the reference ships its three user flows as notebooks
(`00_quick_setup_test.ipynb`, `02_training.ipynb`, `03_evaluation.ipynb`);
the port keeps the flows as runnable example scripts and derives the
notebooks, under the same names, from them so the two surfaces cannot
drift (tests/test_torch_notebooks.py asserts the committed notebooks match
regeneration). The setup cell of a notebook opened in
`msid_tpu_torch/notebooks/` moves to the repository root, two levels up.

Conversion rules:
  * module docstring            -> leading markdown cell
  * argparse defaults           -> an `args` namespace cell (editable knobs)
  * module-level helper code    -> its own code cell
  * `# -- N. section ------` comments in main() -> markdown headers
    splitting the body into cells

Run:  python -m msid_tpu_torch.scripts.make_notebooks [--check]
"""

from __future__ import annotations

import argparse
import ast
import json
import sys
import textwrap
from pathlib import Path

PACKAGE = Path(__file__).resolve().parents[1]

# example script -> notebook name (reference notebook naming)
NOTEBOOKS = {
    "00_quick_start.py": "00_quick_setup_test.ipynb",
    "02_two_stage_training.py": "02_training.ipynb",
    "03_evaluation_and_export.py": "03_evaluation.ipynb",
}

SETUP_CELL = """\
import os
import sys
from pathlib import Path

if Path.cwd().name == "notebooks":  # run from the repo root (relative paths)
    os.chdir(Path.cwd().parent.parent)
if str(Path.cwd()) not in sys.path:
    sys.path.insert(0, str(Path.cwd()))
"""


def _argparse_defaults(tree: ast.Module) -> dict[str, object]:
    """{dest: default} from every `p.add_argument(...)` call."""
    out: dict[str, object] = {}
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "add_argument"
                and node.args
                and isinstance(node.args[0], ast.Constant)):
            continue
        dest = str(node.args[0].value).lstrip("-").replace("-", "_")
        default: object = None
        for kw in node.keywords:
            if kw.arg == "default":
                default = ast.literal_eval(kw.value)
            elif kw.arg == "action" and getattr(kw.value, "value", None) == "store_true":
                default = False
        out[dest] = default
    return out


def _segment(source: str) -> tuple[str, str, list[str]]:
    """(docstring, pre-main code, main-body lines) of an example script."""
    tree = ast.parse(source)
    doc = ast.get_docstring(tree) or ""
    lines = source.splitlines()

    main_def = next(
        n for n in tree.body
        if isinstance(n, ast.FunctionDef) and n.name == "main"
    )
    # module-level code between the docstring and `def main():`, minus the
    # shebang / __future__ / argparse import / __file__-based sys.path line
    first_code = tree.body[0].end_lineno if (
        tree.body and isinstance(tree.body[0], ast.Expr)
        and isinstance(tree.body[0].value, ast.Constant)
    ) else 0
    pre: list[str] = []
    for ln in lines[first_code: main_def.lineno - 1]:
        s = ln.strip()
        if (s.startswith("#!") or "from __future__" in s
                or s in ("import argparse", "import sys")
                or s == "from pathlib import Path"
                or s.startswith("sys.path.insert")):
            continue
        pre.append(ln)
    pre_src = textwrap.dedent("\n".join(pre)).strip("\n")

    body = lines[main_def.body[0].lineno - 1: main_def.end_lineno]
    body_src = textwrap.dedent("\n".join(body))

    # drop the argparse block: `p = argparse...` .. `args = p.parse_args()`
    kept, skipping = [], False
    for ln in body_src.splitlines():
        if ln.strip().startswith("p = argparse.ArgumentParser"):
            skipping = True
        if not skipping:
            kept.append(ln)
        if skipping and "parse_args()" in ln:
            skipping = False
    return doc, pre_src, kept


def _split_sections(body_lines: list[str]) -> list[tuple[str, str]]:
    """[(section_title, code)] split on `# -- N. title ----` markers."""
    sections: list[tuple[str, list[str]]] = [("", [])]
    for ln in body_lines:
        s = ln.strip()
        if s.startswith("# -- ") and s.endswith("-"):
            title = s.strip("# -").strip()
            sections.append((title, []))
        else:
            sections[-1][1].append(ln)
    return [
        (title, "\n".join(code).strip("\n"))
        for title, code in sections
        if "\n".join(code).strip()
    ]


def _cell(kind: str, src: str) -> dict:
    lines = src.splitlines()
    source = [ln + "\n" for ln in lines[:-1]] + lines[-1:]
    if kind == "markdown":
        return {"cell_type": "markdown", "metadata": {}, "source": source}
    return {
        "cell_type": "code",
        "metadata": {},
        "execution_count": None,
        "outputs": [],
        "source": source,
    }


def build_notebook(example: Path) -> dict:
    source = example.read_text()
    doc, pre_src, body_lines = _segment(source)
    defaults = _argparse_defaults(ast.parse(source))

    title = example.stem.split("_", 1)[1].replace("_", " ")
    cells = [_cell("markdown", f"# {title}\n\n{doc}")]

    args_lines = ["class args:  # CLI defaults of the example script — edit here"]
    args_lines += [f"    {k} = {v!r}" for k, v in defaults.items()]
    cells.append(_cell("code", SETUP_CELL + "\n\n" + "\n".join(args_lines)))

    if pre_src:
        cells.append(_cell("code", pre_src))

    for section_title, code in _split_sections(body_lines):
        if section_title:
            cells.append(_cell("markdown", f"### {section_title}"))
        cells.append(_cell("code", code))

    return {
        "cells": cells,
        "metadata": {
            "kernelspec": {
                "display_name": "Python 3",
                "language": "python",
                "name": "python3",
            },
            "language_info": {"name": "python", "version": "3"},
        },
        "nbformat": 4,
        "nbformat_minor": 5,
    }


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--check", action="store_true",
                    help="verify committed notebooks match regeneration")
    ns = ap.parse_args()

    out_dir = PACKAGE / "notebooks"
    out_dir.mkdir(exist_ok=True)
    stale = []
    for example_name, nb_name in NOTEBOOKS.items():
        nb = build_notebook(PACKAGE / "examples" / example_name)
        text = json.dumps(nb, indent=1, ensure_ascii=False) + "\n"
        target = out_dir / nb_name
        if ns.check:
            if not target.exists() or target.read_text() != text:
                stale.append(nb_name)
        else:
            target.write_text(text)
            print(f"wrote {target}")
    if stale:
        print(f"STALE (rerun python -m msid_tpu_torch.scripts.make_notebooks): {stale}")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
