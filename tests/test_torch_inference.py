"""The port's InferenceSession on the CPU, its default device, and the rule
that the port imports nothing of JAX or of the JAX package."""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from msid_tpu_torch.deployment.inference import InferenceSession
from msid_tpu_torch.models.restoration import SatMAERestoration
from msid_tpu_torch.utils.config import load_config

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "msid_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "msid_tpu")


def tiny_model():
    return SatMAERestoration(image_size=32, embed_dim=32, depth=1, num_heads=2,
                             decoder_arch="unet_skip", decoder_channels=(8, 8, 8, 8),
                             residual_output=True, input_fill=True)


@pytest.fixture(scope="module")
def session():
    return InferenceSession(tiny_model(), batch_size=2, image_size=32, device="cpu")


def test_predict_shape_and_dtype(session):
    x = np.random.default_rng(0).normal(0, 0.5, (2, 32, 32, 13)).astype(np.float32)
    y = session.predict(x)
    assert y.shape == x.shape and y.dtype == np.float32
    with torch.no_grad():
        want = session.model(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(y, want)
    # float64 input is cast, as the JAX session does
    np.testing.assert_array_equal(session.predict(x.astype(np.float64)), y)


@pytest.mark.parametrize("shape,match", [
    ((32, 32, 13), "4D"),
    ((2, 32, 16, 13), "shape"),
    ((2, 32, 32, 12), "shape"),
    ((3, 32, 32, 13), "batch"),
])
def test_predict_rejects_bad_input(session, shape, match):
    with pytest.raises(ValueError, match=match):
        session.predict(np.zeros(shape, np.float32))


def test_cpu_session_has_no_device_benchmark(session):
    with pytest.raises(RuntimeError, match="CUDA events"):
        session.benchmark(warmup_runs=0, benchmark_iterations=1)


def test_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device works here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        InferenceSession(tiny_model())
    cfg = load_config(ROOT / "configs" / "experiments" / "long_skip_fill.yaml")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SatMAERestoration.from_config(cfg)


def _imported_modules(path):
    names = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module)
    return names


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_source_imports_no_jax(path):
    bad = [n for n in _imported_modules(path) if n.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_port_import_loads_no_jax():
    """Importing every port module in a fresh interpreter loads no module of
    JAX, flax, optax or msid_tpu."""
    modules = sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
        for p in PORT_FILES if p.parent != ROOT)
    code = ("import sys\n"
            + "".join(f"import {m}\n" for m in modules)
            + f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
            + "print(len(bad)); print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.splitlines()[0] == "0", out.stdout
