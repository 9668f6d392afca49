"""The port's small utility surface on the CPU against the JAX package:
``save_config``/``print_config``/``get_project_root``, ``setup_device``,
``device_memory_stats`` and ``print_config_summary``, and of
``utils/download.py`` the presence checks (on synthetic directories) and
``inspect_checkpoint`` (on the port's checkpoints)."""

from pathlib import Path

import pytest
import torch

from msid_tpu.utils import config as jax_config
from msid_tpu.utils import download as jax_download
from msid_tpu.utils import setup_helpers as jax_setup
from msid_tpu_torch.utils import config, download, setup_helpers
from msid_tpu_torch.utils.checkpointing import CheckpointManager, save_single

ROOT = Path(__file__).resolve().parent.parent
TINY = ROOT / "configs" / "experiments" / "tiny_cpu.yaml"


@pytest.mark.parametrize("path", ["experiments/tiny_cpu.yaml", "experiments/long_skip_fill.yaml"])
def test_save_config_round_trips_and_writes_the_jax_file(path, tmp_path):
    cfg = config.load_config(ROOT / "configs" / path)
    config.save_config(cfg, tmp_path / "ours" / "config.yaml")
    jax_config.save_config(cfg, tmp_path / "theirs" / "config.yaml")
    assert config.load_config(tmp_path / "ours" / "config.yaml") == cfg
    assert ((tmp_path / "ours" / "config.yaml").read_text()
            == (tmp_path / "theirs" / "config.yaml").read_text())


def test_printed_config_and_summary_are_the_jax_ones(capsys):
    cfg = config.load_config(TINY)
    for ours, theirs in ((config.print_config, jax_config.print_config),
                         (setup_helpers.print_config_summary, jax_setup.print_config_summary)):
        ours(cfg)
        printed = capsys.readouterr().out
        theirs(cfg)
        assert printed == capsys.readouterr().out and printed


def test_project_root_is_the_jax_packages():
    assert config.get_project_root() == jax_config.get_project_root() == ROOT


def test_setup_device_takes_the_cards_unless_the_cpu_is_asked_for(monkeypatch):
    assert setup_helpers.setup_device("cpu") == [torch.device("cpu")]
    with pytest.raises(ValueError, match="platform"):
        setup_helpers.setup_device("tpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for platform in (None, "cuda", "gpu"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            setup_helpers.setup_device(platform)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert setup_helpers.setup_device() == [torch.device("cuda", 0), torch.device("cuda", 1)]


def test_device_memory_stats_keys_are_the_jax_ones(monkeypatch):
    assert setup_helpers.device_memory_stats() == {}       # no card here

    class Props:
        total_memory = 80 << 30

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda i: 10)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda i: 20)
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda i: Props)
    assert setup_helpers.device_memory_stats() == {"cuda:0": {
        "bytes_in_use": 10, "peak_bytes_in_use": 20, "bytes_limit": 80 << 30}}


def make_eurosat(root: Path, classes: int, tiles: bool = True) -> Path:
    for i in range(classes):
        d = root / f"Class{i}"
        d.mkdir(parents=True)
        (d / ("tile_0.tif" if tiles else "notes.txt")).write_bytes(b"II*\x00")
    return root


@pytest.mark.parametrize("layout", ["missing", "eight_classes", "nine_classes",
                                    "no_tiles", "a_file"])
def test_presence_checks_give_the_jax_answers(layout, tmp_path):
    root = tmp_path / "EuroSAT_MS"
    if layout == "eight_classes":
        make_eurosat(root, 8)
    elif layout == "nine_classes":
        make_eurosat(root, 9)
    elif layout == "no_tiles":
        make_eurosat(root, 10, tiles=False)
    elif layout == "a_file":
        root.write_text("not a directory")
    assert download.verify_eurosat(root) == jax_download.verify_eurosat(root)
    assert download.verify_eurosat(root) == (layout == "nine_classes")
    assert download.verify_eurosat(root, 8) == jax_download.verify_eurosat(root, 8)


@pytest.mark.parametrize("weights", [None, "missing", "small", "large"])
def test_verify_downloads_gives_the_jax_report(weights, tmp_path):
    path = tmp_path / "satmae.pth"
    if weights in ("small", "large"):
        with open(path, "wb") as f:
            f.truncate((101 << 20) if weights == "large" else 1024)   # sparse
    cfg = {"data": {"root_dir": str(make_eurosat(tmp_path / "data", 9))},
           "model": {"encoder": {"pretrained_path": None if weights is None else str(path)}}}
    report = download.verify_downloads(cfg)
    assert report == jax_download.verify_downloads(cfg)
    assert report["dataset_present"] and report["weights_present"] == (weights == "large")
    assert download.verify_downloads({}) == jax_download.verify_downloads({})


def test_inspect_checkpoint_reads_the_ports_checkpoints(tmp_path):
    state = {"model": {"a.weight": torch.zeros(2, 2), "a.bias": torch.zeros(2)},
             "optimizer": {}, "step": 3, "nan_skips": 0, "ema": None}
    manager = CheckpointManager(tmp_path / "run", keep_top_k=2)
    for step in (3, 7):
        manager.save(step, state, metrics={"val_psnr": float(step)}, force=True)
    manager.close()
    assert download.inspect_checkpoint(tmp_path / "run") == {
        "format": "checkpoint_manager", "steps": [3, 7], "path": str(tmp_path / "run")}
    step = download.inspect_checkpoint(tmp_path / "run" / "7")
    assert step["format"] == "torch" and step["num_tensors"] == 2
    assert step["top_level_keys"] == ["model", "optimizer", "step", "nan_skips", "ema"]
    assert step["sample_keys"] == ["a.weight", "a.bias"] and "_has_ema" in step["metadata_keys"]
    save_single(tmp_path / "single", state, {"note": 1})
    assert download.inspect_checkpoint(tmp_path / "single")["metadata_keys"] == ["note"]
    torch.save({"state_dict": state["model"]}, tmp_path / "weights.pth")
    assert (download.inspect_checkpoint(tmp_path / "weights.pth")
            == jax_download.inspect_checkpoint(tmp_path / "weights.pth"))
