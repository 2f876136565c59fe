"""The port's tools against the JAX package's, on the CPU.

* ``ep_tpu_torch.tools.extract_features`` against ``tools/extract_features.py``
  on the same test-written ``--finetune`` checkpoint and ``fake`` images:
  the ``.npz`` of ``cls``, ``pos`` (GAP) and ``ep`` (the patch tokens) mode
  without a head, and with ``--head_ckpt`` the EP head's logits, from the JAX
  driver's checkpoint on the JAX side and its conversion to the port's
  ``.pth`` on the port's; f32 at 1e-5.
* ``ep_tpu_torch.tools.extract_pool_attention`` against
  ``tools/extract_pool_attention.py`` for EP on the same checkpoints: the
  (B, Q, N) map at 1e-5, the labels and predictions equal; both exit with the
  same message for a head without a map.
* ``ep_tpu_torch.tools.convert_checkpoint``: the converted file loads
  strictly through ``--finetune`` and gives the features of the hub ``.pth``
  it came from; a converted file that lacks an entry is refused.
* ``search_linprobe_torch``: ``run_trial`` with a fake driver, as
  ``tests/test_cli_aux.py`` holds the JAX search; then two trials of the real
  driver, whose ``training_log.txt`` files ``tools/plot_lr.py`` and
  ``tools/plot_lr_search.py`` parse.
* ``ep_tpu_torch.tools.validate_zoo`` with two heads, on the CPU.

A tiny ViT: width 32, 2 blocks of 2 heads, 16 px images in patches of 4,
float32. The JAX tools run on the 8 CPU devices of the test session, so
their batches of 16 divide by 8.
"""
import argparse
import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import ep_tpu.cli.linprobe as jax_linprobe
import ep_tpu.models.assembly as jax_assembly
import ep_tpu.parallel.mesh as jax_mesh
import ep_tpu_torch.cli.linprobe as linprobe
import ep_tpu_torch.tools.extract_features as port_ef
import ep_tpu_torch.tools.extract_pool_attention as port_pa
import ep_tpu_torch.tools.validate_zoo as port_zoo
import search_linprobe_torch as port_search
from ep_tpu_torch.configs import TrainConfig as PortTrainConfig
from ep_tpu_torch.configs import config_from_args, get_args_parser
from ep_tpu_torch.convert.torch_vit import load_pretrained_backbone
from ep_tpu_torch.models.assembly import build_backbone_config, init_probe_model
from ep_tpu_torch.tools.convert_checkpoint import main as convert_main

from test_torch_checkpoint import write_timm_checkpoint
from test_torch_driver import TINY, _cfg, _jax_checkpoint_to_port

ROOT = Path(__file__).resolve().parent.parent


def _jax_tool(name):
    """``tools/<name>.py`` as a module of its own name."""
    spec = importlib.util.spec_from_file_location(
        f"jax_tool_{name}", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _tiny_port(cfg):
    return build_backbone_config(cfg).replace(
        patch_size=4, embed_dim=32, depth=2, num_heads=2)


@pytest.fixture
def tiny(monkeypatch):
    """Every tool builds the tiny ViT."""
    monkeypatch.setattr(jax_assembly, "build_backbone_config", lambda c: TINY)
    monkeypatch.setattr(jax_linprobe, "build_backbone_config", lambda c: TINY)
    for mod in (linprobe, port_ef):
        monkeypatch.setattr(mod, "build_backbone_config", _tiny_port)


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """A hub ``.pth``, and the JAX driver's EP head after one epoch on it
    (``checkpoint-.msgpack``) with its conversion to the port's ``.pth``.
    The JAX driver registers its mesh and leaves it; a module fixture runs
    before the conftest's per-test isolation takes its snapshot, so the
    registry is restored here, or the mesh reaches the worker's next file."""
    tmp = tmp_path_factory.mktemp("ckpts")
    hub = write_timm_checkpoint(tmp / "vit.pth", seed=3)
    with pytest.MonkeyPatch.context() as mp, \
            jax_mesh.use_mesh(jax_mesh.current_mesh()):
        mp.setattr(jax_assembly, "build_backbone_config", lambda c: TINY)
        mp.setattr(jax_linprobe, "build_backbone_config", lambda c: TINY)
        jax_linprobe.main(_cfg(tmp / "jax", epochs=1, finetune=hub))
    port = tmp / "port" / "checkpoint-.pth"
    port.parent.mkdir()
    _jax_checkpoint_to_port(tmp / "jax" / "checkpoint-.msgpack", port)
    return hub, str(tmp / "jax" / "checkpoint-.msgpack"), str(port)


FLAGS = ["--model", "vit_tiny_patch16", "--dataset_name", "fake",
         "--nb_classes", "4", "--image_size", "16", "--batch_size", "16",
         "--amp", "float32", "--ep_queries", "4", "--no_pallas_pool",
         "--num_workers", "2"]


def _run_jax(monkeypatch, name, argv):
    monkeypatch.setattr(sys, "argv", [f"{name}.py"] + argv)
    _jax_tool(name).main()


@pytest.mark.parametrize("mode, head", [("cls", False), ("pos", False),
                                        ("ep", False), ("ep", True)])
def test_extract_features_matches_the_jax_tool(tmp_path, monkeypatch, tiny,
                                               checkpoints, mode, head):
    hub, jax_head, port_head = checkpoints
    argv = FLAGS + ["--cls_features", mode, "--finetune", hub]
    _run_jax(monkeypatch, "extract_features",
             argv + ["--out", str(tmp_path / "jax.npz")]
             + (["--head_ckpt", jax_head] if head else []))
    port_ef.main(argv + ["--out", str(tmp_path / "port.npz"), "--device",
                         "cpu"] + (["--head_ckpt", port_head] if head else []))
    ours, theirs = (np.load(tmp_path / f, allow_pickle=False)
                    for f in ("port.npz", "jax.npz"))
    assert sorted(ours.files) == sorted(theirs.files)
    assert ("logits" in ours.files) == head
    shape = {"cls": (128, 32), "pos": (128, 32), "ep": (128, 16, 32)}[mode]
    assert ours["features"].shape == shape
    np.testing.assert_array_equal(ours["labels"], theirs["labels"])
    for key in ("cls_features", "model"):
        assert str(ours[key]) == str(theirs[key])
    for key in ("features", "logits")[:1 + head]:
        np.testing.assert_allclose(ours[key], theirs[key], rtol=1e-5,
                                   atol=1e-5, err_msg=key)


def test_extract_pool_attention_matches_the_jax_tool(tmp_path, monkeypatch,
                                                     tiny, checkpoints):
    hub, jax_head, port_head = checkpoints
    argv = FLAGS + ["--cls_features", "ep", "--finetune", hub,
                    "--n_images", "8"]
    _run_jax(monkeypatch, "extract_pool_attention",
             argv + ["--resume", jax_head, "--out", str(tmp_path / "j.npz")])
    port_pa.main(argv + ["--resume", port_head, "--device", "cpu",
                         "--out", str(tmp_path / "p.npz")])
    ours, theirs = np.load(tmp_path / "p.npz"), np.load(tmp_path / "j.npz")
    assert ours["attention"].shape == (8, 4, 16)
    np.testing.assert_allclose(ours["attention"].sum(-1), 1.0, atol=1e-5)
    np.testing.assert_allclose(ours["attention"], theirs["attention"],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(ours["labels"], theirs["labels"])
    np.testing.assert_array_equal(ours["preds"], theirs["preds"])


def test_extract_pool_attention_exits_without_a_map(tmp_path, monkeypatch,
                                                    tiny):
    argv = FLAGS + ["--cls_features", "cls", "--out", str(tmp_path / "a.npz")]
    with pytest.raises(SystemExit) as theirs:
        _run_jax(monkeypatch, "extract_pool_attention", argv)
    with pytest.raises(SystemExit) as ours:
        port_pa.main(argv + ["--device", "cpu"])
    assert str(ours.value) == str(theirs.value)
    assert "has no attention map" in str(ours.value)


def test_convert_checkpoint_round_trip(tmp_path, monkeypatch):
    """The converted file loads strictly through ``--finetune`` and gives
    the hub file's features; it holds the port's names and the model's."""
    import ep_tpu_torch.tools.convert_checkpoint as conv
    monkeypatch.setattr(conv, "build_backbone_config", _tiny_port)
    hub = write_timm_checkpoint(tmp_path / "hub.pth", seed=4)
    out = tmp_path / "vit.eptorch.pth"
    convert_main(["--model", "vit_tiny_patch16", "--finetune", hub, "--out",
                  str(out), "--image_size", "16"])
    payload = torch.load(out, weights_only=True)
    assert payload["model"] == "vit_tiny_patch16"
    assert "blocks.1.attn.qkv.weight" in payload["backbone"]

    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (4, 16, 16, 3), np.float32))
    feats = {}
    for name, path in (("hub", hub), ("converted", str(out))):
        cfg = PortTrainConfig(model="vit_tiny_patch16", cls_features="pos",
                              nb_classes=4, image_size=16, amp="float32",
                              finetune=path)
        bcfg = _tiny_port(cfg)
        model = init_probe_model(cfg, 7, bcfg, device="cpu")
        load_pretrained_backbone(cfg, bcfg, model)
        with torch.no_grad():
            feats[name] = model.features(x)
    torch.testing.assert_close(feats["converted"], feats["hub"], rtol=0,
                               atol=0)

    del payload["backbone"]["blocks.1.norm2.bias"]
    torch.save(payload, out)
    with pytest.raises(KeyError, match="blocks.1.norm2.bias"):
        load_pretrained_backbone(cfg, bcfg, model)


def test_search_run_trial_with_a_fake_driver(tmp_path, monkeypatch):
    """``tests/test_cli_aux.py::test_search_fallback_grid`` on the port's
    search."""
    calls = []

    def fake_main(cfg):
        calls.append(cfg.blr)
        Path(cfg.output_dir).mkdir(parents=True, exist_ok=True)
        (Path(cfg.output_dir) / "training_log.txt").write_text(
            f"Base learning rate: {cfg.blr}\n"
            f"Max Accuracy: {50 + 10 * cfg.blr:.2f}%\n")

    monkeypatch.setattr(port_search, "linprobe_main", fake_main)
    base = config_from_args(
        argparse.ArgumentParser(parents=[get_args_parser()]).parse_args([]))
    base = base.replace(output_dir=str(tmp_path))
    results = {}
    for n, blr in enumerate(port_search.SEARCH_SPACE["blr"]):
        results[blr] = port_search.run_trial(base, blr, n)
    assert calls == port_search.SEARCH_SPACE["blr"]
    assert max(results, key=results.get) == max(port_search.SEARCH_SPACE["blr"])
    assert (tmp_path / "trial_0" / "training_log.txt").exists()
    # the grid and its override are the JAX search's
    import search_linprobe
    assert port_search.SEARCH_SPACE == search_linprobe.SEARCH_SPACE


def test_search_of_the_driver_feeds_the_plot_tools(tmp_path, monkeypatch,
                                                   tiny):
    """Two trials of the port's driver on the CPU (2 epochs each); the plot
    tools read their ``training_log.txt`` files as the JAX driver's."""
    monkeypatch.setattr(port_search, "SEARCH_SPACE", {"blr": [0.5, 4.0]})
    best_blr, best_acc = port_search.main(
        FLAGS + ["--cls_features", "ep", "--epochs", "2", "--warmup_epochs",
                 "1", "--batch_size", "32", "--device", "cpu",
                 "--output_dir", str(tmp_path)])
    sys.path.insert(0, str(ROOT / "tools"))
    try:
        from plot_lr import parse_training_log
        from plot_lr_search import parse_training_logs
    finally:
        sys.path.remove(str(ROOT / "tools"))
    trials = parse_training_logs(str(tmp_path))
    assert sorted(trials) == [0.5, 4.0]
    assert trials[best_blr] == [best_acc]
    for n in (0, 1):
        epochs, acc = parse_training_log(
            str(tmp_path / f"trial_{n}" / "training_log.txt"))
        assert epochs == [0, 1] and max(acc) == trials[[0.5, 4.0][n]][0]


def test_validate_zoo_with_two_heads(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(port_zoo, "HEADS", ["pos", "ep"])
    # validate_zoo replaces the driver's backbone builder, as the JAX tool
    # does; the monkeypatch puts it back
    monkeypatch.setattr(linprobe, "build_backbone_config",
                        linprobe.build_backbone_config)
    out = tmp_path / "zoo.json"
    with pytest.raises(SystemExit) as done:
        port_zoo.main(["--epochs", "2", "--device", "cpu", "--out", str(out)])
    assert done.value.code == 0
    results = json.loads(out.read_text())
    assert list(results) == ["pos", "ep"]
    assert all(0.0 <= r["max_acc"] <= 100.0 for r in results.values())
    table = capsys.readouterr().out
    assert "| head | max acc (4 classes, chance 25%) | time (s) |" in table
    assert "| ep | " in table


def test_validate_zoo_keeps_the_jax_tools_heads():
    assert port_zoo.HEADS == _jax_tool("validate_zoo").HEADS
