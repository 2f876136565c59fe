"""Rules of the port that hold for every module: it imports nothing of JAX and
nothing of the JAX package, it keeps its own copy of the configuration, and
its constructors build on the card unless asked for the CPU."""
import ast
import dataclasses
from pathlib import Path

import pytest
import torch

import ep_tpu.configs as jax_configs
import ep_tpu_torch.configs as port_configs
from ep_tpu_torch.convert.from_flax import flax_to_torch
from ep_tpu_torch.models.assembly import (build_backbone_config,
                                          init_probe_model)
from ep_tpu_torch.ops import default_device
from ep_tpu_torch.ops.pool_attn import block_mask
from ep_tpu_torch.utils.pos_embed import bicubic_weight_matrix

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "flax", "optax", "ep_tpu")
PORT_FILES = sorted((ROOT / "ep_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "main_linprobe_torch.py",
    ROOT / "main_attention_stats_torch.py", ROOT / "search_linprobe_torch.py",
    ROOT / "scripts" / "torch_hopper_gemm_check.py",
    ROOT / "scripts" / "chip_ddp_check.py"]
# The port's copies of the JAX package's host data pipeline (numpy and PIL):
# the same text, with the package's own imports pointed at ep_tpu_torch.data.
DATA_COPIES = ("datasets", "transforms", "autoaugment", "loader", "_native",
               "grain_loader")


def _imported_modules(path: Path) -> list[str]:
    """Every module named by an ``import`` or ``from`` in ``path``, at any
    depth (function bodies included)."""
    names = []
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
    return names


def _forbidden(module: str) -> bool:
    return any(module == f or module.startswith(f + ".") for f in FORBIDDEN)


def test_the_walk_sees_the_port():
    names = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    assert {"chip_smoke.py", "scripts/torch_hopper_gemm_check.py",
            "scripts/chip_ddp_check.py", "ep_tpu_torch/configs.py",
            "ep_tpu_torch/ops/mlp_int8.py", "ep_tpu_torch/ops/flash_attn.py",
            "ep_tpu_torch/utils/pos_embed.py",
            "ep_tpu_torch/models/assembly.py", "main_linprobe_torch.py",
            "ep_tpu_torch/cli/linprobe.py", "ep_tpu_torch/train/engine.py",
            "ep_tpu_torch/runtime/checkpoint.py",
            "ep_tpu_torch/runtime/profiler.py",
            "ep_tpu_torch/utils/logging.py",
            "ep_tpu_torch/convert/torch_vit.py",
            "ep_tpu_torch/train/feature_cache.py",
            "ep_tpu_torch/data/device_aug.py",
            "ep_tpu_torch/cli/attention_stats.py",
            "main_attention_stats_torch.py", "search_linprobe_torch.py",
            "ep_tpu_torch/tools/extract_features.py",
            "ep_tpu_torch/tools/extract_pool_attention.py",
            "ep_tpu_torch/tools/convert_checkpoint.py",
            "ep_tpu_torch/tools/validate_zoo.py",
            "ep_tpu_torch/parallel/__init__.py",
            "ep_tpu_torch/parallel/mesh.py",
            "ep_tpu_torch/parallel/metrics.py",
            "ep_tpu_torch/parallel/partition.py"} <= names
    assert {f"ep_tpu_torch/data/{f}.py" for f in DATA_COPIES} <= names
    assert _forbidden("ep_tpu") and _forbidden("ep_tpu.configs")
    assert _forbidden("jax.numpy") and not _forbidden("ep_tpu_torch.configs")


@pytest.mark.parametrize(
    "path", PORT_FILES, ids=lambda p: p.relative_to(ROOT).as_posix())
def test_port_imports_no_jax_and_nothing_of_the_jax_package(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_train_config_is_a_faithful_copy():
    """Field by field: the same names in the same order, the same types and
    the same defaults, so the port's copy cannot drift unseen."""
    a = dataclasses.fields(jax_configs.TrainConfig)
    b = dataclasses.fields(port_configs.TrainConfig)
    assert [f.name for f in b] == [f.name for f in a]
    for fa, fb in zip(a, b):
        assert fb.type == fa.type, fa.name
        assert fb.default == fa.default, fa.name
    assert dataclasses.asdict(port_configs.TrainConfig()) == dataclasses.asdict(
        jax_configs.TrainConfig())
    for name in ("POOLING_NAMES", "CLS_FT_CHOICES", "AMP_CHOICES",
                 "DATASET_CHOICES"):
        assert getattr(port_configs, name) == getattr(jax_configs, name)


def test_flag_surface_is_a_faithful_copy():
    argv = ["--model", "vit_base_patch16", "--cls_features", "ep", "--int8_mlp",
            "--batch_size", "64", "--no_pallas_pool", "--remat_policy", "dots"]
    a = dataclasses.asdict(jax_configs.parse_config(argv))
    b = dataclasses.asdict(port_configs.parse_config(argv))
    assert a == b and b["int8_mlp"] is True and b["pallas_pool"] is False
    pa = {o for act in jax_configs.get_args_parser()._actions
          for o in act.option_strings}
    pb = {o for act in port_configs.get_args_parser()._actions
          for o in act.option_strings}
    assert pa == pb
    assert build_backbone_config(port_configs.parse_config(argv)).int8_mlp


def _tiny_cfg():
    return port_configs.TrainConfig(
        model="vit_tiny_patch16", cls_features="ep", ep_queries=4, d_out=1,
        nb_classes=5, image_size=32, amp="float32")


def test_constructors_build_on_the_card_unless_asked():
    """This test runs where there is no CUDA device: without ``device`` the
    port's constructors raise, with ``device="cpu"`` they build."""
    if torch.cuda.is_available():
        pytest.skip("runs on a machine without a CUDA device")
    cfg = _tiny_cfg()
    bcfg = build_backbone_config(cfg).replace(embed_dim=64, depth=1,
                                              num_heads=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_probe_model(cfg, 0, bcfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        default_device()
    variables = {"params": {"head": {"fc": {"bias": [0.0, 1.0]}}}}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        flax_to_torch(variables)
    # helpers that build a tensor follow the same rule
    with pytest.raises(RuntimeError, match="no CUDA device"):
        block_mask(2, 3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bicubic_weight_matrix(2, 4)
    assert block_mask(2, 3, "cpu").shape == (2, 6)
    assert bicubic_weight_matrix(2, 4, "cpu").shape == (2, 4)
    model = init_probe_model(cfg, 0, bcfg, device="cpu")
    assert {p.device.type for p in model.parameters()} == {"cpu"}
    state, _ = flax_to_torch(variables, device="cpu")
    assert state["head.fc.bias"].device.type == "cpu"
    assert default_device("cpu") == torch.device("cpu")


@pytest.mark.parametrize("name", DATA_COPIES)
def test_data_package_is_a_faithful_copy(name):
    """Each copy of ``ep_tpu/data`` is the JAX package's file with its own
    imports renamed, the grain-backed loader (``--use_grain``) included."""
    jax_text = (ROOT / "ep_tpu" / "data" / f"{name}.py").read_text()
    port_text = (ROOT / "ep_tpu_torch" / "data" / f"{name}.py").read_text()
    assert port_text == jax_text.replace("ep_tpu.data", "ep_tpu_torch.data")
