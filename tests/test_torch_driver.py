"""The probe-training driver of the port (``ep_tpu_torch/cli/linprobe.py``)
against the JAX package's, on the CPU.

* ``TrainingLogFile`` writes the JAX writer's bytes.
* ``build_optimizer`` (lars, adamw, sgd, ``--mu_bf16``, ``--accum_iter 2``)
  against the optax chains over three steps, as the JAX step applies them
  (``p + -lr * u``), to 1e-6.
* ``knn_classifier_multi`` against the JAX version on seeded features.
* A mesh the processes cannot fill raises (``--mesh_data 2`` or
  ``--mesh_model 2`` in one process), and so does ``WORLD_SIZE=2`` that no
  launcher variable gives a rank; ``--device_aug`` with ``--train_aug
  aimv2`` raises, as in the JAX driver, and so does ``main`` without a card
  unless ``--device cpu`` is given.
* The slice as a whole: the JAX driver trains epoch 0 of a tiny model from a
  test-written ``--finetune`` checkpoint; its ``checkpoint-.msgpack`` (head,
  BN statistics, LARS momentum, step, epoch) becomes the port's checkpoint
  through ``convert/from_flax.py``; both drivers resume for epoch 1 on the
  same data. Epoch 1's line of the two ``training_log.txt`` files agrees
  within one unit of each printed digit, and the heads after it within
  1e-5. The port's driver then goes on alone and beats chance on ``fake``
  (more than 40% at 4 classes) within the epochs ``tests/test_train_e2e.py``
  gives the JAX driver. From its own weights it learns, resumes, evaluates
  and runs kNN.

A tiny ViT: width 32, 2 blocks of 2 heads, 16 px images in patches of 4,
float32. The JAX driver runs on the 8 CPU devices of the test session, so its
batch of 32 divides by 8.
"""
import dataclasses

import flax.serialization as fser
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import ep_tpu.cli.linprobe as jax_linprobe
import ep_tpu.models.assembly as jax_assembly
import ep_tpu_torch.cli.linprobe as linprobe
from ep_tpu.configs import TrainConfig
from ep_tpu.models.vit import ViTConfig as FlaxViTConfig
from ep_tpu.train import engine as jax_engine
from ep_tpu.train import lars as jax_lars
from ep_tpu.utils.logging import TrainingLogFile as JaxLogFile
from ep_tpu_torch.configs import TrainConfig as PortTrainConfig
from ep_tpu_torch.convert.from_flax import flax_to_torch
from ep_tpu_torch.models.assembly import build_backbone_config
from ep_tpu_torch.train.engine import knn_classifier_multi
from ep_tpu_torch.train.lars import build_optimizer
from ep_tpu_torch.utils.logging import TrainingLogFile

from test_torch_checkpoint import timm_state_dict, write_timm_checkpoint

TINY = FlaxViTConfig(img_size=16, patch_size=4, embed_dim=32, depth=2,
                     num_heads=2, dtype=jnp.float32, attn_impl="xla")


@pytest.fixture
def tiny(monkeypatch):
    """Both drivers build the tiny ViT."""
    monkeypatch.setattr(jax_assembly, "build_backbone_config", lambda c: TINY)
    monkeypatch.setattr(jax_linprobe, "build_backbone_config", lambda c: TINY)
    monkeypatch.setattr(
        linprobe, "build_backbone_config",
        lambda c: build_backbone_config(c).replace(
            patch_size=4, embed_dim=32, depth=2, num_heads=2))


def _cfg(out, **kw):
    base = dict(dataset_name="fake", nb_classes=4, image_size=16,
                batch_size=32, model="vit_tiny_patch16", cls_features="ep",
                ep_queries=4, d_out=1, pallas_pool=False, epochs=2,
                warmup_epochs=1, blr=4.0, output_dir=str(out), num_workers=2,
                amp="float32", seed=0, device="cpu")
    base.update(kw)
    return TrainConfig(**base)


def _p(cfg):
    return PortTrainConfig(**dataclasses.asdict(cfg))


# ---- training_log.txt -------------------------------------------------------

def test_training_log_is_byte_compatible(tmp_path):
    cfg = _cfg(tmp_path, finetune="/ckpt/mae.pth")
    train = {"loss": 1.234567, "acc1": 45.678, "acc5": 99.1}
    test = {"loss": 0.98765, "acc1": 51.25, "acc5": 100.0}
    logs = []
    for writer, c, d in ((JaxLogFile, cfg, tmp_path / "jax"),
                         (TrainingLogFile, _p(cfg), tmp_path / "port")):
        log = writer(str(d))
        log.write_header(c)
        log.write_setup(256, 1234567)
        for epoch in range(3):
            log.write_epoch(epoch, train, test)
        log.write_line("[early-stop] no gain > 0.1 pts for 5 epochs")
        log.write_final(51.25, test, "0:01:02")
        logs.append((d / "training_log.txt").read_bytes())
    assert logs[0] == logs[1]
    assert b"Trainable Parameters: 1,234,567\n" in logs[1]


# ---- optimizers -------------------------------------------------------------

def _optax_chain(name, wd, mu_dtype, accum):
    tx = jax_lars.build_optimizer(name, wd, mu_dtype=mu_dtype)
    return optax.MultiSteps(tx, every_k_schedule=accum) if accum > 1 else tx


@pytest.mark.parametrize("name, mu_bf16, accum", [
    ("lars", False, 1), ("adamw", False, 1), ("sgd", False, 1),
    ("lars", True, 1), ("adamw", True, 1), ("lars", False, 2),
    ("adamw", False, 2)])
def test_build_optimizer_matches_optax(name, mu_bf16, accum):
    """Three updates (six micro-steps under --accum_iter 2) of a 2-D, a 1-D
    and a 3-D parameter with a weight decay, the LR changing every step, the
    update applied as ``p + -lr * u`` as both train steps apply it."""
    rng = np.random.default_rng(4)
    shapes = [(6, 4), (4,), (2, 3, 5)]
    ps = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    tx = _optax_chain(name, 0.05, jnp.bfloat16 if mu_bf16 else jnp.float32,
                      accum)
    jp = [jnp.asarray(p) for p in ps]
    st = tx.init(jp)
    tp = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in ps]
    opt = build_optimizer(name, tp, 0.05,
                          torch.bfloat16 if mu_bf16 else torch.float32, accum)
    for i in range(3 * accum):
        lr = 0.1 * (i + 1)
        gs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
        upd, st = tx.update([jnp.asarray(g) for g in gs], st, jp)
        jp = [(p.astype(jnp.float32) + -lr * u).astype(p.dtype)
              for p, u in zip(jp, upd)]
        for p, g in zip(tp, gs):
            p.grad = torch.from_numpy(g)
        opt.step(lr)
        for p, ref in zip(tp, jp):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(ref),
                                       rtol=1e-6, atol=1e-6)
    moments = [opt.state[p]["mu"] for p in tp] if name != "sgd" else []
    assert all(m.dtype == (torch.bfloat16 if mu_bf16 else torch.float32)
               for m in moments)


def test_build_optimizer_refuses_an_unknown_name():
    with pytest.raises(ValueError):
        build_optimizer("adagrad", [torch.nn.Parameter(torch.zeros(2))], 0.0)


# ---- kNN --------------------------------------------------------------------

def test_knn_classifier_multi_matches_jax():
    rng = np.random.default_rng(2)
    n_train, n_test, d, classes = 300, 70, 16, 7
    centers = rng.standard_normal((classes, d)).astype(np.float32)
    tr_y = rng.integers(0, classes, n_train)
    te_y = rng.integers(0, classes, n_test)
    tr = centers[tr_y] + rng.standard_normal((n_train, d)).astype(np.float32)
    te = centers[te_y] + rng.standard_normal((n_test, d)).astype(np.float32)
    tr /= np.linalg.norm(tr, axis=1, keepdims=True)
    te /= np.linalg.norm(te, axis=1, keepdims=True)
    ks = [5, 10, 20, 50, 100, 200]
    ours = knn_classifier_multi(tr, tr_y, te, te_y, ks, T=0.07,
                                num_classes=classes)
    theirs = jax_engine.knn_classifier_multi(tr, tr_y, te, te_y, ks, T=0.07,
                                             num_classes=classes)
    assert set(ours) == set(ks)
    for k in ks:
        assert ours[k] == pytest.approx(theirs[k], abs=1e-9), k
    assert knn_classifier_multi(tr, tr_y, te, te_y, [], T=0.07) == {}


# ---- flags and devices -------------------------------------------------------

@pytest.mark.parametrize("kw, error, match", [
    (dict(mesh_data=2), ValueError, "mesh 2x1 != 1 processes"),
    (dict(mesh_model=2), ValueError, "1 processes not divisible by model=2"),
    (dict(device_aug=True, train_aug="aimv2"), ValueError, "aimv2")])
def test_unported_flags_raise(tmp_path, kw, error, match):
    """A mesh larger than the processes raises, as the JAX driver's
    ``make_mesh`` asserts it against its devices (more than one process:
    ``tests/test_torch_parallel.py``); the JAX driver's own refusal of
    ``--device_aug --train_aug aimv2`` carries over."""
    with pytest.raises(error, match=match):
        linprobe.main(_p(_cfg(tmp_path, **kw)))


def test_oracle_ckpt_is_read_after_finetune(tmp_path, tiny, monkeypatch):
    """``--cls_features dino --oracle_ckpt``: the oracle takes the timm-layout
    checkpoint's weights and the backbone ``--finetune``'s, the oracle read
    second, as in the JAX driver; ``--eval`` then runs on them."""
    from ep_tpu_torch.convert import torch_vit
    fin = write_timm_checkpoint(tmp_path / "backbone.pth", seed=1)
    orc = write_timm_checkpoint(tmp_path / "oracle.pth", seed=2)
    order = []
    for name in ("load_pretrained_backbone", "load_oracle"):
        real = getattr(torch_vit, name)

        def spy(cfg, bcfg, model, real=real, name=name):
            real(cfg, bcfg, model)
            order.append((name, model))
        monkeypatch.setattr(torch_vit, name, spy)
    stats = linprobe.main(_p(_cfg(tmp_path / "out", cls_features="dino",
                                  finetune=fin, oracle_ckpt=orc, eval=True)))
    assert [n for n, _ in order] == ["load_pretrained_backbone", "load_oracle"]
    model = order[-1][1]
    key = "blocks.1.attn.qkv.weight"
    assert torch.equal(model.oracle.state_dict()[key],
                       timm_state_dict(2)[key])
    assert torch.equal(model.backbone.state_dict()[key],
                       timm_state_dict(1)[key])
    assert np.isfinite(stats["loss"])


def test_more_than_one_process_raises(tmp_path, monkeypatch):
    """WORLD_SIZE=2 with no launcher variable that names the rank: the
    driver raises rather than train as one process."""
    for var in ("EP_TPU_MULTIHOST", "RANK", "SLURM_PROCID",
                "OMPI_COMM_WORLD_RANK", "COORDINATOR_ADDRESS", "JOBSET_NAME"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="WORLD_SIZE=2"):
        linprobe.main(_p(_cfg(tmp_path)))


def test_main_without_a_card_raises(tmp_path):
    """The flag's default (the JAX package's "tpu") means the card; without
    one the driver raises instead of training on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("runs on a machine without a CUDA device")
    cfg = _p(_cfg(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        linprobe.main(cfg.replace(device="tpu"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        linprobe.main(cfg.replace(device="cuda"))
    assert not (tmp_path / "training_log.txt").exists()


# ---- the slice as a whole ----------------------------------------------------

def _epoch_lines(path):
    lines = (path / "training_log.txt").read_text().splitlines()
    return {int(l.split(",")[0]): [float(v) for v in l.split(", ")[1:]]
            for l in lines if l[:1].isdigit()}


def _jax_checkpoint_to_port(msgpack_path, port_path):
    """The JAX driver's head-only checkpoint as the port's: the same names
    through ``flax_to_torch`` for the head, its BN statistics and the LARS
    momentum."""
    with open(msgpack_path, "rb") as f:
        payload = fser.msgpack_restore(f.read())
    model, buffers = flax_to_torch({"params": payload["model"],
                                    "batch_stats": payload["batch_stats"]},
                                   device="cpu")
    mu, _ = flax_to_torch({"params": payload["optimizer"]["mu"]},
                          device="cpu")
    step = int(payload["step"])
    torch.save({
        "model": {**model, **buffers},
        "optimizer": {"state": {k: {"mu": v} for k, v in mu.items()},
                      "count": step, "mini_step": 0},
        "epoch": int(payload["epoch"]), "step": step,
        "test_stats": payload["test_stats"], "config": payload["config"],
    }, port_path)
    return payload


def test_driver_resumes_a_jax_checkpoint_like_the_jax_driver(tmp_path, tiny):
    ckpt = write_timm_checkpoint(tmp_path / "mae.pth")
    jax_dir, port_dir = tmp_path / "jax", tmp_path / "port"
    jax_linprobe.main(_cfg(jax_dir, epochs=1, finetune=ckpt))
    port_dir.mkdir()
    payload = _jax_checkpoint_to_port(jax_dir / "checkpoint-.msgpack",
                                      port_dir / "checkpoint-.pth")
    assert (int(payload["epoch"]), int(payload["step"])) == (0, 16)

    jax_linprobe.main(_cfg(jax_dir, finetune=ckpt, auto_resume=True))
    linprobe.main(_p(_cfg(port_dir, finetune=ckpt, auto_resume=True)))

    ours, theirs = _epoch_lines(port_dir), _epoch_lines(jax_dir)
    assert list(ours) == [1] and 1 in theirs
    # loss, acc1, loss, acc1, acc5, printed with 4, 2, 4, 2, 2 decimals
    for a, b, unit in zip(ours[1], theirs[1], (1e-4, 1e-2, 1e-4, 1e-2, 1e-2)):
        assert abs(a - b) <= unit * 1.001, (ours[1], theirs[1])

    with open(jax_dir / "checkpoint-.msgpack", "rb") as f:
        after = fser.msgpack_restore(f.read())
    ref, _ = flax_to_torch({"params": after["model"]}, device="cpu")
    own = torch.load(port_dir / "checkpoint-.pth", weights_only=True)
    assert own["step"] == int(after["step"]) == 32
    for k, v in ref.items():
        torch.testing.assert_close(own["model"][k], v, rtol=1e-5, atol=1e-5)

    # the port's driver alone goes on to the 5 epochs that
    # test_lp_learns_fake_dataset gives the JAX driver, and beats chance
    res = linprobe.main(_p(_cfg(port_dir, finetune=ckpt, auto_resume=True,
                                epochs=5)))
    assert list(_epoch_lines(port_dir)) == [2, 3, 4]
    assert res["max_accuracy"] > 40.0  # chance = 25%


def test_driver_learns_resumes_evaluates_and_runs_knn(tmp_path, tiny):
    """The port's driver alone, from its own seeded weights: the EP head
    beats chance within the 4 epochs ``test_ep_head_trains`` gives the JAX
    driver, the run writes its log and a head-only checkpoint, resumes at
    the next epoch with the saved global step, evaluates from the checkpoint
    to the last epoch's numbers, and runs the kNN sweep. (The plain LP head
    on ``gap`` features learns this data slowly from some draws of its
    classifier in either package: from the port's seed-0 draw its loss
    starts at 2.08 against ln 4 = 1.39, and it stays under 40% after 5
    epochs. The hand-off test above shows the port's driver past 40% from
    the JAX driver's weights.)"""
    cfg = _p(_cfg(tmp_path, epochs=4))
    res = linprobe.main(cfg)
    assert res["max_accuracy"] > 40.0  # chance = 25%
    log = (tmp_path / "training_log.txt").read_text()
    assert "Epoch, Train Loss, Train Acc1, Val Loss, Val Acc1, Val Acc5" in log
    assert "Max Accuracy:" in log
    ckpt = torch.load(tmp_path / "checkpoint-.pth", weights_only=True)
    assert all(k.startswith("head.") for k in ckpt["model"])
    assert (ckpt["epoch"], ckpt["step"]) == (3, 64)

    linprobe.main(cfg.replace(epochs=5, auto_resume=True))
    lines = _epoch_lines(tmp_path)
    assert list(lines) == [4]
    assert torch.load(tmp_path / "checkpoint-.pth",
                      weights_only=True)["step"] == 80

    stats = linprobe.main(cfg.replace(
        eval=True, resume=str(tmp_path / "checkpoint-.pth")))
    assert (round(stats["loss"], 4), round(stats["acc1"], 2),
            round(stats["acc5"], 2)) == tuple(lines[4][2:])

    knn = linprobe.main(cfg.replace(knn_eval=True, cls_features="pos",
                                    output_dir=str(tmp_path / "knn")))["knn"]
    assert sorted(knn) == [5, 10, 15, 20, 50, 100, 200]
    top1, top5 = knn[20]
    assert 25.0 < top1 <= top5 <= 100.0


def test_early_stop_triggers(tmp_path, tiny):
    linprobe.main(_p(_cfg(tmp_path, cls_features="gap", epochs=30, blr=0.0,
                          early_stop=True, early_stop_patience=2,
                          early_stop_min_epochs=3, warmup_epochs=0)))
    log = (tmp_path / "training_log.txt").read_text()
    assert "[early-stop]" in log
    assert max(_epoch_lines(tmp_path)) < 29


def test_use_grain_trains_through_the_driver(tmp_path, tiny, monkeypatch):
    """``--use_grain``: one epoch through the port's driver on the grain
    loader (``data/grain_loader.py``, the JAX package's text), read without
    worker processes: the epoch's line, finite, and a checkpoint at the
    epoch's 16 steps (512 images at batch 32)."""
    from ep_tpu_torch.data.grain_loader import GrainDataLoader
    loaders = []
    real = linprobe.build_loaders

    def spy(*a, **kw):
        loaders.extend(real(*a, **kw))
        return loaders[-2:]
    monkeypatch.setattr(linprobe, "build_loaders", spy)
    res = linprobe.main(_p(_cfg(tmp_path, epochs=1, use_grain=True,
                                num_workers=0)))
    assert all(isinstance(l, GrainDataLoader) for l in loaders)
    lines = _epoch_lines(tmp_path)
    assert list(lines) == [0] and all(np.isfinite(lines[0]))
    assert np.isfinite(res["loss"])
    ckpt = torch.load(tmp_path / "checkpoint-.pth", weights_only=True)
    assert (ckpt["epoch"], ckpt["step"]) == (0, 16)
