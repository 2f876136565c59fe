"""Training through zoo heads, the port against the JAX package on the CPU.

* A 3-step trajectory of the whole probe model (D=64, 2 heads, depth 2, 32
  px, float32, 5 classes) with the aim head (a BatchNorm inside the pool)
  and with coca (196 image queries of which only query 0 gets a gradient):
  ep_tpu's jitted step on the 8-device CPU mesh and the port's step, from
  the same weights and batches, LARS with weight decay 0.05. Losses, every
  head parameter and every BatchNorm running statistic agree within 1e-5
  relative (floor 1e-6): LARS's rule by rank holds on the zoo's parameters,
  and coca's rows without a gradient decay through the trust ratio of all
  196 rows.
* The driver with ``--cls_features aim --cache_features --cache_augs 2``, in
  the pattern of ``tests/test_torch_feature_cache.py``: the JAX driver
  trains epoch 0 from a test-written checkpoint, its msgpack (the pool's
  BatchNorm statistics included) becomes the port's checkpoint, and both
  drivers resume for epoch 1. Epoch 1's log lines agree to one unit of each
  printed digit, and the heads, BatchNorm statistics included, within 1e-5.
"""
import flax.serialization as fser
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ep_tpu.cli.linprobe as jax_linprobe
import ep_tpu_torch.cli.linprobe as linprobe
from ep_tpu.models.assembly import ProbeModel as FlaxProbeModel
from ep_tpu.models.vit import ViTConfig as FlaxViTConfig
from ep_tpu.parallel import mesh as M
from ep_tpu.train import lars as jax_lars
from ep_tpu.train import schedule as jax_schedule
from ep_tpu.train import steps as jax_steps
from ep_tpu.train.state import create_train_state
from ep_tpu_torch.convert.from_flax import flax_to_torch
from ep_tpu_torch.models.assembly import ProbeModel, build_backbone_config
from ep_tpu_torch.train import schedule
from ep_tpu_torch.train.lars import LARS
from ep_tpu_torch.train.state import freeze
from ep_tpu_torch.train.steps import make_train_step

from test_torch_checkpoint import write_timm_checkpoint
from test_torch_driver import (_cfg as _driver_cfg, _epoch_lines,
                               _jax_checkpoint_to_port, tiny)  # noqa: F401
from test_torch_train import IMG, STEPS_PER_EPOCH, _cfg, _data, _p

WD = 0.05


@pytest.mark.parametrize("name", ["aim", "coca"])
def test_train_trajectory_matches_jax(mesh8, name):
    cfg = _cfg().replace(cls_features=name, num_heads=4)
    fcfg = FlaxViTConfig(img_size=IMG, patch_size=16, embed_dim=64, depth=2,
                         num_heads=2, dtype=jnp.float32, attn_impl="xla")
    fmodel = FlaxProbeModel(fcfg, cfg)
    variables = jax.tree_util.tree_map(np.asarray, fmodel.init(
        jax.random.key(0), jnp.zeros((2, IMG, IMG, 3)), train=True))
    imgs, labels = _data(3)

    tx = jax_lars.build_optimizer("lars", WD)
    state = create_train_state(variables, tx, finetuning=False)
    step = jax_steps.make_train_step(
        fmodel, tx, jax_schedule.make_lr_fn(cfg, STEPS_PER_EPOCH), mesh8)
    with M.use_mesh(mesh8):
        losses_j = []
        for i in range(3):
            state, m = step(state, M.shard_batch(imgs[i], mesh8),
                            M.shard_batch(labels[i], mesh8))
            losses_j.append(float(m["loss"]))
    head_j, stats_j = flax_to_torch(jax.tree_util.tree_map(np.asarray, {
        "params": {"head": state.trainable["head"]},
        "batch_stats": {"head": state.batch_stats["head"]}}), device="cpu")

    bcfg = build_backbone_config(_p(cfg)).replace(embed_dim=64, depth=2,
                                                  num_heads=2)
    model = ProbeModel(bcfg, _p(cfg))
    params, buffers = flax_to_torch(variables, device="cpu")
    model.load_state_dict({**params, **buffers}, strict=True)
    opt = LARS(freeze(model, cfg.finetuning), weight_decay=WD)
    train_step = make_train_step(
        model, opt, schedule.make_lr_fn(_p(cfg), STEPS_PER_EPOCH))
    losses_t = [float(train_step(i, torch.from_numpy(imgs[i]),
                                 torch.from_numpy(labels[i]).long())["loss"])
                for i in range(3)]

    np.testing.assert_allclose(losses_t, losses_j, rtol=1e-5, atol=1e-5)
    state_t = model.state_dict()
    for k, ref in {**head_j, **stats_j}.items():
        if not k.endswith("num_batches_tracked"):
            np.testing.assert_allclose(state_t[k].numpy(), ref.numpy(),
                                       rtol=1e-5, atol=1e-6, err_msg=k)
    moved = [k for k in head_j
             if not np.allclose(head_j[k], params[k], rtol=0, atol=0)]
    assert len(moved) == len(head_j), sorted(set(head_j) - set(moved))
    if name == "coca":  # rows without a gradient moved by the decay alone
        q0, q1 = params["head.pool.img_queries"], head_j["head.pool.img_queries"]
        assert not torch.equal(q0[1:], q1[1:])


def test_cached_aim_driver_resumes_a_jax_checkpoint_like_the_jax_driver(
        tmp_path, tiny, capsys):  # noqa: F811
    ckpt = write_timm_checkpoint(tmp_path / "mae.pth")
    jax_dir, port_dir = tmp_path / "jax", tmp_path / "port"
    flags = dict(finetune=ckpt, cache_features=True, cache_augs=2,
                 cls_features="aim", num_heads=4)
    jax_linprobe.main(_driver_cfg(jax_dir, epochs=1, **flags))
    port_dir.mkdir()
    payload = _jax_checkpoint_to_port(jax_dir / "checkpoint-.msgpack",
                                      port_dir / "checkpoint-.pth")
    assert "pool" in payload["batch_stats"]["head"]  # the pool's BN

    capsys.readouterr()
    jax_linprobe.main(_driver_cfg(jax_dir, auto_resume=True, **flags))
    said_jax = capsys.readouterr().out
    linprobe.main(_p(_driver_cfg(port_dir, auto_resume=True, **flags)))
    said_port = capsys.readouterr().out
    for said in (said_jax, said_port):
        assert "[cache] train (512, 16, 32) x2 augs val (128, 16, 32)" in said

    ours, theirs = _epoch_lines(port_dir), _epoch_lines(jax_dir)
    assert list(ours) == [1] and 1 in theirs
    for a, b, unit in zip(ours[1], theirs[1], (1e-4, 1e-2, 1e-4, 1e-2, 1e-2)):
        assert abs(a - b) <= unit * 1.001, (ours[1], theirs[1])

    with open(jax_dir / "checkpoint-.msgpack", "rb") as f:
        after = fser.msgpack_restore(f.read())
    ref, stats = flax_to_torch({"params": after["model"],
                                "batch_stats": after["batch_stats"]},
                               device="cpu")
    own = torch.load(port_dir / "checkpoint-.pth", weights_only=True)["model"]
    assert "head.pool.bn.running_var" in own
    for k, v in {**ref, **stats}.items():
        if not k.endswith("num_batches_tracked"):
            torch.testing.assert_close(own[k], v, rtol=1e-5, atol=1e-5)
