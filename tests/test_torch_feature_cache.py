"""The port's cached-feature mode (``ep_tpu_torch/train/feature_cache.py`` and
the driver's ``--cache_features`` branch) against the JAX package's, on the
CPU.

* ``extract_split``: its memmap and RAM paths agree, with a filtered first
  batch too (the cases of ``tests/test_feature_cache_unit.py``), and each
  equals the JAX ``extract_split`` on the same loader and features: the same
  arrays, and the same bytes of ``feat_cache_{name}.npy``. With bf16
  features the storage decision is taken at bf16's width, as there.
* ``CachedFeatureLoader`` is the JAX text and yields the JAX loader's batches
  bit for bit over 3 epochs and 2 variants.
* One ``make_head_steps`` train step and one eval step against the JAX ones
  from the same weights (through ``flax_to_torch``): loss, head and BN
  statistics within 1e-5.
* The slice as a whole: the JAX driver trains epoch 0 with
  ``--cache_features --cache_augs 2`` from a test-written ``--finetune``
  checkpoint; its msgpack becomes the port's checkpoint; both drivers resume
  for epoch 1 (each extracting again). Epoch 1's log lines agree to one unit
  of each printed digit, and the heads within 1e-5.
"""
import ast
from pathlib import Path

import flax.serialization as fser
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ep_tpu.cli.linprobe as jax_linprobe
import ep_tpu.parallel.mesh as M
import ep_tpu.train.feature_cache as jax_fc
import ep_tpu_torch.cli.linprobe as linprobe
import ep_tpu_torch.train.feature_cache as port_fc
from ep_tpu.configs import TrainConfig
from ep_tpu.poolings.registry import ProbeHead as FlaxProbeHead
from ep_tpu.train import lars as jax_lars
from ep_tpu.train import schedule as jax_schedule
from ep_tpu.train.state import create_train_state
from ep_tpu_torch.convert.from_flax import flax_to_torch
from ep_tpu_torch.poolings.registry import ProbeHead
from ep_tpu_torch.train import schedule
from ep_tpu_torch.train.lars import build_optimizer

from test_feature_cache_unit import _FakeLoader
from test_torch_checkpoint import write_timm_checkpoint
from test_torch_driver import (_cfg, _epoch_lines, _jax_checkpoint_to_port,
                               _p, tiny)  # noqa: F401  (tiny is a fixture)

ROOT = Path(__file__).resolve().parent.parent
N_IMG, BS = 22, 8
MASK = np.array([1, 0, 1, 0, 1, 0, 1, 0])


# ---- extract_split ------------------------------------------------------------

def _loader(first_batch_mask=None):
    rng = np.random.default_rng(0)
    images = rng.normal(size=(N_IMG, 4, 4, 3)).astype(np.float32)
    return _FakeLoader(images, np.arange(N_IMG, dtype=np.int32), BS,
                       first_batch_mask)


def _jax_extract(tmp, threshold, mask, bf16=False):
    def backbone_apply(imgs):
        f = jnp.asarray(imgs).reshape(len(imgs), -1)[:, :6]
        return f.astype(jnp.bfloat16) if bf16 else f

    mesh = M.make_mesh(1, 1, devices=[jax.devices()[0]])
    f, labels = jax_fc.extract_split(backbone_apply, _loader(mask), mesh,
                                     str(tmp), "t", memmap_threshold=threshold)
    return np.asarray(f), labels


def _port_extract(tmp, threshold, mask, bf16=False):
    def backbone_apply(imgs):
        f = imgs.reshape(len(imgs), -1)[:, :6]
        return f.to(torch.bfloat16) if bf16 else f

    f, labels = port_fc.extract_split(backbone_apply, _loader(mask), "cpu",
                                      str(tmp), "t",
                                      memmap_threshold=threshold)
    return np.asarray(f), labels


@pytest.mark.parametrize("mask", [None, MASK], ids=["all", "filtered_first"])
def test_extract_split_paths_agree_and_match_jax(tmp_path, mask):
    n = N_IMG - (0 if mask is None else int((MASK == 0).sum()))
    out = {}
    for who, run in (("jax", _jax_extract), ("port", _port_extract)):
        for path, threshold in (("ram", 1 << 40), ("mm", 0)):
            out[who, path] = run(tmp_path / who / path, threshold, mask)
    f_ram, l_ram = out["port", "ram"]
    f_mm, l_mm = out["port", "mm"]
    assert f_ram.shape == f_mm.shape == (n, 6)
    assert f_ram.dtype == np.float32 and f_mm.dtype == np.float16
    np.testing.assert_array_equal(l_ram, l_mm)
    np.testing.assert_allclose(f_ram, f_mm.astype(np.float32), rtol=1e-3,
                               atol=1e-3)  # fp16 store
    assert not np.any(np.all(f_mm == 0, axis=1))  # no stranded zero rows
    for path in ("ram", "mm"):
        (f_j, l_j), (f_p, l_p) = out["jax", path], out["port", path]
        assert f_p.dtype == f_j.dtype
        np.testing.assert_array_equal(f_p, f_j)
        np.testing.assert_array_equal(l_p, l_j)
    assert not (tmp_path / "port" / "ram" / "feat_cache_t.npy").exists()
    assert (tmp_path / "port" / "mm" / "feat_cache_t.npy").read_bytes() == \
        (tmp_path / "jax" / "mm" / "feat_cache_t.npy").read_bytes()


def test_extract_split_decides_at_the_features_width(tmp_path):
    """bf16 features: 22 rows of 6 take 264 bytes at bf16's width and 528 at
    f32's. A threshold between the two keeps both packages in RAM (the port
    widens to f32 only after deciding, holding every bf16 value exactly);
    below 264 both write the same float16 file."""
    f_j, _ = _jax_extract(tmp_path / "jax", 400, None, bf16=True)
    f_p, _ = _port_extract(tmp_path / "port", 400, None, bf16=True)
    assert f_p.dtype == np.float32 and f_p.shape == (N_IMG, 6)
    np.testing.assert_array_equal(f_p, f_j.astype(np.float32))
    assert not list((tmp_path / "port").glob("*.npy"))
    _jax_extract(tmp_path / "jax_mm", 200, None, bf16=True)
    f_p, _ = _port_extract(tmp_path / "port_mm", 200, None, bf16=True)
    assert f_p.dtype == np.float16
    assert (tmp_path / "port_mm" / "feat_cache_t.npy").read_bytes() == \
        (tmp_path / "jax_mm" / "feat_cache_t.npy").read_bytes()


# ---- CachedFeatureLoader ----------------------------------------------------

def _class_source(path: Path, name: str) -> str:
    text = path.read_text()
    node = next(n for n in ast.parse(text).body
                if isinstance(n, ast.ClassDef) and n.name == name)
    return ast.get_source_segment(text, node)


def test_cached_loader_is_the_jax_text():
    assert _class_source(ROOT / "ep_tpu_torch/train/feature_cache.py",
                         "CachedFeatureLoader") == _class_source(
        ROOT / "ep_tpu/train/feature_cache.py", "CachedFeatureLoader")


@pytest.mark.parametrize("shuffle, drop_last", [(True, True), (False, False)])
def test_cached_loader_matches_jax(shuffle, drop_last):
    rng = np.random.default_rng(3)
    variants = [rng.standard_normal((21, 5, 4)).astype(np.float32)
                for _ in range(2)]
    labels = rng.integers(0, 7, 21)
    loaders = [cls(variants, labels, 4, shuffle=shuffle, drop_last=drop_last,
                   seed=5)
               for cls in (jax_fc.CachedFeatureLoader,
                           port_fc.CachedFeatureLoader)]
    assert len(loaders[0]) == len(loaders[1]) == (5 if drop_last else 6)
    for epoch in range(3):
        batches = []
        for ld in loaders:
            ld.set_epoch(epoch)
            batches.append(list(ld))
        for (fj, lj, vj), (fp, lp, vp) in zip(*batches):
            for a, b in ((fj, fp), (lj, lp), (vj, vp)):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
    # epochs 0 and 2 read variant 0, epoch 1 variant 1
    firsts = []
    for epoch in range(3):
        loaders[1].set_epoch(epoch)
        firsts.append(np.sort(next(iter(loaders[1]))[0], axis=None))
    assert not np.array_equal(firsts[0], firsts[1])
    if not shuffle:
        np.testing.assert_array_equal(firsts[0], firsts[2])


# ---- make_head_steps ----------------------------------------------------------

def test_head_steps_match_jax(mesh8):
    """One train step (the LR at its peak: no warmup) and one eval step of
    the EP head on tokens (16 images of 12 tokens of width 32, 4 queries, 5
    classes, float32)."""
    B, N, D, C = 16, 12, 32, 5
    cfg = TrainConfig(cls_features="ep", ep_queries=4, d_out=1, nb_classes=C,
                      amp="float32", batch_size=B, eff_batch_size=B, epochs=4,
                      warmup_epochs=0, lr=2.0, min_lr=0.0)
    head_j = FlaxProbeHead(cfg, D, N, dtype=jnp.float32)
    variables = jax.tree_util.tree_map(np.asarray, head_j.init(
        jax.random.key(0), jnp.zeros((2, N, D)), train=True))
    rng = np.random.default_rng(0)
    feats = rng.standard_normal((B, N, D)).astype(np.float32)
    labels = rng.integers(0, C, B).astype(np.int32)
    valid = np.ones(B, np.float32)
    valid[-3:] = 0

    tx = jax_lars.build_optimizer("lars", 0.0)
    state = create_train_state({"params": {"head": variables["params"]},
                                "batch_stats": {"head": variables[
                                    "batch_stats"]}}, tx, finetuning=False)
    train_j, eval_j = jax_fc.make_head_steps(
        head_j, mesh8, tx, jax_schedule.make_lr_fn(cfg, 2))
    with M.use_mesh(mesh8):
        state, m_j = train_j(state, M.shard_batch(feats, mesh8),
                             M.shard_batch(labels, mesh8))
        sums_j, preds_j = eval_j(state, M.shard_batch(feats, mesh8),
                                 M.shard_batch(labels, mesh8),
                                 M.shard_batch(valid, mesh8))
    after = jax.tree_util.tree_map(np.asarray, state.trainable["head"])
    bn = jax.tree_util.tree_map(np.asarray, state.batch_stats["head"]["bn"])

    pcfg = _p(cfg)
    head = ProbeHead(pcfg, D, dtype=torch.float32)
    params, buffers = flax_to_torch(
        {"params": {"head": variables["params"]},
         "batch_stats": {"head": variables["batch_stats"]}}, device="cpu")
    head.load_state_dict({k[len("head."):]: v
                          for k, v in {**params, **buffers}.items()})
    opt = build_optimizer("lars", list(head.parameters()), 0.0)
    train_p, eval_p = port_fc.make_head_steps(
        head, opt, schedule.make_lr_fn(pcfg, 2))
    m_p = train_p(0, torch.from_numpy(feats), torch.from_numpy(labels).long())
    sums_p, preds_p = eval_p(torch.from_numpy(feats),
                             torch.from_numpy(labels).long(),
                             torch.from_numpy(valid))

    assert set(m_p) == set(m_j)
    for k in m_j:
        np.testing.assert_allclose(float(m_p[k]), float(m_j[k]), rtol=1e-5,
                                   atol=1e-5, err_msg=k)
    assert float(m_p["lr"]) == pytest.approx(2.0)
    for k in sums_j:
        np.testing.assert_allclose(float(sums_p[k]), float(sums_j[k]),
                                   rtol=1e-5, atol=1e-5, err_msg=k)
    np.testing.assert_array_equal(preds_p.numpy(), np.asarray(preds_j))
    pairs = [
        (head.pool.cls_token, after["pool"]["cls_token"]),
        (head.pool.v.weight, after["pool"]["v"]["kernel"].T),
        (head.fc.weight, after["fc"]["kernel"].T),
        (head.fc.bias, after["fc"]["bias"]),
        (head.bn.running_mean, bn["mean"]),
        (head.bn.running_var, bn["var"]),
    ]
    for t, j in pairs:
        np.testing.assert_allclose(t.detach().numpy(), j, rtol=1e-5, atol=1e-6)
    assert not np.allclose(after["fc"]["bias"],
                           variables["params"]["fc"]["bias"])


# ---- the slice as a whole ----------------------------------------------------

def test_cached_driver_resumes_a_jax_checkpoint_like_the_jax_driver(
        tmp_path, tiny, capsys):  # noqa: F811
    ckpt = write_timm_checkpoint(tmp_path / "mae.pth")
    jax_dir, port_dir = tmp_path / "jax", tmp_path / "port"
    flags = dict(finetune=ckpt, cache_features=True, cache_augs=2)
    jax_linprobe.main(_cfg(jax_dir, epochs=1, **flags))
    port_dir.mkdir()
    payload = _jax_checkpoint_to_port(jax_dir / "checkpoint-.msgpack",
                                      port_dir / "checkpoint-.pth")
    assert (int(payload["epoch"]), int(payload["step"])) == (0, 16)

    capsys.readouterr()
    jax_linprobe.main(_cfg(jax_dir, auto_resume=True, **flags))
    said_jax = capsys.readouterr().out
    linprobe.main(_p(_cfg(port_dir, auto_resume=True, **flags)))
    said_port = capsys.readouterr().out
    for said in (said_jax, said_port):
        assert "[cache] train (512, 16, 32) x2 augs val (128, 16, 32)" in said

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
    assert all(k.startswith("head.") for k in own["model"])
    for k, v in ref.items():
        torch.testing.assert_close(own["model"][k], v, rtol=1e-5, atol=1e-5)
    assert not list(port_dir.glob("feat_cache_*.npy"))  # 4 MB: in RAM
