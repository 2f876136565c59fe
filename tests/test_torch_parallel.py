"""Data parallelism of the port (``ep_tpu_torch/parallel/``, ROADMAP module
item 9) against the JAX package's, on the CPU.

In this process:

* ``init_distributed``'s trigger table, case for case as
  ``tests/test_multihost.py::test_init_distributed_trigger_logic`` holds the
  JAX function, plus torchrun's ``RANK`` and the ranks read from SLURM and
  Open MPI (``init_process_group`` recorded, not run);
* ``make_mesh``'s shapes and errors, its rank order against the JAX mesh's
  device order, and the registry;
* the kernel gate's mesh term (``tests/test_pallas_gspmd.py::
  test_attn_impl_auto_gate_mesh_shapes``) and ``int8_mlp_inactive_reason``'s
  words against the JAX function's;
* ``spec_for`` against ``_spec_for`` on every leaf of a ViT-B and a DINOv2
  SwiGLU tree at model 2 and 4, ``shard_state`` at model 1 and its cut at
  model 2 (``tests/test_torch_tensor_parallel.py`` holds the cut model's
  compute);
* the ``metrics`` helpers at world size 1, and the device crop's draws per
  rank against the global batch's.

Two ranks on ``gloo`` (``torch.distributed`` through a ``file://`` store in
the test's directory; each process imports no JAX), started once for the
module and running in turn:

* the train step (``tests/test_multihost.py::test_two_process_distributed``):
  a tiny ViT with the EP head and its BN, each rank a different half of one
  global batch, 3 LARS steps; both ranks' losses equal, and the losses, the
  head and BN's running statistics equal the port as one process on the
  whole batch and the JAX step on the 8-device virtual mesh, within 1e-5;
  then the same as micro-steps of ``--accum_iter 2`` against one process;
* the helpers at world size 2 (``psum``'s backward, the gather's order,
  ``shard_state``'s broadcast and its cut at model 2), and four ranks on a
  (2, 2) mesh (each axis' group);
* the driver with ``--cache_features`` (``::test_two_process_cache_features``),
  ``--eval --dist_eval`` on 127 val images, ``--knn_eval`` and
  ``--mesh_model 2``, each against the one-process port run.

A tiny ViT: width 32, 2 blocks of 2 heads, float32.
"""
from __future__ import annotations

import dataclasses
import os
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import ep_tpu_torch.cli.linprobe as linprobe
import ep_tpu_torch.models.vit as port_vit
from ep_tpu_torch.configs import TrainConfig
from ep_tpu_torch.data.device_aug import DeviceAug
from ep_tpu_torch.models.assembly import ProbeModel, build_backbone_config
from ep_tpu_torch.parallel import mesh as M
from ep_tpu_torch.parallel import metrics as PM
from ep_tpu_torch.parallel.partition import shard_state, spec_for
from ep_tpu_torch.train import schedule
from ep_tpu_torch.train.lars import LARS
from ep_tpu_torch.train.state import freeze
from ep_tpu_torch.train.steps import make_train_step

ROOT = Path(__file__).resolve().parent.parent
IMG, B, C, STEPS_PER_EPOCH, N_STEPS = 32, 16, 5, 2, 3
LAUNCHER_VARS = ("EP_TPU_MULTIHOST", "COORDINATOR_ADDRESS", "SLURM_PROCID",
                 "OMPI_COMM_WORLD_RANK", "JOBSET_NAME", "RANK", "SLURM_NTASKS",
                 "OMPI_COMM_WORLD_SIZE", "WORLD_SIZE", "MASTER_ADDR",
                 "LOCAL_RANK")


# ---- the configurations both sides build ------------------------------------

def _step_cfg() -> dict:
    return dict(model="vit_tiny_patch16", cls_features="ep", ep_queries=4,
                d_out=1, nb_classes=C, image_size=IMG, amp="float32",
                batch_size=B, eff_batch_size=B, epochs=4, warmup_epochs=1,
                lr=2.0, min_lr=0.0)


def _tiny(bcfg):
    return bcfg.replace(embed_dim=32, depth=2, num_heads=2)


def _data():
    rng = np.random.default_rng(0)
    labels = rng.integers(0, C, size=(N_STEPS, B)).astype(np.int32)
    means = rng.standard_normal((C, 1, 1, 3)).astype(np.float32)
    imgs = means[labels] + 0.5 * rng.standard_normal(
        (N_STEPS, B, IMG, IMG, 3)).astype(np.float32)
    return imgs, labels


def _port_steps(model, imgs, labels, rows=slice(None), accum=1):
    """N_STEPS port train steps on ``rows`` of each batch (micro-steps under
    ``accum``); the losses and the step's other metrics."""
    cfg = TrainConfig(**{**_step_cfg(), "accum_iter": accum,
                         "eff_batch_size": B * accum})
    opt = LARS(freeze(model, False), weight_decay=0.0, accum_iter=accum)
    step = make_train_step(model, opt,
                           schedule.make_lr_fn(cfg, STEPS_PER_EPOCH))
    out = []
    for i in range(N_STEPS):
        m = step(i, torch.from_numpy(imgs[i][rows]),
                 torch.from_numpy(labels[i][rows]).long())
        out.append({k: float(v) for k, v in m.items()})
    return out


def _head_state(model) -> dict:
    return {k: v.detach().clone() for k, v in model.head.state_dict().items()}


class _Rows:
    """``dataset`` seen through a list of its indices."""

    def __init__(self, dataset, rows):
        self.dataset, self.rows = dataset, list(rows)

    def __len__(self):
        return len(self.rows)

    def __getitem__(self, i):
        return self.dataset[self.rows[i]]


def _driver_cfg(out, **kw) -> TrainConfig:
    base = dict(dataset_name="fake", nb_classes=4, image_size=16,
                batch_size=32, model="vit_tiny_patch16", cls_features="ep",
                ep_queries=4, d_out=1, pallas_pool=False, epochs=1,
                warmup_epochs=1, blr=4.0, output_dir=str(out), num_workers=2,
                amp="float32", seed=0, device="cpu")
    base.update(kw)
    return TrainConfig(**base)


DRIVER_RUNS = {
    # name -> (TrainConfig overrides, val rows: None = the whole val split)
    "cached": (dict(cache_features=True, epochs=4), None),
    "dist_eval": (dict(eval=True, dist_eval=True), list(range(127))),
    "knn": (dict(knn_eval=True, cls_features="pos"), None),
    "mesh_model": (dict(mesh_model=2), None),
}


def _drive(name, out, val_rows=None, **override):
    """The port's driver on the tiny ViT, case ``name`` of DRIVER_RUNS with
    ``override``; returns (result, whether each block of the model it built
    took the supercell)."""
    kw, rows = DRIVER_RUNS[name]
    real_datasets, real_model = linprobe.build_datasets, linprobe.init_probe_model
    built = []

    def datasets(cfg):
        train, val = real_datasets(cfg)
        rows_ = val_rows if val_rows is not None else rows
        return train, (val if rows_ is None else _Rows(val, rows_))

    def keep(*a, **k):
        built.append(real_model(*a, **k))
        return built[-1]

    saved = (linprobe.build_backbone_config, linprobe.build_datasets,
             linprobe.init_probe_model)
    linprobe.build_backbone_config = lambda c: build_backbone_config(
        c).replace(patch_size=4, embed_dim=32, depth=2, num_heads=2)
    linprobe.build_datasets, linprobe.init_probe_model = datasets, keep
    try:
        res = linprobe.main(_driver_cfg(out, **{**kw, **override}))
    finally:
        (linprobe.build_backbone_config, linprobe.build_datasets,
         linprobe.init_probe_model) = saved
    return res, [b.supercell for b in built[0].backbone.blocks]


# ---- the two-rank run (each rank runs this, with no JAX) ---------------------

def worker(rank: int, tmp: str) -> None:
    """One rank of the module's two-process run: joins the group through the
    port's ``init_distributed`` (RANK, WORLD_SIZE and a ``file://`` store),
    runs every two-rank case and saves what it saw to ``out{rank}.pth``."""
    tmp = Path(tmp)
    M.init_distributed(types.SimpleNamespace(dist_url=f"file://{tmp}/store",
                                             device="cpu"))
    assert M.process_count() == 2 and M.process_index() == rank
    inputs = torch.load(tmp / "inputs.pth", weights_only=False)
    out = {}

    # the train step: this rank's half of each global batch, then the same
    # as micro-steps of --accum_iter 2
    mesh = M.make_mesh(2, 1)
    with M.use_mesh(mesh):
        cfg = TrainConfig(**_step_cfg())
        half = slice(rank * B // 2, (rank + 1) * B // 2)
        for accum, tag in ((1, ""), (2, "_accum")):
            model = ProbeModel(_tiny(build_backbone_config(cfg)), cfg)
            model.load_state_dict(inputs["state"])
            if rank == 1:  # shard_state brings rank 0's weights back
                with torch.no_grad():
                    model.head.fc.weight.add_(1.0)
            shard_state(model, mesh)
            out["steps" + tag] = _port_steps(
                model, inputs["imgs"], inputs["labels"], half, accum)
            out["head" + tag] = _head_state(model)

        # the helpers at world size 2
        x = (torch.arange(3.0) + 10 * rank).requires_grad_()
        y = PM.psum(x)
        (y * (rank + 1)).sum().backward()
        out["psum"] = (y.detach(), x.grad)
        out["pmean"] = PM.pmean(torch.full((2,), float(rank)))
        out["gather"] = PM.all_gather_rows(torch.full((2, 3), float(rank)))
        out["host_mean"] = PM.all_reduce_mean_host(rank + 0.5)
    with M.use_mesh(M.make_mesh(1, 2)):
        out["tp_kernel"] = _tiny(build_backbone_config(cfg)).kernel_attention
        shard_state(model, M.current_mesh())
        out["tp_cut"] = tuple(model.backbone.blocks[0].attn.qkv.weight.shape)

    # the driver, each case in its own directory per rank
    for name in DRIVER_RUNS:
        out[name] = _drive(name, tmp / name / f"rank{rank}")
    out["jax_imported"] = "jax" in sys.modules or any(
        k == "ep_tpu" or k.startswith("ep_tpu.") for k in sys.modules)
    torch.save(out, tmp / f"out{rank}.pth")


def _flax_model():
    """The JAX side's tiny probe model and its variables (numpy)."""
    import jax
    import jax.numpy as jnp
    from ep_tpu.configs import TrainConfig as JaxTrainConfig
    from ep_tpu.models.assembly import ProbeModel as FlaxProbeModel
    from ep_tpu.models.vit import ViTConfig as FlaxViTConfig
    fcfg = FlaxViTConfig(img_size=IMG, patch_size=16, embed_dim=32, depth=2,
                         num_heads=2, dtype=jnp.float32, attn_impl="xla")
    fmodel = FlaxProbeModel(fcfg, JaxTrainConfig(**_step_cfg()))
    variables = fmodel.init(jax.random.key(0), jnp.zeros((2, IMG, IMG, 3)),
                            train=True)
    return fmodel, jax.tree_util.tree_map(np.asarray, variables)


def mesh_worker(rank: int, tmp: str) -> None:
    """One of four ranks on a (2, 2) mesh: this rank's coordinates, a sum
    over each axis and a gather over the model axis, to ``mesh{rank}.pth``."""
    tmp = Path(tmp)
    M.init_distributed(types.SimpleNamespace(dist_url=f"file://{tmp}/store",
                                             device="cpu"))
    mesh = M.make_mesh(2, 2)
    x = torch.tensor([float(rank)])
    torch.save(dict(at=(mesh.data_index, mesh.model_index),
                    data=PM.psum(x, "data", mesh).item(),
                    model=PM.psum(x, "model", mesh).item(),
                    gather=PM.all_gather_rows(x, "model", mesh).tolist()),
               tmp / f"mesh{rank}.pth")


def _start(fn: str, world: int, tmp: Path) -> None:
    """Run ``fn(rank, tmp)`` of this module in ``world`` processes (RANK,
    WORLD_SIZE, a ``file://`` store in ``tmp``); each must exit 0."""
    env = {k: v for k, v in os.environ.items() if k not in LAUNCHER_VARS}
    env.update(WORLD_SIZE=str(world), GLOO_SOCKET_IFNAME="lo",
               OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([str(ROOT), str(ROOT / "tests")]))
    code = "import test_torch_parallel as t; t.{}({}, {!r})"
    procs = [subprocess.Popen(
        [sys.executable, "-c", code.format(fn, r, str(tmp))],
        env={**env, "RANK": str(r), "LOCAL_RANK": str(r)},
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    try:
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r}:\n{log[-4000:]}"


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """Start the two ranks once; returns ((rank 0's, rank 1's) outputs, the
    flax model and variables they started from, the run's directory)."""
    from ep_tpu_torch.convert.from_flax import flax_to_torch
    tmp = tmp_path_factory.mktemp("two_ranks")
    imgs, labels = _data()
    fmodel, variables = _flax_model()
    params, buffers = flax_to_torch(variables, device="cpu")
    torch.save({"state": {**params, **buffers}, "imgs": imgs,
                "labels": labels}, tmp / "inputs.pth")
    _start("worker", 2, tmp)
    outs = tuple(torch.load(tmp / f"out{r}.pth", weights_only=False)
                 for r in range(2))
    return outs, (fmodel, variables), tmp


# ---- in this process ---------------------------------------------------------

def test_init_distributed_trigger_logic(monkeypatch):
    """Rank-0 values still trigger; EP_TPU_MULTIHOST=0 opts out; single-task
    allocations (world size 1) do not trigger (the JAX table). The port
    reads each launcher's rank and world size itself, triggers on torchrun's
    RANK too, and refuses a world above 1 whose rank it cannot tell."""
    calls = []
    monkeypatch.setattr(
        M.dist, "init_process_group",
        lambda backend, init_method, rank, world_size: calls.append(
            (backend, init_method, rank, world_size)))

    def run(env, cfg=None):
        for v in LAUNCHER_VARS:
            monkeypatch.delenv(v, raising=False)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        calls.clear()
        M.init_distributed(cfg)
        assert len(calls) <= 1
        return calls[0] if calls else None

    # the JAX package's cases
    assert run({"SLURM_PROCID": "0", "SLURM_NTASKS": "4"}) == (
        "gloo", "env://", 0, 4)
    assert run({"OMPI_COMM_WORLD_RANK": "0",
                "OMPI_COMM_WORLD_SIZE": "2"})[2:] == (0, 2)
    assert run({"SLURM_PROCID": "3", "SLURM_NTASKS": "4"})[2:] == (3, 4)
    assert run({"EP_TPU_MULTIHOST": "1"})[2:] == (0, 1)
    assert not run({"EP_TPU_MULTIHOST": "0", "SLURM_PROCID": "1",
                    "SLURM_NTASKS": "4"})
    assert not run({"SLURM_PROCID": "0", "SLURM_NTASKS": "1"})
    assert not run({})
    # torchrun's RANK (a difference kept on purpose)
    assert run({"RANK": "1", "WORLD_SIZE": "2"})[2:] == (1, 2)
    assert run({"RANK": "0", "WORLD_SIZE": "2"})[2:] == (0, 2)
    assert not run({"RANK": "0", "WORLD_SIZE": "1"})
    # the rendezvous: --dist_url, else the JAX launcher's coordinator
    assert run({"SLURM_PROCID": "1", "SLURM_NTASKS": "2",
                "COORDINATOR_ADDRESS": "10.0.0.1:1234"})[1] == \
        "tcp://10.0.0.1:1234"
    url = "file:///nowhere/store"
    assert run({"RANK": "1", "WORLD_SIZE": "2"}, types.SimpleNamespace(
        dist_url=url, device="cpu"))[1] == url
    # no rank to be read: raise rather than run as one process
    for env in ({"WORLD_SIZE": "2"}, {"JOBSET_NAME": "job"},
                {"EP_TPU_MULTIHOST": "1", "WORLD_SIZE": "4"}):
        with pytest.raises(RuntimeError, match="rank"):
            run(env)
    # a group that is already there is kept
    monkeypatch.setattr(M.dist, "is_initialized", lambda: True)
    monkeypatch.setattr(M.dist, "get_world_size", lambda group=None: 2)
    monkeypatch.setattr(M.dist, "get_rank", lambda group=None: 1)
    assert not run({"RANK": "1", "WORLD_SIZE": "2"})


def test_make_mesh_shapes_errors_and_registry():
    """One process: the (1, 1) mesh, and a mesh larger than the world raises
    as the JAX ``make_mesh`` asserts it; ``make_mesh`` does not register,
    ``use_mesh`` restores. A rank's coordinates follow the JAX mesh's
    row-major device order."""
    import jax
    from ep_tpu.parallel import mesh as JM
    mesh = M.make_mesh()
    assert mesh.shape == {"data": 1, "model": 1} and mesh.groups == {}
    assert M.make_mesh(1, 1).shape == mesh.shape
    with pytest.raises(ValueError, match="mesh 2x1 != 1 processes"):
        M.make_mesh(2, 1)
    with pytest.raises(ValueError, match="not divisible by model=2"):
        M.make_mesh(-1, 2)
    assert M.current_mesh() is None
    with M.use_mesh(mesh) as m:
        assert M.current_mesh() is m is mesh
        with M.use_mesh(None):
            assert M.current_mesh() is None
        assert M.current_mesh() is mesh
    assert M.current_mesh() is None
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    devices = jax.devices()[:8]
    jmesh = JM.make_mesh(4, 2, devices=devices)
    for rank, d in enumerate(devices):
        where = tuple(int(i) for i in np.argwhere(jmesh.devices == d)[0])
        m = M.Mesh(4, 2, rank=rank)
        assert (m.data_index, m.model_index) == where
    assert M.process_count() == 1 and M.process_index() == 0
    assert M.is_main_process() and M.local_device_count() == 1
    M.barrier()
    a, b = M.shard_batch((np.zeros((2, 3)), np.arange(2)), "cpu")
    assert a.shape == (2, 3) and b.tolist() == [0, 1]


def test_attn_impl_auto_gate_mesh_shapes(monkeypatch):
    """``tests/test_pallas_gspmd.py::test_attn_impl_auto_gate_mesh_shapes``
    for the port: with 8 processes, "auto" keeps the kernels on a data-only
    mesh and takes the plain route on a model-2 mesh or with no mesh, where
    "pallas" still forces them; the JAX gate answers the same on the same
    meshes of devices, and ``int8_mlp_inactive_reason`` gives the JAX
    function's words. Blocks built on the model-2 mesh take the plain
    route."""
    import jax
    from ep_tpu.models.vit import ViTConfig as JaxViTConfig
    from ep_tpu.models.vit import _pallas_attn_enabled
    from ep_tpu.models.vit import int8_mlp_inactive_reason as jax_reason
    from ep_tpu.parallel import mesh as JM
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    monkeypatch.setenv("EP_TPU_PALLAS_INTERPRET", "1")
    monkeypatch.setattr(port_vit, "process_count", lambda: 8)
    auto = port_vit.ViTConfig(attn_impl="auto", int8_mlp=True)
    forced = port_vit.ViTConfig(attn_impl="pallas")
    jauto = JaxViTConfig(attn_impl="auto", int8_mlp=True)
    jforced = JaxViTConfig(attn_impl="pallas")
    for shape in ((8, 1), (4, 2)):
        with JM.use_mesh(JM.make_mesh(*shape)), M.use_mesh(M.Mesh(*shape)):
            assert auto.kernel_attention == _pallas_attn_enabled(jauto) == (
                shape[1] == 1)
            assert forced.kernel_attention and _pallas_attn_enabled(jforced)
            assert port_vit.int8_mlp_inactive_reason(auto) == jax_reason(jauto)
            if shape[1] > 1:
                assert "tensor-parallel mesh" in jax_reason(jauto)
                cfg = TrainConfig(**_step_cfg())
                model = ProbeModel(_tiny(build_backbone_config(cfg)), cfg)
                assert not any(b.supercell or b.attn.kernel
                               for b in model.backbone.blocks)
    with JM.use_mesh(None), M.use_mesh(None):
        assert not auto.kernel_attention and not _pallas_attn_enabled(jauto)
        assert forced.kernel_attention
    monkeypatch.setattr(port_vit, "process_count", lambda: 1)
    assert auto.kernel_attention  # one process: the kernels


def _jax_split_dim(spec) -> int | None:
    names = tuple(spec)
    return names.index("model") if "model" in names else None


@pytest.mark.parametrize("model_size", [2, 4])
@pytest.mark.parametrize("name", ["vit_base_patch16", "dinov2_vitg14"])
def test_spec_for_matches_jax(name, model_size):
    """Every leaf of the JAX package's ViT-B/16 and DINOv2-g/14 (SwiGLU)
    probe trees, paired with the port's name and shape by
    ``convert/from_flax.py``: ``spec_for`` splits the port's tensor where
    ``_spec_for`` splits the flax leaf (a dense kernel's dimensions
    swapped), 6 tensors a block."""
    import jax
    import jax.numpy as jnp
    from ep_tpu.configs import TrainConfig as JaxTrainConfig
    from ep_tpu.models.assembly import ProbeModel as FlaxProbeModel
    from ep_tpu.models.assembly import build_backbone_config as jax_bcfg
    from ep_tpu.parallel.partition import _spec_for
    from ep_tpu_torch.convert.from_flax import _param
    cfg = JaxTrainConfig(model=name, cls_features="ep", ep_queries=4,
                         amp="float32")
    bcfg = jax_bcfg(cfg)
    shapes = jax.eval_shape(
        lambda: FlaxProbeModel(bcfg, cfg).init(
            jax.random.key(0), jnp.zeros((1, 224, 224, 3)), train=True))
    leaves = jax.tree_util.tree_flatten_with_path(shapes["params"])[0]
    split = 0
    for path, leaf in leaves:
        keys = tuple(str(getattr(p, "key", p)) for p in path)
        port_name, arr = _param(keys, np.broadcast_to(np.float32(0),
                                                      leaf.shape))
        want = _jax_split_dim(_spec_for(path, leaf, model_size))
        if want is not None and len(leaf.shape) == 2:
            want = 1 - want  # (in, out) -> nn.Linear's (out, in)
        assert spec_for(port_name, arr.shape, model_size) == want, port_name
        split += want is not None
    assert split == 6 * bcfg.depth


def test_shard_state_at_model_1_and_refusal():
    """At model 1 ``shard_state`` leaves the state as it is. At model 2 it
    no longer refuses (item 9b is ported): it cuts the frozen blocks, here
    to rank 0's pieces, and leaves a module without blocks whole."""
    model = torch.nn.Linear(3, 2)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    assert shard_state(model, M.make_mesh()) is model
    assert all(torch.equal(v, before[k]) for k, v in
               model.state_dict().items())
    assert shard_state(model, M.Mesh(1, 2)) is model
    assert all(torch.equal(v, before[k]) for k, v in
               model.state_dict().items())
    cfg = TrainConfig(**_step_cfg())
    vit = ProbeModel(_tiny(build_backbone_config(cfg)), cfg)
    assert shard_state(vit, M.Mesh(1, 2)) is vit
    for blk in vit.backbone.blocks:  # width 32, 2 heads, hidden 128
        assert blk.attn.qkv.weight.shape == (48, 32)
        assert blk.attn.proj.weight.shape == (32, 16)
        assert blk.mlp.fc1.weight.shape == (64, 32)
        assert blk.mlp.fc2.weight.shape == (32, 64)
    assert vit.head.fc.weight.shape == (C, 32)


def test_metrics_helpers_at_world_size_1():
    """Without a mesh, and on the one-process mesh, the reductions are the
    identity; the host mean and ``weighted_merge`` answer as the JAX
    package's."""
    from ep_tpu.parallel import metrics as JPM
    x = torch.arange(4.0)
    for mesh in (None, M.make_mesh()):
        with M.use_mesh(mesh):
            assert PM.psum(x) is x and PM.pmean(x, "model") is x
            assert PM.all_gather_rows(x) is x
    assert PM.all_reduce_mean_host(2.5) == JPM.all_reduce_mean_host(2.5) \
        == 2.5
    stats = {"loss": (6.0, 3), "acc1": (1.0, 0)}
    assert PM.weighted_merge(stats) == JPM.weighted_merge(stats)
    assert PM.collective_device() == torch.device("cpu")


def test_device_crop_draws_the_global_batch_per_rank():
    """Each rank crops its rows with the global batch's draws of the step:
    two shards of 4 images give the crops of the whole batch of 8; the
    registered mesh's data axis sets the shards."""
    aug = DeviceAug(out_size=16, stage_size=20, seed=3, dtype=torch.float32)
    imgs = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (8, 20, 20, 3), dtype=np.uint8))
    whole = aug.train_fn(5, imgs)
    parts = [dataclasses.replace(aug, shards=2, shard=r).train_fn(
        5, imgs[4 * r:4 * (r + 1)]) for r in range(2)]
    torch.testing.assert_close(torch.cat(parts), whole, rtol=0, atol=0)
    cfg = TrainConfig(image_size=16, amp="float32")
    with M.use_mesh(M.Mesh(2, 2, rank=3)):
        got = DeviceAug.from_cfg(cfg)
    assert (got.shards, got.shard) == (2, 1)
    assert (DeviceAug.from_cfg(cfg).shards, DeviceAug.from_cfg(cfg).shard) \
        == (1, 0)


# ---- two ranks ---------------------------------------------------------------

def test_two_ranks_train_as_one_process_and_the_jax_step(two_ranks, mesh8):
    """Each rank steps on its half of the global batch: both report the same
    loss (and metrics) at every step and hold the same head bit for bit, and
    the losses, head and BN statistics are those of the port run as one
    process on the whole batch and of the JAX step on the 8-device mesh."""
    import jax
    from ep_tpu.configs import TrainConfig as JaxTrainConfig
    from ep_tpu.parallel import mesh as JM
    from ep_tpu.train import lars as jax_lars
    from ep_tpu.train import schedule as jax_schedule
    from ep_tpu.train import steps as jax_steps
    from ep_tpu.train.state import create_train_state
    (r0, r1), (fmodel, variables), _ = two_ranks
    imgs, labels = _data()
    for a, b in zip(r0["steps"], r1["steps"]):
        assert abs(a["loss"] - b["loss"]) <= 1e-6
        assert a == b
    assert all(torch.equal(v, r1["head"][k]) for k, v in r0["head"].items())

    cfg = TrainConfig(**_step_cfg())
    model = ProbeModel(_tiny(build_backbone_config(cfg)), cfg)
    from ep_tpu_torch.convert.from_flax import flax_to_torch
    params, buffers = flax_to_torch(variables, device="cpu")
    model.load_state_dict({**params, **buffers})
    one = _port_steps(model, imgs, labels)
    np.testing.assert_allclose([s["loss"] for s in r0["steps"]],
                               [s["loss"] for s in one], rtol=1e-5, atol=1e-5)
    for k, v in _head_state(model).items():
        np.testing.assert_allclose(r0["head"][k].numpy(), v.numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=k)

    jcfg = JaxTrainConfig(**_step_cfg())
    tx = jax_lars.build_optimizer("lars", 0.0)
    state = create_train_state(variables, tx, finetuning=False)
    step = jax_steps.make_train_step(
        fmodel, tx, jax_schedule.make_lr_fn(jcfg, STEPS_PER_EPOCH), mesh8)
    losses_j = []
    with JM.use_mesh(mesh8):
        for i in range(N_STEPS):
            state, m = step(state, JM.shard_batch(imgs[i], mesh8),
                            JM.shard_batch(labels[i], mesh8))
            losses_j.append(float(m["loss"]))
    head_j = jax.tree_util.tree_map(np.asarray, state.trainable["head"])
    bn_j = jax.tree_util.tree_map(np.asarray, state.batch_stats["head"]["bn"])
    np.testing.assert_allclose([s["loss"] for s in r0["steps"]], losses_j,
                               rtol=1e-5, atol=1e-5)
    pairs = {"pool.cls_token": head_j["pool"]["cls_token"],
             "pool.v.weight": head_j["pool"]["v"]["kernel"].T,
             "fc.weight": head_j["fc"]["kernel"].T,
             "fc.bias": head_j["fc"]["bias"],
             "bn.running_mean": bn_j["mean"], "bn.running_var": bn_j["var"]}
    for k, j in pairs.items():
        np.testing.assert_allclose(r0["head"][k].numpy(), j, rtol=1e-5,
                                   atol=1e-5, err_msg=k)
    # the trajectory moved the head and the statistics
    assert not np.allclose(head_j["fc"]["bias"],
                           variables["params"]["head"]["fc"]["bias"])
    assert not np.allclose(bn_j["var"], 1.0)


def test_two_ranks_accumulate_as_one_process(two_ranks):
    """``--accum_iter 2`` over two ranks: each micro-step's gradient is
    reduced, so every micro-step reports the global batch's loss and
    gradient norm, and the update at the second micro-step is one
    process's."""
    (r0, r1), (_, variables), _ = two_ranks
    from ep_tpu_torch.convert.from_flax import flax_to_torch
    imgs, labels = _data()
    assert r0["steps_accum"] == r1["steps_accum"]
    cfg = TrainConfig(**_step_cfg())
    model = ProbeModel(_tiny(build_backbone_config(cfg)), cfg)
    params, buffers = flax_to_torch(variables, device="cpu")
    model.load_state_dict({**params, **buffers})
    one = _port_steps(model, imgs, labels, accum=2)
    for k in ("loss", "acc1", "grad_norm", "lr"):
        np.testing.assert_allclose([s[k] for s in r0["steps_accum"]],
                                   [s[k] for s in one], rtol=1e-5, atol=1e-5,
                                   err_msg=k)
    for k, v in _head_state(model).items():
        np.testing.assert_allclose(r0["head_accum"][k].numpy(), v.numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=k)
    assert not torch.equal(r0["head_accum"]["fc.weight"],
                           r0["head"]["fc.weight"])


def test_four_ranks_on_a_2x2_mesh(tmp_path):
    """Four ranks on a (2, 2) mesh: row-major coordinates, and each axis'
    group holds the ranks that share the other coordinate (data: {0, 2} and
    {1, 3}; model: {0, 1} and {2, 3})."""
    _start("mesh_worker", 4, tmp_path)
    got = [torch.load(tmp_path / f"mesh{r}.pth") for r in range(4)]
    assert [g["at"] for g in got] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert [g["data"] for g in got] == [2.0, 4.0, 2.0, 4.0]
    assert [g["model"] for g in got] == [1.0, 1.0, 5.0, 5.0]
    assert [g["gather"] for g in got] == [[0.0, 1.0]] * 2 + [[2.0, 3.0]] * 2


def test_two_rank_helpers(two_ranks):
    """``psum`` sums and its backward sums the ranks' gradients; ``pmean``,
    the gather in rank order, the host mean; on a model-2 mesh the gate
    takes the plain route and ``shard_state`` cuts the blocks (qkv's rows of
    one of 2 heads); neither rank imported JAX."""
    (r0, r1), _, _ = two_ranks
    for r in (r0, r1):
        y, g = r["psum"]
        assert y.tolist() == [10.0, 12.0, 14.0] and g.tolist() == [3.0] * 3
        assert r["pmean"].tolist() == [0.5, 0.5]
        assert r["gather"].tolist() == [[0.0] * 3] * 2 + [[1.0] * 3] * 2
        assert r["host_mean"] == 1.0
        assert r["tp_kernel"] is False and r["tp_cut"] == (48, 32)
        assert not r["jax_imported"]


def test_two_rank_cached_driver(two_ranks, tmp_path):
    """``--cache_features`` over two ranks: each extracts its shard and the
    batches are gathered, so both train the head on the whole cache and
    reach the same accuracy as the one-process run; only rank 0 writes
    ``training_log.txt`` and the checkpoint."""
    (r0, r1), _, tmp = two_ranks
    (res0, _), (res1, _) = r0["cached"], r1["cached"]
    assert res0 == res1
    one, _ = _drive("cached", tmp_path)
    assert res0["max_accuracy"] == one["max_accuracy"]
    assert res0["max_accuracy"] > 40.0  # chance = 25%
    assert (tmp / "cached" / "rank0" / "training_log.txt").exists()
    assert (tmp / "cached" / "rank0" / "checkpoint-.pth").exists()
    assert not any((tmp / "cached" / "rank1").glob("*"))


def test_two_rank_dist_eval(two_ranks, tmp_path):
    """``--eval --dist_eval`` on 127 val images: each rank evaluates its
    shard (the sampler's wraparound repeats image 0) and the sums are
    all-reduced, so both ranks report the numbers one process gives on those
    128 images."""
    (r0, r1), _, _ = two_ranks
    (res0, _), (res1, _) = r0["dist_eval"], r1["dist_eval"]
    assert res0 == res1
    one, _ = _drive("dist_eval", tmp_path, val_rows=list(range(127)) + [0])
    for k in ("loss", "acc1", "acc5"):
        assert res0[k] == pytest.approx(one[k], rel=1e-6, abs=1e-6), k


def test_two_rank_knn_eval(two_ranks, tmp_path):
    """``--knn_eval`` over two ranks: the train features of both shards are
    gathered, and the sweep equals the one-process run's."""
    (r0, r1), _, _ = two_ranks
    assert r0["knn"][0] == r1["knn"][0]
    one, _ = _drive("knn", tmp_path)
    assert r0["knn"][0]["knn"] == one["knn"]


def test_two_rank_mesh_model_2(two_ranks, tmp_path):
    """``--mesh_model 2`` on two ranks: both read the same rows and hold the
    whole model, the blocks take the plain route, and the epoch equals the
    one-process run's (where the blocks take the kernel route)."""
    (r0, r1), _, _ = two_ranks
    (res0, cells0), (res1, cells1) = r0["mesh_model"], r1["mesh_model"]
    assert not any(cells0) and not any(cells1)
    assert res0 == res1
    one, cells = _drive("mesh_model", tmp_path, mesh_model=1)
    assert all(cells)
    for k in ("max_accuracy", "loss", "acc1", "acc5"):
        assert res0[k] == pytest.approx(one[k], rel=1e-5, abs=1e-5), k
