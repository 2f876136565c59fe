"""Tensor parallelism of the port (``parallel/partition.py::shard_state`` at a
model axis above 1, ROADMAP module item 9b) against the port as one process
and the JAX package's sharded step, on the CPU.

Two ranks on ``gloo`` at mesh (data 1, model 2), started once for the module
(each process imports no JAX), build every case's probe model with the mesh
registered, load the same weights, call ``shard_state`` and run an eval
forward (logits and the backbone's features) and 2 LARS train steps on the
same batch; four ranks at mesh (2, 2) run the plain ViT case on their halves
of the batch. For every case both ranks agree bit for bit, and the logits,
features, losses, head and BN statistics are within 1e-5 (f32) of:

* the port as one process on the same weights (``flax_to_torch``), whose
  "auto" blocks take the kernels' routes (their plain versions here);
* the JAX package's ``shard_state`` + ``make_train_step`` on
  ``make_mesh(1, 2)`` of the conftest's virtual CPU devices, as
  ``__graft_entry__.py::_dryrun_impl`` runs it (XLA's attention under
  "auto"; the Pallas kernels in interpret mode under "pallas"; compiled
  without excess precision, as ``tests/test_torch_int8.py`` compiles the
  int8 half).

Cases: a plain ViT (GELU, full qkv bias, 4 heads), SimMIM-like (``qv_only``,
a shared relative-position table, LayerScale), DINOv2-like (SwiGLU,
LayerScale, 4 registers), OpenCLIP-like (QuickGELU, ``pre_norm``, the cls
projection), MAE's encoder, 3 heads (the attention half stays whole, the MLP
half is cut), the ``ca2``, ``attn-mn`` and ``dino`` modes (probabilities
joined into head order; the oracle cut too), ``capture_stats=True``, and
``attn_impl="pallas"`` with and without ``int8_mlp`` (the pieces joined into
whole tensors for each block). Placement: each rank's tensors are the
head-group and half slices of the whole ones, each with storage of its own;
``finetuning=True`` cuts nothing.

Tiny sizes: 32 px images in patches of 8, depth 2, D=64 (48 for 3 heads),
float32, a batch of 8.
"""
from __future__ import annotations

import dataclasses
import os
import subprocess
import sys
import time
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from ep_tpu_torch.configs import TrainConfig
from ep_tpu_torch.models.assembly import ProbeModel
from ep_tpu_torch.parallel import mesh as M
from ep_tpu_torch.parallel.partition import shard_state
from ep_tpu_torch.train import schedule
from ep_tpu_torch.train.lars import LARS
from ep_tpu_torch.train.state import freeze
from ep_tpu_torch.train.steps import make_train_step

ROOT = Path(__file__).resolve().parent.parent
IMG, PATCH, D, DEPTH, HEADS, B, C, N_STEPS = 32, 8, 64, 2, 4, 8, 5, 2
TOL = 1e-5
BASE = dict(model="vit_tiny_patch16", cls_features="ep", ep_queries=4,
            d_out=1, nb_classes=C, image_size=IMG, amp="float32",
            batch_size=B, eff_batch_size=B, epochs=4, warmup_epochs=1,
            lr=2.0, min_lr=0.0, pallas_pool=False)
CASES = {
    # name -> (TrainConfig overrides, backbone overrides)
    "vit": ({}, {}),
    "simmim": (dict(simmim=True), {}),
    "dinov2": (dict(model="dinov2_vitg14_reg"), {}),
    "openclip": (dict(model="ViT-B-16", openclip=True, cls_features="cls"),
                 dict(proj_dim=32)),
    "mae": (dict(model="mae_vit_base_patch16"), {}),
    "heads3": ({}, dict(embed_dim=48, num_heads=3)),
    "ca2": (dict(cls_features="ca2"), {}),
    "attn-mn": (dict(cls_features="attn-mn"), {}),
    "dino": (dict(cls_features="dino"), {}),
    "capture": ({}, {}),
    "pallas": (dict(attn_impl="pallas"), {}),
    "pallas-int8": (dict(attn_impl="pallas", int8_mlp=True), {}),
}
FOUR_RANK_CASE = "vit"
LAUNCHER_VARS = ("EP_TPU_MULTIHOST", "COORDINATOR_ADDRESS", "SLURM_PROCID",
                 "OMPI_COMM_WORLD_RANK", "JOBSET_NAME", "RANK", "SLURM_NTASKS",
                 "OMPI_COMM_WORLD_SIZE", "WORLD_SIZE", "MASTER_ADDR",
                 "LOCAL_RANK")


def _data():
    rng = np.random.default_rng(0)
    labels = rng.integers(0, C, size=(N_STEPS, B)).astype(np.int32)
    imgs = rng.standard_normal((N_STEPS, B, IMG, IMG, 3)).astype(np.float32)
    return imgs, labels


def _train_cfg(name: str, **kw) -> dict:
    return {**BASE, **CASES[name][0], **kw}


# ---- the port's side (the ranks import no JAX) ------------------------------

def _port_run(model, imgs, labels, rows=slice(None), capture=False) -> dict:
    """An eval forward on step 0's batch (logits, the backbone's features),
    then N_STEPS train steps on ``rows`` of each batch: the losses, the
    head's state (BN's statistics in it)."""
    model.eval()
    x0 = torch.from_numpy(imgs[0][rows])
    with torch.no_grad():
        logits, feats = model(x0, return_backbone_features=True)
        out = dict(logits=logits, feats=feats)
        if capture:
            out["capture"] = model.backbone(x0, "cls", capture_stats=True)
    model.train()
    cfg = model.cfg
    opt = LARS(freeze(model, False), weight_decay=0.0)
    step = make_train_step(model, opt, schedule.make_lr_fn(cfg, 2))
    out["losses"] = [float(step(i, torch.from_numpy(imgs[i][rows]),
                                torch.from_numpy(labels[i][rows]).long())
                          ["loss"]) for i in range(N_STEPS)]
    out["head"] = {k: v.clone() for k, v in model.head.state_dict().items()}
    return out


def _build(case: dict, finetuning: bool = False) -> ProbeModel:
    cfg = TrainConfig(**{**case["cfg"], "finetuning": finetuning})
    model = ProbeModel(case["bcfg"], cfg)
    model.load_state_dict(case["state"])
    model.cfg = cfg
    return model


def _pieces(model) -> dict:
    """Every backbone (and oracle) parameter after the cut, and whether each
    has storage of its own (no view of a larger tensor)."""
    return {k: (p.detach().clone(), p._base is None and
                p.untyped_storage().nbytes() == p.numel() * p.element_size())
            for k, p in model.named_parameters() if not k.startswith("head.")}


def _joins(model) -> int:
    """Blocks that join their pieces for each call (the kernel route)."""
    return sum(getattr(m, "gather", False) for m in model.modules())


def worker(rank: int, tmp: str, world: int) -> None:
    """One rank: joins the group (a ``file://`` store), runs every case on
    mesh (1, 2), or at world size 4 the four-rank case on mesh (2, 2), and
    saves what it saw to ``out{world}_{rank}.pth``."""
    tmp = Path(tmp)
    M.init_distributed(types.SimpleNamespace(
        dist_url=f"file://{tmp}/store{world}", device="cpu"))
    assert M.process_count() == world and M.process_index() == rank
    while not (tmp / "inputs.pth").exists():  # the ranks start before it
        time.sleep(0.05)
    inputs = torch.load(tmp / "inputs.pth", weights_only=False)
    imgs, labels = inputs["imgs"], inputs["labels"]
    mesh = M.make_mesh(world // 2, 2)
    out = {}
    with M.use_mesh(mesh):
        names = CASES if world == 2 else [FOUR_RANK_CASE]
        for name in names:
            case = inputs["cases"][name]
            model = _build(case)
            if rank == 1:  # shard_state brings rank 0's weights back
                with torch.no_grad():
                    model.head.fc.weight.add_(1.0)
            shard_state(model, mesh)
            half = B // mesh.shape["data"]
            rows = slice(mesh.data_index * half, (mesh.data_index + 1) * half)
            res = dict(pieces=_pieces(model), joins=_joins(model))
            res.update(_port_run(model, imgs, labels, rows,
                                 capture=name == "capture"))
            out[name] = res
        if world == 2:
            model = _build(inputs["cases"]["vit"], finetuning=True)
            shard_state(model, mesh)
            out["finetuning"] = _pieces(model)
    out["jax_imported"] = "jax" in sys.modules or any(
        k == "ep_tpu" or k.startswith("ep_tpu.") for k in sys.modules)
    torch.save(out, tmp / f"out{world}_{rank}.pth")


def _start(world: int, tmp: Path):
    env = {k: v for k, v in os.environ.items() if k not in LAUNCHER_VARS}
    env.update(WORLD_SIZE=str(world), GLOO_SOCKET_IFNAME="lo",
               OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([str(ROOT), str(ROOT / "tests")]))
    code = "import test_torch_tensor_parallel as t; t.worker({}, {!r}, {})"
    return [subprocess.Popen(
        [sys.executable, "-c", code.format(r, str(tmp), world)],
        env={**env, "RANK": str(r), "LOCAL_RANK": str(r)},
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]


# ---- the JAX side and the inputs ---------------------------------------------

def _flax_case(name: str):
    """(flax model, its variables with the backbone and oracle redrawn, the
    port's backbone config) of case ``name``: the port's model, DINOv2 in
    the hub's layout (``test_torch_backbone_util.hub_twin``)."""
    import jax
    import jax.numpy as jnp
    from ep_tpu.configs import TrainConfig as JaxTrainConfig
    from ep_tpu.models.assembly import ProbeModel as FlaxProbeModel
    from ep_tpu.models.assembly import build_backbone_config
    from ep_tpu_torch.models import mae as pmae
    from ep_tpu_torch.models.assembly import (
        build_backbone_config as port_backbone_config)
    from test_torch_backbone_util import (hub_twin, hub_variables,
                                          redraw_backbone)
    cfg = JaxTrainConfig(**_train_cfg(name))
    cut = dict(img_size=IMG, patch_size=PATCH, embed_dim=D, depth=DEPTH,
               num_heads=HEADS)
    pbcfg = port_backbone_config(TrainConfig(**_train_cfg(name)))
    bcfg = build_backbone_config(cfg)
    if not isinstance(pbcfg, pmae.MAEConfig):
        cut = {**cut, "attn_impl": cfg.attn_impl, **CASES[name][1]}
    pbcfg = dataclasses.replace(pbcfg, **cut)
    bcfg = hub_twin(dataclasses.replace(bcfg, **cut), pbcfg)
    fm = FlaxProbeModel(bcfg, cfg)
    v = fm.init(jax.random.key(0), jnp.zeros((2, IMG, IMG, 3)), train=True)
    return fm, hub_variables(redraw_backbone(v, seed=len(name)), pbcfg), pbcfg


class _Ranks:
    """The two-rank and four-rank runs, started side by side; ``outs[w]``
    waits for world ``w``'s ranks (the JAX side compiles meanwhile) and holds
    each rank's outputs."""

    def __init__(self, tmp: Path):
        self.tmp, self.flax, self.cases = tmp, {}, {}
        self.procs = {w: _start(w, tmp) for w in (2, 4)}
        self._outs = {}

    @property
    def outs(self) -> dict:
        for w, ps in self.procs.items():
            if w in self._outs:
                continue
            logs = [p.communicate(timeout=300)[0] for p in ps]
            for r, (p, log) in enumerate(zip(ps, logs)):
                assert p.returncode == 0, f"world {w} rank {r}:\n{log[-4000:]}"
            self._outs[w] = tuple(torch.load(self.tmp / f"out{w}_{r}.pth",
                                             weights_only=False)
                                  for r in range(w))
        return self._outs

    def stop(self) -> None:
        for ps in self.procs.values():
            for p in ps:
                p.kill()
                p.wait()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The ranks, started first (they wait for their inputs), and every
    case's flax model and weights, written for them."""
    from ep_tpu_torch.convert.from_flax import flax_to_torch
    from test_torch_backbone_util import drop_register_rows
    tmp = tmp_path_factory.mktemp("tensor_parallel")
    run = _Ranks(tmp)
    try:
        for name in CASES:
            fm, v, bcfg = _flax_case(name)
            params, buffers = flax_to_torch(v, device="cpu")
            run.cases[name] = dict(cfg=_train_cfg(name), bcfg=bcfg,
                                   state=drop_register_rows(
                                       {**params, **buffers}, bcfg))
            run.flax[name] = (fm, v)
        imgs, labels = _data()
        torch.save(dict(cases=run.cases, imgs=imgs, labels=labels),
                   tmp / "inputs.part")
        (tmp / "inputs.part").rename(tmp / "inputs.pth")
        yield run
    finally:
        run.stop()


def _one_process(case: dict, name: str) -> dict:
    imgs, labels = _data()
    return _port_run(_build(case), imgs, labels, capture=name == "capture")


def _close(got, want, what):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL, err_msg=what)


def _strict(fn, *args):
    """``fn(*args)`` compiled without XLA's excess precision."""
    import jax
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})(*args)


def _jax_sharded(name, fm, variables, monkeypatch, model: int = 2) -> dict:
    """The JAX package's sharded run of case ``name``: ``shard_state`` on
    ``make_mesh(1, model)``, an eval forward, then ``make_train_step``'s
    steps."""
    import jax
    from ep_tpu.configs import TrainConfig as JaxTrainConfig
    from ep_tpu.models.vit import VisionTransformer as FlaxViT
    from ep_tpu.parallel import mesh as JM
    from ep_tpu.parallel.partition import shard_state as jax_shard_state
    from ep_tpu.train import lars as jax_lars
    from ep_tpu.train import schedule as jax_schedule
    from ep_tpu.train import steps as jax_steps
    from ep_tpu.train.state import create_train_state
    if len(jax.devices()) < model:
        pytest.skip(f"needs {model} virtual devices")
    monkeypatch.setenv("EP_TPU_PALLAS_INTERPRET", "1")
    imgs, labels = _data()
    cfg = JaxTrainConfig(**_train_cfg(name))
    mesh = JM.make_mesh(1, model, devices=jax.devices()[:model])
    tx = jax_lars.build_optimizer("lars", 0.0)
    out = {}
    with JM.use_mesh(mesh):
        state = jax_shard_state(create_train_state(variables, tx, False), mesh)
        x0 = JM.shard_batch(imgs[0], mesh)
        full = {"params": state.full_params(),
                "batch_stats": state.batch_stats}
        out["logits"], out["feats"] = _strict(
            lambda v, x: fm.apply(v, x, train=False,
                                  return_backbone_features=True), full, x0)
        if name == "capture":
            vit = FlaxViT(fm.backbone_cfg)
            out["capture"] = _strict(
                lambda v, x: vit.apply(v, x, "cls", capture_stats=True),
                {"params": state.frozen["backbone"]}, x0)
        step = jax_steps.make_train_step(
            fm, tx, jax_schedule.make_lr_fn(cfg, 2), mesh)
        losses, compiled = [], None
        for i in range(N_STEPS):
            args = (state, JM.shard_batch(imgs[i], mesh),
                    JM.shard_batch(labels[i], mesh))
            if compiled is None:
                compiled = step.lower(*args).compile(compiler_options={
                    "xla_allow_excess_precision": False})
            state, m = compiled(*args)
            losses.append(float(m["loss"]))
    out["losses"] = losses
    head = {"params": {"head": state.trainable["head"]},
            "batch_stats": state.batch_stats}
    from ep_tpu_torch.convert.from_flax import flax_to_torch
    params, buffers = flax_to_torch(jax.tree_util.tree_map(np.asarray, head),
                                    device="cpu")
    out["head"] = {k[len("head."):]: v for k, v in {**params, **buffers}.items()
                   if not k.endswith("num_batches_tracked")}
    return out


def _same_run(got: dict, want: dict, what: str, close=_close) -> None:
    """Logits, features, losses, the head and BN's statistics (and the
    capture's features, statistics and magnitudes) within TOL."""
    for k in ("logits", "feats", "losses"):
        close(got[k], want[k], f"{what}: {k}")
    for k, v in want["head"].items():
        close(got["head"][k], v, f"{what}: head.{k}")
    if "capture" in want:
        for a, b, k in zip(got["capture"], want["capture"],
                           ("features", "stats", "magnitudes")):
            close(a, b, f"{what}: capture {k}")


# ---- the tests ----------------------------------------------------------------

def _int8_close(got, want, what):
    """A whole int8 model against the JAX package's: every element within
    1e-2 of the largest magnitude and a mean relative distance under 5e-3,
    the bound ``tests/test_torch_int8.py::_assert_model_close`` holds logits
    to. The packages' attention halves differ in the last bits, which moves
    single int8 codes, each a quantisation step in a token's outputs; one
    process is as far from JAX as the cut model is."""
    from test_torch_int8 import _assert_model_close
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    _assert_model_close(got, np.asarray(want, np.float32), "float32",
                        logits=True)


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_run_matches_the_jax_sharded_step(ranks, name, monkeypatch):
    """Logits, features, losses, head and BN statistics of the cut model
    against the JAX package's ``shard_state`` and train step on a (1, 2)
    mesh of virtual devices. The int8 case: the JAX run cut over 2 devices
    within TOL of its run on one, the port's within the int8 model bound of
    it (its one-process run within TOL of the cut one:
    ``test_sharded_run_matches_one_process``)."""
    fm, v = ranks.flax[name]
    want = _jax_sharded(name, fm, v, monkeypatch)
    close = _close
    if name == "pallas-int8":
        _same_run(want, _jax_sharded(name, fm, v, monkeypatch, model=1),
                  "JAX cut against JAX whole")
        close = _int8_close
    _same_run(ranks.outs[2][0][name], want, name, close)


@pytest.mark.parametrize("name", list(CASES))
def test_ranks_agree_and_import_no_jax(ranks, name):
    """Both ranks of a model group compute the same thing, bit for bit, and
    neither imported JAX."""
    r0, r1 = ranks.outs[2]
    a, b = r0[name], r1[name]
    for k in ("logits", "feats"):
        assert torch.equal(a[k], b[k]), k
    assert a["losses"] == b["losses"]
    assert all(torch.equal(v, b["head"][k]) for k, v in a["head"].items())
    assert not r0["jax_imported"] and not r1["jax_imported"]


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_run_matches_one_process(ranks, name):
    """The same quantities against the port as one process on the same
    weights, whose blocks take the kernels' routes (plain versions here)."""
    _same_run(ranks.outs[2][0][name], _one_process(ranks.cases[name], name),
              name)


def _expected_pieces(state: dict, rank: int, heads: int) -> dict:
    """The pieces rank ``rank`` of 2 should hold, from the whole tensors:
    qkv's (and its bias's) q, k and v rows of its head group and proj's
    matching columns where 2 divides the heads; its half of fc1's rows and
    of each of w12's two halves, fc2's and w3's matching columns."""
    want = {}
    for k, t in state.items():
        leaf = k.rsplit(".", 2)
        tail = ".".join(leaf[-2:])
        if tail in ("qkv.weight", "qkv.bias") and heads % 2 == 0:
            n = t.shape[0] // 6
            want[k] = torch.cat([t[j * 2 * n + rank * n:
                                   j * 2 * n + (rank + 1) * n]
                                 for j in range(3)])
        elif tail == "proj.weight" and ".attn." in k and heads % 2 == 0:
            n = t.shape[1] // 2
            want[k] = t[:, rank * n:(rank + 1) * n]
        elif tail in ("fc1.weight", "fc1.bias"):
            n = t.shape[0] // 2
            want[k] = t[rank * n:(rank + 1) * n]
        elif tail in ("w12.weight", "w12.bias"):
            n = t.shape[0] // 4
            want[k] = torch.cat([t[j * 2 * n + rank * n:
                                   j * 2 * n + (rank + 1) * n]
                                 for j in range(2)])
        elif tail in ("fc2.weight", "w3.weight"):
            n = t.shape[1] // 2
            want[k] = t[:, rank * n:(rank + 1) * n]
        else:
            want[k] = t
    return want


@pytest.mark.parametrize("name", ["vit", "dinov2", "heads3", "mae", "dino",
                                  "simmim"])
def test_each_rank_holds_its_slices_in_storage_of_its_own(ranks, name):
    """Each rank's backbone (and oracle) tensors are exactly its head-group
    and half slices of the whole ones, at the expected shapes, each a copy
    whose storage is just its piece; every other tensor stays whole. With 3
    heads only the MLP half is cut."""
    outs, cases = ranks.outs, ranks.cases
    state = {k: v for k, v in cases[name]["state"].items()
             if not k.startswith("head.") and "running" not in k
             and "num_batches" not in k}
    heads = cases[name]["bcfg"].num_heads
    cut = 0
    for rank, out in enumerate(outs[2]):
        pieces = out[name]["pieces"]
        want = _expected_pieces(state, rank, heads)
        assert set(pieces) == set(want)
        for k, w in want.items():
            got, own = pieces[k]
            assert own, k
            assert got.shape == w.shape and torch.equal(got, w), k
            cut += got.shape != state[k].shape
    # a block's cut tensors: qkv, its bias (none under SimMIM's qv_only)
    # and proj where 2 divides the heads; fc1 or w12, its bias, fc2 or w3
    attn = (3 if name != "simmim" else 2) if heads % 2 == 0 else 0
    blocks = DEPTH * (2 if name == "dino" else 1)  # the oracle's too
    assert cut == 2 * blocks * (attn + 3)
    assert outs[2][0][name]["joins"] == 0


def test_pallas_blocks_join_their_pieces(ranks):
    """Under ``attn_impl="pallas"`` every cut block joins its pieces for each
    call (the kernels' route); under "auto" none does."""
    r0 = ranks.outs[2][0]
    assert r0["pallas"]["joins"] == r0["pallas-int8"]["joins"] == DEPTH
    assert r0["vit"]["joins"] == 0


def test_finetuning_cuts_nothing(ranks):
    """With ``finetuning=True`` the backbone is trained, not frozen: every
    tensor stays whole on both ranks, as the JAX rule's ``use_tp`` says."""
    outs, state = ranks.outs, ranks.cases["vit"]["state"]
    for out in outs[2]:
        for k, (got, _) in out["finetuning"].items():
            assert torch.equal(got, state[k]), k


def test_four_ranks_on_a_2x2_mesh_match_one_process(ranks):
    """Mesh (2, 2): each data index steps on its half of the batch, each
    model group cuts the backbone; the losses, head and BN statistics are
    one process's on the whole batch, on all four ranks."""
    one = _one_process(ranks.cases[FOUR_RANK_CASE], FOUR_RANK_CASE)
    four = ranks.outs[4]
    for out in four:
        _close(out[FOUR_RANK_CASE]["losses"], one["losses"], "losses")
        for k, v in one["head"].items():
            _close(out[FOUR_RANK_CASE]["head"][k], v, f"head.{k}")
    # the model groups {0, 1} and {2, 3} hold the same pieces
    for k, (t, _) in four[0][FOUR_RANK_CASE]["pieces"].items():
        assert torch.equal(t, four[2][FOUR_RANK_CASE]["pieces"][k][0]), k
