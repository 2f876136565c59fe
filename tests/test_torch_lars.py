"""The host side of the LARS kernel pair (``ep_tpu_torch/ops/lars.py``) and
the gradient norm of the train step, on the CPU.

The kernels run only on the card (``tests/test_torch_cuda.py`` holds them to
the plain loop); here: the chunk table both passes walk, the per-step
pointer rows, the leaf table's layout against ``csrc/lars.cu``, that CPU
parameters keep the plain loop, and ``global_grad_norm`` against the
per-leaf sum it replaced.
"""
import re

import numpy as np
import pytest
import torch

from ep_tpu_torch.ops import LAUNCHES, reset_launches
from ep_tpu_torch.ops._build import CSRC_DIR
from ep_tpu_torch.ops.lars import CHUNK, LEAF_DTYPE, chunk_table, pointer_rows
from ep_tpu_torch.train.lars import LARS, RawUpdateOptimizer
from ep_tpu_torch.train.steps import global_grad_norm

# ViT-B/16's fine-tuning leaves in the order of its parameters: the patch
# embedding, a block, the EP head; then empty leaves, leaves of one element,
# a chunk exactly, one past it
VIT_B = [768 * 3 * 16 * 16, 768, 768, 197 * 768, 768, 768, 2304 * 768, 2304,
         768 * 768, 768, 768, 768, 3072 * 768, 3072, 768 * 3072, 768,
         32 * 768, 768 * 768, 1000 * 768, 1000]


@pytest.mark.parametrize("numels, chunk", [
    (VIT_B, CHUNK), (VIT_B, 4), ([0, 5, 0, 0, 1, 7], 4), ([0], CHUNK),
    ([], CHUNK), ([CHUNK, CHUNK + 1, CHUNK - 1, 1], CHUNK),
    ([3, 4, 5, 8, 9], 4), ([2 ** 31 + 3], 2 ** 20)])
def test_chunk_table_covers_every_element_once_in_order(numels, chunk):
    """Chunk c of leaf l covers [(c - first[l]) * chunk, min(that + chunk,
    numel)), as both kernels compute it (csrc/lars.cu::chunk_span)."""
    leaf_of, first, count = chunk_table(numels, chunk)
    assert len(first) == len(count) == len(numels)
    assert leaf_of == sorted(leaf_of)  # leaf after leaf
    at = {leaf: 0 for leaf in range(len(numels))}
    for c, leaf in enumerate(leaf_of):
        assert first[leaf] <= c < first[leaf] + count[leaf]
        lo = (c - first[leaf]) * chunk
        hi = min(lo + chunk, numels[leaf])
        assert lo == at[leaf] and lo < hi  # no gap, no overlap, none empty
        assert lo % 4 == 0  # the vector walk's alignment
        at[leaf] = hi
    assert [at[leaf] for leaf in range(len(numels))] == list(numels)
    assert count == [-(-n // chunk) for n in numels]


def test_leaf_table_is_the_kernels_struct():
    """``LEAF_DTYPE`` lays out ``LarsLeaf`` of ``csrc/lars.cu`` field for
    field (8-byte numel, then 4-byte fields, 32 bytes), and the per-step row
    is the five 8-byte words of ``LarsPtrs``."""
    src = (CSRC_DIR / "lars.cu").read_text()
    body = re.search(r"struct LarsLeaf \{(.*?)\};", src, re.S).group(1)
    fields = re.findall(r"(long long|int|float)\s+([\w, ]+);", body)
    names = [n.strip() for _, ns in fields for n in ns.split(",")]
    assert names == [
        "numel", "first_chunk", "n_chunks", "scaled", "weight_decay",
        "trust", "momentum"]
    assert list(LEAF_DTYPE.names) == names
    assert LEAF_DTYPE.itemsize == 32
    assert "sizeof(LarsLeaf) == 32" in src and "sizeof(LarsPtrs) == 40" in src
    assert CHUNK % 4 == 0


def test_pointer_rows():
    """Five words a leaf: p, g or 0, the momentum read or 0, the one
    written, the dtype codes; a momentum of another type than mu_dtype is
    read from and a new one written."""
    p = [torch.zeros(3, 4), torch.zeros(5, dtype=torch.bfloat16),
         torch.zeros(2, 2), torch.zeros(0)]
    g = [torch.ones(3, 4), None, torch.ones(2, 2, dtype=torch.float32), None]
    mu = [None, torch.zeros(5, dtype=torch.bfloat16), torch.zeros(2, 2), None]
    rows, out, held = pointer_rows(p, g, mu, torch.bfloat16)
    assert len(rows) == 5 * len(p)
    r = np.array(rows).reshape(-1, 5)
    assert (r[:, 0] == [t.data_ptr() for t in p]).all()
    assert r[0, 1] == g[0].data_ptr() and r[1, 1] == 0 and r[3, 1] == 0
    assert r[0, 2] == 0 and r[1, 2] == mu[1].data_ptr() and r[3, 2] == 0
    assert out[1] is mu[1]  # kept in place: bf16 is mu_dtype
    assert out[2] is not mu[2] and out[2].dtype == torch.bfloat16
    assert all(o.shape == t.shape and o.dtype == torch.bfloat16
               for o, t in zip(out, p))
    assert (r[:, 3] == [o.data_ptr() for o in out]).all()
    assert list(r[:, 4]) == [0 | 0 << 2 | 1 << 6, 1 | 1 << 4 | 1 << 6,
                             0 | 0 << 2 | 0 << 4 | 1 << 6, 1 << 6]
    assert held[0] is g[0]


@pytest.mark.parametrize("bad", ["p_dtype", "g_shape", "mu_dtype", "strided"])
def test_pointer_rows_refuse_what_the_kernels_do_not_take(bad):
    p, g, mu, mu_dtype = torch.zeros(4, 6), torch.zeros(4, 6), None, torch.float32
    if bad == "p_dtype":
        p, g = p.half(), g.half()
    elif bad == "g_shape":
        g = torch.zeros(24)
    elif bad == "mu_dtype":
        mu_dtype = torch.float16
    else:
        p = torch.zeros(6, 4).t()
    with pytest.raises((TypeError, ValueError)):
        pointer_rows([p], [g], [mu], mu_dtype)


class PlainLARS(LARS):
    """LARS through ``RawUpdateOptimizer``'s loop on any device."""
    _apply_updates = RawUpdateOptimizer._apply_updates


@pytest.mark.parametrize("accum", [1, 2])
def test_lars_on_the_cpu_keeps_the_plain_loop(accum):
    """CPU parameters take ``RawUpdateOptimizer``'s loop over ``_update``,
    bit for bit, and launch nothing."""
    rng = np.random.default_rng(0)
    shapes = [(6, 5), (5,), (3, 2, 2), (4,)]
    a = [torch.nn.Parameter(torch.from_numpy(rng.standard_normal(s).astype(
        np.float32))) for s in shapes]
    b = [torch.nn.Parameter(t.detach().clone()) for t in a]
    kw = dict(weight_decay=0.05, accum_iter=accum)
    opt = LARS(a, **kw)
    ref = PlainLARS(b, **kw)
    reset_launches()
    for step in range(3 * accum):
        for i, (x, y) in enumerate(zip(a, b)):
            if i == 3:
                continue  # a leaf without a gradient
            g = torch.from_numpy(rng.standard_normal(x.shape).astype(np.float32))
            x.grad, y.grad = g.clone(), g.clone()
        opt.step(0.5)
        ref.step(0.5)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
        assert torch.equal(opt.state[x]["mu"], ref.state[y]["mu"])
    assert opt.param_groups[0]["count"] == ref.param_groups[0]["count"] == 3
    assert LAUNCHES["lars_norms"] == LAUNCHES["lars_apply"] == 0


@pytest.mark.parametrize("n, dtypes", [
    (152, (torch.float32,)), (7, (torch.float32, torch.bfloat16)),
    (1, (torch.bfloat16,))])
def test_global_grad_norm_is_the_per_leaf_sum(n, dtypes):
    """The multi-tensor norm equals the square root of the per-leaf sums of
    squares it replaced, within float32 rounding (the sums run in another
    order); bf16 leaves are summed in float32 either way."""
    rng = np.random.default_rng(n)
    grads = [torch.from_numpy(rng.standard_normal(int(rng.integers(0, 5000)))
                              .astype(np.float32) * 10.0 ** rng.integers(-3, 2))
             .to(dtypes[i % len(dtypes)]) for i in range(n)]
    got = global_grad_norm(iter(grads))
    want = torch.sqrt(sum(g.float().square().sum() for g in grads))
    assert got.dtype == torch.float32 and got.shape == ()
    torch.testing.assert_close(got, want, rtol=1e-6, atol=0)
