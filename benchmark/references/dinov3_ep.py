"""Plain PyTorch reference of the benchmarked training step on DINOv3
ViT-7B/16 (``dinov3_vit7b16``).

The encoder follows DINOv3's ``DinoVisionTransformer``
(``dinov3/models/vision_transformer.py``; ``dinov3/layers/
rope_position_encoding.py``, ``ffn_layers.py``) at inference. Tokens are
``[cls | s1..s4 | patches in row-major order]``, with no position embedding.
Each block, with LayerNorm eps 1e-5:

    x = x + ls1 * proj(attn(rope(qkv(LN1(x)))))
    x = x + ls2 * w3(silu(w1 LN2(x)) * (w2 LN2(x)))

Attention is softmax(q k^T / sqrt(Dh)) v per head; qkv has no bias. RoPE,
with head width Dh and an H x W patch grid:

- ``periods[i] = base ** (2i / (Dh/2))`` for i < Dh/4 (base 100);
- ``ch[r] = 2 * (r + 0.5) / H - 1`` and ``cw[c] = 2 * (c + 0.5) / W - 1``;
- for patch (r, c): ``a = 2 pi * [ch[r] / periods, cw[c] / periods]``, Dh/2
  angles, tiled twice to Dh;
- ``rope(x) = x * cos(a) + cat(-x[Dh/2:], x[:Dh/2]) * sin(a)``;
- it applies to q and k of the patch rows; [CLS] and the storage tokens are
  left as they are.

The coordinates' shift, jitter and rescale are drawn in training only and
are left out. After the blocks the final LayerNorm over every token; the EP
head pools the N patch tokens (the storage tokens and [CLS] left out, as
``select_features`` does), then BatchNorm over the batch with no affine map,
a linear classifier, the mean cross-entropy, its gradients by autograd, and
LARS with heavy-ball momentum under the warmup-cosine learning rate, as
``vit_ep.py`` computes them.

It imports torch and math and nothing else (the helpers it shares with
``dinov2_ep.py`` are written out again, so that each reference stands
alone), takes the weights and batches that the benchmark draws, and computes
in float32 with TF32 off, or, as the control, with every product's operands
rounded to float8 e4m3 (``precision="fp8"``). A frozen encoder's weights
stay in the type they were drawn in and one block's are cast to float32 at a
time, so that the check fits on the card beside the program's 13.4 GB.

Sizes (:func:`dims`): ``ffn`` is the SwiGLU hidden width F (``w12`` is
(2F, D), ``[w1 | w2]``; ``w3`` (D, F)). ``hidden`` is 3F/2, the width of a
two-product MLP with the same operations and weight bytes as ``w12`` and
``w3`` together, which is what ``benchmark/flops.py`` reads. T = 1 + R + N
counts the storage tokens.

Weights are a dict in this module's layout (:func:`layout`): per-block tensors
are stacked along a leading axis of ``depth``. A leaf id names one tensor of
the trained model: ``"fc_w"``, or ``"blocks.3.w12_w"`` for block 3's slice.
"""
from __future__ import annotations

import math

import torch

BLOCK_KEYS = ("ln1_w", "ln1_b", "qkv_w", "proj_w", "proj_b", "ls1", "ln2_w",
              "ln2_b", "w12_w", "w12_b", "w3_w", "w3_b", "ls2")
ENCODER_KEYS = ("patch_w", "patch_b", "cls", "reg") + BLOCK_KEYS + (
    "norm_w", "norm_b")
HEAD_KEYS = ("ep_q", "ep_v", "fc_w", "fc_b")
FP8_MAX = 448.0  # the largest finite float8 e4m3fn value


def dims(cfg: dict, image_size: int) -> dict:
    """The sizes the reference needs, from a configuration file's numbers."""
    D, p = cfg["hidden_size"], cfg["patch_size"]
    g = image_size // p
    F, R = cfg["intermediate_size"], cfg["num_register_tokens"]
    return dict(D=D, L=cfg["num_hidden_layers"], H=cfg["num_attention_heads"],
                ffn=F, hidden=3 * F // 2, R=R, p=p, grid=g, N=g * g,
                T=1 + R + g * g, Q=cfg["ep_queries"], C=cfg["num_classes"],
                eps=cfg["layer_norm_eps"], bn_eps=cfg["bn_eps"],
                rope_base=cfg["rope_base"])


def layout(d: dict) -> dict:
    """name -> shape of every weight of the reference."""
    D, L, F, p = d["D"], d["L"], d["ffn"], d["p"]
    return {"patch_w": (D, 3, p, p), "patch_b": (D,), "cls": (1, 1, D),
            "reg": (1, d["R"], D), "ln1_w": (L, D), "ln1_b": (L, D),
            "qkv_w": (L, 3 * D, D), "proj_w": (L, D, D), "proj_b": (L, D),
            "ls1": (L, D), "ln2_w": (L, D), "ln2_b": (L, D),
            "w12_w": (L, 2 * F, D), "w12_b": (L, 2 * F), "w3_w": (L, D, F),
            "w3_b": (L, D), "ls2": (L, D), "norm_w": (D,), "norm_b": (D,),
            "ep_q": (1, d["Q"], D), "ep_v": (D, D), "fc_w": (d["C"], D),
            "fc_b": (d["C"],)}


def fan_in(name: str, shape: tuple, d: dict) -> int:
    """The inputs of a product's weight: its last axis, or a patch's pixels."""
    return 3 * d["p"] ** 2 if name == "patch_w" else shape[-1]


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    """x through float8 e4m3 with one scale for the tensor, back in f32."""
    s = x.detach().abs().amax().float().clamp_min(1e-30) / FP8_MAX
    q = (x.detach() / s).to(torch.float8_e4m3fn).float() * s
    return x + (q - x).detach()  # the rounded value, the identity's gradient


class Products:
    """Every product of the reference, in f32 or on fp8-rounded operands."""

    def __init__(self, precision: str = "f32"):
        if precision not in ("f32", "fp8"):
            raise ValueError(f"precision {precision!r}: f32 or fp8")
        self.fp8 = precision == "fp8"

    def __call__(self, eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.fp8:
            a, b = round_fp8(a), round_fp8(b)
        return torch.einsum(eq, a.float(), b.float())


def layer_norm(x, w, b, eps):
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * w + b


def swiglu(u: torch.Tensor) -> torch.Tensor:
    """The gate on ``w12``'s output ``[w1 x | w2 x]``: silu of its first
    half times its second (``SwiGLUFFN.forward``)."""
    x1, x2 = u.chunk(2, dim=-1)
    return x1 * torch.sigmoid(x1) * x2


def rope_tables(grid_h: int, grid_w: int, head_dim: int, base: float,
                device) -> tuple[torch.Tensor, torch.Tensor]:
    """(sin, cos), each (grid_h * grid_w, head_dim) f32, the patches in
    row-major order (``RopePositionEmbedding.forward``, ``normalize_coords=
    "separate"``)."""
    dd = dict(device=device, dtype=torch.float32)
    periods = base ** (2 * torch.arange(head_dim // 4, **dd) / (head_dim // 2))
    ch = 2.0 * (torch.arange(0.5, grid_h, **dd) / grid_h) - 1.0
    cw = 2.0 * (torch.arange(0.5, grid_w, **dd) / grid_w) - 1.0
    coords = torch.stack(torch.meshgrid(ch, cw, indexing="ij"), -1)
    angles = 2 * math.pi * coords.reshape(-1, 2)[:, :, None] / periods
    angles = angles.reshape(grid_h * grid_w, head_dim // 2).tile(2)
    return torch.sin(angles), torch.cos(angles)


def rotate(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor) -> torch.Tensor:
    """``rope_apply``: x * cos + rotate_half(x) * sin over the last axis."""
    h = x.shape[-1] // 2
    return x * cos + torch.cat([-x[..., h:], x[..., :h]], -1) * sin


def rope_qk(q: torch.Tensor, k: torch.Tensor, sin: torch.Tensor,
            cos: torch.Tensor, prefix: int):
    """q, k (b, H, T, Dh) with rows ``prefix``.. rotated (``SelfAttention.
    apply_rope``)."""
    q = torch.cat([q[:, :, :prefix], rotate(q[:, :, prefix:], sin, cos)], 2)
    k = torch.cat([k[:, :, :prefix], rotate(k[:, :, prefix:], sin, cos)], 2)
    return q, k


def tokens(W: dict, images: torch.Tensor, d: dict, mm: Products) -> torch.Tensor:
    """images (b, S, S, 3) -> the first block's input (b, 1 + R + N, D):
    ``[CLS | storage tokens | patches]``, no position embedding."""
    b, S = images.shape[:2]
    p, D = d["p"], d["D"]
    g = S // p
    x = images.float().reshape(b, g, p, g, p, 3).permute(0, 1, 3, 5, 2, 4)
    x = mm("bnk,dk->bnd", x.reshape(b, g * g, 3 * p * p),
           W["patch_w"].reshape(D, -1)) + W["patch_b"].float()
    return torch.cat([W["cls"].float().expand(b, 1, D),
                      W["reg"].float().expand(b, d["R"], D), x], 1)


def encode(W: dict, images: torch.Tensor, d: dict, mm: Products) -> torch.Tensor:
    """images (b, S, S, 3) -> the patch tokens after the final LayerNorm
    (b, N, D), f32."""
    x = tokens(W, images, d, mm)
    b, T, D = x.shape
    H = d["H"]
    Dh = D // H
    g = images.shape[1] // d["p"]
    sin, cos = rope_tables(g, g, Dh, d["rope_base"], x.device)
    prefix = 1 + d["R"]
    for i in range(d["L"]):
        w = {k: W[k][i].float() for k in BLOCK_KEYS}
        h = layer_norm(x, w["ln1_w"], w["ln1_b"], d["eps"])
        qkv = mm("btk,ok->bto", h, w["qkv_w"])
        q, k, v = qkv.reshape(b, T, 3, H, Dh).permute(2, 0, 3, 1, 4)
        q, k = rope_qk(q, k, sin, cos, prefix)
        s = mm("bhtc,bhsc->bhts", q, k) * Dh ** -0.5
        o = mm("bhts,bhsc->bhtc", torch.softmax(s, -1), v)
        o = o.transpose(1, 2).reshape(b, T, D)
        x = x + w["ls1"] * (mm("btk,ok->bto", o, w["proj_w"]) + w["proj_b"])
        h = layer_norm(x, w["ln2_w"], w["ln2_b"], d["eps"])
        h = swiglu(mm("btk,ok->bto", h, w["w12_w"]) + w["w12_b"])
        x = x + w["ls2"] * (mm("btk,ok->bto", h, w["w3_w"]) + w["w3_b"])
        del w
    x = layer_norm(x, W["norm_w"].float(), W["norm_b"].float(), d["eps"])
    return x[:, prefix:]


def head_logits(W: dict, feats: torch.Tensor, d: dict,
                mm: Products) -> torch.Tensor:
    """The EP head over the patch tokens (B, N, D): the logits (B, C)."""
    B, N, D = feats.shape
    Q = d["Q"]
    q = W["ep_q"][0].float() * D ** -0.5
    a = torch.softmax(mm("bnd,qd->bqn", feats, q), -1)
    v = mm("bnk,dk->bnd", feats, W["ep_v"]).reshape(B, N, Q, D // Q)
    pooled = mm("bqn,bnqc->bqc", a, v).reshape(B, D)
    mean = pooled.mean(0)
    var = (pooled - mean).square().mean(0)
    z = (pooled - mean) * torch.rsqrt(var + d["bn_eps"])
    return mm("bk,ck->bc", z, W["fc_w"]) + W["fc_b"].float()


def head_loss(W: dict, feats: torch.Tensor, labels: torch.Tensor, d: dict,
              mm: Products) -> torch.Tensor:
    """The EP head and the mean cross-entropy over the batch."""
    logits = head_logits(W, feats, d, mm)
    return (torch.logsumexp(logits, -1)
            - logits.gather(1, labels[:, None].long())[:, 0]).mean()


def chunk_rows(d: dict, grad: bool, budget: float = 12e9) -> int:
    """Images a chunk of the encoder takes so that its f32 tensors stay
    within ``budget`` bytes: one block's at a time, or every block's where
    autograd keeps them."""
    T, D, H, F = d["T"], d["D"], d["H"], d["ffn"]
    per_block = 4 * (3 * H * T * T + 14 * T * D + 5 * T * F)
    per_image = per_block * (d["L"] if grad else 2)
    return max(1, int(budget // per_image))


def lr_at(step: int, sched: dict) -> float:
    """The warmup-cosine learning rate at a global step."""
    lr = sched["blr"] * sched["eff_batch_size"] / 256.0
    f = step / sched["steps_per_epoch"]
    warm, epochs, lo = sched["warmup_epochs"], sched["epochs"], sched["min_lr"]
    if f < warm:
        return lr * f / warm
    return lo + (lr - lo) * 0.5 * (1.0 + math.cos(
        math.pi * (f - warm) / (epochs - warm)))


def leaves(name: str, t: torch.Tensor) -> dict:
    """leaf id -> each leaf that ``t`` holds: a block's slice of a stacked
    weight, or ``t`` itself."""
    if name in BLOCK_KEYS:
        return {f"blocks.{i}.{name}": t[i] for i in range(t.shape[0])}
    return {name: t}


class Reference:
    """The reference trainer: ``step`` runs one training step and returns its
    loss; ``grads`` and ``change_norms`` read its state."""

    def __init__(self, W: dict, d: dict, opt: dict, finetuning: bool,
                 precision: str = "f32"):
        # float32 products in float32: TF32 would round their operands
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.d, self.opt, self.mm = d, opt, Products(precision)
        names = list(W) if finetuning else list(HEAD_KEYS)
        # trained weights in f32; a frozen encoder's as drawn, each block's
        # cast to f32 only while it runs (the 7B's whole f32 encoder would
        # not fit beside the program on one card)
        self.W = dict(W)
        self.trained = {k: W[k].float().clone().requires_grad_(True)
                        for k in names}
        self.W.update(self.trained)
        self.start = {k: v.detach().clone() for k, v in self.trained.items()}
        self.mu = {k: torch.zeros_like(v) for k, v in self.trained.items()}
        self.finetuning = finetuning

    def features(self, images: torch.Tensor) -> torch.Tensor:
        """The patch tokens of ``images`` in chunks, outside autograd."""
        n = chunk_rows(self.d, grad=False)
        with torch.no_grad():
            return torch.cat([encode(self.W, images[i:i + n], self.d, self.mm)
                              for i in range(0, len(images), n)])

    def step(self, step: int, images: torch.Tensor, labels: torch.Tensor) -> float:
        for p in self.trained.values():
            p.grad = None
        feats = self.features(images)
        if self.finetuning:
            feats.requires_grad_(True)
        loss = head_loss(self.W, feats, labels, self.d, self.mm)
        loss.backward()
        if self.finetuning:
            # the encoder's backward in chunks of images, each recomputed
            # with autograd and fed its rows of the loss's gradient
            n = chunk_rows(self.d, grad=True)
            for i in range(0, len(images), n):
                out = encode(self.W, images[i:i + n], self.d, self.mm)
                out.backward(feats.grad[i:i + n])
        self._lars(lr_at(step, self.opt["schedule"]))
        return float(loss.detach())

    @torch.no_grad()
    def _lars(self, lr: float) -> None:
        o = self.opt
        for k, p in self.trained.items():
            g = p.grad.float()
            stacked = k in BLOCK_KEYS
            leaf_ndim = p.ndim - (1 if stacked else 0)
            if leaf_ndim > 1:
                g = g + o["weight_decay"] * p
                dim = tuple(range(1 if stacked else 0, p.ndim))
                pn = torch.linalg.vector_norm(p, dim=dim, keepdim=True)
                gn = torch.linalg.vector_norm(g, dim=dim, keepdim=True)
                q = torch.where((pn > 0) & (gn > 0),
                                o["trust_coefficient"] * pn / gn,
                                torch.ones_like(pn))
                g = g * q
            self.mu[k] = o["momentum"] * self.mu[k] + g
            p -= lr * self.mu[k]

    def grads(self) -> dict:
        """leaf id -> the last step's gradient, f32 on the host."""
        out = {}
        for k, p in self.trained.items():
            out.update(leaves(k, p.grad.float().cpu()))
        return out

    def change_norms(self) -> dict:
        """leaf id -> the norm of its change since the first step."""
        out = {}
        for k, p in self.trained.items():
            d = leaves(k, p.detach() - self.start[k])
            norms = torch.stack([torch.linalg.vector_norm(t) for t in d.values()])
            out.update(zip(d, norms.tolist()))
        return out
