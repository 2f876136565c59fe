"""Plain PyTorch reference of the benchmarked training step on SigLIP2's
vision tower (SO400M/14 at 384 px, google/siglip2-so400m-patch14-384).

The encoder follows transformers' ``SiglipVisionTransformer``
(``models/siglip/modeling_siglip.py``) at inference:

- ``SiglipVisionEmbeddings``: a ``Conv2d(3, D, p, stride=p)`` with "valid"
  padding over the whole image, computed here as that convolution, so that
  an image side that is not a multiple of the patch (384 = 27 * 14 + 6)
  loses its last pixels the way the convolution drops them; the patches in
  row-major order plus a learned position embedding of one row a patch. No
  [CLS] token and no registers: T = N.
- ``SiglipEncoderLayer``, pre-LN, LayerNorm eps 1e-6:

      x = x + out_proj(attn(q_proj, k_proj, v_proj of LN1(x)))
      x = x + fc2(gelu_tanh(fc1(LN2(x))))

  with biases on q, k, v, the output projection, fc1 and fc2; attention is
  softmax(q k^T / sqrt(Dh)) v per head, and ``gelu_pytorch_tanh`` is the
  tanh GELU at every precision. q, k and v are one (3D, D) product here, the
  three projections' rows stacked.
- ``post_layernorm`` over every token.

One departure: transformers' tower ends in its MAP head
(``SiglipMultiheadAttentionPoolingHead``), the model's own attentive pool,
which probing replaces. It is left out; the features are the N normed patch
tokens. The EP head pools them, then BatchNorm over the batch with no affine
map, a linear classifier, the mean cross-entropy, its gradients by autograd,
and LARS with heavy-ball momentum under the warmup-cosine learning rate, as
``vit_ep.py`` and ``dinov3_ep.py`` compute them.

It imports torch and math and nothing else (the helpers it shares with the
other references are written out again, so that each stands alone), takes
the weights and batches that the benchmark draws, and computes in float32
with TF32 off, or, as the control, with every product's operands (the
convolution's too) rounded to float8 e4m3 (``precision="fp8"``). A frozen
encoder's weights stay in the type they were drawn in and one block's are
cast to float32 at a time.

Weights are a dict in this module's layout (:func:`layout`): per-block tensors
are stacked along a leading axis of ``depth``. A leaf id names one tensor of
the trained model: ``"fc_w"``, or ``"blocks.3.qkv_w"`` for block 3's slice.
"""
from __future__ import annotations

import math

import torch

BLOCK_KEYS = ("ln1_w", "ln1_b", "qkv_w", "qkv_b", "proj_w", "proj_b",
              "ln2_w", "ln2_b", "fc1_w", "fc1_b", "fc2_w", "fc2_b")
ENCODER_KEYS = ("patch_w", "patch_b", "pos") + BLOCK_KEYS + ("norm_w",
                                                            "norm_b")
HEAD_KEYS = ("ep_q", "ep_v", "fc_w", "fc_b")
FP8_MAX = 448.0  # the largest finite float8 e4m3fn value


def dims(cfg: dict, image_size: int) -> dict:
    """The sizes the reference needs, from a configuration file's numbers:
    a grid of floor(image_size / p) patches a side, T = N (no prefix)."""
    D, p = cfg["hidden_size"], cfg["patch_size"]
    g = image_size // p
    return dict(D=D, L=cfg["num_hidden_layers"], H=cfg["num_attention_heads"],
                hidden=cfg["intermediate_size"], p=p, grid=g, N=g * g,
                T=g * g, Q=cfg["ep_queries"], C=cfg["num_classes"],
                eps=cfg["layer_norm_eps"], bn_eps=cfg["bn_eps"])


def layout(d: dict) -> dict:
    """name -> shape of every weight of the reference."""
    D, L, hid, p = d["D"], d["L"], d["hidden"], d["p"]
    return {"patch_w": (D, 3, p, p), "patch_b": (D,), "pos": (1, d["N"], D),
            "ln1_w": (L, D), "ln1_b": (L, D), "qkv_w": (L, 3 * D, D),
            "qkv_b": (L, 3 * D), "proj_w": (L, D, D), "proj_b": (L, D),
            "ln2_w": (L, D), "ln2_b": (L, D), "fc1_w": (L, hid, D),
            "fc1_b": (L, hid), "fc2_w": (L, D, hid), "fc2_b": (L, D),
            "norm_w": (D,), "norm_b": (D,),
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

    def _operands(self, a, b):
        if self.fp8:
            a, b = round_fp8(a), round_fp8(b)
        return a.float(), b.float()

    def __call__(self, eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return torch.einsum(eq, *self._operands(a, b))

    def conv(self, x: torch.Tensor, w: torch.Tensor, stride: int) -> torch.Tensor:
        """The patch embedding's valid convolution, x NCHW, no bias."""
        return torch.nn.functional.conv2d(*self._operands(x, w), stride=stride)


def layer_norm(x, w, b, eps):
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * w + b


def gelu_tanh(x):
    """``gelu_pytorch_tanh``."""
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi)
                                       * (x + 0.044715 * x * x * x)))


def tokens(W: dict, images: torch.Tensor, d: dict, mm: Products) -> torch.Tensor:
    """images (b, S, S, 3) -> the first block's input (b, N, D): the valid
    convolution's patches in row-major order plus the position embedding."""
    x = mm.conv(images.permute(0, 3, 1, 2), W["patch_w"], d["p"])
    x = x.flatten(2).transpose(1, 2) + W["patch_b"].float()
    return x + W["pos"].float()


def block(w: dict, x: torch.Tensor, d: dict, mm: Products) -> torch.Tensor:
    """One ``SiglipEncoderLayer`` on x (b, T, D), its weights ``w`` f32."""
    b, T, D = x.shape
    H = d["H"]
    Dh = D // H
    h = layer_norm(x, w["ln1_w"], w["ln1_b"], d["eps"])
    qkv = mm("btk,ok->bto", h, w["qkv_w"]) + w["qkv_b"]
    q, k, v = qkv.reshape(b, T, 3, H, Dh).permute(2, 0, 3, 1, 4)
    s = mm("bhtc,bhsc->bhts", q, k) * Dh ** -0.5
    o = mm("bhts,bhsc->bhtc", torch.softmax(s, -1), v)
    o = o.transpose(1, 2).reshape(b, T, D)
    x = x + mm("btk,ok->bto", o, w["proj_w"]) + w["proj_b"]
    h = layer_norm(x, w["ln2_w"], w["ln2_b"], d["eps"])
    h = gelu_tanh(mm("btk,ok->bto", h, w["fc1_w"]) + w["fc1_b"])
    return x + mm("btk,ok->bto", h, w["fc2_w"]) + w["fc2_b"]


def post_layernorm(W: dict, x: torch.Tensor, d: dict) -> torch.Tensor:
    """The tower's final LayerNorm over every token."""
    return layer_norm(x, W["norm_w"].float(), W["norm_b"].float(), d["eps"])


def encode(W: dict, images: torch.Tensor, d: dict, mm: Products) -> torch.Tensor:
    """images (b, S, S, 3) -> the tokens after ``post_layernorm``
    (b, N, D), f32."""
    x = tokens(W, images, d, mm)
    for i in range(d["L"]):
        x = block({k: W[k][i].float() for k in BLOCK_KEYS}, x, d, mm)
    return post_layernorm(W, x, d)


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
    T, D, H, hid = d["T"], d["D"], d["H"], d["hidden"]
    per_block = 4 * (3 * H * T * T + 12 * T * D + 3 * T * hid)
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
        # cast to f32 only while it runs
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
