"""Hand-written Hopper kernels for the hot ops, and the rule that picks them.

The counterpart of ``ep_tpu/ops/__init__.py::kernel_mode``, decided per call
by where the tensors live instead of by backend:

* CUDA tensors go to the kernel (built from ``ep_tpu_torch/csrc`` at first
  use). There is no switch that turns the kernels off on a CUDA device, and no
  fallback: a shape or type the kernel does not take raises.
* CPU tensors go to the plain PyTorch version of the same function, which is
  also what the kernel is checked against on the card.

The same rule places what the port builds: a constructor that makes tensors
takes ``device`` and builds on the card unless asked otherwise
(:func:`default_device`).

Each kernel wrapper adds one to its entry in ``LAUNCHES`` where it launches
its kernel, so a run can show which kernels its main path went through.
"""
from __future__ import annotations

import torch

MAX_SMEM = 232448  # shared memory one block may use on Hopper (227 KB)

# kernel name -> launches since the last reset_launches()
LAUNCHES: dict[str, int] = {
    "ln_qkv_gemm": 0,
    "attn_core": 0,
    "proj_residual_gemm": 0,
    "ep_pool": 0,
    "attn_core_bwd": 0,
    "attn_flash": 0,
    "ep_pool_proj": 0,
    "mlp_int8_ln_quant": 0,
    "mlp_int8_fc1": 0,
    "mlp_int8_fc2": 0,
    "ln1_apply": 0,
    "ln1_bwd": 0,
    "swiglu_gate": 0,
    "lars_norms": 0,
    "lars_apply": 0,
    "rope_qk": 0,
    "ls_residual": 0,
    # not a kernel: the plain-torch attention backward past kernel E's limit
    # (ops/attn_fused.py::attention_backward), counted on the card to show
    # which backward a path took
    "attn_bwd_long": 0,
    # not a kernel: fc1 with its bias and tanh GELU in cuBLASLt's epilogue
    # (ops/fc1_gelu.py), counted to show which MLP route a path took
    "fc1_gelu_epilogue": 0,
}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def default_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``. None means the card: the port's
    constructors build on CUDA unless the caller asks for another device, and
    raise where there is no CUDA device."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: ep_tpu_torch builds on the card by default; "
            "pass device='cpu' to build on the CPU")
    return torch.device("cuda")


def use_kernel(*tensors: torch.Tensor) -> bool:
    """True when every tensor is on a CUDA device (launch the kernel), False
    when every tensor is on the CPU (run the plain version). Raises otherwise."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cuda"}:
        return True
    if kinds == {"cpu"}:
        return False
    raise ValueError(f"tensors on {sorted(kinds)}: the kernels take CUDA "
                     "tensors and the plain versions CPU tensors, not a mix")


def check(t: torch.Tensor, name: str, shape: tuple, dtype: torch.dtype) -> None:
    """Raise unless ``t`` is a contiguous, 16-byte aligned ``dtype`` tensor of
    ``shape`` (None in ``shape`` matches any size)."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != len(shape) or any(
            s is not None and s != d for s, d in zip(shape, t.shape)):
        raise ValueError(f"{name}: expected shape {shape}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: the kernel needs a contiguous tensor")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: the kernel needs a 16-byte aligned tensor")
