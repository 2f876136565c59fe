"""ep_tpu_torch — the probe-training and fine-tuning paths of ``ep_tpu`` in
PyTorch, with hand-written CUDA kernels for Hopper (sm_90a).

A second package beside ``ep_tpu``, which stays the reference. Modules keep
their ``ep_tpu`` counterparts' names:
  configs   — TrainConfig and the flag surface (the port's own copy)
  ops       — the CUDA kernels (csrc/) and their plain PyTorch versions
  models    — the ViT backbone and the backbone + head assembly
  poolings  — the EP pool, BatchNorm and the probe head
  train     — LARS, the warmup-cosine schedule, state and the steps
  convert   — the JAX package's variables -> this package's tensors
It imports torch and numpy, never jax and nothing of ``ep_tpu``.
"""
