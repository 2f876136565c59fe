"""ep_tpu_torch — the probe-training and fine-tuning paths of ``ep_tpu`` in
PyTorch, with hand-written CUDA kernels for Hopper (sm_90a).

A second package beside ``ep_tpu``, which stays the reference. Modules keep
their ``ep_tpu`` counterparts' names:
  configs   — TrainConfig and the flag surface (the port's own copy)
  ops       — the CUDA kernels (csrc/) and their plain PyTorch versions
  models    — the ViT backbone and the backbone + head assembly
  poolings  — the EP pool, BatchNorm and the probe head
  train     — LARS, AdamW and SGD, the warmup-cosine schedule, state, the
              steps and the engine's epoch, eval and kNN loops
  convert   — the JAX package's variables and timm-layout checkpoints ->
              this package's tensors
  data      — the host data pipeline (copies of ``ep_tpu/data``)
  runtime   — checkpoints and the profiler
  utils     — the position embedding and the training log
  cli       — the probe-training driver (``main_linprobe_torch.py``)
It imports torch and numpy, never jax and nothing of ``ep_tpu``.
"""
