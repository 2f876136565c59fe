"""Data parallelism over ``torch.distributed`` (counterpart of
``ep_tpu.parallel``): one process per card, a (data, model) mesh of ranks."""
