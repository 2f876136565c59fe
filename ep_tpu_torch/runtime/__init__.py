"""Checkpoints and the profiler (counterpart of ``ep_tpu.runtime``)."""
