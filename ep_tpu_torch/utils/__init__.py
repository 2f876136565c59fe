"""Position-embedding helpers (counterpart of ``ep_tpu.utils``)."""
