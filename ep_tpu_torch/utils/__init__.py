"""Position-embedding helpers and the training log (counterpart of
``ep_tpu.utils``)."""
