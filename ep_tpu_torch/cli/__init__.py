"""The probe-training driver (counterpart of ``ep_tpu.cli``)."""
