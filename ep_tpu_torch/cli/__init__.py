"""The probe-training and attention-statistics drivers (counterpart of
``ep_tpu.cli``)."""
