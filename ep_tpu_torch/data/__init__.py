"""The host data pipeline: copies of ``ep_tpu/data`` (numpy and PIL only;
``grain_loader.py`` and ``device_aug.py`` are not part of the port)."""
