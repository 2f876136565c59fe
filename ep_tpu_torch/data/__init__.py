"""The host data pipeline: copies of ``ep_tpu/data`` (numpy and PIL only;
``grain_loader.py`` is not part of the port), and ``device_aug.py``, whose
host half is such a copy and whose device half is torch."""
