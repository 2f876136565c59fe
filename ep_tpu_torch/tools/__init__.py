"""Command-line tools of the port (counterparts of the repository's
``tools/*.py`` that drive the JAX package), each run as
``python -m ep_tpu_torch.tools.<name>``."""
