"""Plain references, one module for each model family, found by the
``reference`` key of a configuration file. Each imports torch alone and
provides ``dims``, ``layout``, ``ENCODER_KEYS``, ``BLOCK_KEYS``,
``HEAD_KEYS`` and ``Reference``."""
