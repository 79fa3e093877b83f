"""Host utilities: named locks, atomic file publishes and the ``--timing``
phase timer (standard library only), and the I/O pipeline's two threads,
the frame prefetcher and the asynchronous solution writer."""

import os


def env_truthy(name: str) -> bool:
    """The accepted values of a boolean ``SART_*`` switch (``SART_INTEGRITY``,
    ``SART_LOCK_DEBUG``): the JAX package's one list
    (``sartsolver_tpu/utils/__init__.py:env_truthy``), so that a value one
    switch accepts never leaves another silently unarmed."""
    return os.environ.get(name, "") in ("1", "true", "on")
