"""Host utilities: named locks, atomic file publishes and the ``--timing``
phase timer. Standard library only."""
