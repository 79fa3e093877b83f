"""Host utilities: named locks, atomic file publishes and the ``--timing``
phase timer (standard library only), and the I/O pipeline's two threads,
the frame prefetcher and the asynchronous solution writer."""
