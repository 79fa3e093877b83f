"""Availability: the failure taxonomy and exit codes, bounded retries, the
fault-injection registry and the OOM degradation ladder of the frame-group
loops."""
