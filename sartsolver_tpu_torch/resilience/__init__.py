"""Availability: the OOM degradation ladder of the frame-group loops."""
