"""The upload-once, solve-many-frames solver (one device for now)."""
