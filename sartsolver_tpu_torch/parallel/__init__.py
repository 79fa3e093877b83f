"""The upload-once, solve-many-frames solver and the chunked RTM ingest
that fills its matrix (one device for now)."""
