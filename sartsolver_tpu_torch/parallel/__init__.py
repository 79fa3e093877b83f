"""The upload-once, solve-many-frames solver, the chunked RTM ingest that
fills its matrix, and the grid of ranks both run on (``mesh.py``,
``comm.py``)."""
