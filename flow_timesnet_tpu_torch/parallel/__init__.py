"""Data parallelism over ranks, one process a card (``mesh.py``)."""
