"""Several devices for the port: the device mesh (`mesh.py`), one process
per mesh position, and its data axis."""
