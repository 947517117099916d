"""Multi-device runs of the port: the device mesh (mesh.py) and the
sharded phases over it (engine.py), driven from one process."""
