"""Multi-device dispatch of the port: the coefficient-sharded hmult and
hrotate (`sharded.py`), the collectives and meshes that run their
per-shard programs (`comm.py`) and the shardability predicates
(`mesh.py`)."""
