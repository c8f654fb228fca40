"""Multi-device dispatch of the port: the coefficient-sharded hmult and
hrotate, and the JAX package's GSPMD surface on the explicit dispatches
(`sharded.py`: `make_sharded_hmult`, the elementwise ops), the limb and
hybrid dispatches (`limb_sharded.py`), the coefficient-sharded NTT
(`coeff_ntt.py`), the collectives and meshes that run their per-shard
programs (`comm.py`), `make_mesh` and the shardability predicates
(`mesh.py`), and the dispatch model behind `--dispatch auto`
(`dispatch_model.py`)."""
