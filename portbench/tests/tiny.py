"""Small sizes of portbench's cells for CPU tests."""

# A small parameter set for CPU runs: three digits, the last one short.
TINY = {"n": 256, "max_level": 8, "alpha": 3, "dnum": 3, "level": 7,
        "scale_bits": 29}
HMULT = {"op": "hmult_batch", "batch": 3, "pool_batches": 2, "samples": 3,
         "trace_requests": 2}
MATVEC = {"op": "matvec_bsgs", "d": 8, "g": 4, "pool": 3, "samples": 3,
          "trace_requests": 2}
MIXES = {"hmult": ("setB.hmult.b8", HMULT), "matvec": ("setB.matvec64",
                                                        MATVEC)}
