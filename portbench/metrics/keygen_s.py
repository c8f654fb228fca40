"""keygen_s (s), host set-up: the benchmark's span around the port's key
generation in set-up (`CkksEngine.keygen` and `gen_rotation_key` on the
host engine's native core, the upload included). Moves setup_s."""


def read(rec):
    return rec.spans.get("keygen")
