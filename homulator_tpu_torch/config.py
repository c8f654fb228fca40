"""Config: typed parameters + reference-compatible `.cfg` parser.

The port's own copy of `homulator_tpu/config.py`, unchanged.

The reference reads flat `key = value` uint32 files with `#` comments
(src/Config.cpp:4-52) and takes positional CLI overrides
(bench_test/bench_micro24.cpp:16-25). We parse the same files — its
`config_4.cfg` / `config_4_N15.cfg` work unchanged — but only the keys
that describe the *workload* (N) matter to a real implementation; the
modeled-hardware keys (unit delays, FIFO depths, MAC grid shapes) are
accepted and surfaced for reference but do not configure TPU kernels.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional


def parse_cfg(path: str) -> Dict[str, int]:
    """Reference-compatible parser: `key = value`, '#' comments, blank lines."""
    out: Dict[str, int] = {}
    with open(path) as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if not line or "=" not in line:
                continue
            key, _, value = line.partition("=")
            key = key.strip()
            value = value.strip()
            if not key or not value:
                continue
            try:
                out[key] = int(value)
            except ValueError:
                continue
    return out


@dataclasses.dataclass
class RunConfig:
    """One benchmark run, mirroring the reference CLI contract
    `<cfg> <op> <maxLevel> <level> <alpha> [cluster]` (bench_micro24.cpp:5-27)."""

    n: int
    op: str
    max_level: int
    level: int
    alpha: int
    cluster: Optional[int] = None  # reference cluster count; maps to mesh size
    scale_bits: int = 29
    raw: Optional[Dict[str, int]] = None

    @classmethod
    def from_cli(cls, cfg_path: str, op: str, max_level: int, level: int,
                 alpha: int, cluster: Optional[int] = None) -> "RunConfig":
        raw = parse_cfg(cfg_path)
        n = raw.get("N")
        if n is None:
            raise ValueError(f"config {cfg_path} has no N")
        if cluster is None:
            cluster = raw.get("cluster")
        return cls(n=n, op=op, max_level=max_level, level=level, alpha=alpha,
                   cluster=cluster, raw=raw)
