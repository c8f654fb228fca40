"""Load `BENCHMARK.json` and the files its entries name.

Everything that belongs to one configuration, traffic mix or metric is a
file found by its name:

  configs      the entry's `file` (portbench/configs/<config>.json)
  traffic      portbench/traffic/<traffic>.json, whose `op` names a driver
               portbench/drivers/<op>.py
  per_layer    portbench/metrics/<name>.py
  end_to_end   portbench/endtoend/<name>.py

A name's part from its first dot on names the cells whose end-to-end metric
it is, or moves, and not its reader: `requests_per_s.host_paced` is read by
`endtoend/requests_per_s.py`, `glue_ms_per_req.host_paced` by
`metrics/glue_ms_per_req.py`. One quantity whose cells need different
bounds, or whose metric moves different end-to-end metrics, is so split
into entries without a second reader.

A metric belongs to a cell when its `workloads` lists the cell, or when it
has no `workloads` key.
"""

from __future__ import annotations

import json
import os
import re
from typing import List

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def load(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def cell(man: dict, name: str) -> dict:
    for w in man["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no cell {name!r} in BENCHMARK.json")


def config_entry(man: dict, name: str) -> dict:
    for c in man["configs"]:
        if c["name"] == name:
            return c
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def read_json(root: str, rel: str) -> dict:
    with open(os.path.join(root, rel)) as f:
        return json.load(f)


def config(root: str, man: dict, name: str) -> dict:
    return read_json(root, config_entry(man, name)["file"])


def traffic_file(traffic: str) -> str:
    return f"portbench/traffic/{traffic}.json"


def mix(root: str, traffic: str) -> dict:
    return read_json(root, traffic_file(traffic))


def metrics_of(man: dict, section: str, cell_name: str) -> List[dict]:
    """The entries of `section` ("end_to_end" or "per_layer") that this
    cell reports."""
    return [m for m in man[section]
            if "workloads" not in m or cell_name in m["workloads"]]


READERS = {"end_to_end": "portbench.endtoend",
           "per_layer": "portbench.metrics"}


def reader_file(section: str, name: str) -> str:
    """The file of a metric's reader: its name up to the first dot."""
    base = name.split(".")[0]
    return f"{READERS[section].replace('.', '/')}/{base}.py"
