"""The benchmark's data: a cell's workload, traffic mix and configuration
files, found by name, and the metrics `BENCHMARK.json` asks of the cell.

A cell ``<name>`` is ``workloads/<name>.json`` (config, traffic, chips,
why, the limits of its correctness numbers); its traffic mix is
``traffic/<traffic>.json`` (the driver that runs it and the driver's
parameters); its configuration is ``configs/<config>.json`` (the published
keys as run, ``arch``: the port's fields as run, each checked against the
published key that ``arch_from`` names).
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any, Dict, List, Optional

HERE = Path(__file__).resolve().parents[1]  # portbench/
ROOT = HERE.parent


@dataclasses.dataclass
class Cell:
    name: str
    workload: Dict[str, Any]
    traffic: Dict[str, Any]
    config: Dict[str, Any]
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]

    @property
    def arch(self) -> Dict[str, Any]:
        return self.config["arch"]

    @property
    def chips(self) -> int:
        return int(self.workload["chips"])

    @property
    def limits(self) -> Dict[str, float]:
        return self.workload["limits"]


def _read(path: Path) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def published_value(published: Dict[str, Any], key: str):
    """A published key, dotted for a nested group (``attn_config.rope_theta``)."""
    node = published
    for part in key.split("."):
        node = node[part]
    return node


def check_config(config: Dict[str, Any]) -> None:
    """Each ``arch`` field named in ``arch_from`` equals its published key."""
    for field, key in config.get("arch_from", {}).items():
        want = published_value(config["published"], key)
        got = config["arch"][field]
        if (float(got) if isinstance(want, (int, float)) and not isinstance(want, bool)
                else got) != want:
            raise ValueError(f"config {config['name']}: arch.{field} = {got!r}, "
                             f"published {key} = {want!r}")


def load_config(name: str) -> Dict[str, Any]:
    config = _read(HERE / "configs" / f"{name}.json")
    check_config(config)
    return config


def _applies(entry: Dict[str, Any], cell: str, reported: Optional[set] = None) -> bool:
    if "workloads" in entry:
        return cell in entry["workloads"]
    return reported is None or entry.get("moves") in reported


def load_cell(name: str) -> Cell:
    """The cell ``name``; the root's `BENCHMARK.json` says which metrics it
    reports."""
    workload = _read(HERE / "workloads" / f"{name}.json")
    traffic = _read(HERE / "traffic" / f"{workload['traffic']}.json")
    config = load_config(workload["config"])
    benchmark = _read(ROOT / "BENCHMARK.json")
    e2e = [m for m in benchmark["end_to_end"] if _applies(m, name)]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in benchmark["per_layer"] if _applies(m, name, reported)]
    return Cell(name, workload, traffic, config, e2e, per_layer)
