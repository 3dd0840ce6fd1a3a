"""Data-center topology model (paper §6 "Topology").

Machines are grouped into racks and pods on a fat-tree [Al-Fares et al.].
Paper defaults: 48 machines/rack, 16 racks/pod (Google-workload experiments);
the Facebook-fabric variant (192 machines/rack, 48 racks/pod) is provided as
an alternative preset.

Distance tiers (used to assign latency traces, paper §6):
  0 = same machine, 1 = same rack, 2 = same pod, 3 = inter-pod.
"""

from __future__ import annotations

import dataclasses

import numpy as np

TIER_SAME_MACHINE = 0
TIER_RACK = 1
TIER_POD = 2
TIER_INTER_POD = 3
N_TIERS = 4


@dataclasses.dataclass(frozen=True)
class Topology:
    n_machines: int
    machines_per_rack: int = 48
    racks_per_pod: int = 16
    slots_per_machine: int = 8  # "C cores" capacity in the flow network

    @property
    def n_racks(self) -> int:
        return -(-self.n_machines // self.machines_per_rack)

    @property
    def n_pods(self) -> int:
        return -(-self.n_racks // self.racks_per_pod)

    def rack_of(self, machine):
        return np.asarray(machine) // self.machines_per_rack

    def pod_of(self, machine):
        return self.rack_of(machine) // self.racks_per_pod

    def rack_members(self, rack: int) -> np.ndarray:
        lo = rack * self.machines_per_rack
        hi = min(lo + self.machines_per_rack, self.n_machines)
        return np.arange(lo, hi)

    def tier_from(self, machine: int) -> np.ndarray:
        """Distance tier from `machine` to every machine (vectorised)."""
        m = np.arange(self.n_machines)
        rack = self.rack_of(machine)
        pod = self.pod_of(machine)
        tiers = np.full(self.n_machines, TIER_INTER_POD, dtype=np.int32)
        tiers[self.pod_of(m) == pod] = TIER_POD
        tiers[self.rack_of(m) == rack] = TIER_RACK
        tiers[m == machine] = TIER_SAME_MACHINE
        return tiers

    def tier_matrix(self) -> np.ndarray:
        """Full (n_machines, n_machines) tier matrix. Small clusters only."""
        m = np.arange(self.n_machines)
        rack = self.rack_of(m)
        pod = self.pod_of(m)
        tiers = np.full((self.n_machines, self.n_machines), TIER_INTER_POD, np.int32)
        tiers[pod[:, None] == pod[None, :]] = TIER_POD
        tiers[rack[:, None] == rack[None, :]] = TIER_RACK
        np.fill_diagonal(tiers, TIER_SAME_MACHINE)
        return tiers


def google_topology(n_machines: int = 12500) -> Topology:
    """Paper §6 default: Google workload, 48 machines/rack, 16 racks/pod."""
    return Topology(n_machines=n_machines, machines_per_rack=48, racks_per_pod=16)


def facebook_topology(n_machines: int = 12500) -> Topology:
    """Paper §6 alternative: Facebook fabric, 192 machines/rack, 48 racks/pod."""
    return Topology(n_machines=n_machines, machines_per_rack=192, racks_per_pod=48)
