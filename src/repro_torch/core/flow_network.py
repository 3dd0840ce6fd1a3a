"""Explicit Quincy/NoMora flow network (paper §4, Table 2).

Port of `repro.core.flow_network` (numpy, unchanged). Keeps the aggregator
vertices (unscheduled U_i, cluster X, racks R_r) explicit so the MCMF
solver solves the same graph Firmament would, and tests can check it
against the dense transportation instance the auction solver consumes.

The arc order is the reference's (tasks, then racks, machines and jobs):
the Bellman-Ford in `mcmf` breaks ties by the lowest arc id, so another
order could pick another optimum.

Node layout: [super_source | tasks | unscheduled aggs | X | racks |
machines | sink].
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .policy import DenseCosts, PolicyParams, RoundState
from .topology import Topology


@dataclasses.dataclass
class FlowGraph:
    src: np.ndarray
    dst: np.ndarray
    cap: np.ndarray
    cost: np.ndarray
    n_nodes: int
    source: int
    sink: int
    # node-id bases
    task0: int
    unsched0: int
    x_node: int
    rack0: int
    machine0: int
    arc_kind: np.ndarray  # parallel array: 0=src,1=t->m,2=t->r,3=t->X,4=t->U,
    #                       5=X->R,6=R->M,7=M->S,8=U->S
    arc_task: np.ndarray  # task index for task arcs, -1 otherwise
    arc_target: np.ndarray  # machine/rack index for task arcs, -1 otherwise


def build_flow_graph(
    state: RoundState,
    topo: Topology,
    params: PolicyParams,
    costs: DenseCosts,
) -> FlowGraph:
    T, J, M = state.n_tasks, state.n_jobs, state.n_machines
    per_rack = topo.machines_per_rack
    R = -(-M // per_rack)

    task0 = 1
    unsched0 = task0 + T
    x_node = unsched0 + J
    rack0 = x_node + 1
    machine0 = rack0 + R
    sink = machine0 + M
    n_nodes = sink + 1
    source = 0

    src, dst, cap, cost, kind, a_task, a_tgt = [], [], [], [], [], [], []

    def arc(s, d, c, w, k, t=-1, tgt=-1):
        src.append(s)
        dst.append(d)
        cap.append(c)
        cost.append(w)
        kind.append(k)
        a_task.append(t)
        a_tgt.append(tgt)

    # Super-source generates one unit per task.
    for t in range(T):
        arc(source, task0 + t, 1, 0, 0, t)

    d = costs.d  # (T, M) pre-threshold machine costs
    c_rack = costs.c_rack  # (T, R)
    b = costs.b
    a = costs.a
    w = costs.w  # (T, M+J) effective (includes preemption discount)

    rack_of_m = np.arange(M) // per_rack
    for t in range(T):
        cur = int(state.cur_machine[t])
        for m in np.nonzero(d[t] <= params.p_m)[0]:
            arc(task0 + t, machine0 + int(m), 1, int(w[t, m]), 1, t, int(m))
        # A running task always keeps the arc to its current machine.
        if cur >= 0 and d[t, cur] > params.p_m:
            arc(task0 + t, machine0 + cur, 1, int(w[t, cur]), 1, t, cur)
        for r in np.nonzero(c_rack[t] <= params.p_r)[0]:
            arc(task0 + t, rack0 + int(r), 1, int(c_rack[t, r]), 2, t, int(r))
        arc(task0 + t, x_node, 1, int(b[t]), 3, t)
        arc(task0 + t, unsched0 + int(state.task_job[t]), 1, int(a[t]), 4, t)

    free = state.free_slots.astype(np.int64)
    for r in range(R):
        members = np.arange(r * per_rack, min((r + 1) * per_rack, M))
        arc(x_node, rack0 + r, int(free[members].sum()), 0, 5)
        for m in members:
            arc(rack0 + r, machine0 + int(m), int(free[m]), 0, 6)
    for m in range(M):
        arc(machine0 + m, sink, int(free[m]), 0, 7)

    tasks_per_job = np.bincount(state.task_job, minlength=J)
    for j in range(J):
        cap_u = (
            int(tasks_per_job[j])
            if params.unsched_capacity is None
            else min(int(tasks_per_job[j]), params.unsched_capacity)
        )
        arc(unsched0 + j, sink, cap_u, 0, 8)

    return FlowGraph(
        src=np.asarray(src, np.int64),
        dst=np.asarray(dst, np.int64),
        cap=np.asarray(cap, np.int64),
        cost=np.asarray(cost, np.int64),
        n_nodes=n_nodes,
        source=source,
        sink=sink,
        task0=task0,
        unsched0=unsched0,
        x_node=x_node,
        rack0=rack0,
        machine0=machine0,
        arc_kind=np.asarray(kind, np.int64),
        arc_task=np.asarray(a_task, np.int64),
        arc_target=np.asarray(a_tgt, np.int64),
    )


def extract_assignment(g: FlowGraph, flow: np.ndarray, state: RoundState) -> np.ndarray:
    """Flow -> per-task column (machine id, M+job for unscheduled, -1).

    Tasks routed through rack/cluster aggregators are matched greedily to
    the machines that received aggregator flow — any matching has equal
    cost because aggregator arcs are zero-cost past the task arc.
    """
    T, M = state.n_tasks, state.n_machines
    out = np.full(T, -1, np.int64)

    active = np.nonzero(flow > 0)[0]

    # Direct task->machine and task->unscheduled arcs.
    rack_pool: dict[int, list[int]] = {}  # tasks that entered via rack aggs
    x_tasks: list[int] = []  # tasks routed through the cluster aggregator
    rm_flow: dict[tuple[int, int], int] = {}  # rack->machine aggregator flow
    xr_flow: dict[int, int] = {}  # X->rack aggregator flow

    for e in active:
        k = int(g.arc_kind[e])
        if k == 1:
            out[g.arc_task[e]] = g.arc_target[e]
        elif k == 4:
            out[g.arc_task[e]] = M + state.task_job[g.arc_task[e]]
        elif k == 2:
            rack_pool.setdefault(int(g.arc_target[e]), []).append(int(g.arc_task[e]))
        elif k == 3:
            x_tasks.append(int(g.arc_task[e]))
        elif k == 5:
            xr_flow[int(g.dst[e] - g.rack0)] = int(flow[e])
        elif k == 6:
            rack = int(g.src[e] - g.rack0)
            machine = int(g.dst[e] - g.machine0)
            rm_flow[(rack, machine)] = int(flow[e])

    # X->rack flow pulls cluster-aggregated tasks into that rack's pool
    # (any ordering is cost-equal: all post-task arcs cost 0).
    xi = 0
    for rack in sorted(xr_flow):
        take = xr_flow[rack]
        pool = rack_pool.setdefault(rack, [])
        while take > 0 and xi < len(x_tasks):
            pool.append(x_tasks[xi])
            xi += 1
            take -= 1

    # Distribute each rack's pool onto the machines that received its flow.
    # rack->machine arcs carry exactly the aggregated tasks (direct task->
    # machine arcs bypass the rack vertex), so pool sizes match by flow
    # conservation.
    for (rack, machine), f in sorted(rm_flow.items()):
        pool = rack_pool.get(rack, [])
        while f > 0 and pool:
            out[pool.pop()] = machine
            f -= 1

    return out
