"""The MCMF backend against the reference: the Quincy graph's seven arc
arrays, the successive-shortest-paths flow (including unreachable nodes
and the Bellman-Ford's batched flag reads), the extracted assignment, the
auction optimum, and whole replays on ``mcmf`` — tolerance 0, the port on
``device="cpu"``."""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import flow_network as r_flow  # noqa: E402
from repro.core import latency as r_latency  # noqa: E402
from repro.core import mcmf as r_mcmf  # noqa: E402
from repro.core import policy as r_policy  # noqa: E402
from repro.core import scheduler_backend as r_sb  # noqa: E402
from repro.core import simulator as r_sim  # noqa: E402
from repro.core import topology as r_topology  # noqa: E402
from repro.core import workload as r_workload  # noqa: E402
from repro_torch import convert, obs  # noqa: E402
from repro_torch.core import flow_network as t_flow  # noqa: E402
from repro_torch.core import mcmf as t_mcmf  # noqa: E402
from repro_torch.core import policy as t_policy  # noqa: E402
from repro_torch.core import scheduler_backend as t_sb  # noqa: E402
from repro_torch.core import simulator as t_sim  # noqa: E402

ARRAYS = ("src", "dst", "cap", "cost", "arc_kind", "arc_task", "arc_target")
TOPO = r_topology.Topology(
    n_machines=48, machines_per_rack=8, racks_per_pod=3, slots_per_machine=4
)


def _round_state(rng, topo, plane, T=8, J=2, t=5, running=0):
    """`tests/test_solvers.py`'s instance; ``running`` of the tasks are
    already placed (movers keep the arc to their current machine)."""
    roots = rng.integers(0, topo.n_machines, size=J)
    cur = np.full(T, -1, np.int64)
    cur[:running] = rng.integers(0, topo.n_machines, size=running)
    return r_policy.RoundState(
        task_job=np.sort(rng.integers(0, J, size=T)),
        perf_idx=rng.integers(0, 4, size=T),
        root_machine=roots,
        root_latency=np.stack([plane.latency_from(int(m), t) for m in roots]),
        wait_s=rng.uniform(0, 30, size=T).astype(np.float32),
        run_s=rng.uniform(0, 300, size=T).astype(np.float32) * (cur >= 0),
        cur_machine=cur,
        free_slots=rng.integers(0, 4, size=topo.n_machines).astype(np.int32),
    )


def _graphs(seed, running=0, p_m=None):
    rng = np.random.default_rng(200 + seed)
    plane = r_latency.LatencyPlane.synthesize(TOPO, duration_s=30, seed=seed)
    state = _round_state(rng, TOPO, plane, running=running)
    kw = {} if p_m is None else dict(p_m=p_m, preemption=True)
    r_params = r_policy.PolicyParams(**kw)
    ref_costs = r_policy.dense_costs(state, TOPO, r_params)
    t_state, t_topo = convert.from_reference(state), convert.from_reference(TOPO)
    t_params = convert.from_reference(r_params)
    port_costs = t_policy.dense_costs(t_state, t_topo, t_params)
    return (state, r_flow.build_flow_graph(state, TOPO, r_params, ref_costs),
            t_state, t_flow.build_flow_graph(t_state, t_topo, t_params, port_costs))


@pytest.mark.parametrize("seed,running,p_m", [(0, 0, None), (1, 0, None), (2, 4, 150),
                                              (3, 8, 110)])
def test_flow_graph_arrays_equal_reference(seed, running, p_m):
    _, ref, _, port = _graphs(seed, running, p_m)
    for name in ARRAYS:
        a, b = getattr(ref, name), getattr(port, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    for name in ("n_nodes", "source", "sink", "task0", "unsched0", "x_node", "rack0",
                 "machine0"):
        assert getattr(ref, name) == getattr(port, name), name


@pytest.mark.parametrize("seed,running,p_m", [(0, 0, None), (2, 4, 150), (3, 8, 110)])
def test_flow_and_assignment_equal_reference(seed, running, p_m):
    state, ref_g, t_state, g = _graphs(seed, running, p_m)
    ref = r_mcmf.min_cost_max_flow(ref_g.src, ref_g.dst, ref_g.cap, ref_g.cost,
                                   ref_g.source, ref_g.sink, ref_g.n_nodes)
    port = t_mcmf.min_cost_max_flow(g.src, g.dst, g.cap, g.cost, g.source, g.sink,
                                    g.n_nodes, device="cpu")
    assert np.array_equal(ref.flow, port.flow)
    assert (ref.total_cost, ref.total_flow) == (port.total_cost, port.total_flow)
    assert port.total_flow == state.n_tasks
    assert np.array_equal(r_flow.extract_assignment(ref_g, ref.flow, state),
                          t_flow.extract_assignment(g, port.flow, t_state))


def _random_graph(seed, n_nodes=14, n_arcs=40, isolated=3):
    """A random digraph whose last ``isolated`` nodes have no arcs at all,
    plus arcs of zero capacity and negative-cost reverse arcs in the
    residual graph: unreachable nodes and empty segments."""
    rng = np.random.default_rng(seed)
    live = n_nodes - isolated
    src = rng.integers(0, live, size=n_arcs)
    dst = rng.integers(0, live, size=n_arcs)
    keep = src != dst
    src, dst = src[keep], dst[keep]
    cap = rng.integers(0, 3, size=len(src))
    cost = rng.integers(0, 50, size=len(src))
    return src, dst, cap, cost, 0, live - 1, n_nodes


@pytest.mark.parametrize("seed", range(6))
def test_min_cost_max_flow_with_unreachable_nodes(seed):
    src, dst, cap, cost, s, t, n = _random_graph(seed)
    ref = r_mcmf.min_cost_max_flow(src, dst, cap, cost, s, t, n)
    port = t_mcmf.min_cost_max_flow(src, dst, cap, cost, s, t, n, device="cpu")
    assert np.array_equal(ref.flow, port.flow)
    assert (ref.total_cost, ref.total_flow) == (port.total_cost, port.total_flow)


@pytest.mark.parametrize("seed", range(4))
def test_bellman_ford_equals_reference_for_any_flag_cadence(seed):
    """dist and parent equal the reference's `_bellman_ford` bit for bit
    whether the host reads the flag every iteration or every k, and the
    iterations never exceed the reference's cap of n_nodes + 1."""
    import jax.numpy as jnp

    src, dst, cap, cost, s, _t, n = _random_graph(100 + seed, n_nodes=20, n_arcs=70)
    rng = np.random.default_rng(seed)
    resid = np.concatenate([cap, rng.integers(0, 2, size=len(src))]).astype(np.int32)
    src2 = np.concatenate([src, dst]).astype(np.int32)
    dst2 = np.concatenate([dst, src]).astype(np.int32)
    cost2 = np.concatenate([cost, -cost]).astype(np.int32)
    want_d, want_p = r_mcmf._bellman_ford(
        jnp.asarray(src2), jnp.asarray(dst2), jnp.asarray(cost2), jnp.asarray(resid),
        jnp.int32(s), n)
    iters = set()
    for k in (1, 3, 7, 10_000):
        d, p, it, reads = t_mcmf._bellman_ford(
            torch.from_numpy(src2.astype(np.int64)), torch.from_numpy(dst2.astype(np.int64)),
            torch.from_numpy(cost2), torch.from_numpy(resid), s, n, check_every=k)
        assert d.dtype == p.dtype == torch.int32
        assert np.array_equal(d.numpy(), np.asarray(want_d)), k
        assert np.array_equal(p.numpy(), np.asarray(want_p)), k
        assert it <= n + 1 and reads == math.ceil(it / k)
        iters.add(it)
    assert max(iters) == n + 1  # k = 10,000: capped, one flag read


def test_mcmf_counters_count_paths_iterations_and_syncs():
    _, _, _, g = _graphs(0)
    with obs.scope():
        fr = t_mcmf.min_cost_max_flow(g.src, g.dst, g.cap, g.cost, g.source, g.sink,
                                      g.n_nodes, device="cpu")
        c = obs.counters()
    # Unit paths: one augmentation a task, then one failed search.
    assert c["mcmf.augmentations"] == fr.total_flow == 8
    assert c["mcmf.bf_iterations"] >= 9 * 2
    assert c["mcmf.host_syncs"] >= 9 * 2


def test_mcmf_rejects_costs_beyond_int32():
    with pytest.raises(ValueError, match="int32"):
        t_mcmf.min_cost_max_flow(np.array([0]), np.array([1]), np.array([1]),
                                 np.array([2**29]), 0, 1, 2, device="cpu")


@pytest.mark.parametrize("seed", range(3))
def test_mcmf_backend_matches_exact_auction_and_reference(seed):
    """`MCMFBackend` and `AuctionBackend(exact=True)` reach one optimum
    (mirrors tests/test_policy_device.py), and equal the reference's
    `MCMFBackend` column for column."""
    rng = np.random.default_rng(500 + seed)
    topo = r_topology.Topology(n_machines=40, machines_per_rack=8, racks_per_pod=2,
                               slots_per_machine=4)
    plane = r_latency.LatencyPlane.synthesize(topo, duration_s=30, seed=seed)
    state = _round_state(rng, topo, plane, T=10, J=2)
    t_state, t_topo = convert.from_reference(state), convert.from_reference(topo)
    params = t_policy.PolicyParams()
    ctx = t_sb.RoundContext(rng=np.random.default_rng(0),
                            task_counts=np.zeros(topo.n_machines, np.int64),
                            n_ready=state.n_tasks)
    pa = t_sb.AuctionBackend(params, t_topo, tie_jitter=0, exact=True,
                             device="cpu").place(t_state, ctx)
    pm = t_sb.make_backend("mcmf", params, t_topo, device="cpu").place(t_state, ctx)
    assert pa.objective == pm.objective
    M = topo.n_machines
    for p in (pa, pm):
        counts = np.bincount(p.cols[(p.cols >= 0) & (p.cols < M)], minlength=M)
        assert np.all(counts <= state.free_slots)
    ref = r_sb.MCMFBackend(r_policy.PolicyParams(), topo).place(
        state, r_sb.RoundContext(rng=np.random.default_rng(0),
                                 task_counts=np.zeros(M, np.int64), n_ready=state.n_tasks))
    assert np.array_equal(ref.cols, pm.cols) and ref.objective == pm.objective


def test_backend_names_equal_reference():
    assert t_sb.BACKEND_NAMES == r_sb.BACKEND_NAMES
    assert len(set(t_sb.BACKEND_NAMES)) == len(t_sb.BACKEND_NAMES)
    for name in t_sb.BACKEND_NAMES:
        b = t_sb.make_backend(name, t_policy.PolicyParams(),
                              convert.from_reference(TOPO), device="cpu")
        ref = r_sb.make_backend(name, r_policy.PolicyParams(), TOPO)
        assert b.name == ref.name
        for flag in ("needs_latency", "caps_admission", "supports_migration",
                     "selects_movers", "supports_window", "supports_whatif",
                     "supports_serving"):
            assert getattr(b, flag) == getattr(ref, flag), (name, flag)


@pytest.mark.parametrize("n_machines,via", [(16, "backend"), (48, "solver")])
def test_mcmf_replay_equals_reference(n_machines, via):
    topo = r_topology.Topology(n_machines=n_machines, machines_per_rack=8,
                               racks_per_pod=2, slots_per_machine=4)
    plane = r_latency.LatencyPlane.synthesize(topo, duration_s=60, seed=1)
    wl = r_workload.synth_workload(topo, duration_s=60, seed=1, target_utilisation=0.6)
    pick = dict(backend="mcmf") if via == "backend" else dict(solver="mcmf")
    common = dict(policy="nomora", seed=5, fixed_algo_s=0.0, migration_interval_s=30,
                  **pick)
    params = dict(preemption=True, beta_scale=0.0)
    ref = r_sim.Simulator(wl, plane, r_sim.SimConfig(
        params=r_policy.PolicyParams(**params), **common)).run()
    port = t_sim.Simulator(convert.from_reference(wl), convert.from_reference(plane),
                           t_sim.SimConfig(params=t_policy.PolicyParams(**params),
                                           device="cpu", **common)).run()
    assert ref.rounds > 0 and ref.tasks_migrated > 0
    for f in ("algo_runtime_s", "placement_latency_s", "response_time_s",
              "migrated_pct_per_round", "per_job_perf", "tasks_placed",
              "tasks_migrated", "rounds"):
        assert getattr(ref, f) == getattr(port, f), f


@pytest.mark.parametrize("seed", range(3))
def test_mcmf_matches_networkx(seed):
    """`tests/test_solvers.py`'s bipartite instances against networkx."""
    nx = pytest.importorskip("networkx")
    rng = np.random.default_rng(100 + seed)
    T, M, J = int(rng.integers(2, 8)), int(rng.integers(3, 12)), int(rng.integers(1, 3))
    w_m = rng.integers(100, 1000, size=(T, M))
    tj = rng.integers(0, J, size=T)
    a = rng.integers(1001, 2000, size=T)
    caps = rng.integers(0, 3, size=M)
    task0, mach0, uns0 = 1, 1 + T, 1 + T + M
    sink = uns0 + J
    arcs = [(0, task0 + t, 1, 0) for t in range(T)]
    for t in range(T):
        arcs += [(task0 + t, mach0 + m, 1, int(w_m[t, m])) for m in range(M)]
        arcs.append((task0 + t, uns0 + int(tj[t]), 1, int(a[t])))
    arcs += [(mach0 + m, sink, int(caps[m]), 0) for m in range(M)]
    arcs += [(uns0 + j, sink, T, 0) for j in range(J)]
    src, dst, cap, cost = (np.asarray(x) for x in zip(*arcs))
    fr = t_mcmf.min_cost_max_flow(src, dst, cap, cost, 0, sink, sink + 1, device="cpu")
    G = nx.DiGraph()
    for u, v, c, w in arcs:
        G.add_edge(u, v, capacity=c, weight=w)
    assert fr.total_flow == T
    assert fr.total_cost == nx.cost_of_flow(G, nx.max_flow_min_cost(G, 0, sink))
