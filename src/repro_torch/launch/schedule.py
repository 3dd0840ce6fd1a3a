"""NoMora-scheduled ML cluster: the paper's policy placing LM jobs.

Port of `repro.launch.schedule`. LM workloads (one per architecture of
``configs``, by job kind) become NoMora jobs whose root is the coordinator
host; the policy places them against live latency, migrates them when
latency degrades (or a host fails), and each placement's hosts are ordered
for the job's device mesh so that the model-parallel axis occupies the
lowest-latency hosts relative to the root
(`repro_torch.launch.mesh.nomora_ordered_devices`).

  PYTHONPATH=src python -m repro_torch.launch.schedule --machines 192 --jobs 12

The scheduling rounds run on the card (``SimConfig.device``) unless
``device="cpu"`` / ``--device cpu`` is given; without a card the default
raises.
"""

from __future__ import annotations

import argparse

import numpy as np

from ..core import latency, simulator, topology, workload
from ..core.policy import PolicyParams
from .mesh import nomora_ordered_devices

ARCH_KIND = {
    "command-r-plus-104b": "train",
    "qwen3-1.7b": "train",
    "granite-20b": "train",
    "qwen3-0.6b": "serve",
    "llama4-scout-17b-a16e": "train",
    "dbrx-132b": "train",
    "rwkv6-7b": "scan_train",
    "recurrentgemma-2b": "scan_train",
    "musicgen-medium": "serve",
    "llama-3.2-vision-11b": "serve",
}


def schedule_ml_jobs(
    n_machines: int = 192,
    n_jobs: int = 12,
    duration_s: int = 300,
    hosts_per_job: int = 8,
    seed: int = 0,
    preemption: bool = True,
    device: str = "cuda",
):
    """Place a fleet of LM jobs with NoMora; return placements + metrics."""
    topo = topology.Topology(
        n_machines=n_machines, machines_per_rack=16, racks_per_pod=4,
        slots_per_machine=4,
    )
    plane = latency.LatencyPlane.synthesize(topo, duration_s=duration_s, seed=seed)
    archs = list(ARCH_KIND)
    jobs = [
        workload.ml_job(
            i,
            archs[i % len(archs)],
            ARCH_KIND[archs[i % len(archs)]],
            n_hosts=hosts_per_job,
            duration_s=duration_s - 10,
            arrival_s=float(2 * i),
        )
        for i in range(n_jobs)
    ]
    wl = workload.Workload(jobs=jobs, duration_s=duration_s, topo=topo)
    cfg = simulator.SimConfig(
        policy="nomora",
        params=PolicyParams(preemption=preemption, beta_scale=0.0),
        migration_interval_s=30,
        straggler_threshold=0.85 if preemption else None,
        seed=seed,
        device=device,
    )
    sim = simulator.Simulator(wl, plane, cfg)
    metrics = sim.run()

    placements = {}
    for jid, rec in sim.jobs.items():
        hosts = [t.machine for t in rec.tasks if t.machine >= 0]
        if rec.root_machine < 0 or not hosts:
            continue
        lat = plane.latency_from(rec.root_machine, duration_s - 1)
        # The host list, NoMora-ordered for mesh construction: closest
        # hosts take the model-parallel axis.
        ordered = nomora_ordered_devices(
            host_of_device=list(range(len(hosts))),
            latency_to_root=[lat[h] for h in hosts],
            devices=hosts,
        )
        placements[jid] = {
            "arch": rec.job.ml_arch,
            "root": int(rec.root_machine),
            "hosts_mesh_order": [int(h) for h in ordered],
            "mean_rtt_us": float(np.mean([lat[h] for h in hosts])),
        }
    return placements, metrics


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--machines", type=int, default=192)
    ap.add_argument("--jobs", type=int, default=12)
    ap.add_argument("--duration", type=int, default=300)
    ap.add_argument("--hosts-per-job", type=int, default=8)
    ap.add_argument("--no-preemption", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    placements, metrics = schedule_ml_jobs(
        args.machines, args.jobs, args.duration, args.hosts_per_job,
        preemption=not args.no_preemption, device=args.device,
    )
    s = metrics.summary()
    print(f"[schedule] device={args.device} jobs placed: {len(placements)}; "
          f"avg app perf area: {s['avg_app_perf_area']:.1f}%; "
          f"migrations: {int(s['tasks_migrated'])}")
    for jid, p in sorted(placements.items())[:6]:
        print(f"[schedule] job {jid} ({p['arch']}): root=m{p['root']} "
              f"mean RTT {p['mean_rtt_us']:.0f}us mesh order {p['hosts_mesh_order']}")
    return placements, metrics


if __name__ == "__main__":
    main()
