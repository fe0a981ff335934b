"""Entry `fleet`: a probe round of the capacity atlas through
`repro_torch.fleet.run_fleet`, whole runs back to back.

Lanes: every topology of the configuration x the traffic's arrival
seeds, the same lanes for every --seed: the seed orders each batch's lanes
and draws the lanes compared, so every run does the same work (early
stopping makes a batch's length depend on its arrivals).  A topology's
lanes probe one rate of its bisection's first probes (the traffic's
`probes`, picked by topo seed), k x rel_tol x its frozen exact LP bound,
as the atlas probes them.  A run is one `run_fleet` call per (policy group, shape bucket), the
atlas's batches, each padded to its bucket's frozen dims.  The frozen
topologies reach the program as scenarios registered under names of their
own (`register_scenario`), so the program's factories are never asked.
"""
from __future__ import annotations

import numpy as np

from portbench.reference import fleet as reference

#: Per-lane metrics compared with the reference (all of `run_fleet`'s but
#: the inputs it echoes).
METRICS = ("useful_rate", "delivered", "delivered_useful", "mean_queue",
           "mean_queue_mid", "mean_queue_tail", "max_queue", "stable",
           "verdict", "decided_at_slot", "slots_saved")


def lanes(config: dict, traffic: dict) -> list:
    """[(topology key, probe position, offered rate, lane seed)] in lane
    order."""
    seeds = [int(s) for s in traffic["seeds"]]
    probes = traffic["probes"]
    out = []
    for fam in config["families"]:
        for ts in config["topo_seeds"]:
            key = f"{fam}/{ts}"
            pos = int(probes[int(ts) % len(probes)])
            k = config["probes"][key][pos]
            lam = float(np.float32(k * (config["rel_tol"]
                                        * config["bounds"][key])))
            out.extend((key, pos, lam, s) for s in seeds)
    return out


def units(config: dict, all_lanes: list, seed: int) -> list:
    """[(wireless, bucket, [lane index])]: the atlas's batches, policy
    groups in first-seen order, buckets ascending within each, each
    batch's lanes in an order drawn from ``seed``."""
    rng = np.random.default_rng(int(seed))
    groups = {}
    for i, (key, *_rest) in enumerate(all_lanes):
        w = bool(config["topologies"][key]["wireless"])
        groups.setdefault(w, {}).setdefault(config["buckets"][key],
                                            []).append(i)
    return [(w, b, rng.permutation(idx).tolist()) for w, by in groups.items()
            for b, idx in sorted(by.items())]


def sample(all_lanes: list, per_stratum: int, seed: int) -> list:
    """Lane indices drawn from ``seed``: ``per_stratum`` of each (family,
    probe), so every topology family, event and interference model and
    load regime is compared."""
    rng = np.random.default_rng(int(seed))
    strata = {}
    for i, (key, pos, _, _) in enumerate(all_lanes):
        strata.setdefault((key.split("/")[0], pos), []).append(i)
    picked = []
    for _, idx in sorted(strata.items()):
        picked.extend(rng.choice(idx, size=min(per_stratum, len(idx)),
                                 replace=False).tolist())
    return sorted(picked)


class FleetEntry:
    """One cell's atlas round: `setup` registers the frozen topologies and
    builds each batch's jobs; `run` is one `run_fleet` call per batch."""

    metric = "engine_slots_per_s"

    def __init__(self, cell: dict, seed: int, device):
        self.config, self.traffic = cell["config_data"], cell["traffic_data"]
        self.params = cell["params"]
        self.seed = int(seed)
        self.device = device
        self.lanes = lanes(self.config, self.traffic)
        self.batches = None

    def setup(self) -> None:
        from repro_torch.core.graph import ComputeProblem, Graph
        from repro_torch.fleet import (FleetJob, PadDims, Scenario,
                                       list_scenarios, register_scenario)
        known = set(list_scenarios())
        names = {}
        for key, topo in self.config["topologies"].items():
            name = f"portbench.{self.config['name']}.{key}"
            names[key] = name
            if name in known:
                continue
            problem = ComputeProblem(
                Graph(topo["n_nodes"], np.asarray(topo["edges"], np.int32),
                      np.asarray(topo["capacity"], np.float64)),
                topo["s1"], topo["s2"], topo["dest"],
                tuple(topo["comp_nodes"]), tuple(topo["comp_caps"]))
            register_scenario(Scenario(
                name, (lambda p: lambda _seed: p)(problem),
                arrival=topo["arrival"], events=topo["events"],
                wireless=topo["wireless"]))
        cfg = self.config
        self.batches = []
        for wireless, b, idx in units(cfg, self.lanes, self.seed):
            jobs = [FleetJob(scenario=names[self.lanes[i][0]],
                             policy=cfg["policy"], lam=self.lanes[i][2],
                             seed=self.lanes[i][3], eps_b=cfg["eps_b"])
                    for i in idx]
            self.batches.append((wireless, PadDims(**cfg["bucket_pads"][b]),
                                 idx, jobs))
        self.where = {}
        for u, (_, _, idx, _) in enumerate(self.batches):
            self.where.update({i: (u, j) for j, i in enumerate(idx)})

    def run(self):
        from repro_torch.fleet import run_fleet
        cfg = self.config
        return [run_fleet(jobs, T=cfg["T"], chunk=cfg["chunk"],
                          device=self.device, dims=dims,
                          early_stop=cfg["early_stop"])
                for _, dims, _, jobs in self.batches]

    def lane_slots(self, res) -> int:
        """Lane-slots of the offered horizon: early-stopped slots count as
        done, since the user has the verdict."""
        return sum(len(jobs) * int(r.T)
                   for (_, _, _, jobs), r in zip(self.batches, res))

    # -- correctness ------------------------------------------------------

    def sample(self) -> list:
        return sample(self.lanes, int(self.params["ref_per_stratum"]),
                      self.seed)

    def answers(self, res, idx: list) -> dict:
        """{metric: [len(idx)] float64} of the sampled lanes."""
        rows = [res[u].metrics[j] for u, j in (self.where[i] for i in idx)]
        return {k: np.array([m[k] for m in rows], np.float64)
                for k in METRICS}

    def reference(self, idx: list, carry: str = "float32") -> dict:
        cfg = self.config
        chosen = [self.lanes[i] for i in idx]
        pads = cfg["bucket_pads"]
        pad = {k: max(p[k] for p in pads) for k in pads[0]}
        return reference.run_lanes(
            [cfg["topologies"][key] for key, _, _, _ in chosen],
            [lam for _, _, lam, _ in chosen], [s for *_, s in chosen],
            pad=pad, eps_b=cfg["eps_b"], T=cfg["T"], chunk=cfg["chunk"],
            regulated=reference.regulated(cfg["policy"]), carry=carry)

    def control(self, idx: list) -> dict:
        """The cell's control: the reference with its carry held in
        bfloat16 between slots, its arithmetic in float32."""
        return self.reference(idx, "bfloat16")

    def compare(self, prog: dict, ref: dict) -> dict:
        """`verdicts_differ`: sampled lanes whose streaming verdict is not
        the reference's.  `lane_gap`: over the other lanes, the largest
        |program - reference| / max(|reference|, 1) of any metric."""
        agree = prog["verdict"] == ref["verdict"]
        gap = 0.0
        for k in METRICS:
            d = np.abs(prog[k] - ref[k]) / np.maximum(np.abs(ref[k]), 1.0)
            if agree.any():
                gap = max(gap, float(d[agree].max()))
        return {"verdicts_differ": int((~agree).sum()), "lane_gap": gap}

    def kernel_launches(self, results: list) -> list:
        """[(shapes, launches)] of the fused slot step in ``results``: one
        shape per batch, its lanes padded to the bucket's dims."""
        reg = reference.regulated(self.config["policy"])
        out = []
        for res in results:
            for (_, dims, _, jobs), r in zip(self.batches, res):
                out.append(({"B": len(jobs), "N": dims.n_nodes,
                             "E": dims.n_edges, "NC": dims.n_comp,
                             "regulated": reg, "shared_problem": False},
                            int(r.slot_steps)))
        return out


ENTRY = FleetEntry
