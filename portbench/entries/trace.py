"""Entry `trace`: the paper's Fig. 5(b) sweeps through the trace
simulator, `repro_torch.sim.sweep_rates`, one sweep per problem of the
configuration's rate grids, back to back; a run is every sweep once.

The problems reach the program as `ComputeProblem`s built from the frozen
topologies; the policy and the seed are the traffic's and --seed.
"""
from __future__ import annotations

import numpy as np

from portbench.reference import trace as reference
from portbench.reference.fleet import regulated

TRACES = reference.TRACES


class TraceEntry:
    metric = "trace_slots_per_s"

    def __init__(self, cell: dict, seed: int, device):
        self.config, self.traffic = cell["config_data"], cell["traffic_data"]
        self.params = cell["params"]
        self.seed = int(seed)
        self.device = device
        self.sweeps = [(key, [float(x) for x in self.config["rates"][key]])
                       for key in self.traffic["problems"]]

    def setup(self) -> None:
        from repro_torch.core.graph import ComputeProblem, Graph
        from repro_torch.core.policies import PolicyConfig
        self.cfg = PolicyConfig(self.traffic["policy"],
                                eps_b=self.config["eps_b"])
        self.problems = {}
        for key, _ in self.sweeps:
            t = self.config["topologies"][key]
            self.problems[key] = ComputeProblem(
                Graph(t["n_nodes"], np.asarray(t["edges"], np.int32),
                      np.asarray(t["capacity"], np.float64)),
                t["s1"], t["s2"], t["dest"], tuple(t["comp_nodes"]),
                tuple(t["comp_caps"]))

    def run(self):
        from repro_torch.sim import sweep_rates
        return [sweep_rates(self.problems[key], self.cfg, lams,
                            T=self.config["T"], seed=self.seed,
                            device=self.device)
                for key, lams in self.sweeps]

    def lane_slots(self, res) -> int:
        return sum(len(lams) for _, lams in self.sweeps) * self.config["T"]

    # -- correctness ------------------------------------------------------

    def sample(self) -> list:
        """Every sweep and every rate: a run's answers are few."""
        return list(range(len(self.sweeps)))

    def answers(self, res, idx: list) -> dict:
        """{"<problem>.<trace>": [L, T] float64} of the sweeps ``idx``."""
        out = {}
        for i in idx:
            key = self.sweeps[i][0]
            r = res[i]
            for name in TRACES:
                out[f"{key}.{name}"] = getattr(r, name).detach().to(
                    "cpu").double().numpy()
        return out

    def reference(self, idx: list, carry: str = "float32") -> dict:
        out = {}
        for i in idx:
            key, lams = self.sweeps[i]
            ref = reference.sweep(self.config["topologies"][key],
                                  self.traffic["policy"],
                                  self.config["eps_b"], lams,
                                  self.config["T"], self.seed, carry)
            out.update({f"{key}.{k}": v for k, v in ref.items()})
        return out

    def control(self, idx: list) -> dict:
        """The cell's control: the reference with its carry held in
        bfloat16 between slots, its arithmetic in float32."""
        return self.reference(idx, "bfloat16")

    def compare(self, prog: dict, ref: dict) -> dict:
        """`trace_gap`: the largest |program - reference| / max(|reference|,
        1) of any float trace at any slot and rate.  `n_star_differ`: the
        share of (rate, slot) at which the load balancer chose another
        comp node than the reference's."""
        gap, differ, n = 0.0, 0, 0
        for key, _ in self.sweeps:
            for name in TRACES:
                p, r = prog[f"{key}.{name}"], ref[f"{key}.{name}"]
                if name == "n_star":
                    differ += int((p != r).sum())
                    n += r.size
                else:
                    gap = max(gap, float((np.abs(p - r) / np.maximum(
                        np.abs(r), 1.0)).max()))
        return {"trace_gap": gap, "n_star_differ": differ / max(n, 1)}

    def kernel_launches(self, results: list) -> list:
        """[(shapes, launches)] of the fused slot step in ``results``: one
        launch a slot of each sweep, one lane per rate, the problem
        unpadded and shared by the lanes."""
        out = []
        for _ in results:
            for key, lams in self.sweeps:
                t = self.config["topologies"][key]
                out.append(({"B": len(lams), "N": t["n_nodes"],
                             "E": len(t["edges"]),
                             "NC": len(t["comp_nodes"]),
                             "regulated": regulated(self.traffic["policy"]),
                             "shared_problem": True}, self.config["T"]))
        return out


ENTRY = TraceEntry
