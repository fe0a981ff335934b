"""Entry `prefill_mla`: the prefill of a model with DeepSeek-V3's block
(latent attention, shared experts, leading dense layers, a sigmoid gate)
through the port's own `runtime.step.make_prefill_step`, as `prefill`'s
entry runs granite's: one run is one prefill of the traffic's batch,
returning each prompt's logits at its last position, and `correct`
compares every prompt's with the plain reference's (`compare`).

What differs from `prefill.PrefillEntry`: the port's configuration is its
`MLAConfig` (the file's `port` section); the router queues H are the MoE
layers' alone, [n_layers - first_dense_layers, E]; the launches and FLOPs
come from `roofline/prefill_mla.py`; `FAULTS` break the latent attention
and the shared experts; and the reference is held to the program's picks.

The random model is chaotic under the gate's near-ties (see
`reference/moonlight.py`): on the card a free-running reference reads
each prompt's last row a third to seven tenths of its largest logit away
from the program's, bfloat16's flips alone.  So `reference` runs the
program once more after the window with its gate's picks recorded, checks
that this run's answer equals the last timed run's bit for bit (so the
picks are those of the answers compared), and computes the reference on
those picks (`moonlight.forward_held`), every other part its own.  The
picks themselves are judged by two numbers: `pick_margin`, the largest
amount by which a token's lowest pick falls short of the reference's own
top k, and `pick_miss_share`, the share of (token, MoE layer) pairs whose
shortfall exceeds PICK_ROUNDING, which a gate that mis-picks a small share
of tokens by small gaps raises.  The control is the reference computed in
float8 in the program's place, with its own picks, held to the float32
reference on those picks in the same way.
"""
from __future__ import annotations

import math

import torch

from portbench.entries.prefill import PrefillEntry, _patched
from portbench.roofline import prefill_mla as counts

#: A pick's shortfall below the reference's own k-th score (in sigmoid
#: score) that rounding alone does not reach: `pick_miss_share` counts the
#: (token, MoE layer) pairs beyond it.
PICK_ROUNDING = 0.02


class PrefillMLAEntry(PrefillEntry):

    def setup(self) -> None:
        from repro_torch.configs.base import RunConfig, ShapeConfig
        from repro_torch.configs.moonlight_16b_a3b import MLAConfig
        from repro_torch.runtime.step import make_prefill_step
        self.model = MLAConfig(**self.config["port"])
        self.step = make_prefill_step(RunConfig(
            self.model, ShapeConfig(self.traffic_name, self.S, self.B,
                                    "prefill"),
            activ_dtype=self.activ, param_dtype=self.config["torch_dtype"]))
        gen = torch.Generator(device=self.device).manual_seed(self.seed)
        self.W = self.ref.weights(self.config, gen)
        self.weights = self.ref.program_params(self.W)
        self.tokens = torch.randint(0, self.model.vocab, (self.B, self.S),
                                    generator=gen, device=self.device)
        moe_layers = self.model.n_layers - self.model.first_dense_layers
        self.H0 = torch.zeros((moe_layers, self.model.n_experts),
                              dtype=torch.float32, device=self.device)

    def run(self):
        self._last = super().run()
        return self._last

    def program_picks(self) -> list:
        """The gate's picks of one more run of the timed path, [B, S, k]
        per MoE layer, recorded where `models.moe._route` returns them;
        that run's answer must equal the last run's bit for bit."""
        got, last = [], getattr(self, "_last", None)

        def wrap(real):
            def route(*a, **kw):
                out = real(*a, **kw)
                got.append(out[0].clone())
                return out
            return route
        with _patched("repro_torch.models.moe", "_route", wrap):
            again = self.run()
        if last is not None and not torch.equal(again, last):
            raise RuntimeError(
                "the run that recorded the gate's picks did not repeat the "
                "last timed run bit for bit: the picks would not be those "
                "of the answers compared")
        return got

    def reference(self, idx: list, picks: list | None = None) -> dict:
        """The float32 reference held to ``picks`` (the program's unless
        given; module docstring), for the prompts ``idx``: their last rows'
        logits, `pick_margin` and `pick_miss_share`."""
        if picks is None:
            if getattr(self, "_picks", None) is None:
                self._picks = self.program_picks()
            picks = [p[idx] for p in self._picks]
        logits, short = self.ref.forward_held(
            self.config, self.W, self.tokens[idx], self.H0, picks)
        return {"logits": logits, "shortfall": short,
                "pick_margin": float(short.amax()),
                "pick_miss_share": float(
                    (short > PICK_ROUNDING).float().mean())}

    def control(self, idx: list) -> dict:
        """The reference computed in float8 e4m3 (the precision below the
        configuration's bfloat16) with its own picks, in the program's
        place; it carries the float32 reference held to those picks."""
        logits, picks = self.ref.forward(self.config, self.W,
                                         self.tokens[idx], self.H0,
                                         "float8_e4m3fn")
        return {"logits": logits, "held": self.reference(idx, picks)}

    def compare(self, prog: dict, ref: dict) -> dict:
        """`PrefillEntry.compare`'s row gaps, against the reference held to
        the answer's picks (the control carries its own); `pick_margin`:
        those picks' largest shortfall below the reference's own top k (in
        sigmoid score); `pick_miss_share`: the share of (token, MoE layer)
        pairs whose shortfall exceeds PICK_ROUNDING."""
        ref = prog.get("held", ref)
        return {**super().compare(prog, ref),
                "pick_margin": ref["pick_margin"],
                "pick_miss_share": ref["pick_miss_share"]}

    def kernel_launches(self, results: list) -> list:
        """[(shapes, launches)] of the traced prefills: the sm90 flash
        kernel's (192, 128) instance once a layer, the gate once an MoE
        layer, and the prefill itself."""
        return counts.prefill_launches(self.config, self.B, self.S,
                                       self.activ, len(results))


def _qkv_fault(alter):
    """``alter(cfg, q, k, v)`` applied to what every layer's latent
    projection (`attention._mla_qkv`) gives, as a fault underneath the
    flash kernel's inputs."""
    def wrap(real):
        def qkv(cfg, *a, **kw):
            return alter(cfg, *real(cfg, *a, **kw))
        return qkv
    return _patched("repro_torch.models.attention", "_mla_qkv", wrap)


def k_pe_zeroed():
    """The keys' shared RoPE columns lost: every head's k_pe reads 0, as an
    assembly that skipped the broadcast would leave it."""
    def alter(cfg, q, k, v):
        k = k.clone()
        k[..., cfg.qk_nope_head_dim:] = 0
        return q, k, v
    return _qkv_fault(alter)


def scale_of_v():
    """Scores scaled by 1/sqrt(v's head dim, 128) where the q/k head dim
    (192) sets it, as a kernel that took the scale from v would."""
    def alter(cfg, q, k, v):
        D = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
        return q * math.sqrt(D / cfg.v_head_dim), k, v
    return _qkv_fault(alter)


def shared_experts_dropped():
    """Every MoE layer's shared experts add nothing."""
    def wrap(real):
        def shared(p, x):
            return torch.zeros_like(x)
        return shared
    return _patched("repro_torch.models.moe", "_shared_expert", wrap)


def no_causal_mask():
    """Every layer's latent attention sees the keys after its query."""
    def wrap(real):
        def attention(*a, **kw):
            return real(*a, **{**kw, "causal": False})
        return attention
    return _patched("repro_torch.models.transformer", "mla_attention", wrap)


def seventh_for_sixth():
    """The gate mis-picks one token in 64: that token's lowest-scoring
    pick is replaced by its (k+1)-th best expert (its 7th for its 6th),
    weighted as the gate weights its picks, as a selection network that
    lost one compare now and then would pick."""
    def wrap(real):
        def route(cfg, p, x_flat, *a, **kw):
            idx, w, *rest = real(cfg, p, x_flat, *a, **kw)
            G, Tg, k = idx.shape
            scores = torch.sigmoid(torch.einsum(
                "gtd,de->gte", x_flat, p["router"].to(x_flat.dtype))
                .to(torch.float32))
            nxt = torch.sort(scores, dim=-1, descending=True,
                             stable=True).indices[..., k:k + 1]
            low = torch.gather(scores, -1, idx).argmin(-1, keepdim=True)
            hit = (torch.arange(G * Tg, device=idx.device) % 64 == 0) \
                .view(G, Tg, 1)
            idx = torch.where(hit, idx.scatter(-1, low, nxt), idx)
            wrong = torch.gather(scores, -1, idx)
            wrong = wrong / wrong.sum(-1, keepdim=True).clamp(min=1e-9) * \
                cfg.routed_scale
            return (idx, torch.where(hit, wrong.to(w.dtype), w), *rest)
        return route
    return _patched("repro_torch.models.moe", "_route", wrap)


FAULTS = {"k_pe_zeroed": k_pe_zeroed, "scale_of_v": scale_of_v,
          "shared_experts_dropped": shared_experts_dropped,
          "no_causal_mask": no_causal_mask,
          "seventh_for_sixth": seventh_for_sixth}
ENTRY = PrefillMLAEntry
