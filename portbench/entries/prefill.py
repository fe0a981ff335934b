"""Entry `prefill`: a model's prompt prefill through the port's own
`runtime.step.make_prefill_step`, the step `launch/serve.py` uses; a run
is one prefill of the traffic's batch of prompts, returning each prompt's
logits at its last position.

The configuration file names the model twice: its published keys (what
the plain reference reads) and `port`, the port's `ModelConfig` fields.
Its `reference` names the module under `portbench/reference/` that draws
the weights from --seed and computes the reference forward; the program
is given the same weight tensors in its own layout.

`correct` (see `compare`): every run's answer, the last position's logits
of every prompt of the batch, against the reference's on the same
weights, prompts and zero queues.

`FAULTS`: the timed path broken underneath, each a context manager, for
`portbench/readings.py` and the tests; the benchmark's runs use none.
"""
from __future__ import annotations

import contextlib
import importlib

import torch

from portbench.roofline import prefill as counts


class PrefillEntry:
    metric = "prefill_tokens_per_s"

    def __init__(self, cell: dict, seed: int, device):
        self.config = cell["config_data"]
        self.traffic, self.params = cell["traffic_data"], cell["params"]
        self.traffic_name = cell["traffic"]
        self.seed, self.device = int(seed), device
        self.B = int(self.traffic["batch"])
        self.S = int(self.traffic["seq_len"])
        self.activ = self.traffic["activ_dtype"]
        self.ref = importlib.import_module(
            f"portbench.reference.{self.config['reference']}")

    def setup(self) -> None:
        from repro_torch.configs.base import (ModelConfig, RunConfig,
                                              ShapeConfig)
        from repro_torch.runtime.step import make_prefill_step
        self.model = ModelConfig(**self.config["port"])
        self.step = make_prefill_step(RunConfig(
            self.model, ShapeConfig(self.traffic_name, self.S, self.B,
                                    "prefill"),
            activ_dtype=self.activ, param_dtype=self.config["torch_dtype"]))
        gen = torch.Generator(device=self.device).manual_seed(self.seed)
        self.W = self.ref.weights(self.config, gen)
        self.weights = self.ref.program_params(self.W)
        self.tokens = torch.randint(0, self.model.vocab, (self.B, self.S),
                                    generator=gen, device=self.device)
        self.H0 = torch.zeros((self.model.n_layers, self.model.n_experts),
                              dtype=torch.float32, device=self.device)

    def run(self):
        return self.step(self.weights, {"tokens": self.tokens}, self.H0)

    def lane_slots(self, res) -> int:
        """Prompt tokens a run: B x S."""
        return self.B * self.S

    # -- correctness ------------------------------------------------------

    def sample(self) -> list:
        """Every prompt of the batch, in every run."""
        return list(range(self.B))

    def answers(self, res, idx: list) -> dict:
        return {"logits": res.reshape(self.B, -1)[idx]}

    def reference(self, idx: list, precision: str = "float32") -> dict:
        logits = self.ref.forward(self.config, self.W, self.tokens[idx],
                                  self.H0, precision)
        return {"logits": logits}

    def control(self, idx: list) -> dict:
        """The reference computed in float8 e4m3, the precision below the
        configuration's bfloat16."""
        return self.reference(idx, "float8_e4m3fn")

    def compare(self, prog: dict, ref: dict) -> dict:
        """A prompt's gap: the largest |program - reference| logit over
        the reference's largest |logit|.  `row_gap_mean`: its mean over
        the prompts; `row_gap_max`: the largest."""
        r = ref["logits"]
        gaps = (prog["logits"].to(r.dtype) - r).abs().amax(-1) \
            / r.abs().amax(-1)
        return {"row_gap_mean": float(gaps.mean()),
                "row_gap_max": float(gaps.max())}

    def kernel_launches(self, results: list) -> list:
        """[(shapes, launches)] of the traced prefills: the sm90 flash
        kernel and the gate, once a layer, and the prefill itself."""
        return counts.prefill_launches(self.config, self.B, self.S,
                                       self.activ, len(results))


@contextlib.contextmanager
def _patched(module: str, name: str, wrap):
    """``module.name`` replaced by ``wrap(original)`` inside the block."""
    mod = importlib.import_module(module)
    real = getattr(mod, name)
    setattr(mod, name, wrap(real))
    try:
        yield
    finally:
        setattr(mod, name, real)


def altered_answer():
    """One prompt's answer altered where it is produced: the output head
    raises the largest logit of the middle row of the batch by a quarter
    of its largest |logit|."""
    def wrap(real):
        def unembed(*a, **kw):
            out = real(*a, **kw)
            b = out.shape[0] // 2
            top = out[b].abs().amax(-1, keepdim=True)
            out[b] = out[b].scatter_add(-1, out[b].argmax(-1, keepdim=True),
                                        0.25 * top)
            return out
        return unembed
    return _patched("repro_torch.models.transformer", "unembed", wrap)


def late_keys_only():
    """A fault past the middle of the prompt: in every layer the queries
    after position S / 2 attend only to the keys after it, as a flash
    kernel whose key loop started at the wrong tile would."""
    def wrap(real):
        def attention(cfg, p, x, positions, **kw):
            out = real(cfg, p, x, positions, **kw)
            h = x.shape[1] // 2
            out[:, h:] = real(cfg, p, x[:, h:], positions[:, h:], **kw)
            return out
        return attention
    return _patched("repro_torch.models.transformer", "attention", wrap)


def no_causal_mask():
    """Every layer's self-attention sees the keys after its query."""
    def wrap(real):
        def attention(*a, **kw):
            return real(*a, **{**kw, "causal": False})
        return attention
    return _patched("repro_torch.models.transformer", "attention", wrap)


FAULTS = {"altered_answer": altered_answer, "late_keys_only": late_keys_only,
          "no_causal_mask": no_causal_mask}
ENTRY = PrefillEntry
