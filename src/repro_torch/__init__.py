"""PyTorch/CUDA port of the backpressure network-computation system.

A package beside the JAX reference `repro`, with the same subpackage and
module names.  It imports torch, numpy and scipy, never jax and nothing of
`repro`.

  * `core` — graph, capacity LP, batched queue state, slot policies, and
    the backpressure MoE router (`core.router`);
  * `kernels.bp_slot` — the per-slot routing and comp/balance decisions
    (`csrc/bp_slot.cu`);
  * `kernels.bp_topk` — the fused backpressure top-k gate of MoE routing
    (`csrc/bp_topk.cu`), and the whole gate of one MoE layer in one launch
    (`csrc/bp_topk_route.cu`);
  * `sim`, `fleet` — the trace simulator and the batched fleet engine;
    every state tensor carries a leading fleet axis [B];
  * `serving` — trace-driven serving with backpressure admission control
    on the fleet substrate (`run_serving`, `serving_report`), with the
    latency accumulators of `core.latency`;
  * `obs` — the chunk-boundary telemetry stream (`obs.emitter`), its
    versioned record schema (`obs.schema`) and a live view
    (``python -m repro_torch.obs.follow``);
  * `configs`, `models` — the ported architectures and the dense/MoE
    decoder-only transformer's decode path;
  * `launch.serve` — the continuous-batching serving `Engine`.

The kernels are hand-written CUDA, built with nvcc at first use; on CPU
tensors their wrappers run the plain PyTorch versions.  Entry points
(`run_fleet`, `run_serving`, `simulate`, `Engine`, ...) run on CUDA
unless the caller passes ``device="cpu"``, and raise without a card.
"""
