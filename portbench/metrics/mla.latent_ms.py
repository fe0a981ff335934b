"""`mla.latent_ms`: device milliseconds a prefill inside the program's
``mla.latent`` spans (the latent attention's projections, norm, RoPE and
K/V assembly, one span a layer), from the span run
(`portbench.spanrun.spans_of`): the spans' device intervals summed over the
run's ``prefill.step`` spans.  None where the program records no such
span."""
from portbench.spanrun import spans_of


def read(reading):
    got = spans_of(reading)
    if not got:
        return None
    latent = [r for r in got if r["name"] == "mla.latent" and "d0_ns" in r]
    steps = [r for r in got if r["name"] == "prefill.step"]
    if not latent or not steps:
        return None
    return sum(r["d1_ns"] - r["d0_ns"] for r in latent) * 1e-6 / len(steps)
