"""The window's prefills' share of the card's bf16 peak, in percent: the
FLOPs the model needs for them (``pb.flops.prefill_flops``: every layer
for every prompt token with the routed experts a token uses and the shared
one, attention at its causal pairs, the head at the last position) over
their seconds as ``launch.serve.serve`` reports them (``prefill_s``, the
card synchronised) and 989e12 FLOP/s."""

from pb.flops import BF16_FLOPS, prefill_flops


def read(run):
    c = run.counters
    s = c.get("prefill_s", 0.0)
    if not s:
        return None
    need = sum(prefill_flops(run.config, c["batch"], n)
               for n in c["prefill_lengths"])
    return 100.0 * need / (s * BF16_FLOPS)
