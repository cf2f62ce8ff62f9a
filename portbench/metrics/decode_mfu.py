"""The window's decode steps' share of the card's bf16 peak, in percent:
the FLOPs the model needs for the steps that ``decode_s`` times
(``pb.flops.decode_flops`` at each step's cache length: a request of
prompt length L writes positions L .. L + gen - 2) over the window's
``decode_s`` and 989e12 FLOP/s."""

from pb.flops import BF16_FLOPS, decode_flops


def read(run):
    c = run.counters
    s = c.get("decode_s", 0.0)
    if not s:
        return None
    need = sum(decode_flops(run.config, c["batch"], n + j)
               for n in c["served_lengths"] for j in range(c["gen_tokens"] - 1))
    return 100.0 * need / (s * BF16_FLOPS)
