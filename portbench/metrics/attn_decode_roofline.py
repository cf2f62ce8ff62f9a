"""The decode attention calls' share of their roofline, in percent: the
least time of each call (``pb.flops.attn_bound_s`` from its shapes and key
count) summed, over the device time of every operation launched inside
the calls to ``flash_attention_bshd`` with one query row."""

from pb.flops import attn_bound_s

LABEL = "serve.attn_decode"


def read(run):
    calls = run.calls.get(LABEL)
    dev = (run.trace or {}).get("by_span", {}).get(LABEL, 0.0)
    if not calls or not dev:
        return None
    return 100.0 * sum(attn_bound_s(**c) for c in calls) / dev
