"""Device operations launched inside the window's decode steps
(``serve_step`` and the layers it calls), over those steps: what the host
issues for one token of every sequence."""

LABELS = ("serve.step", "serve.moe_decode", "serve.attn_decode")


def read(run):
    t = run.trace
    steps = sum(1 for s in run.spans if s[2] == "serve.step")
    if not t or not steps:
        return None
    n = sum(t["by_span_n"].get(k, 0) for k in LABELS)
    return n / steps if n else None
