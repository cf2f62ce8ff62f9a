"""Device milliseconds of the MoE layers (``models.layers.apply_moe``:
router, dispatch, the expert products, combine and the shared expert) per
decode step: the device time of every operation launched inside the
decode steps' MoE calls, over the steps."""


def read(run):
    t = run.trace
    steps = sum(1 for s in run.spans if s[2] == "serve.step")
    dev = (t or {}).get("by_span", {}).get("serve.moe_decode", 0.0)
    if not steps or not dev:
        return None
    return 1e3 * dev / steps
