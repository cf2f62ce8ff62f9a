"""The MLA decode kernel's share of its roofline, in percent: the least
time of each call of ``repro_torch.kernels.mla_decode.mla_decode`` in the
window (``pb.mla.mla_decode_bound_s``: the ``kv_len`` latent and rope
rows, q and o over 3.35 TB/s) summed, over the device time of every
operation launched inside the program's ``mla.kernel`` spans in the
window's decode steps (``pb.serve_mla``: the kernels, and a copy of the
queries where one is needed)."""

from pb.mla import mla_decode_bound_s


def read(run):
    t = run.trace or {}
    dev = t.get("program", {}).get("mla.kernel", {}).get("device_s", 0.0)
    calls = t.get("mla_calls")
    if not calls or not dev:
        return None
    return 100.0 * sum(mla_decode_bound_s(**c) for c in calls) / dev
