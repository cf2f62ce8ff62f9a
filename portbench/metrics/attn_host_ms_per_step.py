"""Host milliseconds of the attention layers a decode step: the program's
``layer.attn`` spans (``models.layers.apply_attn``: projections and rope,
the cache write, the kernel call and the output projection) inside the
window's decode steps, over the steps."""

from pb.program_spans import ms_per_step


def read(run):
    return ms_per_step(run, "layer.attn")
