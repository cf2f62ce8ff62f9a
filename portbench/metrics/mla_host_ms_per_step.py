"""Host milliseconds of the MLA layers a decode step: the program's
``layer.mla`` spans (``models.layers.apply_mla``: projections, rope and
absorption, the cache write, the attention call and the output
projections) inside the window's decode steps, over the steps."""

from pb.program_spans import ms_per_step


def read(run):
    return ms_per_step(run, "layer.mla")
