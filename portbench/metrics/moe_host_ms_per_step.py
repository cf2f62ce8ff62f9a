"""Host milliseconds of the MoE layers a decode step: the program's
``layer.moe`` spans (``models.layers.apply_moe``: routing, dispatch, the
expert products, combine, the shared expert and the aux loss) inside the
window's decode steps, over the steps."""

from pb.program_spans import ms_per_step


def read(run):
    return ms_per_step(run, "layer.moe")
