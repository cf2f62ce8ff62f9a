"""Host milliseconds of a decode step: the mean length of the window's
``serve.decode_step`` spans (``launch.serve.serve`` around each
``serve_step`` call), the host's issue of one step (nothing inside it
synchronises with the card)."""

from pb.program_spans import DECODE_STEP, ms_per_step


def read(run):
    return ms_per_step(run, DECODE_STEP)
