"""The RK combination's share of the FVM step's device time: the device time
of the operations launched inside the port's ``solver.combine`` spans
within a ``solver.forward`` span, over that of the operations launched
inside ``solver.forward`` (the port's span log, ``program_spans``). None
without the log or without steps in the window."""

from benchmark import program_spans


def read(rec):
    return program_spans.share_of_step(rec, "solver.combine")
