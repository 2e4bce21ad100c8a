"""The spectral convs' share of the FNO-3D forward's device time: the
device time of the operations launched inside the port's ``fno3d.conv``
spans within a ``train.forward`` span, over that of the operations launched
inside ``train.forward`` (the port's span log, ``program_spans``). The test
passes' forwards, outside any train step, are left out. None without the
log or without train steps in the window."""

from benchmark import program_spans


def read(rec):
    return program_spans.share_of_step(rec, "fno3d.conv", "train.forward")
