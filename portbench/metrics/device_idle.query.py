"""Share of the traced window in which no operation ran on the device."""

from portbench import readers


def read(obs):
    return readers.idle_share(obs)
