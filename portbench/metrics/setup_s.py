"""Process start to the first timed request: imports, the weights and the
index made from the seed, the program's load, every build and warm-up."""


def read(obs):
    return obs["setup_s"]
