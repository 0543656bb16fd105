"""The ``wrapped`` configuration's generator: the default one, recording
each call's seed in :data:`CALLS`."""

from portbench import models

CALLS = []


def generate(config, seed):
    CALLS.append(seed)
    return models.generate(config, seed)
