"""The ``wrapped`` configuration's system: the default one (the port's
predict CLI), recording each system's device in :data:`CALLS`."""

from portbench import system

CALLS = []

prebuild = system.prebuild
bucket_of = system.bucket_of


class System(system.System):
    def __init__(self, raw, device=None, batch_size=None):
        CALLS.append(device)
        super().__init__(raw, device, batch_size)
