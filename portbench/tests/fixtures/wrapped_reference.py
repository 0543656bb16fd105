"""The ``wrapped`` configuration's reference: the default one, recording
each reference's ``quantize`` in :data:`CALLS`."""

from portbench import reference

CALLS = []


class Reference(reference.Reference):
    def __init__(self, model, *, quantize=False):
        CALLS.append(quantize)
        super().__init__(model, quantize=quantize)
