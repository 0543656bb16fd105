"""The ``wrapped`` configuration's yardstick: the default one's bytes of
the boundary kernel and, for a second kernel, 4 B a line fed; each call's
lines and chars fed go to :data:`CALLS`."""

from portbench import work

CALLS = []


def kernel_bytes(config, raw, corpus, lines_fed, chars_fed):
    CALLS.append((lines_fed, chars_fed))
    return dict(work.kernel_bytes(config, raw, corpus, lines_fed, chars_fed),
                second_kernel=4.0 * lines_fed)
