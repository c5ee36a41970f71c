"""Share of the traced window with no device operation while a query's
thread was inside a host-only span (`spans.HOST_STAGES`): the replies'
spans against the trace's kernels, on one clock. An upper bound on the
idle share (`device_idle.query`) those host stages explain."""

from portbench import spans


def read(obs):
    return spans.host_idle_share(obs)
