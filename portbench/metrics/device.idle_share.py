"""device.idle_share: the share of the profiled iterations' wall time in
which no kernel ran on the card, %: 1 − the union of the traced kernels'
intervals (copies and memsets left out) over the iterations' span, from the
host's clock, synchronized at both ends. No kernel traced: nothing to read.
"""


def read(view):
    if not view.kernels:
        return None
    return 100.0 * (1.0 - view.busy_s / view.wall_s)
