"""lander_step_roofline: the lander step kernel's share of its roofline, %.

The least time each traced ``lander_step`` launch could take on the card
(``work/lander_step.py``: its bytes at the HBM's peak or its float32
operations at the peak, whichever is longer), summed over the launches of
the profiled iterations, over the device time those launches took. No
launch traced: nothing to read.
"""


def read(view):
    ns = view.kernel_ns("lander_step")
    if not ns:
        return None
    least = view.work("lander_step").least_s(view.cfg, view.peaks)
    return 100.0 * least * len(ns) / (sum(ns) / 1e9)
