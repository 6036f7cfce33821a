"""env_steps_per_s: every env step of the iterations the window completed
(B·T each) over the host time from the window's start to the fetch that
ends its last iteration."""


def read(view):
    return len(view.iter_s) * view.steps_per_iter / view.window_s
