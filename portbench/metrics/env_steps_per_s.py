"""env_steps_per_s: every env step of the iterations the window completed
(each the program side's ``env_steps`` at the cell's settings: B·T for the
PPO family) over the host time from the window's start to the fetch that
ends its last iteration."""


def read(view):
    return len(view.iter_s) * view.steps_per_iter / view.window_s
