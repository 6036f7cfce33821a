"""ppo_update_roofline: the share of their roofline that PPO's update
kernels reach together, %.

``ppo_loss_fwd`` and ``ppo_loss_bwd`` (the loss head over a minibatch's
rows), ``grad_sq_norms`` and ``clip_adam`` (the global-norm clip and Adam
over every parameter): for each traced launch the least time its work
(``work/<kernel>.py``) could take at the card's peaks, summed over the
profiled iterations, over the device time of those launches. No launch
traced: nothing to read.
"""

KERNELS = ("ppo_loss_fwd", "ppo_loss_bwd", "grad_sq_norms", "clip_adam")


def read(view):
    net, sizes = view.work(view.conf["model_work"]), view.conf["env_sizes"]
    shape = {"rows": view.cfg["minibatch_size"], "actions": sizes["actions"],
             "params": net.params(view.cfg, sizes), "tensors": net.tensors(view.cfg, sizes)}
    least = spent = 0.0
    for k in KERNELS:
        ns = view.kernel_ns(k)
        least += view.work(k).least_s(view.peaks, **shape) * len(ns)
        spent += sum(ns) / 1e9
    return 100.0 * least / spent if spent else None
