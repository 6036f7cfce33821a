"""Work of one ``ppo_loss_fwd`` launch, as ``chip_smoke.py`` phase 19 (d)
counts it (:3115, :3600-3616), over a minibatch of ``rows`` rows of
``actions`` logits: it reads each row's logits and value (f32) and its four
packed columns (action, old log-prob, advantage, value target, f32) once,
and writes the loss and the five metrics (f32); 64 float32 operations a row
at A = 4 (each add, multiply, compare, select, exp and log as one)."""

OPS_PER_ROW = 64


def launch_bytes(rows: int, actions: int) -> int:
    return 4 * rows * (actions + 1 + 4) + 4 * (1 + 5)


def least_s(peaks: dict, rows: int, actions: int, **_) -> float:
    return max(launch_bytes(rows, actions) / peaks["hbm_bytes_per_s"],
               OPS_PER_ROW * rows / peaks["f32_flops_per_s"])
