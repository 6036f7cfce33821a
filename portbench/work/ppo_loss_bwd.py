"""Work of one ``ppo_loss_bwd`` launch, as ``chip_smoke.py`` phase 19 (d)
counts it (:3116, :3617-3618): it reads what the forward reads and the
loss's gradient, and writes the logits' and the values' gradients (f32);
112 float32 operations a row at A = 4."""

OPS_PER_ROW = 112


def launch_bytes(rows: int, actions: int) -> int:
    read = 4 * rows * (actions + 1 + 4) + 4
    return read + 4 * rows * (actions + 1)


def least_s(peaks: dict, rows: int, actions: int, **_) -> float:
    return max(launch_bytes(rows, actions) / peaks["hbm_bytes_per_s"],
               OPS_PER_ROW * rows / peaks["f32_flops_per_s"])
