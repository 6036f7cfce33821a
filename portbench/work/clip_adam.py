"""Work of one ``clip_adam`` launch, as ``chip_smoke.py`` phase 19 (d) counts
it (:3118, :3623-3626): it reads each parameter, its gradient and its two
moments and writes the parameter and the moments (f32: 28 B a parameter),
and reads one square a tensor; 14 float32 operations a parameter."""

OPS_PER_PARAM = 14


def launch_bytes(params: int, tensors: int) -> int:
    return 28 * params + 4 * tensors


def least_s(peaks: dict, params: int, tensors: int, **_) -> float:
    return max(launch_bytes(params, tensors) / peaks["hbm_bytes_per_s"],
               OPS_PER_PARAM * params / peaks["f32_flops_per_s"])
