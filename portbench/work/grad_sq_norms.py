"""Work of one ``grad_sq_norms`` launch, as ``chip_smoke.py`` phase 19 (d)
counts it (:3117, :3619-3622): it reads every gradient (f32) once and writes
one square a tensor; 2 float32 operations a parameter."""

OPS_PER_PARAM = 2


def launch_bytes(params: int, tensors: int) -> int:
    return 4 * params + 4 * tensors


def least_s(peaks: dict, params: int, tensors: int, **_) -> float:
    return max(launch_bytes(params, tensors) / peaks["hbm_bytes_per_s"],
               OPS_PER_PARAM * params / peaks["f32_flops_per_s"])
