from gymrl_tpu_torch.nn.layers import Dense

__all__ = ["Dense"]
