from repro_torch.nn import attention, layers, moe

__all__ = ["attention", "layers", "moe"]
