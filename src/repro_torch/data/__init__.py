from repro_torch.data import loader, synthetic

__all__ = ["loader", "synthetic"]
