from repro_torch.checkpoint.manager import CheckpointManager, restore, restore_tree, save

__all__ = ["CheckpointManager", "restore", "restore_tree", "save"]
