from repro_torch.checkpoint.store import CheckpointMeta, CheckpointStore
