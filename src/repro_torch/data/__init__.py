from repro_torch.data.pipeline import DataConfig, SyntheticLMDataset, make_batch_shapes
