from repro_torch.data.pipeline import (MemmapTokenDataset, Prefetcher,
                                       SyntheticTokenStream, make_pipeline)

__all__ = ["SyntheticTokenStream", "MemmapTokenDataset", "Prefetcher",
           "make_pipeline"]
