from repro_torch.data.pipeline import (ByteCorpus, DataCursor, GlobalBatchDispenser,
                                 SyntheticLM)

__all__ = ["ByteCorpus", "DataCursor", "GlobalBatchDispenser", "SyntheticLM"]
