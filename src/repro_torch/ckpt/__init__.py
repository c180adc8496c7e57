"""Content-addressed, async layer-sharded checkpoints on the JAX
package's on-disk format (``ckpt/checkpoint.py``)."""
from repro_torch.ckpt.checkpoint import (CheckpointError, CheckpointManager,
                                         TrainState, elect_writer,
                                         record_hash)

__all__ = ["CheckpointError", "CheckpointManager", "TrainState",
           "elect_writer", "record_hash"]
