"""Checkpointing in the reference's npz + manifest format."""
from repro_torch.checkpoint.io import (checkpoint_step,  # noqa: F401
                                       restore_checkpoint, save_checkpoint)
