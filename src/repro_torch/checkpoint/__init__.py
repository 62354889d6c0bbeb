"""Fault-tolerant checkpointing in the JAX package's format."""

from repro_torch.checkpoint.manager import (CheckpointManager, load_manifest,
                                            load_pytree, save_pytree)
from repro_torch.checkpoint.transpose import (TransposeError, elastic_loader,
                                              restore_targets,
                                              state_program_records,
                                              transpose_matrix_state)

__all__ = ["CheckpointManager", "load_manifest", "load_pytree",
           "save_pytree", "TransposeError", "elastic_loader",
           "restore_targets", "state_program_records",
           "transpose_matrix_state"]
