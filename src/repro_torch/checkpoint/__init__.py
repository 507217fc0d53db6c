"""Checkpoints (port of ``repro.checkpoint``): parameter trees to npz
(``checkpoint``) and crash-safe run snapshots (``state``)."""
from repro_torch.checkpoint.checkpoint import (CheckpointError,  # noqa: F401
                                               load_pytree, save_pytree)
from repro_torch.checkpoint.state import (SnapshotError,  # noqa: F401
                                          build_resumed_pipeline,
                                          engine_snapshot, load_snapshot,
                                          resume_run, save_engine_snapshot,
                                          save_snapshot)
