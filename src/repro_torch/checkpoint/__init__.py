from .checkpoint import (AsyncCheckpointer, CheckpointCorruptError,
                         CheckpointError, StructureMismatchError,
                         cleanup_stale_tmp, latest_step, restore,
                         restore_latest_valid, save, valid_steps)
